#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`spark_druid_olap_tpu_torch`).

    python3 chip_smoke.py [--ssb-scale 10] [--tpch-scale 1] [--stream-chunks 512]

Needs one CUDA card; without one it exits non-zero and prints no result.
Phases, one JSON line each:

1. card: name and power limit from nvidia-smi, torch and CUDA versions;
2. build: compiles the group-by kernel from `csrc/` (nvcc, sm_90a);
3. kernel: the kernel against its plain PyTorch version on the card, at
   the reference kernel's test shapes, the all-masked case and the shapes
   the main path launches in phases 4 to 16 (one 512K-row segment at each
   query's and grouping set's G and column counts, at the tier's presence
   counts and compacted domains, at the fallback's assisted subtrees, plus a time-sorted Timeseries segment, the
   sparse tier's 4096 slots on rows sorted by slot, and the stream's 2^21-row
   chunk; a shape left out fails the run): mins/maxs
   exactly equal, sums within rtol 1e-5 (another summation order over
   512K rows), two launches bit-equal.  At those shapes it times the
   kernel (`ms`) and one library call computing the same sums
   (`index_add_`, `library_ms`) by device time under torch.profiler,
   over launches that rotate through copies of the inputs larger than the
   L2 together, so reads come from HBM as the bound assumes; the call
   through the wrapper on the host clock (`call_ms`, CUDA events around
   one Python call); the plain version (`plain_ms`, CUDA events); and, to
   see what holds the kernel back, its device time per pass (`pass_ms`),
   and at the headline shape and the first sorted one also on L2-resident
   inputs (`l2_ms`) and with every row masked (`floor_ms`; at every shape
   until phase 19 came);
4. main path: SSB (SF10: 60M lineorder rows in 512K-row time-sorted
   segments, resident on the card) and TPC-H lineitem (SF1), the 13 SSB
   queries, TPC-H Q1, a Timeseries and a TopN through
   `Engine(device="cuda").execute`, each checked against a float64 pandas
   oracle (group keys and counts exact, sums within rtol 2e-5) and run
   twice for bit-identical frames; p50 of the warm runs, rows scanned per
   second, strategy and the kernel launches each query made;
5. profile: one more warm run of each query under torch.profiler, its
   device time by kernel and the device's idle share of the p50;
6. sql: each workload's data registered into its own `TPUOlapContext`
   (whose engine ran that workload in phases 4 and 5, so the columns are
   already resident) with its star schema and its normalized dimension
   tables; the 13 SSB queries and every TPC-H query sent as joined SQL
   through `ctx.sql`.  Each query's planned Druid JSON must equal its
   native spec where one exists; its frame must be bit-identical to the
   native path's frame for the planned spec (same columns), hold against
   the float64 oracle, and be bit-identical over two runs; the kernel must
   launch for every query with G <= 4096.  Reported per query: plan ms
   cold (parse + plan of the text, no plan cache) and cached (the
   plan-cache hit); warm `ctx.sql` and native runs of the same spec
   interleaved in pairs, the side that goes first alternating, with the
   p50 of each side and the median of the per-pair differences; the
   launches of the `ctx.sql` runs;
7. sketches: first the sketch ops on the card against the same functions
   on the CPU, bit for bit: HLL (p = 11 and p = 4), theta (K = 4096) and
   quantile (K = 1024) partials and their merges over the first 4 in-scope
   SSB segments, at the group ids of the queries below, and `_rho` over
   ±8192 around every power of two below 2^28 against the reference's
   values (the exact floor(log2) with the committed exception table).
   Then `ssb.SKETCH_QUERIES` through `ctx.sql` (TopN + HLL, the same
   TopN over a filter that masks half of each segment's rows, CUBE + HLL,
   CUBE + theta, APPROX_QUANTILE), 1 cold and 1 warm run each: frames
   bit-identical from run to run and held against the exact oracle
   (`ssb.check_sketch_answer`: sums within rtol 2e-5, distinct counts
   within 4 standard errors, quantiles within 4 standard errors in rank
   (±6.25% at the median, ±3.75% at p90, K = 1024; the largest rank error
   of each fraction is reported), every CUBE grouping id with its nulls),
   and the kernel launched once per in-scope segment per run for every
   grouping set.  Reported per query: p50, device busy ms and idle share
   (one more run under torch.profiler), and the sketch ops' own device ms
   (a replay of just the sketch partials and merges over the query's
   segments under torch.profiler);
8. tiers: the high-cardinality tier at the data of phase 4, resident.
   First its ops on the card against the same functions on the CPU over the
   first 4 in-scope segments of SSB q3.2 and of the exact-distinct inner
   grouping (by c_city and lo_custkey): `compact_rows`,
   `sparse_partial_aggregate` at 4096 slots (the kernel inner) and at 2^18
   (the segmented reduce), their fold by `merge_sparse_states`, the
   presence counts and the compacted codes: gids, counts, mins, maxs,
   flags, `n_rows` and `n_real` equal, sums within rtol 1e-5, two launches
   bit-equal; and the host syncs of one sparse pass and one compacted pass.
   Then the 11 high-cardinality SQL queries (SSB q2.x, q3.x, q4.2, q4.3;
   TPC-H q3, q10) under "auto", "sparse" and "segment": under "auto" the
   plan's class answers (the next path only after a recorded decline), the kernel launches for every pass at most 4096 wide, frames
   hold against the oracle, are bit-identical over two runs and agree
   across tiers (keys exact, sums within 2e-5); per query and tier the
   tier taken, G', the rungs, launches, the time of 1 warm run, and (under
   "auto") device busy ms and idle share from one profiled run.  Last, exact
   COUNT(DISTINCT lo_custkey) (BASELINE config #3's TopN with the sketch
   replaced, and a global count) under count_distinct_mode = 'exact' over
   `ssb.key_dimension_datasource`: equal to the exact oracle, answered on a
   segmented-reduce rung.
9. arena: one dispatch per query.  The engines' captured programs are
   dropped; then every query of phases 4 and 6 (the tier's high-G SQL
   queries among them) and three CUBEs (cube_hll and cube_theta of phase
   7, and a CUBE of revenue alone, whose sets are all captured) run with
   the arena on (SET arena_execution = true): a first run (eager), a
   second (the capture) and a third (a replay), bit-identical and held
   against the oracle; then a warm run each way, on and off interleaved,
   every frame bit-identical to the replay's; then one profiled run with
   the arena on (each way until phase 18 came).  The run fails where a pass neither replayed (one dispatch over
   every in-scope segment) nor recorded an "arena:" decline, or where the
   kernel did not launch once per in-scope segment of a replayed run
   (replays counted).  Reported per query: dispatches of the first run,
   on and off; captures and capture ms; launches on and off; p50 each way
   and their ratio; device busy ms and idle share with the arena on; the
   declines.
   Each CUBE also runs its sets through `Engine.execute_groupby_batch`
   against one after another, interleaved, bit-identical set by set: p50
   each way.  Last, one cold SSB scope (q4.1, `Engine.drop_residency`
   before each run) with the transfer pipeline on (copies from pinned
   host copies) and off (pageable copies): the first pipelined run (which
   pins the columns), then 1 run each way (2 until phase 18): wall, h2d ms and
   bytes, and from one profiled run each way the HtoD copy ms, kernel ms,
   the share of copy time that overlaps a kernel and the idle share;
10. fallback: the twelve extended TPC-H classes (`tpch.EXTENDED_QUERIES`:
   q2, q4, q9, q11, q13, q15, q16, q17, q18, q20, q21, q22) through
   `ctx.sql` on phase 6's TPC-H context (lineitem SF1 resident, orders
   1.5M rows, customer, supplier, part), with `rawline` (the normalized
   lineitem, 6M rows) and `partsupp` registered: the planner rewrites
   none but q9, so they run on the host fallback with their GROUP BY
   subtrees offered to the device assist.  Every frame against its
   float64 oracle (keys and counts exact, sums within rtol 2e-5),
   bit-identical over two runs, and equal to the same query with the
   assist off (`device_assist_min_rows` above every table's rows);
   executor "device" for q9, "fallback" or "device+fallback" for the
   rest; the kernel launched in at least one assisted query.  Reported per
   query: executor, assists and declines, the G and tier of each engine
   run, launches, the warm run's ms with the assist on and off, the
   decode ms of a cold and a warm run, and device busy ms and idle share
   from one profiled run.  No scale is cut.
11. native: the Druid-native surface on the contexts of phases 4 to 10
   (SSB SF10 and TPC-H SF1, resident).  The wire form of every main-path
   query and of phase 7's topn_hll (`json.dumps(q.to_druid())` through
   `models/wire.query_from_druid`, the engine and `druid_result_shape`):
   the decoded spec prints the original's JSON and the frame is
   bit-identical to phase 4's native frame.  Phase 9's cube_revenue CUBE as
   a wire subtotalsSpec, equal to `execute_grouping_sets` on the same sets.
   A GroupBy with having, limitSpec and an expression post-aggregator
   against its float64 oracle.  Three scans over lineorder's own columns
   under q1.1's fact predicate (an unordered LIMIT 1000 drill-through, an
   ORDER BY lo_extendedprice DESC LIMIT 100 over every segment, a wire
   compactedList Scan over one month): rows and their order equal to a
   stable pandas sort of the host frame filtered in segment order.  Two
   Searches for "united" over c_city and s_city (one under the fact
   predicate): counts equal to a bincount of the frame's codes.  The three
   metadata queries of both datasources, against the segments' metadata
   and launching nothing.  GROUP BY LOOKUP(c_nation, 'n2r') over the joined
   customer (the map from the customer table) against GROUP BY c_region:
   keys and counts exact, sums within rtol 1e-6, bit-equality reported.
   q1.1 and q2.1 as TableQuery chains, bit-identical to `ctx.sql`.  And
   `execute_native_degraded` on TPC-H Q1's wire spec and an ordered Scan at
   SF1, against the device frames (rows exact, sums within rtol 2e-5).
   Reported per query: p50 of 2 warm runs, and for scans and searches the
   segments, rows per second scanned and bytes copied to the host;
12. resilience: deadlines, partial answers, retries and the breaker on the
   resident contexts of phases 4 to 11 (SSB SF10, TPC-H SF1).  (a) A
   clock-free deadline sweep: SSB q4.1 (the kernel) and q3.1 (the adaptive
   tier) through `ctx.sql` with `InjectedDeadline` at the K-th checkpoint
   of `engine.segment_loop` (K = 0, 1, half the scope, scope - 1), the
   arena on (chunked replays, one graph per segment) and off (the loop):
   rows seen and coverage exactly the first K in-scope segments' rows over
   the scope's, frames bit-identical on and off and equal to the float64
   oracle over those segments' rows (rtol 2e-5), partial.  (b) Wall-clock
   deadlines at about half each query's warm p50 (the ordered top-100
   Scan, cube_theta, TPC-H q18 on the fallback, the last two at the p50s
   phases 7 and 10 measured; the stream in phase 13):
   wall, overshoot past the timeout and coverage reported, the run failing
   only where the overshoot passes the p50 (no checkpoint reached).  (c)
   Every query of phase 9 with no deadline and one armed that never
   expires (60 s), one pair after a first armed run: frames
   bit-identical, p50 each way and their ratio.  (d) Retries: q4.1 with its
   graph warm and `device_dispatch` armed once, an injected fault and a CUDA
   out-of-memory error: one retry, not degraded, the clean frame's bits,
   the graph and columns evicted (the retry runs the loop over fresh
   copies); the retry's wall.  (e) The breaker: TPC-H Q1 with
   `device_dispatch` armed on every call degrades to the host fallback
   (frame against the oracle), the breaker opens on the second query, the
   third routes straight to the host (a 60 s cooldown meanwhile: one
   degraded Q1 outlasts the default 2 s); disarmed, the cooldown cut to
   500 ms and waited out, a half-open probe on the card closes it with the
   clean frame's bits; at SSB SF10 the degraded route raises FallbackSizeError; degraded
   p50 against the card's.  (f) A failed capture (the `compile` site armed
   with the port's KernelError) raises: no retry, not degraded, the breaker
   untouched.  (g) `sql_progressive` on q4.1: one refinement per in-scope
   segment, the last bit-identical to `ctx.sql`; the time to the first.
   Every query of phases 4 to 11 is held clean (`MetricsWatch`: no
   retry, not degraded, not partial, no expired deadline; the two answers
   phase 11 asks `execute_native_degraded` for are degraded and nothing
   else), and every stream of phase 13 outside its cut runs folds every
   chunk, not truncated (`check_stream_whole`);
13. stream: BASELINE config #4, the hourly rollup over the event stream, as
   `bench.py` sends it: a Timeseries at hour granularity (Count, DoubleSum
   of value, DoubleMax of latency) through `StreamExecutor.execute` over
   2^21-row chunks of `gen_event_chunk`, generated on 8 threads, staged in
   host memory and page-warmed before any timing (512 chunks,
   1B rows, unless `--stream-chunks` cuts them).  One warm-up on one chunk,
   then the timed stream.  Checked against a float64 numpy oracle over the
   same staged chunks (hour index from ts): counts exact (a bucket holds
   about 6M rows, below 2^24, so float32 counts are exact), sums within
   rtol 2e-5, max exact; the frame bit-identical over two runs and with
   double buffering off; one kernel launch per chunk, at G 169.  Reported:
   rows, chunks, wall s and rows/s, `StreamStats`, h2d GB/s, the wall with
   double buffering on against off over the first chunks (on, off, off,
   on), and over 32 chunks (on and off), from CUDA timing events around
   each chunk's copies and compute and from a torch.profiler run: HtoD
   memcpy ms, kernel ms, the share of copy time that overlaps a kernel,
   and the device's busy and idle share.  A profiler window that dropped
   its copies or kernels is taken again, up to 3 windows; after that the
   events' numbers stand in (`timer`).  Then phase 12's stream checks: an
   injected deadline at the middle chunk (`streaming.chunk_loop`,
   skip = chunks / 2): half the rows folded, the frame against the oracle
   over the first half, the producer joined and the staging ring's pinned
   bytes freed; and a wall-clock deadline of half the stream's wall.

14. serving (run after phase 12, on its resident SSB SF10 and TPC-H SF1
   contexts, before phase 13 frees them): an `OlapServer(ctx, port=0)` per
   context on the card.  (a) Single requests: phase 11's wire bodies (the
   16 main-path specs, topn_hll, cube_revenue's subtotalsSpec, the ordered
   top-100 Scan) and their SQL, each response's bytes equal to the
   in-process answer's envelope, `X-Druid-Query-Id` echoing
   `context.queryId`, every trace served, `/status/metrics` parsing and
   counting the requests.  (b) A dashboard mix: 8 client threads, 24
   requests each, a seeded shuffle of the 13 SSB queries (native JSON or
   SQL by a coin), the Timeseries and the TopN, beside a thread sending
   the heavy-lane top-100 Scan, with fusion off and then on
   (`fusion_window_ms` 2, `fusion_max_batch` 16), the result cache off:
   every answer's bytes equal the serial answer's; queries per second, p50
   and p99 per lane, the fused batches.  Then a repeat pass with the cache
   on: every repeat a hit, no launch.  (c) A fused batch of q1.1-q1.3,
   q4.1, the Timeseries and the TopN: warm, one replay, one host sync, its
   launches the sum of its members' segments, bit-identical to serial.
   (c2), run before (c): a dashboard of 8 panels (those six as native
   JSON, q1.1 and q4.1 as SQL) refreshed 12 times, its 8 client threads
   released together, fusion off and then on (a 50 ms window): every
   answer's bytes equal the serial answer's, and with fusion on the
   panels' recurring set fuses (its first batch on the fused eager loop,
   its second capturing) and replays its fused graph through the fusion
   scheduler, or the run fails; the refresh wall's p50 and p99 each way.
   (d) Admission, clock-free: a held slot under `max_concurrent_queries`
   1 gives 503 with Retry-After; a saturated heavy lane admits an
   interactive TopN and refuses the Scan.  (e) Observability: receipts at
   `prof_sample_rate` 1 carry CUDA-event `device_ms`, beside the
   profiler's device time of the same query; unsampled serving adds no
   sync (`obs.prof.SYNCS`, and a traced query's sync sites equal an
   untraced one's); the p50 with a trace open and without.

15. ingest and storage (run after phase 16, on its resident SSB SF10
   context, before phase 13 frees it).  (a) 16 batches of 4096 flat-fact
   rows (values from the existing dictionaries, `ssb.fact_rows`) and one
   full 65536-row delta appended to lineorder; after each, q1.1, q4.1
   (the kernel), q2.1 (the adaptive tier) and the TopN run natively, as
   SQL and natively again (on the new segment set: the eager loop, the
   capture, a replay), every frame held against the float64 oracle over
   the base rows and every appended row; the append ack p50/p95, the
   append-to-visible p50, captures and replays per version, launches per
   run, and the arena's churn.  (b) One row with a c_city no dictionary
   holds: every segment remaps; the remap ms, the re-upload bytes and ms,
   the first and warm q4.1; no device column, pinned copy or graph of a
   retired uid is left.  (c) Compaction into 2^19-row segments: its ms,
   the answers against the oracle, the retired uids gone, the warm q4.1
   against phase 4's.  (d) q4.1 cached (the result cache on), then three
   appends of 5000 rows: each refresh launches the kernel over the new
   delta alone, against the oracle; beside it the full first run, and a
   cached HLL and theta query refreshed alike, equal to its full run.  (e)
   The server's ingest route: an append visible to the next served query,
   503 with Retry-After on a held ingest slot.  (f) A fresh SSB SF1
   context (`ssb.register_streamed`) with `storage_dir` in a temporary
   directory: append, flush, append (a WAL tail), a new context on the
   directory (snapshot mmap and WAL replay) serving bit-identical frames;
   the recover ms, the first cold query from disk-backed columns, the warm
   p50; `save_table`, `load_table` and the SQL load of the saved
   directory.  (g) `__sys`: sampler ticks around four queries, then
   `SELECT sum(delta) FROM __sys` on the card.  Phase 3 checks the delta
   segments' padded row counts (1024, 4096, 5120, 65536) at the headline
   (G, Ms, Mn, Mx).

16. cost model (run after phase 14, on its resident SSB SF10 and TPC-H SF1
   contexts, the result cache and fusion off, before phase 15's appends
   change the data under the oracles and phase 13 frees the contexts).  Phases 4 to 15 already run
   their contexts under `SessionConfig.load_calibrated()` (the committed
   `calibration.torch_cuda.json` when it names this card; the loaded file
   and its constants are printed first, beside the card's name and power
   limit), so every SQL query runs its plan's class.  (a) `plan/calibrate`
   on the card into a temporary file, loaded back: every constant
   measured, finite and positive, the file naming this card.  (b) The 13
   SSB queries, the Timeseries and the TopN, and TPC-H Q1, q3 and q10:
   the plan's pick (and the pick under (a)'s fresh calibration), the
   modelled µs of every class the model prices, and each such class's
   warm p50 with the engine pinned to it (phase 8's forced runs reused;
   a class whose first run is 10x the fastest's is timed once); the
   planned run takes its plan's route or records a decline and holds the
   oracle, as does every pinned class but where its sums miss the oracle's
   tolerance, which is reported.  Whether each pick is within 1.25x of the
   fastest class is reported, not failed.  (c) Phase 10's twelve classes:
   the calibrated assist's decisions (assisted, or declined with the
   modelled figures), and where the model declined, the query again
   under the rules alone (no cost gate) for its ms, against the oracle.  (d)
   The stream's class at (2^21, 169) under (a)'s calibration: the model's
   class runs two chunks against the oracle.  Phase 3 checks and times
   the calibration's launches (G 256 and 4096 at 2^19 and 2^17 rows, two
   sums; the sparse tier's 4096 slots at 2^23 and 2^21 rows).

17. mesh (run after phase 16, before phase 15's appends, on phases 4-5's
   resident SSB SF10 and TPC-H SF1): multi-device execution
   (`parallel/distributed.DistributedEngine`) on logical meshes of the card
   (4 x cuda:0 as (4, 1); as (2, 2), the group domain sharded; as a 2 x 2
   slice mesh under the flat and the hierarchical merge tree) and, where
   the machine has two or more cards, (n, 1) over them with the NCCL merge;
   each mesh and its device list printed.  (a) Phase 16's queries under
   each mesh's plan, on (4, 1) also pinned to every class the model
   prices: the oracle, the single-device port's frame under the same
   class, the route, the kernel launched where the path runs it; the warm
   p50 of each mesh's plan beside the single device's (`mesh_p50`, with
   the card's name and power limit).  (b) topn_hll, cube_theta and the
   quantiles through a context whose plans take the (4, 1) mesh: HLL and
   theta columns equal the single device's, quantiles within the rank
   bound; q4.1 as SQL with `last_metrics.distributed` and `mesh_shape`.
   (c) BASELINE config #4's stream on (4, 1), 32 chunks of 2^21 rows,
   against its oracle.  (d) A deadline before the arena's third step on
   (4, 1) (coverage, the oracle over the folded blocks); a retry after a
   fault at `mesh.dispatch`; the mesh breaker open while a single-device
   query routes to "device"; a fused batch eager, captured and replayed.
   Phase 3 checks and times the mesh's new shapes: half of every even G
   (the (2, 2) mesh's per-device domains) and the stream's 2^19-row shard.
18. processes (after phase 17, before phase 15's appends): the
   multi-process tiers.  (a) Phase 4's SSB SF10 lineorder (and the SQL
   dimension tables) written once to a temporary `storage_dir` by a broker
   context that shares the SSB context's resident engine.  (b) Two ranks
   of `python3 chip_smoke.py --rank-worker ...` on the card over gloo on
   127.0.0.1 (`parallel/multihost.py`), each booting the store and placing
   only its own rows (the arena's blocks of its row device: its
   `local_segments`), run q1.1, q2.1 (adaptive), q3.1, q4.1, the
   Timeseries, the TopN, topn_hll and the quantiles: both ranks' frames
   bit-equal, and bit-equal to this process's 2-slice x 1 slice mesh of
   the card; each rank's residency half the slice mesh's; every answer
   against the oracle.  Where the machine has two or more cards, one rank
   per card over NCCL as well.  (c) Two historicals, `python -m
   spark_druid_olap_tpu_torch.cluster.historical` on the card, booted from
   the store, each under an explicit residency cap, and the broker
   (replication 2) behind an `OlapServer`: the 13 SSB queries, the
   Timeseries and the TopN as native JSON and as SQL through the broker's
   server, twice each (the same response bytes), held against the oracle
   and the single context's frames (keys and counts exact, sums within
   rtol 2e-5); those the broker covers scatter (the rest answer on the
   broker, as in the JAX package).  h0 is SIGKILLed mid-sequence and a
   covered query answers from its replica with the bytes it had before;
   `/status/metrics?cluster=1` stamps h0 stale; with both killed a covered
   query answers 200 as a coverage-stamped partial (coverage 0).  No RPC
   failed but those to killed nodes.  (d) Every child reports its kernel
   launches by shape (a rank in its result, a historical on `GET
   /status/kernels` before it is killed), each checked against phase 3's
   shapes and rows; the kernels line counts them as `launches_multihost`
   and `launches_cluster`.
19. csv (last, after the stream frees its host memory): CSV ingest through
   the port's native decoder (`native/`, built with g++ on first use).  A
   worker process (`--csv-worker`, started after phase 3, beside phases 4
   onwards: host work only) writes SSB SF1 (6M lineorder rows) under a
   temporary directory as CSV (the flat lineorder as 8 sharded files and
   as one file, and the four dimension tables) and makes the reference:
   the one file through `pd.read_csv` (timed alone) and the sharded build,
   saved with `catalog.persist.save_datasource`.  Phase 19 loads that
   reference, then lineorder through the native decoder: the one file
   through `register_table` (the native decode and encode), the shards
   through `ingest/shard.build_datasource_from_csv` (the files decoded in
   parallel, their dictionaries merged); the dimension tables through
   `register_table`, every native load checked to have read natively,
   with no decline.  The native loads' segments equal the pandas
   load's (dictionaries, codes, metrics, zone maps), and the 13 SSB queries
   as SQL on the card over each load, every context pinned to the adaptive
   class (so every pass at most 4096 wide is the kernel's, the tier's
   presence passes included), launch the kernel for every query and
   answer as the pandas load does: keys exact, sums within rtol 1e-6.
   Reported beside the card's name and power limit: rows per second of
   `pd.read_csv` and of the native decode over the one file, back to back
   in the worker right after it wrote the file (both from the page cache),
   and of the native decode inside phase 19's `register_table`; the
   write, build and register seconds; per query the ms and launches of
   each load.
   Every launch is at a (G, Ms, Mn, Mx) phase 3 checked.

Every kernel launch of phases 4 to 19, children included, CUDA graph replays included
(`cuda_groupby.LAUNCH_SHAPES`), is at a (G, Ms, Mn, Mx) that phase 3
checked, or the run fails.  The arena is on (the default) in every phase
but where phase 9 turns it off.

Phases 4 and 6 also check the route of every query (a native query above
4096 groups takes the adaptive or sparse tier; a SQL query its plan's
class, or the next path after a recorded decline; phase 6's native run of
the planned spec takes the same class), and that the kernel launched for
every query whose pass (G, G' or the slots) is at most 4096 wide.

Then the `kernels` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  Any failed check raises: the script
exits non-zero and prints no result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from spark_druid_olap_tpu_torch import resilience
from spark_druid_olap_tpu_torch.catalog.persist import is_disk_backed
from spark_druid_olap_tpu_torch.config import (
    CALIBRATED_FLOATS,
    CALIBRATED_INTS,
    SessionConfig,
)
from spark_druid_olap_tpu_torch.api import (
    TPUOlapContext,
    execute_grouping_sets,
    grouping_set_queries,
)
from spark_druid_olap_tpu_torch.exec.arena import arena_disabled
from spark_druid_olap_tpu_torch.exec.engine import (
    Engine,
    merge_sketch_states,
    segments_in_scope,
    sketch_partials,
)
from spark_druid_olap_tpu_torch.exec.metrics import QueryMetrics
from spark_druid_olap_tpu_torch.exec.lowering import (
    groupby_with_time_granularity,
    lower_groupby,
    timeseries_to_groupby,
    topn_to_groupby,
)
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models import query as Q
from spark_druid_olap_tpu_torch.models import wire
from spark_druid_olap_tpu_torch.exec.streaming import StreamExecutor
from spark_druid_olap_tpu_torch.ops import cuda_groupby, hll
from spark_druid_olap_tpu_torch.parallel import spmd_arena
from spark_druid_olap_tpu_torch.parallel.distributed import DistributedEngine
from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh, make_slice_mesh
from spark_druid_olap_tpu_torch.plan import calibrate
from spark_druid_olap_tpu_torch.plan.cost import (
    _kernel_costs,
    choose_kernel_strategy,
    choose_physical,
    query_kernel_costs,
)
from spark_druid_olap_tpu_torch.plan.expr import col
from spark_druid_olap_tpu_torch.utils import datagen
from spark_druid_olap_tpu_torch.workloads import ssb, tpch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_OPS_PER_S = 67e12  # H100 SXM published float32 rate outside tensor cores
KERNEL_RTOL = 1e-5
ORACLE_RTOL = 2e-5

# the reference kernel's test shapes (R, G, Ms, Mn, Mx)
TEST_SHAPES = [(4096, 12, 3, 0, 0), (8192, 300, 4, 2, 1), (8192, 700, 2, 1, 1), (1024, 1, 1, 0, 0)]
# one 512K-row segment at the shapes the main path launches
MAIN_SHAPES = [
    (524288, 1, 2, 0, 0),  # q1.1-q1.3: revenue and count, one group
    (524288, 12, 8, 0, 0),  # TPC-H Q1
    (524288, 26, 2, 0, 0),  # TopN by c_nation
    (524288, 84, 2, 0, 0),  # Timeseries by month
    (524288, 208, 2, 0, 0),  # q4.1
    (524288, 208, 4, 1, 1),  # the headline row of PR 1, min/max included
    (524288, 4096, 4, 1, 1),  # min/max at the scatter cutover
    # phase 7: revenue and count at each sketch query's and CUBE set's G
    (524288, 6, 2, 0, 0),  # CUBE sets (c_region), (s_region)
    (524288, 8, 2, 0, 0),  # CUBE set (d_year); the quantile query
    (524288, 36, 2, 0, 0),  # CUBE set (c_region, s_region)
    (524288, 48, 2, 0, 0),  # CUBE sets (c_region, d_year), (s_region, d_year)
    (524288, 251, 2, 0, 0),  # topn_hll, filtered_hll (c_city)
    (524288, 288, 2, 0, 0),  # CUBE set (c_region, s_region, d_year)
    # phase 6, TPC-H SQL: q6, q14, q19 (one group, three sums), q8 and
    # q8_extract (years), q7 (nation pairs x years)
    (524288, 1, 3, 0, 0),
    (524288, 8, 3, 0, 0),
    (524288, 1352, 2, 0, 0),
]
# phase 8 and the high-cardinality queries of phases 4 and 6: the adaptive
# tier's presence counts (one count column at a dimension's cardinality,
# null slot included: d_year, nations, cities, brands) and its compacted
# passes at each query's G' (SSB SF10)
MAIN_SHAPES += [(524288, G, 1, 0, 0) for G in (8, 26, 251, 1001)]
MAIN_SHAPES += [(524288, G, 2, 0, 0) for G in (4, 7, 24, 100, 150, 273, 280, 600, 800)]
# phase 10, the fallback's assisted subtrees at TPC-H SF1: Q2's min by
# (s_region, p_type) under its window (Q15's and Q16's groupings by
# s_nation and p_brand, and the sparse tier's first rung under Q4's EXISTS,
# are shapes above)
MAIN_SHAPES.append((524288, 36, 1, 1, 0))
# phase 13: one 2^21-row chunk of the event stream, hourly buckets over the
# week (169 with the bucket at the interval's end), rows and value summed,
# latency maxed
STREAM_SHAPE = (1 << 21, 169, 2, 0, 1)
MAIN_SHAPES.append(STREAM_SHAPE)
# phase 16's calibration (`plan/calibrate.py`): the dense class at G 256 and
# 4096 over a segment's rows and a quarter of them, two sums (its rows
# random; the sparse tier's pass over 4096 slots at both row counts is below)
MAIN_SHAPES += [(R, G, 2, 0, 0) for G in (256, 4096) for R in (524288, 131072)]
HEADLINE = (524288, 208, 4, 1, 1)
# the padded row counts of phase 15's delta segments, at the headline's
# (G, Ms, Mn, Mx): a one-row delta, a 4096-row batch, 5000 rows (5120: no
# whole number of the kernel's 2048- or 4096-row chunks), a full delta
DELTA_ROWS = (1024, 4096, 5120, 65536)
# Timeseries over a time-sorted segment: one or two months per segment
SKEWED = (524288, 84, 2, 0, 0)
# the sparse tier's pass over 4096 slots, on rows sorted by slot, at each
# query's column counts: SSB and TPC-H q3 (revenue, rows), TPC-H q10 (two
# hidden max carriers), the exact-distinct inner groupings (rows alone; rows
# and revenue, with c_city's hidden max carrier); and the calibration's, at
# its eager classes' 2^23 and 2^21 rows
SORTED_SHAPES = [(524288, 4096, 2, 0, 0), (524288, 4096, 1, 0, 0), (524288, 4096, 2, 0, 2),
                 (524288, 4096, 2, 0, 1), (8388608, 4096, 2, 0, 0), (2097152, 4096, 2, 0, 0)]
# the plain version is timed 3 times after two warm-ups; once, warm from the
# shape's check, where its one-hot product has more than 2^31 cells (seconds
# a call)
PLAIN_REPS_CELLS = 1 << 31
ROTATE_BYTES = 200e6  # inputs cycled per timing: four times the 50 MB L2
WARM_RUNS = 3  # warm runs of a query: few enough to keep the run in its time limit
SQL_PAIRS = 4  # interleaved SQL/native pairs per query in phase 6 (even)
SKETCH_COLD, SKETCH_WARM = 1, 1  # runs of each sketch query in phase 7 (3 warm until phase 18)
OP_CHECK_SEGMENTS = 4
STREAM_CHUNKS = 512  # 1B rows of 2^21: BASELINE config #4
STREAM_AB_CHUNKS = 64  # double buffering on against off
STREAM_PROFILE_CHUNKS = 32
PROFILE_TRIES = 3  # profiler windows taken where one dropped its device events
STREAM_WORKERS = 8  # chunk generator threads
HOUR_MS = 3_600_000
# the sketch ops checked at each query's group ids
OP_CHECKS = {
    "topn_hll": (A.HyperUnique("hll11", "lo_custkey", precision=11),
                 A.HyperUnique("hll4", "lo_custkey", precision=4)),
    "cube_theta": (A.ThetaSketch("theta", "lo_custkey", size=4096),),
    "quantiles": (A.QuantilesSketch("quantiles", "lo_revenue", size=1024),),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# -- phase 3: the kernel against its plain version ---------------------------


def make_inputs(R, G, Ms, Mn, Mx, device, seed=0, mask_p=0.8, layout="random"):
    """Kernel inputs; `layout` "two_runs": the segment spans two adjacent
    groups (a time-sorted Timeseries segment); "sorted": rows sorted by
    group id, as the sparse tier hands them over."""
    rng = np.random.default_rng(seed)
    mask = rng.random(R) < mask_p
    gid = rng.integers(0, G, R).astype(np.int32)
    if layout == "two_runs":
        gid = np.where(np.arange(R) < R * 3 // 5, G // 2, G // 2 + 1).astype(np.int32)
    elif layout == "sorted":
        gid = np.sort(gid)
    arrs = (
        gid,
        mask,
        (rng.random((R, Ms)) * 1000 * mask[:, None]).astype(np.float32),
        rng.random((R, Mn + Mx)).astype(np.float32),
        rng.random((R, Mn + Mx)) < 0.9,
    )
    return [torch.from_numpy(a).to(device) for a in arrs]


def cuda_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warm` warm-ups: the
    host's time to issue the call and the card's to run it."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int, expect: int = 0, tries: int = PROFILE_TRIES):
    """Device time per call of fn(i), i < n, from the device-side events
    (kernels, copies, fills) that torch.profiler records.  Without
    `expect`, their sum divided by n.  With `expect`, fn(i) launches
    expect // n kernels of distinct names, each once, and the time per call
    is the sum over names of each name's mean event time: a trace can drop
    the first events of a window, and the mean still reads the true time
    while every name kept at least half of its n events.  A window that
    recorded no device time, or with `expect` dropped any event, is taken
    again, up to `tries` windows; then the fullest window that served is
    read, and where none served, CUDA events around the n back-to-back
    calls.  Returns (ms, timer, ms by kernel name, events by kernel name)."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    fn(1 % n)
    torch.cuda.synchronize()
    best = None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        counts = {e.key: e.count for e in dev}
        totals = {e.key: e.self_device_time_total / 1e3 for e in dev}
        if not expect and sum(totals.values()) > 0:
            by_name = {k: v / n for k, v in totals.items()}
            return sum(by_name.values()), "profiler", by_name, counts
        if expect and len(counts) == expect // n and all(n <= 2 * c <= 2 * n
                                                         for c in counts.values()):
            by_name = {k: totals[k] / counts[k] for k in totals}
            if sum(counts.values()) == expect:
                return sum(by_name.values()), "profiler", by_name, counts
            if best is None or sum(counts.values()) > sum(best[1].values()):
                best = (by_name, counts)
    if best is not None:
        return sum(best[0].values()), "profiler", *best
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, "events", {}, {}


def bound(R, G, Ms, Mn, Mx):
    """Least time the card could take: each input byte read once, each
    output written once, at the HBM rate; against one add or compare per
    row and column at the float32 rate.  Returns (ms, bound_by)."""
    nbytes = R * (4 + 1 + 4 * Ms + 5 * (Mn + Mx)) + 4 * G * (Ms + Mn + Mx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = R * (Ms + Mn + Mx) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel_shape(R, G, Ms, Mn, Mx, device, seed, mask_p=0.8, layout="random"):
    args = make_inputs(R, G, Ms, Mn, Mx, device, seed, mask_p, layout)
    if mask_p == 0.0:
        args[2].zero_()
    got = cuda_groupby.cuda_partial_aggregate(*args, num_groups=G, num_min=Mn, num_max=Mx)
    again = cuda_groupby.cuda_partial_aggregate(*args, num_groups=G, num_min=Mn, num_max=Mx)
    want = cuda_groupby.plain_partial_aggregate(*args, G, Mn, Mx)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel not bit-stable at {(R, G, Ms, Mn, Mx)}")
    for name, a, b in zip(("mins", "maxs"), got[1:], want[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel {name} differ from plain at {(R, G, Ms, Mn, Mx)}")
    err = (got[0].double() - want[0].double()).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = err / want[0].double().abs().clamp_min(1e-30)
    max_rel = float(rel.max()) if rel.numel() else 0.0
    if not bool((err <= KERNEL_RTOL * want[0].double().abs()).all()):
        raise AssertionError(f"kernel sums off by {max_rel} (rtol {KERNEL_RTOL}) at {(R, G, Ms, Mn, Mx)}")
    if mask_p == 0.0 and not (
        float(got[0].abs().sum()) == 0.0
        and bool(torch.isposinf(got[1]).all()) and bool(torch.isneginf(got[2]).all())
    ):
        raise AssertionError("all-masked input must give 0 / +inf / -inf")
    return args, max_abs, max_rel


def time_kernel(args, R, G, Ms, Mn, Mx, device, diagnose=False):
    """Times of the kernel, its plain version and the library call at one
    shape, beside the bound; with `diagnose`, also on L2-resident inputs and
    with every row masked."""
    set_bytes = sum(t.numel() * t.element_size() for t in args)
    n = max(20, -(-int(ROTATE_BYTES) // set_bytes))
    sets = [args] + [[t.clone() for t in args] for _ in range(n - 1)]
    kw = dict(num_groups=G, num_min=Mn, num_max=Mx)
    launch = 2 * n  # a partial pass and a fold pass per call
    ms, timer, by_name, events = device_ms(
        lambda i: cuda_groupby.cuda_partial_aggregate(*sets[i], **kw), n, launch)
    l2_ms = floor_ms = None
    l2_events = floor_events = {}
    if diagnose:
        # the same launch on L2-resident inputs, and with every row masked
        # (staging, set-up and the combines only): what is left when HBM
        # and the per-row work are taken away
        l2_ms, _, _, l2_events = device_ms(
            lambda i: cuda_groupby.cuda_partial_aggregate(*args, **kw), n, launch)
        masked = [[g, torch.zeros_like(m), sv, mmv, mmm] for g, m, sv, mmv, mmm in sets]
        floor_ms, _, _, floor_events = device_ms(
            lambda i: cuda_groupby.cuda_partial_aggregate(*masked[i], **kw), n, launch)
        del masked
    lib_in = [
        (torch.where(m, g.long(), torch.full_like(g.long(), G)), sv)
        for g, m, sv, _, _ in sets
    ]
    del sets

    def library(i):
        seg, sv = lib_in[i]
        return torch.zeros(G + 1, Ms, device=device).index_add_(0, seg, sv)

    library_ms, _, _, _ = device_ms(library, n)
    del lib_in
    b_ms, b_by = bound(R, G, Ms, Mn, Mx)
    return {
        "ms": ms,
        "timer": timer,
        "pass_ms": {
            next((w for w in ("partial_pass", "fold_pass") if w in k), k[:40]): v
            for k, v in by_name.items()
        },
        "l2_ms": l2_ms,
        "floor_ms": floor_ms,
        # device events per window: 2n (partial_pass, fold_pass) when clean
        "events": [sum(e.values()) for e in (events, l2_events, floor_events)],
        "rotated_sets": n,
        "call_ms": cuda_ms(lambda: cuda_groupby.cuda_partial_aggregate(*args, **kw)),
        # above PLAIN_REPS_CELLS one run, warm from the shape's check
        "plain_ms": cuda_ms(lambda: cuda_groupby.plain_partial_aggregate(*args, G, Mn, Mx),
                            *((3, 2) if R * G <= PLAIN_REPS_CELLS else (1, 0))),
        "library_ms": library_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
        "below_library": ms < library_ms,
    }


# the shapes phase 3 also times on L2-resident and all-masked inputs (every
# main shape until phase 19 came)
DIAGNOSED = {(HEADLINE, "random"), (SORTED_SHAPES[0], "sorted")}


def kernel_phase(device):
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's product in full f32
    rows = []
    for i, shape in enumerate(TEST_SHAPES):
        _, max_abs, max_rel = check_kernel_shape(*shape, device, seed=i)
        rows.append({"shape": shape, "max_abs_err": max_abs, "max_rel_err": max_rel})
    check_kernel_shape(2048, 10, 2, 1, 1, device, seed=9, mask_p=0.0)
    rows.append({"shape": (2048, 10, 2, 1, 1), "all_masked": True})
    timed = []
    cases = ([(shape, "random") for shape in MAIN_SHAPES] + [(SKEWED, "two_runs")]
             + [(shape, "sorted") for shape in SORTED_SHAPES])
    for i, ((R, G, Ms, Mn, Mx), layout) in enumerate(cases):
        args, max_abs, max_rel = check_kernel_shape(
            R, G, Ms, Mn, Mx, device, seed=100 + i, layout=layout)
        timed.append({
            "shape": (R, G, Ms, Mn, Mx),
            "layout": layout,
            "geometry": cuda_groupby.geometry(R, G, Ms, Mn + Mx)._asdict(),
            "max_abs_err": max_abs,
            "max_rel_err": max_rel,
            **time_kernel(args, R, G, Ms, Mn, Mx, device,
                          diagnose=((R, G, Ms, Mn, Mx), layout) in DIAGNOSED),
        })
        emit("kernel_timing", **timed[-1])
    for i, R in enumerate(DELTA_ROWS):
        shape = (R,) + HEADLINE[1:]
        args, max_abs, max_rel = check_kernel_shape(*shape, device, seed=200 + i)
        G, Ms, Mn, Mx = HEADLINE[1:]
        kw = dict(num_groups=G, num_min=Mn, num_max=Mx)
        rows.append({
            "shape": shape, "delta": True, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "geometry": cuda_groupby.geometry(R, G, Ms, Mn + Mx)._asdict(),
            "call_ms": cuda_ms(lambda: cuda_groupby.cuda_partial_aggregate(*args, **kw)),
            "plain_ms": cuda_ms(lambda: cuda_groupby.plain_partial_aggregate(*args, G, Mn, Mx),
                                reps=3),
            "bound_ms": bound(*shape)[0],
        })
        emit("kernel_delta_check", **rows[-1])
    rows += mesh_kernel_checks(device)
    emit("kernel_check", cases=rows, rtol=KERNEL_RTOL, bit_stable=True,
         seconds=time.perf_counter() - t0)
    return rows, timed


# -- phase 4: the main path --------------------------------------------------


def uses_kernel(m: QueryMetrics) -> bool:
    """Whether a query's path ran a pass at most 4096 groups wide, which the
    kernel carries: the plain path at G <= 4096, the adaptive tier's
    compacted pass at G' <= 4096, the sparse tier over 4096 slots."""
    if m.strategy == "adaptive":
        return 0 < (m.compact_groups or 0) <= 4096
    if m.strategy == "sparse":
        return m.sparse_slots <= 4096
    return m.strategy == "cuda" and m.segments > 0


def class_strategy(cls: str, device) -> str:
    """The path (`QueryMetrics.strategy`) a cost-model class runs as: dense
    is the kernel on a card and its plain version on the CPU."""
    if cls == "dense":
        return "cuda" if torch.device(device).type == "cuda" else "dense"
    return cls


# the paths a tier hands its query to after a recorded decline
_AFTER_DECLINE = {"adaptive": ("sparse", "segment"), "sparse": ("segment",)}


def check_route(name: str, m: QueryMetrics, strategy: str = "auto", plan=None,
                device=None) -> None:
    """A query takes its route.  With `plan` (a cost-model class: the SQL
    path under "auto") it runs the plan's class; a forced `strategy`
    ("sparse", "segment", "adaptive", "dense") runs itself; a native query
    under "auto" (no plan: the engine's own ladder) runs the adaptive or
    sparse tier above 4096 groups.  A tier passes its query on only after
    a recorded decline."""
    if m.segments == 0:
        return
    if plan is not None or strategy != "auto":
        cls = plan if strategy == "auto" else strategy
        want = class_strategy(cls, device or "cuda")
        if want == "cuda" and m.num_groups > 4096:
            want = "segment"  # the card has no one-hot path above the kernel's range
        elif want in ("sparse", "adaptive") and m.num_groups <= 4096:
            want = class_strategy("dense", device or "cuda")  # no tier that narrow
        ok = m.strategy == want or (m.tier_declines and m.strategy in _AFTER_DECLINE.get(want, ()))
        if not ok:
            raise AssertionError(f"{name}: {cls} took {m.strategy} ({m.declines})")
        return
    if m.num_groups <= 4096:
        return
    if m.strategy not in ("adaptive", "sparse") and not (
            m.strategy == "segment" and m.tier_declines):
        raise AssertionError(f"{name}: auto took {m.strategy} ({m.declines})")


def tier_fields(m: QueryMetrics) -> dict:
    return {"compact_groups": m.compact_groups, "kept_source": m.kept_source,
            "inner_strategy": m.inner_strategy, "sparse_slots": m.sparse_slots,
            "sparse_row_capacity": m.sparse_row_capacity,
            "sparse_passes": m.sparse_passes, "declines": m.declines}


def checked_rows() -> dict:
    """The most rows phase 3 checked at each (G, Ms, Mn, Mx): a launch of
    that shape over more rows meets chunk counts no check met."""
    out = {}
    for R, *key in MAIN_SHAPES + SORTED_SHAPES + MESH_SHAPES:
        out[tuple(key)] = max(out.get(tuple(key), 0), R)
    return out


class KernelShapes:
    """The (G, Ms, Mn, Mx) of every kernel launch on the card between
    `start` and `stop`, CUDA graph replays included: the wrapper's
    per-shape counter (`cuda_groupby.LAUNCH_SHAPES`), less what it held at
    `start`; and the most rows a launch took at each
    (`cuda_groupby.LAUNCH_ROWS`)."""

    def __init__(self):
        self._base = {}
        self._final = None

    def start(self):
        self._base = dict(cuda_groupby.LAUNCH_SHAPES)
        self._final = None
        return self

    @property
    def seen(self):
        if self._final is not None:
            return self._final
        return {k: v - self._base.get(k, 0) for k, v in cuda_groupby.LAUNCH_SHAPES.items()
                if v > self._base.get(k, 0)}

    def stop(self):
        self._final = self.seen

    def check(self):
        """Fails on a launched shape that phase 3 did not check, or that a
        launch took over more rows than phase 3 checked it at."""
        checked = checked_rows()
        rows = {k: cuda_groupby.LAUNCH_ROWS.get(k, 0) for k in self.seen}
        missing = sorted(k for k in self.seen if k not in checked)
        over = sorted((k, rows[k], checked[k]) for k in self.seen
                      if k in checked and rows[k] > checked[k])
        emit("kernel_shapes", launched={str(k): v for k, v in sorted(self.seen.items())},
             most_rows={str(k): v for k, v in sorted(rows.items())},
             unchecked=missing, over_checked_rows=over)
        if missing:
            raise AssertionError(f"kernel shapes (G, Ms, Mn, Mx) not checked in phase 3: {missing}")
        if over:
            raise AssertionError("kernel shapes launched over more rows than phase 3 checked "
                                 f"((G, Ms, Mn, Mx), rows, checked rows): {over}")


def _frame_check(name, got, want, keys, rtol=ORACLE_RTOL):
    """Group keys and integer columns exact, floats within rtol; returns the
    largest relative error seen."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, oracle {len(want)}")
    got = got.sort_values(keys, kind="stable").reset_index(drop=True) if keys else got
    want = want.sort_values(keys, kind="stable").reset_index(drop=True) if keys else want
    worst = 0.0
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if c in keys or w.dtype.kind in "iuM" or np.asarray(got[c]).dtype.kind in "iu":
            if w.dtype.kind == "M":
                g, w = g.astype("datetime64[ms]"), w.astype("datetime64[ms]")
            if not np.array_equal(g.astype(object), w.astype(object)):
                raise AssertionError(f"{name}: column {c} differs from the oracle")
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        err = np.abs(g - w)
        if not (err <= rtol * np.abs(w)).all():
            raise AssertionError(f"{name}: column {c} off by {float((err / np.abs(w)).max())}")
        if len(w):
            worst = max(worst, float((err / np.maximum(np.abs(w), 1e-300)).max()))
    return worst


_ORACLES = {}


def oracle(workload, name, frame):
    """The float64 oracle of one query, computed once per run (phases 4 and
    6 check the same queries)."""
    key = (workload, name)
    if key not in _ORACLES:
        _ORACLES[key] = (tpch if workload == "tpch" else ssb).oracle(frame, name)
    return _ORACLES[key]


def _top_k_check(name, got, want, value, rtol=ORACLE_RTOL):
    """ORDER BY value DESC LIMIT k against the oracle's top k, tie-aware:
    the values agree in order, every returned key that the oracle also
    returns carries its value, and a key the oracle left out sits at the
    cut (a float32 near-tie)."""
    g = np.asarray(got[value], dtype=np.float64)
    w = np.asarray(want[value], dtype=np.float64)
    if len(g) != len(w) or (np.diff(g) > 0).any():
        raise AssertionError(f"{name}: wrong length or order")
    if not (np.abs(g - w) <= rtol * np.abs(w)).all():
        raise AssertionError(f"{name}: top-{len(w)} values differ from the oracle")
    keys = [c for c in want.columns if c != value]
    wmap = dict(zip(map(tuple, want[keys].astype(str).to_numpy()), w))
    for k, v in zip(map(tuple, got[keys].astype(str).to_numpy()), g):
        ref = wmap.get(k, w[-1])
        if abs(v - ref) > rtol * abs(ref):
            raise AssertionError(f"{name}: {k} {v} vs oracle {ref}")
    return float((np.abs(g - w) / np.abs(w)).max()) if len(w) else 0.0


def check_against_oracle(name, got, frame, workload, want=None, rtol=ORACLE_RTOL):
    """`got` against the float64 oracle of query `name` over `frame` (or
    `want`, an oracle computed elsewhere), sums within `rtol`; returns the
    largest relative error."""
    if workload == "tpch":
        want = oracle(workload, name, frame)
        if isinstance(want, float):
            g = float(got.iloc[0, -1])
            if len(got) != 1 or abs(g - want) > rtol * abs(want):
                raise AssertionError(f"{name}: {g} vs oracle {want}")
            return abs(g - want) / abs(want)
        if name in ("q3", "q10"):  # ORDER BY revenue DESC LIMIT k
            return _top_k_check(name, got[list(want.columns)], want, "revenue", rtol)
        keys = [c for c in want.columns if want[c].dtype.kind not in "f"]
        return _frame_check(name, got[list(want.columns)], want, keys, rtol)
    if want is None:
        want = oracle(workload, name, frame)
    if isinstance(want, float):
        g = float(got["revenue"].iloc[0])
        if len(got) != 1 or abs(g - want) > rtol * abs(want):
            raise AssertionError(f"{name}: {g} vs oracle {want}")
        return abs(g - want) / abs(want)
    if name == "topn":
        # tie-aware: each returned nation's revenue matches the oracle, the
        # order is non-increasing, and nothing left out beats the cut
        w = dict(zip(want.c_nation.astype(str), want.revenue))
        rev = np.asarray(got.revenue, dtype=np.float64)
        worst = 0.0
        for n, r in zip(got.c_nation.astype(str), rev):
            if abs(r - w[n]) > rtol * abs(w[n]):
                raise AssertionError(f"topn: {n} {r} vs oracle {w[n]}")
            worst = max(worst, abs(r - w[n]) / abs(w[n]))
        k = ssb.TOPN_QUERY.threshold
        if len(got) != k or (np.diff(rev) > 0).any():
            raise AssertionError("topn: wrong length or order")
        left_out = [v for n, v in w.items() if n not in set(got.c_nation.astype(str))]
        if left_out and max(left_out) > rev[-1] * (1 + rtol):
            raise AssertionError("topn: a nation above the cut was left out")
        return worst
    keys = [c for c in want.columns if c not in ("revenue", "profit")]
    want = want.assign(**{c: want[c].astype(object) for c in keys if c != "timestamp"})
    return _frame_check(name, got[list(want.columns)], want, keys, rtol)


def build_workloads(ssb_scale: float, tpch_scale: float, seed: int = 7):
    """The flat datasources and oracle frames of both workloads, and the
    normalized dimension tables the SQL phase registers.  The fact tables'
    raw columns are freed once flattened."""
    t0 = time.perf_counter()
    tables = ssb.gen_tables(ssb_scale, seed=seed)
    cols, dicts = ssb.flat_columns(tables)
    del tables["lineorder"]
    ssb_ds = ssb.datasource(cols, dicts)
    ssb_frame = ssb.coded_frame(cols, dicts)
    del cols
    tt = tpch.gen_tables(tpch_scale)
    tcols, tdicts = tpch.flat_columns(tt)
    tpch_ds = tpch.datasource(tcols, tdicts, rows_per_segment=1 << 19)
    tpch_frame = tpch.flat_frame(tt)
    del tcols  # tt["lineitem"] stays: phase 10 registers it as rawline
    emit(
        "data", ssb_scale=ssb_scale, ssb_rows=ssb_ds.num_rows,
        ssb_segments=len(ssb_ds.segments), tpch_scale=tpch_scale,
        tpch_rows=tpch_ds.num_rows, tpch_segments=len(tpch_ds.segments),
        seconds=time.perf_counter() - t0,
    )
    return {
        "ssb": (ssb_ds, ssb_frame),
        "tpch": (tpch_ds, tpch_frame),
        "dims": {"ssb": tables, "tpch": tt},
    }


def main_path_queries():
    return (
        [("ssb", n, q) for n, q in ssb.NATIVE_QUERIES.items()]
        + [("tpch", "q1", tpch.NATIVE_QUERIES["q1"])]
        + [("ssb", "timeseries", ssb.TIMESERIES_QUERY), ("ssb", "topn", ssb.TOPN_QUERY)]
    )


NATIVE_FRAMES = {}  # (workload, query) -> phase 4's first frame, for phase 11


def run_main_path(engines, workloads, warm_runs: int = WARM_RUNS):
    """Drive every query of the main path through its workload's engine
    (`engines`: workload -> Engine); returns one summary per query."""
    import pandas as pd

    out = []
    for workload, name, q in main_path_queries():
        ds, frame = workloads[workload]
        engine = engines[workload]
        before = cuda_groupby.LAUNCHES
        first = engine.execute(q, ds)  # cold: moves the columns to the card
        m = engine.last_metrics
        second = engine.execute(q, ds)
        pd.testing.assert_frame_equal(first, second, check_exact=True)
        NATIVE_FRAMES[(workload, name)] = first
        times = []
        for _ in range(warm_runs):
            t0 = time.perf_counter()
            engine.execute(q, ds)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = cuda_groupby.LAUNCHES - before
        if engine.device.type == "cuda":
            check_route(name, m)
            if uses_kernel(m) and launches == 0:
                raise AssertionError(f"{name}: {m.describe()} but the kernel never launched")
        p50 = statistics.median(times)
        out.append({
            "query": name,
            "strategy": m.strategy,
            "num_groups": m.num_groups,
            **tier_fields(m),
            "segments": m.segments,
            "rows_scanned": m.rows_scanned,
            "result_rows": len(first),
            "p50_ms": p50,
            "rows_per_s": m.rows_scanned / (p50 / 1e3),
            "cold_ms": m.total_ms,
            "h2d_bytes": m.h2d_bytes,
            "kernel_launches": launches,
            "oracle_max_rel_err": check_against_oracle(name, first, frame, workload),
            "bit_identical": True,
        })
        emit("query", **out[-1])
    return out


def profile_queries(engines, workloads, summaries):
    """One more warm run of each query under torch.profiler: device time by
    kernel, the group-by kernel's share, and the device's idle share of the
    query's unprofiled p50 wall time."""
    from torch.profiler import ProfilerActivity, profile

    p50 = {s["query"]: s["p50_ms"] for s in summaries}
    for workload, name, q in main_path_queries():
        ds, _ = workloads[workload]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engines[workload].execute(q, ds)
        # device-side events only (kernels, copies): an aten op's average
        # repeats its kernels' device time
        dev = {
            e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
        }
        busy = sum(dev.values())
        groupby = sum(v for k, v in dev.items() if "partial_pass" in k or "fold_pass" in k)
        emit(
            "profile", query=name, wall_p50_ms=p50[name], device_busy_ms=busy,
            groupby_kernel_ms=groupby,
            device_idle_share=(1 - busy / p50[name]) if busy else None,
            top_device_ms=sorted(dev.items(), key=lambda kv: -kv[1])[:4],
        )


# -- phase 6: the SQL front end -----------------------------------------------


def register_sql(ctxs, workloads) -> float:
    """Register each workload's flat datasource with its star schema, and
    its normalized dimension tables, into its own context (`ctxs`:
    workload -> TPUOlapContext; SSB and TPC-H both name a customer,
    supplier and part table); returns seconds."""
    t0 = time.perf_counter()
    dims = workloads["dims"]
    s, t = ctxs["ssb"], ctxs["tpch"]
    s.register_datasource(workloads["ssb"][0], star_schema=ssb.STAR_SCHEMA)
    s.register_table("dwdate", dims["ssb"]["dwdate"], time_column="d_datekey")
    t.register_datasource(workloads["tpch"][0], star_schema=tpch.STAR_SCHEMA)
    t.register_table("orders", dims["tpch"]["orders"], time_column="o_orderdate")
    for name in ("customer", "supplier", "part"):
        s.register_table(name, dims["ssb"][name])
        t.register_table(name, dims["tpch"][name])
    return time.perf_counter() - t0


def sql_queries():
    return [("ssb", n, q) for n, q in ssb.QUERIES.items()] + [
        ("tpch", n, q) for n, q in tpch.QUERIES.items()
    ]


def _runs_ms(fn, n: int) -> list:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _median_ms(fn, n: int) -> float:
    return statistics.median(_runs_ms(fn, n))


def _interleaved_ms(sql_fn, native_fn, pairs: int):
    """`pairs` runs of each function, interleaved: SQL then native in even
    pairs, native then SQL in odd ones, so neither side always runs first.
    Returns (SQL ms, native ms, kernel launches of the SQL runs)."""
    sql_ms, native_ms, launches = [], [], 0
    for i in range(pairs):
        for side in (("sql", "native") if i % 2 == 0 else ("native", "sql")):
            before = cuda_groupby.LAUNCHES
            t0 = time.perf_counter()
            (sql_fn if side == "sql" else native_fn)()
            ms = (time.perf_counter() - t0) * 1e3
            if side == "sql":
                sql_ms.append(ms)
                launches += cuda_groupby.LAUNCHES - before
            else:
                native_ms.append(ms)
    return sql_ms, native_ms, launches


def run_sql_path(ctxs, workloads, pairs: int = SQL_PAIRS):
    """Drive every SQL query through its workload's `ctx.sql` (`ctxs`:
    workload -> TPUOlapContext); returns one summary per query.  Only the
    launches of the `ctx.sql` calls are counted."""
    import pandas as pd

    natives = {"ssb": ssb.NATIVE_QUERIES, "tpch": tpch.NATIVE_QUERIES}
    out = []
    for workload, name, sql in sql_queries():
        ctx = ctxs[workload]
        _, frame = workloads[workload]
        plan_cold = _median_ms(lambda: ctx.plan_sql(sql), 3)
        rw = ctx.plan_sql(sql)
        spec = natives[workload].get(name)
        planned = json.dumps(rw.query.to_druid(), sort_keys=True, default=str)
        if spec is not None and planned != json.dumps(
            spec.to_druid(), sort_keys=True, default=str
        ):
            raise AssertionError(f"{name}: planned JSON differs from the native spec")
        launches = cuda_groupby.LAUNCHES
        first = ctx.sql(sql)
        m = ctx.last_metrics
        second = ctx.sql(sql)
        launches = cuda_groupby.LAUNCHES - launches
        pd.testing.assert_frame_equal(first, second, check_exact=True)
        plan_cached = _median_ms(lambda: ctx.plan_cached(sql), 20)
        ds = ctx.catalog.get(rw.datasource)
        native_q = spec if spec is not None else rw.query
        # the native run of the same spec under the same plan's class
        strategy = ctx.strategy_for(rw)
        native = ctx.engine.execute(native_q, ds, strategy)
        native_strategy = ctx.last_metrics.strategy
        sql_ms, native_ms, warm_launches = _interleaved_ms(
            lambda: ctx.sql(sql), lambda: ctx.engine.execute(native_q, ds, strategy), pairs)
        launches += warm_launches
        if ctx.engine.device.type == "cuda":
            check_route(name, m, plan=rw.physical.strategy, device=ctx.engine.device)
            if uses_kernel(m) and launches == 0:
                raise AssertionError(f"{name}: {m.describe()} but the kernel never launched")
        diffs = [a - b for a, b in zip(sql_ms, native_ms)]
        cols = [c for c in first.columns if c in native.columns]
        pd.testing.assert_frame_equal(
            first[cols].reset_index(drop=True), native[cols].reset_index(drop=True),
            check_exact=True,
        )
        if native_strategy != m.strategy:
            raise AssertionError(f"{name}: SQL ran {m.strategy}, native {native_strategy}")
        out.append({
            "query": f"{name} (TPC-H)" if workload == "tpch" else name,
            "json_equals_native": None if spec is None else True,
            "plan": rw.physical.strategy,
            "strategy": m.strategy,
            "num_groups": m.num_groups,
            **tier_fields(m),
            "segments": m.segments,
            "result_rows": len(first),
            "plan_cold_ms": plan_cold,
            "plan_cached_ms": plan_cached,
            "sql_p50_ms": statistics.median(sql_ms),
            "native_p50_ms": statistics.median(native_ms),
            # per pair, SQL ms minus native ms: median, and the pairs where
            # SQL went first / native went first
            "sql_minus_native_ms": statistics.median(diffs),
            "diff_sql_first_ms": diffs[0::2],
            "diff_native_first_ms": diffs[1::2],
            "kernel_launches": launches,
            "oracle_max_rel_err": check_against_oracle(name, first, frame, workload),
            "bit_identical": True,
            "bit_identical_to_native": True,
        })
        emit("sql_query", **out[-1])
    return out


# -- phase 7: sketches --------------------------------------------------------


def _sketch_sets(ctx, name, full=False):
    """The group-by specs one sketch query runs, one per grouping set, as
    `api.execute_grouping_sets` splits them; with `full`, only its grouping
    by every dimension."""
    import dataclasses

    rw = ctx.plan_sql(ssb.SKETCH_QUERIES[name])
    q = rw.query
    if isinstance(q, Q.TopNQuery):
        q = topn_to_groupby(q)
    if full or not rw.grouping_sets:
        qs = [dataclasses.replace(q, subtotals=())]
    else:
        qs = grouping_set_queries(q, rw.grouping_sets)
    return [groupby_with_time_granularity(x) for x in qs]


def sketch_op_checks(ctx):
    """The engine's sketch partials and merges (`sketch_partials`,
    `merge_sketch_states`) on the context's device against the same
    functions on the CPU over the same inputs, bit for bit: over the first
    OP_CHECK_SEGMENTS in-scope SSB segments (their resident columns), at the
    group ids of each query's grouping by every dimension; one summary per
    op."""
    import dataclasses

    ds = ctx.catalog.get("lineorder")
    out = []
    for name, aggs in OP_CHECKS.items():
        (q,) = _sketch_sets(ctx, name, full=True)
        q = dataclasses.replace(q, aggregations=aggs, post_aggregations=(), limit_spec=None)
        lowering = lower_groupby(q, ds)
        acc = {"card": {}, "cpu": {}}
        segs = segments_in_scope(q, ds)[:OP_CHECK_SEGMENTS]
        for seg in segs:
            cols = ctx.engine._cols_for_segment(seg, ds, lowering.columns, QueryMetrics())
            gid, mask = lowering.row_arrays(cols)[:2]
            new = {
                "card": sketch_partials(lowering, cols, gid, mask),
                "cpu": sketch_partials(
                    lowering, {k: v.cpu() for k, v in cols.items()}, gid.cpu(), mask.cpu()),
            }
            for k in acc:
                merge_sketch_states(lowering.la, acc[k], new[k])
            for agg in aggs:
                for what, states in (("partial", new), ("merge", acc)):
                    if not torch.equal(states["card"][agg.name].cpu(), states["cpu"][agg.name]):
                        raise AssertionError(f"{agg.name}: {what} on the card differs from the CPU")
        for agg in aggs:
            out.append({"op": agg.name, "query": name, "num_groups": lowering.num_groups,
                        "segments": len(segs), "state_shape": list(acc["card"][agg.name].shape),
                        "bit_equal_to_cpu": True})
            emit("sketch_op_check", **out[-1])
    return out


def rho_check(device):
    """`hll._rho` on `device` over ±8192 around every power of two below
    2^28 (p = 4) against the reference's values computed on the host: the
    float32 exponent of w with the committed exception table applied."""
    half, top = 8192, 28
    w = np.unique(np.concatenate([
        np.arange(max((1 << k) - half, 0), min((1 << k) + half, 1 << top)) for k in range(top)
    ]))
    lg = np.frexp(np.maximum(w, 1).astype(np.float32))[1].astype(np.int64) - 1
    for a, b, v in hll._LOG2_EXCEPTIONS:
        lg[(w >= a) & (w <= b)] = v
    want = np.where(w == 0, top + 1, top - lg)
    got = hll._rho(torch.from_numpy(w << 4).to(device), 4).cpu().numpy()
    bad = int((got != want).sum())
    emit("rho_check", values=len(w), mismatches=bad, exceptions_applied=int(
        sum(b - a + 1 for a, b, _ in hll._LOG2_EXCEPTIONS)))
    if bad:
        raise AssertionError(f"_rho on {device} differs from the reference at {bad} values")
    return {"values": len(w), "mismatches": bad}


def run_sketch_queries(ctx, frame, cold=SKETCH_COLD, warm=SKETCH_WARM):
    """Each SKETCH_QUERIES entry through `ctx.sql`, `cold` + `warm` runs:
    bit-identical frames, the exact oracle, and one kernel launch per
    in-scope segment per run for every grouping set; one summary each."""
    import pandas as pd

    ds = ctx.catalog.get("lineorder")
    out, oracles = [], {}
    for name, sql in ssb.SKETCH_QUERIES.items():
        sets = _sketch_sets(ctx, name)
        t_query = time.perf_counter()
        before = cuda_groupby.LAUNCHES
        frames, times = [], []
        for _ in range(cold + warm):
            t0 = time.perf_counter()
            frames.append(ctx.sql(sql))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = cuda_groupby.LAUNCHES - before
        for f in frames[1:]:
            pd.testing.assert_frame_equal(frames[0], f, check_exact=True)
        per_run = sum(len(segments_in_scope(q, ds)) for q in sets)
        lowered = [lower_groupby(q, ds) for q in sets]
        for lw in lowered:
            la = lw.la
            shape = (lw.num_groups, len(la.sum_names), len(la.min_names), len(la.max_names))
            if shape not in {s[1:] for s in MAIN_SHAPES}:
                raise AssertionError(f"{name}: kernel shape {shape} not checked in phase 3")
        on_card = ctx.engine.device.type == "cuda"
        if on_card and launches != per_run * (cold + warm):
            raise AssertionError(
                f"{name}: {launches} kernel launches, want {per_run} per run")
        runs_s = time.perf_counter() - t_query
        t0 = time.perf_counter()
        key = "cube" if name.startswith("cube") else name  # one answer for both cubes
        if key not in oracles:
            oracles[key] = ssb.sketch_oracle(frame, name)
        want = oracles[key]
        oracle_s = time.perf_counter() - t0
        out.append({
            "query": name,
            "grouping_sets": len(sets),
            "num_groups": [lw.num_groups for lw in lowered],
            "segments_per_run": per_run,
            "result_rows": len(frames[0]),
            "cold_ms": times[:cold],
            "p50_ms": statistics.median(times[cold:]),
            "kernel_launches": launches,
            **ssb.check_sketch_answer(name, frames[0], want),
            "runs_seconds": runs_s,
            "oracle_seconds": oracle_s,
            "bit_identical": True,
        })
        emit("sketch_query", **out[-1])
    return out


def _device_events_ms(prof):
    """Device time by kernel name (kernels, copies, memsets), summed from the
    profiler's raw device events: parsing a trace of a whole CUBE into
    `key_averages()` costs tens of seconds."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return out


def profiled_device_ms(fn, allow_empty=False, tries: int = PROFILE_TRIES):
    """fn() under torch.profiler; its device time by kernel name.  A window
    that recorded no device event is taken again (the trace can drop a
    window's events), up to `tries` windows, then the run fails, unless
    `allow_empty` (a query whose answer needs no device work, such as an
    empty kept set recalled from the memo)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = _device_events_ms(prof)
        if out or allow_empty:
            return out
    raise AssertionError(f"{tries} profiler windows recorded no device time")


def profile_sketch_queries(ctx, summaries):
    """One more run of each sketch query under torch.profiler (device busy
    ms, idle share of the p50), and a replay of only its sketch partials
    and merges over its segments, in the engine's order, under the
    profiler: the sketch ops' device ms, by kernel."""
    ds = ctx.catalog.get("lineorder")
    engine = ctx.engine
    for s in summaries:
        name = s["query"]
        t0 = time.perf_counter()
        busy = sum(profiled_device_ms(lambda: ctx.sql(ssb.SKETCH_QUERIES[name])).values())
        by_kernel = {}
        for q in _sketch_sets(ctx, name):
            lowering = engine._lowering_for(q, ds)
            inputs = []
            for seg in segments_in_scope(q, ds):
                cols = lowering.add_virtual(dict(engine._cols_for_segment(
                    seg, ds, lowering.columns, QueryMetrics())))  # resident
                inputs.append((cols, *lowering.row_arrays(cols)[:2]))
            torch.cuda.synchronize()

            def replay():
                acc = {}
                for cols, gid, mask in inputs:
                    merge_sketch_states(lowering.la, acc, sketch_partials(lowering, cols, gid, mask))

            by_set = profiled_device_ms(replay)
            del inputs
            for k, v in by_set.items():
                by_kernel[k] = by_kernel.get(k, 0.0) + v
        sketch_ms = sum(by_kernel.values())
        s.update(
            device_busy_ms=busy,
            device_idle_share=(1 - busy / s["p50_ms"]) if busy else None,
            sketch_ops_device_ms=sketch_ms,
            sketch_ops_top_kernels=sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5],
        )
        emit("sketch_profile", query=name, wall_p50_ms=s["p50_ms"], device_busy_ms=busy,
             device_idle_share=s["device_idle_share"], sketch_ops_device_ms=sketch_ms,
             sketch_ops_top_kernels=[(k[:60], v) for k, v in s["sketch_ops_top_kernels"]],
             seconds=time.perf_counter() - t0)


# -- phase 8: the high-cardinality tier ---------------------------------------

HIGH_G = [("ssb", n) for n in ("q2_1", "q2_2", "q2_3", "q3_1", "q3_2", "q3_3", "q3_4",
                               "q4_2", "q4_3")] + [("tpch", "q3"), ("tpch", "q10")]
TIER_STRATEGIES = ("auto", "sparse", "segment")
TIER_WARM = 1  # warm runs of each tier query (3 until phase 18)
TIER_SLOTS = (4096, 1 << 18)  # the kernel over slots; the segmented reduce


def _compare_states(what, card, cpu):
    """Sparse states on the card against the CPU: flags and counts equal;
    unless overflowed, gids, mins and maxs equal and sums within
    KERNEL_RTOL.  Returns (overflowed, max rel err of the sums)."""
    for k in ("overflow", "row_overflow", "n_rows", "n_real"):
        if not torch.equal(card[k].cpu(), cpu[k]):
            raise AssertionError(f"{what}: {k} on the card differs from the CPU")
    if bool(cpu["overflow"]):
        return True, 0.0
    for k in ("gids", "mins", "maxs"):
        if not torch.equal(card[k].cpu(), cpu[k]):
            raise AssertionError(f"{what}: {k} on the card differs from the CPU")
    a, b = card["sums"].cpu().double(), cpu["sums"].double()
    if not bool(((a - b).abs() <= KERNEL_RTOL * b.abs()).all()):
        raise AssertionError(f"{what}: sums off by more than rtol {KERNEL_RTOL}")
    return False, float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def _bit_equal(what, a, b):
    if any(not torch.equal(a[k], b[k]) for k in a):
        raise AssertionError(f"{what}: two launches on the card differ")


def _syncs(fn):
    """Where a second call of fn() makes the host wait on the card (torch's
    sync debug mode; the first call warms up): {file:line: count}; None
    where there is no card."""
    import warnings

    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "called a synchronizing" in str(w.message):
            site = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def tier_op_checks(cases):
    """The tier's ops on the card against the same functions on the CPU,
    over the first OP_CHECK_SEGMENTS in-scope segments of each (name,
    context, SQL) case: `compact_rows` at the query's first row-capacity
    rung, `sparse_partial_aggregate` at 4096 slots (the kernel inner; its
    plain version on the CPU) and at 2^18 (the segmented reduce), their
    fold by `merge_sparse_states`, the presence counts and the compacted
    codes; two launches on the card bit-equal.  Also the host syncs of one
    sparse pass and one compacted pass over the same segments."""
    from spark_druid_olap_tpu_torch.exec.adaptive_exec import compacted_lowering
    from spark_druid_olap_tpu_torch.ops import sparse_groupby as sg

    out = []
    cpu_engine = Engine(device="cpu")
    for name, ctx, sql in cases:
        rw = ctx.plan_sql(sql)
        q = groupby_with_time_granularity(rw.query)
        ds = ctx.catalog.get(rw.datasource)
        engine = ctx.engine
        lowering = engine._lowering_for(q, ds)
        la, G = lowering.la, lowering.num_groups
        segs = segments_in_scope(q, ds)[:OP_CHECK_SEGMENTS]
        cap = engine._first_row_capacity(q, ds, segs)
        kw = dict(num_groups=G, num_min=len(la.min_names), num_max=len(la.max_names),
                  row_capacity=cap)
        acc = {n: {"card": None, "cpu": None} for n in TIER_SLOTS}
        worst, overflowed, cols_by_seg = 0.0, {}, []
        for seg in segs:
            cols = engine._cols_for_segment(seg, ds, lowering.columns, QueryMetrics())
            cols_by_seg.append(cols)
            arrs = {"card": lowering.row_arrays(cols),
                    "cpu": lowering.row_arrays({k: v.cpu() for k, v in cols.items()})}
            packed = {w: sg.compact_rows(*a, capacity=cap or 4096) for w, a in arrs.items()}
            for a, b in zip(packed["card"], packed["cpu"]):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{name}: compact_rows on the card differs from the CPU")
            for slots in TIER_SLOTS:
                st = {
                    "card": sg.sparse_partial_aggregate(
                        *arrs["card"], slots=slots, inner_strategy="cuda", **kw),
                    "cpu": sg.sparse_partial_aggregate(
                        *arrs["cpu"], slots=slots, inner_strategy="dense", **kw),
                }
                _bit_equal(f"{name} at {slots} slots", st["card"], sg.sparse_partial_aggregate(
                    *arrs["card"], slots=slots, inner_strategy="cuda", **kw))
                _, err = _compare_states(f"{name} partial at {slots} slots", st["card"], st["cpu"])
                worst = max(worst, err)
                a = acc[slots]
                if a["card"] is None:
                    a.update(st)
                else:
                    merged = sg.merge_sparse_states(a["card"], st["card"], G)
                    _bit_equal(f"{name} merge at {slots} slots", merged,
                               sg.merge_sparse_states(a["card"], st["card"], G))
                    a["card"], a["cpu"] = merged, sg.merge_sparse_states(a["cpu"], st["cpu"], G)
                ov, err = _compare_states(f"{name} merge at {slots} slots", a["card"], a["cpu"])
                overflowed[slots] = ov
                worst = max(worst, err)
        counts = {"card": engine._presence_counts(q, ds, lowering, segs, QueryMetrics()),
                  "cpu": cpu_engine._presence_counts(q, ds, lowering, segs, QueryMetrics())}
        for a, b in zip(counts["card"], counts["cpu"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: presence counts on the card differ from the CPU")
        kept = [np.nonzero(c > 0)[0].astype(np.int32) for c in counts["card"]]
        clow = compacted_lowering(lowering, kept)
        for cols in cols_by_seg:
            gid = clow.row_arrays(cols)[0]
            if not torch.equal(gid.cpu(), clow.row_arrays({k: v.cpu() for k, v in cols.items()})[0]):
                raise AssertionError(f"{name}: compacted codes on the card differ from the CPU")
        syncs = {
            "sparse_pass": _syncs(lambda: engine._sparse_pass(
                ds, lowering, segs, cap, TIER_SLOTS[0], QueryMetrics())),
        }
        if clow.num_groups <= 4096:
            with arena_disabled():  # the eager loop's syncs
                syncs["compacted_pass"] = _syncs(lambda: engine._partials_for_query(
                    clow, segs, ds, "cuda", QueryMetrics()))
        out.append({"case": name, "num_groups": G, "segments": len(segs), "row_capacity": cap,
                    "compact_groups": clow.num_groups, "presence_cards": [len(c) for c in kept],
                    "merged_overflow": {str(k): v for k, v in overflowed.items()},
                    "sums_max_rel_err": worst, "host_syncs": syncs, "bit_equal_to_cpu": True})
        emit("tier_op_check", **out[-1])
    return out


def _cross_tier_check(name, frames):
    """The same keys and counts under every tier; sums within ORACLE_RTOL
    (each tier adds in its own order)."""
    base = frames["auto"]
    keys = [c for c in base.columns if base[c].dtype.kind not in "f"]
    a = base.sort_values(keys, kind="stable").reset_index(drop=True)
    for tier, f in frames.items():
        b = f.sort_values(keys, kind="stable").reset_index(drop=True)
        if list(b.columns) != list(a.columns) or len(b) != len(a):
            raise AssertionError(f"{name}: {tier} frame differs in shape from auto's")
        for c in a.columns:
            x, y = np.asarray(a[c]), np.asarray(b[c])
            if c in keys:
                if not np.array_equal(x.astype(object), y.astype(object)):
                    raise AssertionError(f"{name}: {tier} column {c} differs from auto's")
            elif not (np.abs(x - y) <= ORACLE_RTOL * np.abs(x)).all():
                raise AssertionError(f"{name}: {tier} column {c} off from auto's")


def run_tier_queries(ctxs, workloads, warm=TIER_WARM):
    """The 11 high-cardinality queries through `ctx.sql` under each of
    TIER_STRATEGIES: the route, the oracle, bit-identical runs, the kernel
    launched where a pass is at most 4096 wide, the same answer across
    tiers; p50 of the warm runs and, under "auto", from one profiled run,
    device busy ms and idle share.  One summary per query and tier."""
    out, frames = [], {}
    for strategy in TIER_STRATEGIES:
        for workload, name in HIGH_G:
            ctx = ctxs[workload]
            ctx.engine.strategy = strategy
            sql = (tpch if workload == "tpch" else ssb).QUERIES[name]
            before = cuda_groupby.LAUNCHES
            t0 = time.perf_counter()
            first = ctx.sql(sql)
            cold_ms = (time.perf_counter() - t0) * 1e3
            m = ctx.last_metrics
            second = ctx.sql(sql)
            import pandas as pd

            pd.testing.assert_frame_equal(first, second, check_exact=True)
            times = []
            for _ in range(warm):
                t0 = time.perf_counter()
                ctx.sql(sql)
                times.append((time.perf_counter() - t0) * 1e3)
            launches = cuda_groupby.LAUNCHES - before
            plan = ctx.plan_sql(sql).physical.strategy
            check_route(name, m, strategy, plan=plan, device=ctx.engine.device)
            if ctx.engine.device.type == "cuda" and uses_kernel(m) and launches == 0:
                raise AssertionError(f"{name}: {m.describe()} but the kernel never launched")
            # profiled under the plan's own tier only (all three until
            # phase 18: the time limit)
            busy = sum(profiled_device_ms(lambda: ctx.sql(sql),
                                          allow_empty=m.compact_groups == 0).values()
                       ) if strategy == "auto" else None
            p50 = statistics.median(times)
            if "LIMIT" not in sql:
                frames.setdefault(name, {})[strategy] = first
            out.append({
                "query": name, "workload": workload, "strategy_asked": strategy,
                "plan": plan, "strategy": m.strategy, "num_groups": m.num_groups,
                **tier_fields(m),
                "segments": m.segments, "result_rows": len(first), "cold_ms": cold_ms,
                "p50_ms": p50, "kernel_launches": launches, "device_busy_ms": busy,
                "device_idle_share": None if busy is None else 1 - busy / p50,
                "oracle_max_rel_err": check_against_oracle(name, first, workloads[workload][1],
                                                           workload),
                "bit_identical": True,
            })
            emit("tier_query", **out[-1])
    for ctx in ctxs.values():
        ctx.engine.strategy = "auto"
    for name, by_tier in frames.items():
        _cross_tier_check(name, by_tier)
    return out


def run_exact_distinct(ctx, frame, warm=WARM_RUNS):
    """`ssb.EXACT_DISTINCT_QUERIES` through `ctx.sql` under count_distinct_mode
    = 'exact': bit-identical runs, distinct counts equal to the exact oracle,
    the inner grouping on its plan's route (a sparse or adaptive plan
    answered by the sparse tier on a segmented-reduce rung); the rungs and
    the p50."""
    import pandas as pd

    out = []
    for name, sql in ssb.EXACT_DISTINCT_QUERIES.items():
        before = cuda_groupby.LAUNCHES
        t0 = time.perf_counter()
        first = ctx.sql(sql)
        cold_ms = (time.perf_counter() - t0) * 1e3
        m = ctx.last_metrics  # the inner grouping's
        pd.testing.assert_frame_equal(first, ctx.sql(sql), check_exact=True)
        times = []
        for _ in range(warm):
            t0 = time.perf_counter()
            ctx.sql(sql)
            times.append((time.perf_counter() - t0) * 1e3)
        plan = ctx.plan_sql(sql).physical.strategy  # the inner grouping's
        check_route(name, m, plan=plan, device=ctx.engine.device)
        if plan in ("sparse", "adaptive") and (m.strategy != "sparse" or m.sparse_slots <= 4096):
            raise AssertionError(f"{name}: the inner grouping took {m.describe()}")
        out.append({
            "query": name, "plan": plan, "strategy": m.strategy, "num_groups": m.num_groups,
            **tier_fields(m),
            "segments": m.segments, "result_rows": len(first), "cold_ms": cold_ms,
            "p50_ms": statistics.median(times), "kernel_launches": cuda_groupby.LAUNCHES - before,
            **ssb.check_sketch_answer(name, first, ssb.sketch_oracle(frame, name)),
            "bit_identical": True,
        })
        emit("exact_distinct_query", **out[-1])
    return out


# -- phase 9: one dispatch per query, batch dispatch, the transfer pipeline -----

ARENA_WARM = 1  # warm runs each way, arena on and off interleaved (3 until phase 15, 2 until 16)
# a CUBE without sketches: every set's pass is captured (G 1 to 288, Ms 2)
CUBE_REVENUE = ("SELECT c_region, s_region, d_year, sum(lo_revenue) AS revenue "
                "FROM lineorder GROUP BY CUBE (c_region, s_region, d_year)")
COLD_QUERY = "q4_1"  # the cold SSB scope: every segment, six columns
COLD_RUNS = 1  # cold runs each way, pipeline on and off interleaved (2 until phase 18)


def _set(ctx, flag: str, on: bool) -> None:
    ctx.sql(f"SET {flag} = {'true' if on else 'false'}")


def _with_set_metrics(engine, fn):
    """fn() and the engine's metrics of every group-by it resolved (one per
    grouping set of a CUBE)."""
    got = []
    orig = engine._dispatch_groupby_once

    def dispatch(q, ds, scope, strategy=None):
        fetch = orig(q, ds, scope, strategy)

        def fetched():
            finish = fetch()

            def recorded():
                df = finish()
                got.append(engine.last_metrics)
                return df

            return recorded

        return fetched

    engine._dispatch_groupby_once = dispatch
    try:
        return fn(), got
    finally:
        del engine._dispatch_groupby_once


def arena_queries(ctxs, workloads):
    """(label, workload, kind, run, check) of every main-path query (native
    specs), every SQL query (the tier's high-G ones are kind "tier") and
    the CUBEs: the two sketch CUBEs of phase 7 and one without sketches.
    `run()` gives the frame; `check(frame)` holds it against its oracle and
    returns the largest relative error."""
    out = []
    for workload, name, q in main_path_queries():
        ds, frame = workloads[workload]
        out.append((name, workload, "native",
                    lambda e=ctxs[workload].engine, q=q, ds=ds: e.execute(q, ds),
                    lambda f, n=name, w=workload, fr=frame: check_against_oracle(n, f, fr, w)))
    for workload, name, sql in sql_queries():
        frame = workloads[workload][1]
        kind = "tier" if (workload, name) in HIGH_G else "sql"
        out.append((f"{name} (SQL)", workload, kind, lambda c=ctxs[workload], t=sql: c.sql(t),
                    lambda f, n=name, w=workload, fr=frame: check_against_oracle(n, f, fr, w)))
    frame = workloads["ssb"][1]
    cube = {}

    def cube_check(name):
        def check(f):
            if not cube:  # the exact CUBE: groups, GROUPING_IDs, revenue, distinct counts
                cube["want"] = ssb.sketch_oracle(frame, "cube_hll")
            want = cube["want"]
            if name == "cube_revenue":  # no distinct column to hold
                f, want = f.assign(uniq_custs=1), want.assign(uniq_custs=1)
            return ssb.check_sketch_answer(name if name != "cube_revenue" else "cube_hll",
                                           f, want)["revenue_max_rel_err"]
        return check

    for name in ("cube_hll", "cube_theta", "cube_revenue"):
        sql = CUBE_REVENUE if name == "cube_revenue" else ssb.SKETCH_QUERIES[name]
        out.append((name, "ssb", "cube", lambda t=sql: ctxs["ssb"].sql(t), cube_check(name)))
    return out


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _busy_ms(fn):
    """Device busy ms of one run from torch.profiler, or None where the
    windows recorded no device event."""
    dev = profiled_device_ms(fn, allow_empty=True)
    return sum(dev.values()) if dev else None


def _arena_check(label, sets, launches, on_card):
    """Every set's pass was replayed from a graph, or the arena recorded
    why it declined, or the set had no segment work; and on the card the
    kernel launched once per in-scope segment of each set that runs it."""
    for m in sets:
        declined = [d for d in m.declines if d.startswith("arena:")]
        covered = (m.dispatch_count == 1 and m.arena_segments == m.segments
                   and m.graph_replays == int(on_card))
        idle = m.segments == 0 or m.compact_groups == 0
        if not (covered or declined or idle):
            raise AssertionError(f"{label}: neither replayed nor a recorded decline: {m.describe()}")
        if covered and declined:
            raise AssertionError(f"{label}: replayed and declined: {m.describe()}")
    want = sum(m.segments for m in sets if uses_kernel(m))
    if on_card and launches != want:
        raise AssertionError(f"{label}: {launches} kernel launches, want {want}")


def run_arena_queries(ctxs, workloads, warm=ARENA_WARM):
    """Every query of `arena_queries` with the arena on and off (SET
    arena_execution): after the engines' programs are dropped, a first run
    (eager, the warm-up), a second (the capture) and a third (a replay),
    bit-identical to each other, to every arena-off run and to the oracle;
    then `warm` runs each way, interleaved; then one profiled run with the
    arena on.
    Fails on a pass that neither replayed nor recorded an arena decline,
    and on the card where the kernel did not launch once per in-scope
    segment in a run, replays counted.  The CUBEs also run their sets
    through `Engine.execute_groupby_batch` against one after another,
    interleaved, bit-identical set by set.  One summary per query."""
    import pandas as pd

    for ctx in ctxs.values():
        ctx.engine._arena.clear()
    on_card = any(c.engine.device.type == "cuda" for c in ctxs.values())
    out = []
    for label, workload, kind, run, check in arena_queries(ctxs, workloads):
        ctx = ctxs[workload]
        engine = ctx.engine
        _set(ctx, "arena_execution", True)
        first, m_first = _with_set_metrics(engine, run)
        captured, capture_wall = _timed(lambda: _with_set_metrics(engine, run))
        captured, m_capture = captured
        before = cuda_groupby.LAUNCHES
        replayed, m_replay = _with_set_metrics(engine, run)
        launches = cuda_groupby.LAUNCHES - before
        for f in (captured, replayed):
            pd.testing.assert_frame_equal(first, f, check_exact=True)
        _arena_check(label, m_replay, launches, on_card)
        err = check(replayed)
        times = {"on": [], "off": []}
        off_launches = None
        for i in range(warm):
            for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
                _set(ctx, "arena_execution", side == "on")
                before = cuda_groupby.LAUNCHES
                (f, sets), ms = _timed(lambda: _with_set_metrics(engine, run))
                times[side].append(ms)
                pd.testing.assert_frame_equal(replayed, f, check_exact=True)
                if side == "off" and off_launches is None:
                    off_launches = cuda_groupby.LAUNCHES - before
                    m_off = sets
                    if any(m.graph_replays for m in sets):
                        raise AssertionError(f"{label}: a replay with the arena off")
        _set(ctx, "arena_execution", True)
        busy_on = _busy_ms(run)  # the arena-off side is not profiled: the time limit
        p50 = {k: statistics.median(v) for k, v in times.items()}
        row = {
            "query": label, "workload": workload, "kind": kind,
            "strategy": [m.strategy for m in m_replay], "sets": len(m_replay),
            "segments": sum(m.segments for m in m_replay),
            "dispatches_first": sum(m.dispatch_count for m in m_first),
            "dispatches_on": sum(m.dispatch_count for m in m_replay),
            "dispatches_off": sum(m.dispatch_count for m in m_off),
            "graph_captures": sum(m.graph_captures for m in m_capture),
            "graph_replays": sum(m.graph_replays for m in m_replay),
            "capture_ms": sum(m.capture_ms for m in m_capture),
            "capture_run_ms": capture_wall,
            "kernel_launches_on": launches, "kernel_launches_off": off_launches,
            "declines": sorted({d for m in m_replay for d in m.declines if d.startswith("arena:")}),
            "p50_on_ms": p50["on"], "p50_off_ms": p50["off"],
            "on_over_off": p50["on"] / p50["off"],
            "device_busy_on_ms": busy_on,
            "device_idle_share_on": None if busy_on is None else 1 - busy_on / p50["on"],
            "oracle_max_rel_err": err, "bit_identical_on_off": True,
        }
        if kind == "cube":
            row.update(_batch_against_serial(ctx, label, warm))
        out.append(row)
        emit("arena_query", **row)
    return out


def _batch_against_serial(ctx, label, warm):
    """A CUBE's sets through `execute_groupby_batch` (every set dispatched
    before any fetch) against the same sets run one after another,
    interleaved, arena on: p50 each way, frames bit-identical set by set."""
    import pandas as pd

    sql = CUBE_REVENUE if label == "cube_revenue" else ssb.SKETCH_QUERIES[label]
    rw = ctx.plan_sql(sql)
    ds = ctx.catalog.get(rw.datasource)
    subs = grouping_set_queries(rw.query, rw.grouping_sets)
    engine = ctx.engine
    ways = {"batch": lambda: engine.execute_groupby_batch(subs, ds),
            "serial": lambda: [engine.execute(q, ds) for q in subs]}
    times, frames = {"batch": [], "serial": []}, {}
    for i in range(warm):
        for way in (("batch", "serial") if i % 2 == 0 else ("serial", "batch")):
            got, ms = _timed(ways[way])
            times[way].append(ms)
            for a, b in zip(frames.setdefault("first", got), got):
                pd.testing.assert_frame_equal(a, b, check_exact=True)
    return {"batch_p50_ms": statistics.median(times["batch"]),
            "serial_p50_ms": statistics.median(times["serial"]),
            "batch_bit_identical_to_serial": True}


def run_cold_pipeline(ctx, workloads, runs=COLD_RUNS):
    """One cold SSB scope (`Engine.drop_residency` before every run) with
    the transfer pipeline on (copies from pinned host copies) and off
    (from the segments' pageable arrays), SET transfer_pipeline: first one
    run with the pipeline on and no pinned host copy (it pins each column
    as it copies it), then `runs` each way, interleaved, the pipeline's
    from the pinned copies: wall ms, h2d ms and bytes; frames
    bit-identical; then one profiled cold run each way: HtoD copy ms,
    kernel ms, the share of copy time that overlaps a kernel, and the
    device's busy and idle share of the p50."""
    import pandas as pd
    from torch.profiler import ProfilerActivity, profile

    ds, frame = workloads["ssb"]
    q = ssb.NATIVE_QUERIES[COLD_QUERY]
    engine = ctx.engine
    rows = {"on": [], "off": []}

    def cold():
        engine.drop_residency()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        return _timed(lambda: engine.execute(q, ds))

    _set(ctx, "transfer_pipeline", True)
    engine._pipeline.clear()  # no pinned copy yet
    first, pinning_ms = cold()
    m = engine.last_metrics
    pinning = {"wall_ms": pinning_ms, "h2d_ms": m.h2d_ms, "h2d_bytes": m.h2d_bytes,
               "pinned_bytes": engine._pipeline.to_dict()["pinned_bytes"]}
    for i in range(runs):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            _set(ctx, "transfer_pipeline", side == "on")
            df, ms = cold()
            m = engine.last_metrics
            pd.testing.assert_frame_equal(first, df, check_exact=True)
            rows[side].append({"wall_ms": ms, "h2d_ms": m.h2d_ms, "h2d_bytes": m.h2d_bytes})
    out = {"query": COLD_QUERY, "segments": engine.last_metrics.segments, "runs": runs,
           "first_run_pinning": pinning,
           "oracle_max_rel_err": check_against_oracle(COLD_QUERY, first, frame, "ssb")}
    for side, rs in rows.items():
        p50 = statistics.median(r["wall_ms"] for r in rs)
        out[side] = {"p50_ms": p50, "runs": rs}
        if engine.device.type != "cuda":
            continue
        _set(ctx, "transfer_pipeline", side == "on")
        for windows in range(1, PROFILE_TRIES + 1):
            engine.drop_residency()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                engine.execute(q, ds)
                torch.cuda.synchronize()
            copies, kernels, every, names = _profiled_intervals(prof)
            if copies and kernels:
                break
        out[side]["profiler_windows"] = windows
        out[side]["profile"] = (
            _overlap_summary(copies, kernels, every, p50, rs[0]["h2d_bytes"])
            if copies and kernels else None)
    _set(ctx, "transfer_pipeline", True)
    out["on_over_off"] = out["on"]["p50_ms"] / out["off"]["p50_ms"]
    on_card = engine.device.type == "cuda"
    if (on_card and pinning["pinned_bytes"] != pinning["h2d_bytes"]) or any(
            r["h2d_bytes"] != pinning["h2d_bytes"] for rs in rows.values() for r in rs):
        raise AssertionError("cold scope: the pipeline did not copy every column "
                             "once from a pinned copy")
    return out


# -- phase 10: the host fallback -----------------------------------------------

# warm runs of each extended query, assist on and off: the host-only ones
# take seconds each, and one keeps the run in its time limit
FALLBACK_WARM = 1


class AssistLog:
    """Records, per query, the engine's metrics of every `ctx.execute_rewrite`
    call (the device assist's Aggregate subtrees while `ctx.sql` interprets
    on the host), and the ms spent decoding segments."""

    def __init__(self, ctx):
        from spark_druid_olap_tpu_torch.exec import fallback

        self.subtrees, self.decode_ms = [], 0.0
        orig_rewrite, orig_decode = ctx.execute_rewrite, fallback.decoded_frame

        def rewrite(rw, *a, **k):
            out = orig_rewrite(rw, *a, **k)
            self.subtrees.append(ctx.engine.last_metrics)
            return out

        def decode(ds, columns=None):
            t0 = time.perf_counter()
            out = orig_decode(ds, columns)
            self.decode_ms += (time.perf_counter() - t0) * 1e3
            return out

        ctx.execute_rewrite = rewrite
        fallback.decoded_frame = decode
        self._undo = lambda: (delattr(ctx, "execute_rewrite"),
                              setattr(fallback, "decoded_frame", orig_decode))

    def reset(self):
        self.subtrees, self.decode_ms = [], 0.0

    def stop(self):
        self._undo()


def _extended_check(name, got, want, rtol=ORACLE_RTOL):
    """Keys and counts exact, floats within rtol, rows compared after
    sorting by the non-float columns (Q2's ties at a region's minimum
    order by the frame); returns the largest relative error."""
    if list(got.columns) != list(want.columns):
        raise AssertionError(f"{name}: columns {list(got.columns)}, want {list(want.columns)}")
    return _frame_check(name, got, want, [c for c in want.columns if want[c].dtype.kind != "f"],
                        rtol=rtol)


def run_fallback_queries(ctx, tables, frame, shapes=None, warm=FALLBACK_WARM):
    """`tpch.EXTENDED_QUERIES` through `ctx.sql` on the TPC-H context
    (lineitem resident since phase 4; `rawline` and `partsupp` registered
    here): every frame against its float64 oracle, bit-identical over two
    runs, and equal (keys and counts exact, sums within ORACLE_RTOL) to the
    same query with the assist off (`device_assist_min_rows` above every
    table's rows) where the assist ran (elsewhere that is the same path);
    `executor` "device" for q9 and "fallback" or "device+fallback" for the
    rest.  Per query: the executor, assists and declines, each assisted
    subtree's G and tier, kernel launches, the p50 of the warm runs with the
    assist on and one run with it off, decode ms (cold and warm),
    and device busy ms and idle share from one profiled run; with `shapes`
    (a started KernelShapes), the (G, Ms, Mn, Mx) of its launches."""
    import pandas as pd

    off_rows = max(ctx.catalog.get(t).num_rows for t in ctx.catalog.tables()) + 1
    default_rows = ctx.config.device_assist_min_rows
    log = AssistLog(ctx)
    out = []
    try:
        for name, sql in tpch.EXTENDED_QUERIES.items():
            t0 = time.perf_counter()
            want = tpch.extended_oracle(tables, name, frame)
            oracle_s = time.perf_counter() - t0
            log.reset()
            before = cuda_groupby.LAUNCHES
            seen = dict(shapes.seen) if shapes is not None else {}
            t0 = time.perf_counter()
            first = ctx.sql(sql)
            cold_ms = (time.perf_counter() - t0) * 1e3
            m = ctx.last_metrics
            subtrees, cold_decode_ms = log.subtrees, log.decode_ms
            log.reset()
            on_ms = []
            for i in range(warm):
                t1 = time.perf_counter()
                again = ctx.sql(sql)
                on_ms.append((time.perf_counter() - t1) * 1e3)
                if i == 0:  # the first warm run holds the cold run's bits
                    pd.testing.assert_frame_equal(first, again, check_exact=True)
            warm_decode_ms = log.decode_ms / warm
            launches = cuda_groupby.LAUNCHES - before
            launched = sorted(str(k) for k, v in (shapes.seen if shapes else {}).items()
                              if v > seen.get(k, 0))
            want_exec = ("device",) if name == "q9" else ("fallback", "device+fallback")
            if m.executor not in want_exec:
                raise AssertionError(f"{name}: executor {m.executor}, want {want_exec}")
            err = _extended_check(name, first, want)
            # a query that launched nothing ran no device work to profile
            busy = sum(profiled_device_ms(
                lambda: ctx.sql(sql), allow_empty=m.executor == "fallback").values()
            ) if launches else 0.0
            p50 = statistics.median(on_ms)
            off_ms, off_exec = [p50], m.executor  # no assist ran: the same path
            if m.assist_subplans:
                ctx.sql(f"SET device_assist_min_rows = {off_rows}")
                try:
                    t1 = time.perf_counter()
                    off = ctx.sql(sql)
                    off_ms = [(time.perf_counter() - t1) * 1e3]
                    off_m = ctx.last_metrics
                finally:
                    ctx.sql(f"SET device_assist_min_rows = {default_rows}")
                if off_m.assist_subplans:
                    raise AssertionError(
                        f"{name}: the assist ran with device_assist_min_rows {off_rows}")
                _extended_check(f"{name} (assist off)", off, first)
                off_exec = off_m.executor
            out.append({
                "query": name, "executor": m.executor, "assist_subplans": m.assist_subplans,
                "declines": m.declines if m.executor != "device" else [],
                # the engine runs of the query: q9's own, or the assist's
                "engine_runs": [{"num_groups": a.num_groups, "strategy": a.strategy,
                                 "compact_groups": a.compact_groups,
                                 "inner_strategy": a.inner_strategy,
                                 "sparse_slots": a.sparse_slots, "segments": a.segments,
                                 "rows_scanned": a.rows_scanned} for a in subtrees],
                "rows_scanned": m.rows_scanned, "result_rows": len(first), "cold_ms": cold_ms,
                "p50_ms": p50, "assist_off_p50_ms": statistics.median(off_ms),
                "assist_off_executor": off_exec, "assist_off_ran": bool(m.assist_subplans),
                "kernel_launches": launches,
                "kernel_shapes": launched,
                "decode_cold_ms": cold_decode_ms, "decode_warm_ms": warm_decode_ms,
                "device_busy_ms": busy, "device_idle_share": 1 - busy / p50,
                "oracle_max_rel_err": err, "oracle_seconds": oracle_s,
                "bit_identical": True, "equal_assist_off": True,
            })
            emit("fallback_query", **out[-1])
    finally:
        log.stop()
    if ctx.engine.device.type == "cuda" and not any(
        q["kernel_launches"] for q in out if q["assist_subplans"]
    ):
        raise AssertionError("no assisted fallback query launched the kernel")
    return out


# -- phase 11: the Druid-native surface ----------------------------------------

NATIVE_WARM = 2  # warm runs of each wire query (3 until phase 18)
# q1.1's fact predicate, the filter of every scan and of one search
FACT_WHERE = "lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"
FACT_FILTER = {"type": "and", "fields": [
    {"type": "bound", "dimension": "lo_discount", "lower": "1", "upper": "3",
     "ordering": "numeric"},
    {"type": "bound", "dimension": "lo_quantity", "upper": "25", "upperStrict": True,
     "ordering": "numeric"}]}
SCAN_MONTH = ["1994-03-01T00:00:00.000Z/1994-04-01T00:00:00.000Z"]


def _spec_json(q) -> str:
    return json.dumps(q.to_druid(), sort_keys=True, default=str)


def _wire_run(ctx, body: dict):
    """A Druid JSON body through the port as a server would run it: decode,
    the engine (a subtotalsSpec through `execute_grouping_sets`, its
    `__grouping_id` dropped), the response envelope.  Returns (spec, frame,
    response)."""
    q = wire.query_from_druid(json.loads(json.dumps(body)))
    ds = ctx.catalog.get(q.datasource)
    if isinstance(q, Q.GroupByQuery) and q.subtotals:
        df = execute_grouping_sets(dataclasses.replace(q, subtotals=()), q.subtotals, ds,
                                   ctx.engine).drop(columns=["__grouping_id"])
    else:
        df = ctx.engine.execute(q, ds)
    return q, df, wire.druid_result_shape(q, df)


def _wire_p50(ctx, body: dict, warm: int) -> float:
    return _median_ms(lambda: _wire_run(ctx, body), warm)


def _fact_mask(frame):
    return ((frame.lo_discount >= 1) & (frame.lo_discount <= 3)
            & (frame.lo_quantity < 25)).to_numpy()


def _rows_equal(name, got, want) -> None:
    """Rows and their order equal: values exact, dictionary columns as
    strings."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        raise AssertionError(f"{name}: {list(got.columns)} x {len(got)} rows, "
                             f"oracle {list(want.columns)} x {len(want)}")
    for c in want.columns:
        g, w = np.asarray(got[c]), want[c]
        w = np.asarray(w.astype(object) if w.dtype.name == "category" else w)
        if w.dtype.kind == "f":
            ok = np.array_equal(g.astype(np.float64), w)
        else:
            ok = list(g) == list(w)
        if not ok:
            raise AssertionError(f"{name}: column {c} differs from the oracle")


def wire_aggregates(ctxs, workloads, warm):
    """The wire form of every main-path query and of phase 7's topn_hll:
    the decoded spec prints the original's JSON, and its frame is
    bit-identical to the native frame."""
    import pandas as pd

    cases = [(w, n, q) for w, n, q in main_path_queries()]
    topn_hll = ctxs["ssb"].plan_sql(ssb.SKETCH_QUERIES["topn_hll"]).query
    cases.append(("ssb", "topn_hll", topn_hll))
    out = []
    for workload, name, q in cases:
        ctx = ctxs[workload]
        want = NATIVE_FRAMES.get((workload, name))
        if want is None:
            want = ctx.engine.execute(q, workloads[workload][0])
        body = json.loads(json.dumps(q.to_druid(), default=str))
        dq, df, shaped = _wire_run(ctx, body)
        if _spec_json(dq) != _spec_json(q):
            raise AssertionError(f"{name}: the decoded spec differs from the original")
        pd.testing.assert_frame_equal(df, want, check_exact=True)
        out.append({"query": f"wire:{name}", "p50_ms": _wire_p50(ctx, body, warm),
                    "result_rows": len(df), "response_bytes": len(json.dumps(shaped)),
                    "bit_identical_to_native": True})
        emit("native_query", **out[-1])
    return out


def wire_subtotals(ctx, warm):
    """phase 9's cube_revenue CUBE as a wire subtotalsSpec: the frame of
    `execute_grouping_sets` on the same sets."""
    import pandas as pd

    rw = ctx.plan_sql(CUBE_REVENUE)
    q = dataclasses.replace(rw.query, subtotals=rw.grouping_sets)
    body = q.to_druid()
    if "subtotalsSpec" not in body:
        raise AssertionError("cube_revenue: the wire form carries no subtotalsSpec")
    _, df, _ = _wire_run(ctx, body)
    want = execute_grouping_sets(rw.query, rw.grouping_sets, ctx.catalog.get(rw.datasource),
                                 ctx.engine).drop(columns=["__grouping_id"])
    pd.testing.assert_frame_equal(df, want, check_exact=True)
    row = {"query": "wire:cube_revenue_subtotals", "p50_ms": _wire_p50(ctx, body, warm),
           "sets": len(rw.grouping_sets), "result_rows": len(df),
           "equals_grouping_sets": True}
    emit("native_query", **row)
    return row


def wire_expression_post(ctx, frame, warm):
    """A GroupBy with having, limitSpec and an expression post-aggregator
    against its float64 oracle (keys and counts exact, sums and the ratio
    within ORACLE_RTOL; the top 10 tie-aware)."""
    f = frame[["c_region", "d_year", "lo_revenue"]]
    g = f.groupby(["c_region", "d_year"], observed=True).agg(
        revenue=("lo_revenue", "sum"), n=("lo_revenue", "size")).reset_index()
    r = np.sort(g.revenue.to_numpy())
    cut = (r[len(r) // 3 - 1] + r[len(r) // 3]) / 2  # between two groups
    g = g[g.revenue > cut].assign(avg_revenue=lambda x: x.revenue / x.n)
    g = g.sort_values("avg_revenue", ascending=False, kind="stable")
    body = {
        "queryType": "groupBy", "dataSource": "lineorder", "granularity": "all",
        "dimensions": ["c_region", "d_year"],
        "aggregations": [{"type": "doubleSum", "name": "revenue", "fieldName": "lo_revenue"},
                         {"type": "count", "name": "n"}],
        "postAggregations": [{"type": "expression", "name": "avg_revenue",
                              "expression": "revenue / n"}],
        "having": {"type": "greaterThan", "aggregation": "revenue", "value": float(cut)},
        "limitSpec": {"type": "default", "limit": 10,
                      "columns": [{"dimension": "avg_revenue", "direction": "descending"}]},
    }
    _, df, _ = _wire_run(ctx, body)
    if len(df) != 10 or list(df.columns) != ["c_region", "d_year", "revenue", "n", "avg_revenue"]:
        raise AssertionError(f"expression_post: {list(df.columns)} x {len(df)} rows")
    avg = df.avg_revenue.to_numpy(np.float64)
    if (np.diff(avg) > 0).any():
        raise AssertionError("expression_post: not ordered by avg_revenue")
    want = {(str(k), int(y)): (rev, n, a) for k, y, rev, n, a in g.itertuples(index=False)}
    worst = 0.0
    for k, y, rev, n, a in df.itertuples(index=False):
        wrev, wn, wa = want[(str(k), int(y))]
        errs = [abs(rev - wrev) / wrev, abs(a - wa) / wa]
        if int(n) != wn or max(errs) > ORACLE_RTOL:
            raise AssertionError(f"expression_post: {(k, y)} {(rev, n, a)} vs {(wrev, wn, wa)}")
        worst = max(worst, *errs)
    left_out = g.avg_revenue.to_numpy()[10:]
    if len(left_out) and left_out.max() > avg[-1] * (1 + ORACLE_RTOL):
        raise AssertionError("expression_post: a group above the cut was left out")
    row = {"query": "wire:expression_post", "p50_ms": _wire_p50(ctx, body, warm),
           "groups_after_having": len(g), "oracle_max_rel_err": worst}
    emit("native_query", **row)
    return row


def native_scans(ctx, frame, warm):
    """Scans over lineorder's own columns under q1.1's fact predicate: an
    unordered drill-through, an ordered top-100 over every segment, and a
    wire compactedList Scan over one month.  Rows and their order equal a
    stable pandas sort of the host frame filtered in segment order."""
    keep = _fact_mask(frame)
    cols3 = ["lo_orderdate", "lo_extendedprice", "lo_discount"]
    sel = frame.loc[keep, cols3]
    lo, hi = (int(np.datetime64(s.rstrip("Z"), "ms").astype(np.int64))
              for s in SCAN_MONTH[0].split("/"))
    month_cols = ["lo_orderdate", "lo_extendedprice", "c_city"]
    in_month = keep & (frame.lo_orderdate.to_numpy() >= lo) & (frame.lo_orderdate.to_numpy() < hi)
    cases = {
        "drill_through": (
            lambda: ctx.sql(f"SELECT {', '.join(cols3)} FROM lineorder WHERE {FACT_WHERE} "
                            "LIMIT 1000"),
            sel.head(1000)),
        "ordered_top100": (
            lambda: ctx.sql(f"SELECT {', '.join(cols3)} FROM lineorder WHERE {FACT_WHERE} "
                            "ORDER BY lo_extendedprice DESC LIMIT 100"),
            sel.sort_values("lo_extendedprice", ascending=False, kind="stable").head(100)),
        "month_compacted": (
            lambda: _wire_run(ctx, {
                "queryType": "scan", "dataSource": "lineorder", "columns": month_cols,
                "intervals": SCAN_MONTH, "filter": FACT_FILTER,
                "resultFormat": "compactedList"})[1],
            frame.loc[in_month, month_cols]),
    }
    out = []
    for name, (run, want) in cases.items():
        got = run()
        m = ctx.engine.last_metrics
        if m.query_type != "scan":
            raise AssertionError(f"{name}: ran {m.query_type}, not a scan")
        _rows_equal(name, got, want.reset_index(drop=True))
        p50 = _median_ms(run, warm)
        out.append({"query": f"scan:{name}", "p50_ms": p50, "result_rows": len(got),
                    "segments": m.segments, "rows_scanned": m.rows_scanned,
                    "rows_per_s": m.rows_scanned / (p50 / 1e3), "d2h_bytes": m.d2h_bytes,
                    "h2d_bytes": m.h2d_bytes, "rows_equal_oracle": True})
        emit("native_query", **out[-1])
    return out


def native_searches(ctx, frame, warm):
    """Searches over the flattened SSB datasource (c_city, s_city) for
    "united", with no filter and under q1.1's fact predicate: the counts
    equal a bincount of the host frame's codes."""
    ds = ctx.catalog.get("lineorder")
    keep = _fact_mask(frame)
    out = []
    for name, filt in (("united", None), ("united_fact_predicate", FACT_FILTER)):
        body = {"queryType": "search", "dataSource": "lineorder",
                "searchDimensions": ["c_city", "s_city"],
                "query": {"type": "insensitive_contains", "value": "united"}}
        if filt is not None:
            body["filter"] = filt
        _, got, _ = _wire_run(ctx, body)
        want = []
        for dim in ("c_city", "s_city"):
            values = ds.dicts[dim].values
            codes = frame[dim].cat.codes.to_numpy()
            if filt is not None:
                codes = codes[keep]
            counts = np.bincount(codes[codes >= 0], minlength=len(values))
            want += [(dim, v, int(counts[c])) for c, v in enumerate(values)
                     if "united" in str(v).lower() and counts[c]]
        if list(zip(got.dimension, got.value, got["count"])) != want or not want:
            raise AssertionError(f"search {name}: counts differ from the bincount oracle")
        m = ctx.engine.last_metrics
        p50 = _wire_p50(ctx, body, warm)
        out.append({"query": f"search:{name}", "p50_ms": p50, "result_rows": len(got),
                    "segments": m.segments, "rows_per_s": m.rows_scanned / (p50 / 1e3),
                    "counts_equal_bincount": True})
        emit("native_query", **out[-1])
    return out


def native_metadata(ctxs, workloads):
    """TimeBoundary, DataSourceMetadata and SegmentMetadata of both
    datasources against the segments' own metadata."""
    out = []
    for workload in ("ssb", "tpch"):
        ds = workloads[workload][0]
        ctx = ctxs[workload]
        lo, hi = ds.interval()
        for body, check in (
            ({"queryType": "timeBoundary"},
             lambda r: r[0]["result"] == {"minTime": _iso(lo), "maxTime": _iso(hi)}),
            ({"queryType": "dataSourceMetadata"},
             lambda r: r[0]["result"] == {"maxIngestedEventTime": _iso(hi)}),
            ({"queryType": "segmentMetadata"},
             lambda r: len(r) == len(ds.segments)
             and sum(x["numRows"] for x in r) == ds.num_rows),
        ):
            body = dict(body, dataSource=ds.name)
            launches = cuda_groupby.LAUNCHES
            _, _, shaped = _wire_run(ctx, body)
            if not check(shaped) or cuda_groupby.LAUNCHES != launches:
                raise AssertionError(f"{workload} {body['queryType']}: {shaped[:1]}")
            out.append({"query": f"{body['queryType']} ({workload})",
                        "p50_ms": _wire_p50(ctx, body, NATIVE_WARM)})
            emit("native_query", **out[-1])
    return out


def _iso(ms) -> str:
    return wire._jsonable(np.datetime64(int(ms), "ms"))


def native_lookup(ctx, dims, warm):
    """GROUP BY LOOKUP(c_nation, 'n2r') over the joined customer, the map
    taken from the customer table, against GROUP BY c_region: keys and
    counts exact, sums within rtol 1e-6."""
    cust = dims["customer"]
    ctx.register_lookup("n2r", dict(zip(cust["c_nation"], cust["c_region"])))
    sql = ("SELECT LOOKUP(c_nation, 'n2r') AS region, count(*) AS n, "
           "sum(lo_revenue) AS revenue FROM lineorder JOIN customer "
           "ON lo_custkey = c_custkey GROUP BY LOOKUP(c_nation, 'n2r')")
    ref_sql = ("SELECT c_region AS region, count(*) AS n, sum(lo_revenue) AS revenue "
               "FROM lineorder GROUP BY c_region")
    got = ctx.sql(sql).sort_values("region").reset_index(drop=True)
    want = ctx.sql(ref_sql).sort_values("region").reset_index(drop=True)
    if list(got.region) != list(want.region) or list(got.n) != list(want.n):
        raise AssertionError("lookup: keys or counts differ from GROUP BY c_region")
    g, w = got.revenue.to_numpy(np.float64), want.revenue.to_numpy(np.float64)
    if not (np.abs(g - w) <= 1e-6 * np.abs(w)).all():
        raise AssertionError("lookup: sums differ from GROUP BY c_region")
    row = {"query": "sql:lookup_n2r", "p50_ms": _median_ms(lambda: ctx.sql(sql), warm),
           "groups": len(got), "sums_bit_equal": bool(np.array_equal(g, w)),
           "max_rel_err": float((np.abs(g - w) / np.abs(w)).max())}
    emit("native_query", **row)
    return row


def native_table_queries(ctx, warm):
    """q1.1 and q2.1 written as TableQuery chains: each frame bit-identical
    to `ctx.sql` of the same query."""
    import pandas as pd

    t = ctx.table("lineorder")
    chains = {
        "q1_1": t.where(col("d_year").eq(1993) & (col("lo_discount") >= 1)
                        & (col("lo_discount") <= 3) & (col("lo_quantity") < 25))
                 .agg(revenue=("sum", col("lo_extendedprice") * col("lo_discount"))),
        "q2_1": t.where(col("p_category").eq("MFGR#12") & col("s_region").eq("AMERICA"))
                 .group_by("d_year", "p_brand1").agg(revenue=("sum", "lo_revenue"))
                 .order_by("d_year").order_by("p_brand1"),
    }
    out = []
    for name, chain in chains.items():
        want = ctx.sql(ssb.QUERIES[name])
        got = chain.collect()
        pd.testing.assert_frame_equal(got[list(want.columns)], want, check_exact=True)
        out.append({"query": f"table:{name}", "p50_ms": _median_ms(chain.collect, warm),
                    "result_rows": len(got), "bit_identical_to_sql": True})
        emit("native_query", **out[-1])
    return out


def native_degraded(ctx):
    """`execute_native_degraded` on TPC-H Q1's wire spec and on one Scan,
    with the device assist off, so the host interpreter answers: the host
    frames against the device frames (keys exact, sums within ORACLE_RTOL;
    the scan's rows exact)."""
    ds = ctx.catalog.get("lineitem")
    off_rows = max(ctx.catalog.get(t).num_rows for t in ctx.catalog.tables()) + 1
    default_rows = ctx.config.device_assist_min_rows
    scan = {"queryType": "scan", "dataSource": "lineitem",
            "columns": ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice"],
            "filter": {"type": "bound", "dimension": "l_quantity", "lower": "49",
                       "lowerStrict": True, "ordering": "numeric"},
            "orderBy": [{"columnName": "l_extendedprice", "order": "descending"}],
            "limit": 100}
    out = []
    for name, body in (("q1", tpch.NATIVE_QUERIES["q1"].to_druid()), ("scan", scan)):
        q = wire.query_from_druid(json.loads(json.dumps(body, default=str)))
        device = ctx.engine.execute(q, ds)
        ctx.sql(f"SET device_assist_min_rows = {off_rows}")
        try:
            t0 = time.perf_counter()
            with WATCH.requested():  # degraded because it was asked for
                host = ctx.execute_native_degraded(q)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ctx.sql(f"SET device_assist_min_rows = {default_rows}")
        if ctx.last_metrics.executor != "fallback":
            raise AssertionError(f"degraded {name}: executor {ctx.last_metrics.executor}")
        host = host[list(device.columns)]
        if name == "scan":
            _rows_equal("degraded scan", host, device)
            err = 0.0
        else:
            keys = [c for c in device.columns if device[c].dtype.kind not in "f"]
            err = _frame_check("degraded q1", host, device, keys)
        out.append({"query": f"degraded:{name}", "ms": ms, "result_rows": len(host),
                    "max_rel_err_to_device": err})
        emit("native_query", **out[-1])
    return out


def run_native_surface(ctxs, workloads, warm=NATIVE_WARM):
    """Phase 11: the Druid-native surface on the SSB and TPC-H contexts
    (the resident data of phases 4 to 10).  Returns the rows emitted."""
    frame = workloads["ssb"][1]
    rows = wire_aggregates(ctxs, workloads, warm)
    rows.append(wire_subtotals(ctxs["ssb"], warm))
    rows.append(wire_expression_post(ctxs["ssb"], frame, warm))
    rows += native_scans(ctxs["ssb"], frame, warm)
    rows += native_searches(ctxs["ssb"], frame, warm)
    rows += native_metadata(ctxs, workloads)
    rows.append(native_lookup(ctxs["ssb"], workloads["dims"]["ssb"], warm))
    rows += native_table_queries(ctxs["ssb"], warm)
    rows += native_degraded(ctxs["tpch"])
    return rows


# -- phase 12: resilience ----------------------------------------------------------

RESILIENCE_PAIRS = 1  # pairs, deadline off and armed, per arena query (2 until phase 15 came)
ARMED_TIMEOUT_MS = 60_000  # armed, never expiring
SWEEP_QUERIES = {  # the columns each query's oracle reads (every oracle reads the last two)
    "q4_1": ("c_region", "s_region", "p_mfgr", "d_year", "c_nation", "lo_revenue",
             "lo_supplycost", "lo_quantity", "lo_discount"),
    "q3_1": ("c_region", "s_region", "d_year", "c_nation", "s_nation", "lo_revenue",
             "lo_quantity", "lo_discount"),
}


def clean_errors(m: QueryMetrics) -> list:
    """What a query's metrics say went wrong on the way to its answer:
    retries, a degraded answer, a partial one, an expired deadline."""
    return [f for f, bad in (("retries", m.retries), ("degraded", m.degraded),
                             ("partial", m.partial),
                             ("deadline_exceeded", m.deadline_exceeded)) if bad]


def check_clean(name: str, m: QueryMetrics) -> None:
    """A query answered on its own path: no retry, not degraded to the
    host, not partial, no expired deadline."""
    bad = clean_errors(m)
    if bad:
        raise AssertionError(f"{name}: {bad}: {m.describe()}")


class MetricsWatch:
    """Nothing degraded unseen: every QueryMetrics that an engine publishes
    (`Engine._finish_metrics`) or the host fallback builds
    (`TPUOlapContext._run_fallback`) between two `check`s is held by
    `check_clean` at the second, after the retry policy and the API have
    stamped it.  Inside `requested()` the caller asked for a degraded
    answer (`execute_native_degraded`): degraded must be set and nothing
    else."""

    def __init__(self):
        self.seen, self.requested_seen = [], []
        self._requested = False
        self._orig = None

    def install(self):
        watch = self
        finish, run_fallback = Engine._finish_metrics, TPUOlapContext._run_fallback

        def finish_metrics(engine, m, *outcome):
            finish(engine, m, *outcome)
            (watch.requested_seen if watch._requested else watch.seen).append(m)

        def fallback(ctx, *a, **k):
            df = run_fallback(ctx, *a, **k)
            (watch.requested_seen if watch._requested else watch.seen).append(ctx.last_metrics)
            return df

        Engine._finish_metrics, TPUOlapContext._run_fallback = finish_metrics, fallback
        self._orig = (finish, run_fallback)
        return self

    def uninstall(self):
        Engine._finish_metrics, TPUOlapContext._run_fallback = self._orig

    @contextlib.contextmanager
    def requested(self):
        self._requested = True
        try:
            yield
        finally:
            self._requested = False

    def check(self, phase: str) -> int:
        seen, requested = self.seen, self.requested_seen
        self.seen, self.requested_seen = [], []
        for i, m in enumerate(seen):
            check_clean(f"{phase} query {i}", m)
        for m in requested:
            if clean_errors(m) != ["degraded"]:
                raise AssertionError(f"{phase}: a requested degraded answer: {m.describe()}")
        emit("clean_check", of=phase, queries=len(seen), requested_degraded=len(requested))
        return len(seen)


WATCH = MetricsWatch()


def _arm(site, **kw):
    resilience.injector().arm(site, **kw)


def _disarm():
    resilience.injector().disarm()


def segments_frame(ds, segs, names):
    """The real rows of `segs` (in segment order) as an oracle frame over
    `names`: dimensions as their values (categoricals over the dictionary),
    metrics as float64."""
    import pandas as pd

    data = {}
    for n in names:
        parts = [np.asarray(s.column(n))[np.asarray(s.valid)] for s in segs]
        codes = np.concatenate(parts) if parts else np.asarray(ds.segments[0].column(n))[:0]
        d = ds.dicts.get(n)
        if d is None:
            data[n] = codes.astype(np.float64)
        elif d.numeric_values is not None:
            data[n] = np.asarray(d.numeric_values)[codes]
        else:
            data[n] = pd.Categorical.from_codes(codes, categories=list(d.values))
    return pd.DataFrame(data)


def _partial_oracle_check(name, got, sub):
    """`got` against the float64 oracle of SSB query `name` over `sub`."""
    want = ssb.oracle(sub, name)
    keys = [c for c in want.columns if c not in ("revenue", "profit")]
    want = want.assign(**{c: want[c].astype(object) for c in keys})
    return _frame_check(name, got[list(want.columns)], want, keys)


def deadline_sweep(ctx, name):
    """SSB `name` through `ctx.sql` with an injected deadline at the K-th
    checkpoint of the segment loop (`engine.segment_loop`, skip=K) for K in
    {0, 1, half the scope, scope - 1}, the arena on (chunked replays) and
    off (the loop): the coverage is the covered rows over the in-scope rows
    exactly, the frames are bit-identical on and off and equal the float64
    oracle over the first K in-scope segments, and partial below the scope."""
    import pandas as pd

    sql = ssb.QUERIES[name]
    rw = ctx.plan_sql(sql)
    ds = ctx.catalog.get(rw.datasource)
    segs = segments_in_scope(groupby_with_time_granularity(rw.query), ds)
    n = len(segs)
    rows_total = sum(s.num_rows for s in segs)
    out = []
    for k in sorted({0, 1, n // 2, n - 1}):
        frames, ms = {}, {}
        for on in (True, False):
            _set(ctx, "arena_execution", on)
            _arm("engine.segment_loop", error_type=resilience.InjectedDeadline, skip=k, times=1)
            try:
                frames[on], ms[on] = _timed(lambda: ctx.sql(sql))
            finally:
                _disarm()
            m = ctx.last_metrics
            seen = sum(s.num_rows for s in segs[:k])
            attrs = frames[on].attrs
            if (attrs.get("rows_seen"), attrs.get("rows_total")) != (seen, rows_total):
                raise AssertionError(f"sweep {name} K={k}: rows {attrs.get('rows_seen')}/"
                                     f"{attrs.get('rows_total')}, want {seen}/{rows_total}")
            if attrs["coverage"] != round(seen / rows_total, 6) or m.coverage != attrs["coverage"]:
                raise AssertionError(f"sweep {name} K={k}: coverage {attrs['coverage']}")
            if not (m.partial and attrs["partial"]) or m.degraded or m.retries:
                raise AssertionError(f"sweep {name} K={k}: {m.describe()}")
            if on and m.arena_segments != k:
                raise AssertionError(f"sweep {name} K={k}: {m.arena_segments} chunked replays")
        _set(ctx, "arena_execution", True)
        pd.testing.assert_frame_equal(frames[True], frames[False], check_exact=True)
        err = _partial_oracle_check(name, frames[True],
                                    segments_frame(ds, segs[:k], SWEEP_QUERIES[name]))
        out.append({"query": name, "k": k, "segments": n, "coverage": frames[True].attrs["coverage"],
                    "result_rows": len(frames[True]), "chunked_ms": ms[True], "loop_ms": ms[False],
                    "strategy": m.strategy, "oracle_max_rel_err": err,
                    "bit_identical_on_off": True})
        emit("resilience_sweep", **out[-1])
    return out


def _p50(fn, n):
    return statistics.median(_timed(fn)[1] for _ in range(n))


def wall_deadline(ctx, label, run, warm=3, p50=None):
    """`run()` (a `ctx.sql`) warm p50 unarmed (or `p50`, an earlier phase's
    warm p50 of the same query), then once with `query_timeout_ms` about
    half of it: the wall, the overshoot past the timeout (queued device work
    and the finalize) and the coverage.  Fails if the overshoot exceeds the
    p50: no checkpoint was reached."""
    p50 = _p50(run, warm) if p50 is None else p50
    timeout = max(1, int(p50 / 2))
    ctx.sql(f"SET query_timeout_ms = {timeout}")
    try:
        df, wall = _timed(run)
    finally:
        ctx.sql("SET query_timeout_ms = 0")
    m = ctx.last_metrics
    row = {"query": label, "p50_ms": p50, "timeout_ms": timeout, "wall_ms": wall,
           "overshoot_ms": wall - timeout, "partial": bool(df.attrs.get("partial")),
           "coverage": df.attrs.get("coverage", 1.0), "rows_seen": df.attrs.get("rows_seen"),
           "site": df.attrs.get("site"), "executor": m.executor, "result_rows": len(df)}
    emit("resilience_wall_deadline", **row)
    if wall - timeout > p50:
        raise AssertionError(f"{label}: overshoot {wall - timeout} ms past a p50 of {p50} ms")
    return row


def armed_deadline_cost(ctxs, workloads, pairs=RESILIENCE_PAIRS):
    """Phase 9's arena-on queries with no deadline and with one armed that
    never expires (60 s; `query_timeout_ms` for SQL, the same
    `deadline_scope` around a native spec): a first armed run (it captures
    the chunk graphs), then `pairs` interleaved pairs.  Frames bit-identical
    both ways; p50 each way and their ratio."""
    import pandas as pd

    out = []
    for label, workload, kind, run, _check in arena_queries(ctxs, workloads):
        ctx = ctxs[workload]

        def armed(run=run, ctx=ctx):
            ctx.sql(f"SET query_timeout_ms = {ARMED_TIMEOUT_MS}")
            try:
                with resilience.deadline_scope(ARMED_TIMEOUT_MS):
                    return run()
            finally:
                ctx.sql("SET query_timeout_ms = 0")

        # the first armed run is the base every later run must equal
        base, first_ms = _timed(armed)
        m_first = ctx.last_metrics
        times = {"off": [], "armed": []}
        for i in range(pairs):
            for side in (("off", "armed") if i % 2 == 0 else ("armed", "off")):
                f, ms = _timed(run if side == "off" else armed)
                times[side].append(ms)
                pd.testing.assert_frame_equal(f, base, check_exact=True)
                check_clean(label, ctx.last_metrics)
        m = ctx.last_metrics
        p50 = {k: statistics.median(v) for k, v in times.items()}
        out.append({"query": label, "kind": kind, "p50_off_ms": p50["off"],
                    "p50_armed_ms": p50["armed"], "armed_over_off": p50["armed"] / p50["off"],
                    "first_armed_ms": first_ms, "chunk_captures": m_first.graph_captures,
                    "dispatches_armed": m.dispatch_count, "arena_segments_armed": m.arena_segments,
                    "segments": m.segments, "bit_identical": True})
        emit("resilience_armed_cost", **out[-1])
    return out


def retries_on_warm_graph(ctx):
    """SSB q4.1 with its graph warm; `device_dispatch` armed once with an
    injected fault, then with a CUDA out-of-memory error: one retry, not
    degraded, the clean frame's bits; the eviction dropped the graph and
    the columns, so the retry ran the loop over fresh copies."""
    import pandas as pd

    sql = ssb.QUERIES["q4_1"]
    _set(ctx, "arena_execution", True)
    out = []
    for err in (resilience.InjectedFault, torch.cuda.OutOfMemoryError):
        for _ in range(2):  # warm: the scope's graph captured and replayed
            ctx.sql(sql)
        clean = ctx.sql(sql)
        m = ctx.last_metrics
        on_card = ctx.engine.device.type == "cuda"
        if (m.dispatch_count, m.graph_replays) != (1, int(on_card)):
            raise AssertionError(f"retry: no warm graph: {m.describe()}")
        clean_ms = _p50(lambda: ctx.sql(sql), 3)
        _arm("device_dispatch", times=1, error_type=err)
        try:
            got, wall = _timed(lambda: ctx.sql(sql))
        finally:
            _disarm()
        m = ctx.last_metrics
        pd.testing.assert_frame_equal(got, clean, check_exact=True)
        if (m.retries, m.degraded, m.graph_replays, m.arena_segments) != (1, False, 0, 0) or (
                m.h2d_bytes == 0):
            raise AssertionError(f"retry {err.__name__}: {m.describe()}")
        out.append({"error": err.__name__, "retry_wall_ms": wall, "clean_p50_ms": clean_ms,
                    "retries": m.retries, "h2d_bytes_reloaded": m.h2d_bytes,
                    "bit_identical": True})
        emit("resilience_retry", **out[-1])
    return out


def breaker_cycle(tctx, sctx, frame):
    """TPC-H SF1 Q1 with `device_dispatch` armed on every call: the first
    query degrades to the host fallback (its frame against the oracle),
    the breaker opens on the second, the third routes straight to the host
    (the cooldown is 60 s meanwhile: a degraded query outlasts the default
    2 s); disarmed, the cooldown set to 500 ms and waited out, a half-open
    probe on the card closes it with the clean frame's bits.  At SSB SF10
    the degraded route raises
    FallbackSizeError (60M rows > fallback_max_rows)."""
    import pandas as pd

    from spark_druid_olap_tpu_torch.exec.fallback import FallbackSizeError

    sql = tpch.QUERIES["q1"]
    clean = tctx.sql(sql)
    card_p50 = _p50(lambda: tctx.sql(sql), 3)
    br = tctx.resilience.breaker
    tctx.sql("SET breaker_cooldown_ms = 60000")
    degraded, states = [], []
    _arm("device_dispatch")
    try:
        for i in range(3):
            df, ms = _timed(lambda: tctx.sql(sql))
            m = tctx.last_metrics
            degraded.append(ms)
            states.append(m.circuit_state)
            want_class = "InjectedFault" if i < 2 else None
            if not m.degraded or m.executor != "fallback" or m.error_class != want_class:
                raise AssertionError(f"breaker run {i}: {m.describe()}")
            check_against_oracle("q1", df, frame, "tpch")
        if states != ["closed", "open", "open"] or br.state != "open":
            raise AssertionError(f"breaker states {states}, now {br.state}")
    finally:
        _disarm()
    tctx.sql("SET breaker_cooldown_ms = 500")
    time.sleep(0.6)  # the cooldown
    if br.state != "half_open":
        raise AssertionError(f"after the cooldown the breaker is {br.state}")
    probe = tctx.sql(sql)
    m = tctx.last_metrics
    tctx.sql("SET breaker_cooldown_ms = 2000")
    pd.testing.assert_frame_equal(probe, clean, check_exact=True)
    if br.state != "closed" or m.degraded or m.executor != "device":
        raise AssertionError(f"half-open probe: {br.state}: {m.describe()}")
    _arm("device_dispatch")
    try:
        tctx_ssb = sctx.sql  # the degraded route at SF10 refuses its 60M rows
        try:
            tctx_ssb(ssb.QUERIES["q4_1"])
        except FallbackSizeError as e:
            size_error = str(e).split(".")[0]
        else:
            raise AssertionError("SF10 degraded route answered")
    finally:
        _disarm()
    sctx.sql(ssb.QUERIES["q4_1"])  # a success closes the SSB breaker's count
    row = {"query": "tpch q1", "card_p50_ms": card_p50, "degraded_ms": degraded,
           "degraded_p50_ms": statistics.median(degraded),
           "degraded_over_card": statistics.median(degraded) / card_p50,
           "circuit_states": states, "probe_closed": True, "probe_bit_identical": True,
           "ssb_sf10_degraded": size_error, "degraded_total": tctx.resilience.degraded_total}
    emit("resilience_breaker", **row)
    return row


def static_kernel_error(ctx):
    """A failed capture (the `compile` site armed with the port's
    KernelError) on a fresh scope's second run: it raises, no retry, not
    degraded, the breaker untouched."""
    sql = ssb.QUERIES["q1_1"]
    ctx.engine._arena.clear()
    first = ctx.sql(sql)  # the warm-up: the next run captures
    br = ctx.resilience.breaker
    failures = br.to_dict()["failures_total"]
    _arm("compile", error_type=resilience.KernelError, times=1)
    try:
        ctx.sql(sql)
    except resilience.KernelError as e:
        msg = str(e)
    else:
        raise AssertionError("an armed capture did not raise")
    finally:
        _disarm()
    m = ctx.last_metrics
    if (m.retries, m.degraded) != (0, False) or br.state != "closed" or (
            br.to_dict()["failures_total"] != failures):
        raise AssertionError(f"static error was retried or counted: {m.describe()}")
    import pandas as pd

    pd.testing.assert_frame_equal(ctx.sql(sql), first, check_exact=True)
    row = {"query": "q1_1", "error": msg, "retries": m.retries, "degraded": m.degraded,
           "breaker": br.state}
    emit("resilience_static", **row)
    return row


def progressive(ctx):
    """`sql_progressive` on SSB q4.1: one refinement per in-scope segment,
    the last bit-identical to `ctx.sql`; the time to the first."""
    import pandas as pd

    sql = ssb.QUERIES["q4_1"]
    final = ctx.sql(sql)
    segs = ctx.last_metrics.segments
    t0 = time.perf_counter()
    gen = ctx.sql_progressive(sql)
    steps = [next(gen)]
    first_ms = (time.perf_counter() - t0) * 1e3
    steps += list(gen)
    total_ms = (time.perf_counter() - t0) * 1e3
    if len(steps) != segs or [i["sequence"] for _, i in steps] != list(range(segs)):
        raise AssertionError(f"progressive: {len(steps)} refinements for {segs} segments")
    pd.testing.assert_frame_equal(steps[-1][0], final, check_exact=True)
    row = {"query": "q4_1", "refinements": len(steps), "first_refinement_ms": first_ms,
           "total_ms": total_ms, "sql_p50_ms": _p50(lambda: ctx.sql(sql), 3),
           "last_bit_identical_to_sql": True}
    emit("resilience_progressive", **row)
    return row


def run_resilience(ctxs, workloads, p50s=None):
    """Phase 12 on the resident SSB SF10 and TPC-H SF1 contexts.  `p50s`
    (label -> ms) holds warm p50s of the wall-deadline queries that earlier
    phases measured (cube_theta in phase 7, q18 in phase 10), which the
    deadlines then take instead of timing the queries again (until phase 19
    came, 3 and 2 warm runs)."""
    sctx, tctx = ctxs["ssb"], ctxs["tpch"]
    p50s = p50s or {}
    sweeps = [r for name in SWEEP_QUERIES for r in deadline_sweep(sctx, name)]
    walls = [
        wall_deadline(sctx, "scan:ordered_top100", lambda: sctx.sql(
            "SELECT lo_orderdate, lo_extendedprice, lo_discount FROM lineorder "
            f"WHERE {FACT_WHERE} ORDER BY lo_extendedprice DESC LIMIT 100")),
        wall_deadline(sctx, "cube_theta", lambda: sctx.sql(ssb.SKETCH_QUERIES["cube_theta"]),
                      p50=p50s.get("cube_theta")),
        wall_deadline(tctx, "fallback:q18", lambda: tctx.sql(tpch.EXTENDED_QUERIES["q18"]),
                      warm=2, p50=p50s.get("fallback:q18")),
    ]
    armed = armed_deadline_cost(ctxs, workloads)
    retries = retries_on_warm_graph(sctx)
    breaker = breaker_cycle(tctx, sctx, workloads["tpch"][1])
    static = static_kernel_error(sctx)
    prog = progressive(sctx)
    return {"sweeps": sweeps, "wall_deadlines": walls, "armed": armed, "retries": retries,
            "breaker": breaker, "static": static, "progressive": prog}


# -- phase 14: serving -------------------------------------------------------------

SERVE_CLIENTS = 8  # dashboard client threads in the concurrent mix
SERVE_REQUESTS = 24  # requests per client per run (40 until phase 18)
SERVE_TIMEOUT_S = 30  # every HTTP request's client timeout
SERVE_FUSION = {"fusion_window_ms": 2, "fusion_max_batch": 16}
TRACE_PAIRS = 4  # interleaved pairs, trace on and off, per query (6 until phase 18)
FUSED_MEMBERS = ("q1_1", "q1_2", "q1_3", "q4_1")  # fusable: G <= 4096, no tier
DASHBOARD_REFRESHES = 12  # refreshes of the 8-panel dashboard, each way
DASHBOARD_WINDOW_MS = 50  # the fusion window a refresh's panels arrive within


def _http(base, path, body=None):
    """(status, headers, body bytes) of one request to a phase-14 server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _envelope_bytes(payload) -> bytes:
    """A payload encoded as the server encodes a response body."""
    return json.dumps(payload, default=wire._jsonable).encode()


def _sql_text(ctx, workload, name):
    return ssb.QUERIES[name] if workload == "ssb" else tpch.QUERIES[name]


def _metric_sum(base, name, **labels) -> float:
    """The sum of a family's samples carrying `labels`, from the server's
    /status/metrics (every sample of which must parse)."""
    status, _, text = _http(base, "/status/metrics")
    if status != 200:
        raise AssertionError(f"/status/metrics answered {status}")
    want = [f'{k}="{v}"' for k, v in labels.items()]
    total = 0.0
    for ln in text.decode().splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        sample, value = ln.rsplit(" ", 1)
        value = float(value)
        if sample.startswith(name + "{") and all(w in sample for w in want):
            total += value
    return total


def _requests_ok(base) -> float:
    """sdol_http_requests_total over the query routes with code 200."""
    return sum(_metric_sum(base, "sdol_http_requests_total", code="200", route=r)
               for r in ("/druid/v2", "/druid/v2/sql"))


def _serving_cases(ctxs):
    """(workload, name, native body, SQL text or None) of phase 11's wire
    bodies: the 16 main-path specs, topn_hll, cube_revenue's subtotalsSpec
    and the ordered top-100 Scan."""
    cases = []
    for w, n, q in main_path_queries():
        sql = _sql_text(ctxs[w], w, n) if (n in ssb.QUERIES or (w == "tpch" and n == "q1")) else None
        cases.append((w, n, json.loads(json.dumps(q.to_druid(), default=str)), sql))
    sctx = ctxs["ssb"]
    cases.append(("ssb", "topn_hll",
                  json.loads(json.dumps(sctx.plan_sql(ssb.SKETCH_QUERIES["topn_hll"]).query.to_druid(),
                                        default=str)), ssb.SKETCH_QUERIES["topn_hll"]))
    rw = sctx.plan_sql(CUBE_REVENUE)
    cases.append(("ssb", "cube_revenue_subtotals",
                  json.loads(json.dumps(dataclasses.replace(rw.query, subtotals=rw.grouping_sets)
                                        .to_druid(), default=str)), None))
    top100 = (f"SELECT lo_orderdate, lo_extendedprice, lo_discount FROM lineorder "
              f"WHERE {FACT_WHERE} ORDER BY lo_extendedprice DESC LIMIT 100")
    cases.append(("ssb", "scan_top100",
                  json.loads(json.dumps(sctx.plan_sql(top100).query.to_druid(), default=str)),
                  top100))
    return cases


def serve_single_requests(ctxs, bases):
    """Each case once through the server, native and SQL: the response bytes
    equal the in-process answer's envelope, bit for bit; X-Druid-Query-Id
    echoes context.queryId; every trace is served; /status/metrics counts
    the requests."""
    from spark_druid_olap_tpu_torch.models.wire import _rows

    # the metrics registry is process-wide: both servers count into it
    before = _requests_ok(bases["ssb"])
    sent = {w: 0 for w in bases}
    out = []
    for w, name, body, sql in _serving_cases(ctxs):
        ctx, base = ctxs[w], bases[w]
        _, _, shaped = _wire_run(ctx, body)
        want = _envelope_bytes(shaped)
        for route, payload, expect in (
                ("/druid/v2", body, want),
                ("/druid/v2/sql", {"query": sql} if sql else None, None)):
            if payload is None:
                continue
            if expect is None:
                expect = _envelope_bytes(_rows(ctx.sql(sql)))
            qid = f"p14-{w}-{name}-{route.rsplit('/', 1)[-1]}"
            payload = dict(payload, context={**payload.get("context", {}), "queryId": qid})
            t0 = time.perf_counter()
            status, headers, got = _http(base, route, payload)
            ms = (time.perf_counter() - t0) * 1e3
            sent[w] += 1
            if status != 200 or got != expect:
                raise AssertionError(f"serving {name} {route}: {status}, bytes equal "
                                     f"{got == expect}: {got[:200]!r}")
            if headers.get("X-Druid-Query-Id") != qid:
                raise AssertionError(f"serving {name}: X-Druid-Query-Id {headers.get('X-Druid-Query-Id')}")
            tstatus, _, doc = _http(base, f"/druid/v2/trace/{qid}")
            doc = json.loads(doc)
            if tstatus != 200 or doc["query_id"] != qid or "receipt" not in doc:
                raise AssertionError(f"serving {name}: trace {tstatus}")
            out.append({"query": name, "route": route, "ms": ms, "response_bytes": len(got),
                        "bytes_equal_in_process": True,
                        "dispatch_count": doc["receipt"]["dispatch_count"]})
            emit("serving_request", **out[-1])
    counted = _requests_ok(bases["ssb"]) - before
    if counted != sum(sent.values()):
        raise AssertionError(f"/status/metrics counted {counted} requests, {sum(sent.values())} sent")
    return out


def _mix_plan(seed):
    """One client's requests: a seeded shuffle over the 13 SSB queries, the
    Timeseries and the TopN, each SSB query as native JSON or SQL by a coin."""
    rng = np.random.default_rng(seed)
    pool = [(n, json.loads(json.dumps(q.to_druid(), default=str))) for n, q in ssb.NATIVE_QUERIES.items()]
    pool += [("timeseries", json.loads(json.dumps(ssb.TIMESERIES_QUERY.to_druid(), default=str))),
             ("topn", json.loads(json.dumps(ssb.TOPN_QUERY.to_druid(), default=str)))]
    plan = []
    for i in rng.integers(0, len(pool), SERVE_REQUESTS):
        name, body = pool[i]
        if name in ssb.QUERIES and rng.random() < 0.5:
            plan.append((name, "/druid/v2/sql", {"query": ssb.QUERIES[name]}))
        else:
            plan.append((name, "/druid/v2", body))
    return plan


def _lane_of(ctx, route, body):
    from spark_druid_olap_tpu_torch.serve.lanes import classify_native

    if route == "/druid/v2/sql":
        return ctx.serve.lane_for_sql(body["query"])
    q = wire.query_from_druid(body)
    return classify_native(q, ctx.catalog.get(q.datasource), ctx.config)


def serve_mix(ctx, base, want, scan_body, scan_want, label):
    """SERVE_CLIENTS threads, each SERVE_REQUESTS requests of `_mix_plan`,
    beside one thread sending the heavy-lane top-100 Scan until they end.
    Every answer must be 200 and equal the serial bytes.  Returns queries
    per second, per-lane p50/p99 and the fused batch sizes."""
    import threading

    lanes = {}
    lat = {}
    errors = []
    done = threading.Event()
    fusion = ctx.serve.fusion
    f0 = (fusion.batches_fused, fusion.members_fused)

    def client(k):
        for name, route, body in _mix_plan(k):
            t0 = time.perf_counter()
            status, _, got = _http(base, route, body)
            ms = (time.perf_counter() - t0) * 1e3
            if status != 200 or got != want[(route, name)]:
                errors.append((name, route, status, got[:120]))
            lat.setdefault(lanes[(route, name)], []).append(ms)

    def scanner():
        while not done.is_set():
            t0 = time.perf_counter()
            status, _, got = _http(base, "/druid/v2", scan_body)
            lat.setdefault(lanes[("scan", "scan")], []).append((time.perf_counter() - t0) * 1e3)
            if status != 200 or got != scan_want:
                errors.append(("scan_top100", "/druid/v2", status, got[:120]))

    for k in range(SERVE_CLIENTS):
        for name, route, body in _mix_plan(k):
            lanes.setdefault((route, name), _lane_of(ctx, route, body))
    lanes[("scan", "scan")] = _lane_of(ctx, "/druid/v2", scan_body)
    sc = threading.Thread(target=scanner)
    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    before = cuda_groupby.LAUNCHES
    t0 = time.perf_counter()
    sc.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    done.set()
    sc.join(timeout=120)
    if any(t.is_alive() for t in threads) or sc.is_alive():
        raise AssertionError(f"{label}: a client thread did not finish")
    if errors:
        raise AssertionError(f"{label}: {len(errors)} answers differ from the serial ones: {errors[:3]}")
    n = SERVE_CLIENTS * SERVE_REQUESTS
    batches = fusion.batches_fused - f0[0]
    members = fusion.members_fused - f0[1]
    row = {"run": label, "requests": n, "scan_requests": len(lat.get(lanes[("scan", "scan")], [])),
           "wall_s": wall, "queries_per_s": n / wall,
           "launches": cuda_groupby.LAUNCHES - before,
           "fused_batches": batches, "fused_members": members,
           "mean_fused_batch": (members / batches) if batches else None,
           "lanes": {ln: {"requests": len(v), "p50_ms": float(np.percentile(v, 50)),
                          "p99_ms": float(np.percentile(v, 99))} for ln, v in lat.items()},
           "bit_identical_to_serial": True}
    emit("serving_mix", **row)
    return row


def serve_concurrent(ctx, base):
    """The dashboard mix, fusion off then on, the result cache off (its
    fused batches are counted, not required: at its rate two fusable
    queries seldom share a 2 ms window; `serve_dashboard` is the run that
    must fuse).  Then a repeat pass with the cache on, every repeat a hit
    with no launch."""
    plans = [p for k in range(SERVE_CLIENTS) for p in _mix_plan(k)]
    want = {}
    for name, route, body in plans:  # the serial answers, one at a time
        if (route, name) not in want:
            status, _, got = _http(base, route, body)
            if status != 200:
                raise AssertionError(f"serial {name} {route}: {status}")
            want[(route, name)] = got
    top100 = (f"SELECT lo_orderdate, lo_extendedprice, lo_discount FROM lineorder "
              f"WHERE {FACT_WHERE} ORDER BY lo_extendedprice DESC LIMIT 100")
    scan_body = json.loads(json.dumps(ctx.plan_sql(top100).query.to_druid(), default=str))
    scan_want = _http(base, "/druid/v2", scan_body)[2]
    ctx.sql("SET admission_queue_timeout_ms = 120000")  # queueing is measured, not refused
    rows = []
    try:
        rows.append(serve_mix(ctx, base, want, scan_body, scan_want, "fusion_off"))
        for k, v in SERVE_FUSION.items():
            ctx.sql(f"SET {k} = {v}")
        rows.append(serve_mix(ctx, base, want, scan_body, scan_want, "fusion_on"))
    finally:
        ctx.sql("SET fusion_window_ms = 0")
        ctx.sql("SET admission_queue_timeout_ms = 2000")
    ctx.sql("SET result_cache_entries = 64")
    try:
        for (route, name), body in {(r, n): b for n, r, b in plans}.items():
            _http(base, route, body)  # fill
        hits0 = ctx.serve.result_cache.hits
        before = cuda_groupby.LAUNCHES
        for (route, name), body in {(r, n): b for n, r, b in plans}.items():
            status, _, got = _http(base, route, body)
            if status != 200 or got != want[(route, name)]:
                raise AssertionError(f"cached {name} {route}: {status}")
        repeats = len({(r, n) for n, r, _ in plans})
        hits = ctx.serve.result_cache.hits - hits0
        launched = cuda_groupby.LAUNCHES - before
        if hits != repeats or launched:
            raise AssertionError(f"cache pass: {hits} hits of {repeats} repeats, {launched} launches")
    finally:
        ctx.sql("SET result_cache_entries = 0")
    rows.append({"run": "cache_repeat", "repeats": repeats, "hits": hits, "launches": launched})
    emit("serving_cache", **rows[-1])
    return rows


def serve_fused_graph(ctx):
    """A fixed fused batch of fusable members: the first batch runs the
    fused loop, the second captures the graph, the third is one replay and
    one host fetch, its launches the sum of its members' in-scope segments
    and every member bit-identical to its serial run."""
    import pandas as pd

    ds = ctx.catalog.get("lineorder")
    # the dashboard's panels in another order: a member set of its own
    # (the dashboard's batches hold them in canonical order), so this
    # batch starts at its first sight
    qs = [ssb.TOPN_QUERY, ssb.TIMESERIES_QUERY] + [ssb.NATIVE_QUERIES[n]
                                                   for n in reversed(FUSED_MEMBERS)]
    serial = [ctx.engine.execute(q, ds) for q in qs]
    serial_ms = _median_ms(lambda: [ctx.engine.execute(q, ds) for q in qs], 3)
    first = _timed(lambda: ctx.engine.execute_fused(qs, ds))[1]
    capture = _timed(lambda: ctx.engine.execute_fused(qs, ds))[1]
    segs = 0
    for q in qs:
        inner, _ = ctx.engine._groupby_family(q, ds)
        segs += len(segments_in_scope(groupby_with_time_granularity(inner), ds))
    before = cuda_groupby.LAUNCHES
    out = ctx.engine.execute_fused(qs, ds)
    launches = cuda_groupby.LAUNCHES - before
    m = out[0][2]
    syncs = _syncs(lambda: ctx.engine.execute_fused(qs, ds))
    on_card = ctx.engine.device.type == "cuda"
    if m.dispatch_count != 1 or (on_card and (m.graph_replays != 1 or launches != segs)):
        raise AssertionError(f"fused batch: {m.describe()}, {launches} launches, {segs} segments")
    if syncs is not None and sum(syncs.values()) != 1:
        raise AssertionError(f"fused batch: host syncs {syncs}, one fetch expected")
    for (df, _, _), want in zip(out, serial):
        pd.testing.assert_frame_equal(df, want, check_exact=True)
    warm_ms = _median_ms(lambda: ctx.engine.execute_fused(qs, ds), 5)
    row = {"members": len(qs), "segments": segs, "launches": launches, "graph_replays": 1,
           "host_syncs": syncs, "first_ms": first, "capture_run_ms": capture,
           "warm_p50_ms": warm_ms, "serial_sum_p50_ms": serial_ms,
           "device_ms": sum(profiled_device_ms(lambda: ctx.engine.execute_fused(qs, ds)).values()),
           "bit_identical_to_serial": True}
    emit("serving_fused_graph", **row)
    return row


def _dashboard_panels():
    """The 8 panels of a dashboard that refreshes them together, as a BI
    dashboard (Apache Superset, Grafana) on its auto-refresh interval sends
    every chart's query at once: q1.1-q1.3, q4.1, the Timeseries and the
    TopN as native JSON, q1.1 and q4.1 as SQL; every one fusable.  (A panel
    on the adaptive tier would run beside the batch and hold the host
    while the others arrive: on a slow host their batches split.)"""
    def body(q):
        return json.loads(json.dumps(q.to_druid(), default=str))

    panels = [(n, "/druid/v2", body(ssb.NATIVE_QUERIES[n])) for n in FUSED_MEMBERS]
    panels += [("timeseries", "/druid/v2", body(ssb.TIMESERIES_QUERY)),
               ("topn", "/druid/v2", body(ssb.TOPN_QUERY))]
    return panels + [(f"{n}_sql", "/druid/v2/sql", {"query": ssb.QUERIES[n]})
                     for n in ("q1_1", "q4_1")]


def serve_dashboard(ctx, base):
    """DASHBOARD_REFRESHES refreshes of `_dashboard_panels`, one client
    thread a panel, the threads released together for each refresh; with
    fusion off, then on (a DASHBOARD_WINDOW_MS window), the result cache
    off and admission and each lane given two slots a panel (a panel that
    queued for a slot its last request has not yet released would miss its
    refresh's batch; over SF10 every panel but the Timeseries and the TopN
    scans more than `lane_heavy_rows`, and the heavy lane has 2 slots by
    default).  Every
    answer's bytes equal the serial answer's.  With fusion on the fusable
    panels' set recurs: its first batch runs the fused eager loop, its
    second captures the fused graph and later ones replay it through the
    fusion scheduler; the run fails unless a batch fused and a fused graph
    was replayed (`sdol_program_cache_total{family="arena-fused",
    outcome="hit"}` on the server).  A refresh's wall is its slowest
    panel's."""
    import threading

    panels = _dashboard_panels()
    want = {}
    for name, route, body in panels:  # the serial answers, one at a time
        status, _, got = _http(base, route, body)
        if status != 200:
            raise AssertionError(f"dashboard serial {name}: {status}")
        want[name] = got
    fusion = ctx.serve.fusion

    def refreshes(label):
        barrier = threading.Barrier(len(panels))
        lat = [[] for _ in panels]
        errors = []

        def panel(i):
            name, route, body = panels[i]
            for _ in range(DASHBOARD_REFRESHES):
                barrier.wait(timeout=120)
                t0 = time.perf_counter()
                status, _, got = _http(base, route, body)
                lat[i].append((time.perf_counter() - t0) * 1e3)
                if status != 200 or got != want[name]:
                    errors.append((name, status, got[:120]))

        threads = [threading.Thread(target=panel, args=(i,)) for i in range(len(panels))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"dashboard {label}: a panel thread did not finish")
        if errors:
            raise AssertionError(f"dashboard {label}: {len(errors)} answers differ from the "
                                 f"serial ones: {errors[:3]}")
        walls = [max(p[r] for p in lat) for r in range(DASHBOARD_REFRESHES)]
        return {"refreshes": DASHBOARD_REFRESHES, "first_refresh_ms": walls[0],
                "refresh_p50_ms": float(np.percentile(walls, 50)),
                "refresh_p99_ms": float(np.percentile(walls, 99)),
                "panel_p50_ms": {p[0]: float(np.percentile(v, 50)) for p, v in zip(panels, lat)}}

    ctx.sql("SET admission_queue_timeout_ms = 120000")
    for flag in ("max_concurrent_queries", "lane_interactive_slots", "lane_heavy_slots"):
        ctx.sql(f"SET {flag} = {2 * len(panels)}")
    try:
        off = refreshes("fusion_off")
        ctx.sql(f"SET fusion_window_ms = {DASHBOARD_WINDOW_MS}")
        ctx.sql("SET fusion_max_batch = 16")
        hits0 = _metric_sum(base, "sdol_program_cache_total", family="arena-fused", outcome="hit")
        caps0 = _metric_sum(base, "sdol_compiles_total", family="arena-fused")
        f0 = (fusion.batches_fused, fusion.members_fused)
        try:
            on = refreshes("fusion_on")
        finally:
            ctx.sql("SET fusion_window_ms = 0")
        replays = _metric_sum(base, "sdol_program_cache_total", family="arena-fused",
                              outcome="hit") - hits0
        captures = _metric_sum(base, "sdol_compiles_total", family="arena-fused") - caps0
    finally:
        ctx.sql("SET max_concurrent_queries = 8")
        ctx.sql("SET lane_interactive_slots = 6")
        ctx.sql("SET lane_heavy_slots = 2")
        ctx.sql("SET admission_queue_timeout_ms = 2000")
    batches = fusion.batches_fused - f0[0]
    members = fusion.members_fused - f0[1]
    if not batches or not replays:
        raise AssertionError(f"dashboard: {batches} fused batches of {members} members, "
                             f"{replays} fused-graph replays through the scheduler")
    row = {"panels": len(panels), "window_ms": DASHBOARD_WINDOW_MS,
           "fused_batches": batches, "fused_members": members,
           "mean_fused_batch": members / batches, "fused_graph_captures": captures,
           "fused_graph_replays": replays, "fusion_off": off, "fusion_on": on,
           "bit_identical_to_serial": True}
    emit("serving_dashboard", **row)
    return row


def serve_admission(ctx, base):
    """Clock-free: one held slot under max_concurrent_queries = 1 gives 503
    with Retry-After; a saturated heavy lane leaves an interactive query
    admitted and refuses a heavy one."""
    topn = json.loads(json.dumps(ssb.TOPN_QUERY.to_druid(), default=str))
    top100 = (f"SELECT lo_orderdate, lo_extendedprice, lo_discount FROM lineorder "
              f"WHERE {FACT_WHERE} ORDER BY lo_extendedprice DESC LIMIT 100")
    scan = json.loads(json.dumps(ctx.plan_sql(top100).query.to_druid(), default=str))
    ctx.sql("SET admission_queue_timeout_ms = 50")
    ctx.sql("SET max_concurrent_queries = 1")
    res = ctx.resilience
    try:
        res.admission.acquire()
        try:
            status, headers, body = _http(base, "/druid/v2", topn)
        finally:
            res.admission.release()
        if status != 503 or int(headers.get("Retry-After", 0)) < 1:
            raise AssertionError(f"a held slot: {status} {headers.get('Retry-After')} {body[:120]!r}")
        ctx.sql("SET max_concurrent_queries = 8")
        ctx.sql("SET lane_heavy_rows = 1000")  # the Scan is heavy at any scale
        heavy = res.lane("heavy")
        held = [heavy.acquire() for _ in range(heavy.max_concurrent)]
        try:
            interactive = _http(base, "/druid/v2", topn)[0]
            refused, rh, rbody = _http(base, "/druid/v2", scan)
        finally:
            for _ in held:
                heavy.release()
        if interactive != 200 or refused != 503 or b"heavy lane" not in rbody:
            raise AssertionError(f"lanes: interactive {interactive}, heavy {refused} {rbody[:120]!r}")
    finally:
        ctx.sql("SET max_concurrent_queries = 8")
        ctx.sql("SET admission_queue_timeout_ms = 2000")
        ctx.sql(f"SET lane_heavy_rows = {4 << 20}")
    row = {"held_slot_status": 503, "retry_after_s": int(headers["Retry-After"]),
           "interactive_beside_full_heavy_lane": interactive, "heavy_status": refused}
    emit("serving_admission", **row)
    return row


def serve_observability(ctx):
    """Sampled receipts (prof_sample_rate = 1) carry device_ms from CUDA
    events, beside the profiler's device time of the same query; at the
    default rate the phase adds no sync (obs.prof.SYNCS, and the sync sites
    of a traced query equal an untraced one's); the p50 of the engine call
    with a trace open and without."""
    from spark_druid_olap_tpu_torch.obs import prof

    ds = ctx.catalog.get("lineorder")
    rows = []
    for name in ("q1_1", "q2_1", "q4_1"):
        q = ssb.NATIVE_QUERIES[name]
        ctx.sql("SET prof_sample_rate = 1")
        try:
            rc = ctx.sql(ssb.QUERIES[name]).attrs["receipt"]
        finally:
            ctx.sql("SET prof_sample_rate = 0")
        if rc["device_timing"] != "cuda_events" or rc["device_ms"] <= 0:
            raise AssertionError(f"sampled {name}: {rc}")
        profiled = sum(profiled_device_ms(lambda: ctx.engine.execute(q, ds)).values())
        s0 = prof.SYNCS

        def traced(q=q):
            with ctx.tracer.query_trace(query_type="native"):
                return ctx.engine.execute(q, ds)

        on_sites = _syncs(traced)
        off_sites = _syncs(lambda: ctx.engine.execute(q, ds))
        if prof.SYNCS != s0 or on_sites != off_sites:
            raise AssertionError(f"{name}: tracing added syncs {on_sites} vs {off_sites}")
        on, off = [], []
        for i in range(TRACE_PAIRS):
            for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
                t0 = time.perf_counter()
                traced() if side == "on" else ctx.engine.execute(q, ds)
                (on if side == "on" else off).append((time.perf_counter() - t0) * 1e3)
        rows.append({"query": name, "receipt_device_ms": rc["device_ms"],
                     "receipt_syncs": rc["syncs"], "profiler_device_ms": profiled,
                     "added_syncs_unsampled": 0, "p50_trace_on_ms": statistics.median(on),
                     "p50_trace_off_ms": statistics.median(off)})
        emit("serving_observability", **rows[-1])
    return rows


def run_serving(ctxs, workloads):
    """Phase 14 on the resident SSB SF10 and TPC-H SF1 contexts: one server
    per context on the card, bound to a free port, shut down at the end."""
    from spark_druid_olap_tpu_torch.obs import prof
    from spark_druid_olap_tpu_torch.server import OlapServer

    servers = {w: OlapServer(c, port=0).start() for w, c in ctxs.items()}
    try:
        bases = {w: f"http://127.0.0.1:{s.port}" for w, s in servers.items()}
        syncs0 = prof.SYNCS
        single = serve_single_requests(ctxs, bases)
        mix = serve_concurrent(ctxs["ssb"], bases["ssb"])
        if prof.SYNCS != syncs0:
            raise AssertionError(f"unsampled serving added {prof.SYNCS - syncs0} syncs")
        dashboard = serve_dashboard(ctxs["ssb"], bases["ssb"])
        fused = serve_fused_graph(ctxs["ssb"])
        admission = serve_admission(ctxs["ssb"], bases["ssb"])
        obs = serve_observability(ctxs["ssb"])
    finally:
        for s in servers.values():
            s.shutdown()
    return {"single": single, "mix": mix, "fused": fused, "dashboard": dashboard,
            "admission": admission, "obs": obs}


# -- phase 15: ingest and storage --------------------------------------------------

APPEND_BATCHES = 16  # batches appended to lineorder, a query round after each
APPEND_ROWS = 4096
FULL_DELTA_ROWS = 1 << 16  # delta_seal_rows: one full delta segment
ODD_DELTA_ROWS = 5000  # pads to 5120 rows: no whole number of the kernel's chunks
NEW_CITY = "CANADA  NEW"  # sorts before "CANADA0": every later city's code shifts
INGEST_QUERIES = ("q1_1", "q4_1", "q2_1", "topn")
TOPN_SQL = ("SELECT c_nation, sum(lo_revenue) AS revenue FROM lineorder "
            "JOIN customer ON lo_custkey = c_custkey "
            "GROUP BY c_nation ORDER BY revenue DESC LIMIT 10")
DELTA_REFRESHES = 3  # append + cached refresh cycles of phase 15 (d)
# phase 15 (d)'s sketch query: HLL and theta states merged on the host by
# the delta refresh (the CUBE set (c_region)'s kernel shape)
DELTA_SKETCH_SQL = ("SELECT c_region, approx_count_distinct(lo_custkey) AS u_hll, "
                    "approx_count_distinct_ds_theta(lo_custkey) AS u_theta, "
                    "sum(lo_revenue) AS revenue FROM lineorder GROUP BY c_region")
RESTART_SCALE = 1.0  # the restart's own SSB context: a depth cut (PERF.md §4)
RESTART_WARM = 2  # (3 until phase 18)
SYS_TICKS = 3


def _merge_oracle(name, a, b):
    """The oracle over two row sets from the oracles over each: grouped
    sums add by key (float64); the TopN keeps every nation, descending."""
    import pandas as pd

    if isinstance(a, float):
        return a + b
    value = "profit" if "profit" in a.columns else "revenue"
    keys = [c for c in a.columns if c != value]
    both = pd.concat([a.assign(**{k: a[k].astype(object) for k in keys if k != "d_year"}),
                      b.assign(**{k: b[k].astype(object) for k in keys if k != "d_year"})])
    out = both.groupby(keys, sort=True)[value].sum().reset_index()
    if name == "topn":
        out = out.sort_values(value, ascending=False, kind="stable").reset_index(drop=True)
    return out


class IngestOracle:
    """The float64 oracles of phase 15's queries over the base rows (phase
    4's, cached) and every batch appended since."""

    def __init__(self, base_frame):
        self.want = {n: oracle("ssb", n, base_frame) for n in INGEST_QUERIES}

    def add(self, batch):
        f = ssb.rows_frame(batch)
        for n in INGEST_QUERIES:
            self.want[n] = _merge_oracle(n, self.want[n], ssb.oracle(f, n))


def _ingest_run(ctx, name, side):
    """One run of a phase-15 query, native (`Engine.execute` on the live
    snapshot) or SQL: (frame, ms, metrics, launches)."""
    before = cuda_groupby.LAUNCHES
    t0 = time.perf_counter()
    if side == "native":
        q = ssb.TOPN_QUERY if name == "topn" else ssb.NATIVE_QUERIES[name]
        df = ctx.engine.execute(q, ctx.catalog.get("lineorder"))
    else:
        df = ctx.sql(TOPN_SQL if name == "topn" else ssb.QUERIES[name])
    ms = (time.perf_counter() - t0) * 1e3
    return df, ms, ctx.last_metrics, cuda_groupby.LAUNCHES - before


def ingest_round(ctx, orc, tag, runs=("native", "sql", "native")):
    """Each phase-15 query run `runs` (on a new segment set: the eager
    loop, the capture, a replay), every frame held against the oracle over
    every appended row, the SQL frame bit-identical to the native one.
    Returns per-query rows."""
    import pandas as pd

    out = {}
    for name in INGEST_QUERIES:
        frames, row = {}, {"ms": [], "captures": 0, "replays": 0, "launches": []}
        for side in runs:
            df, ms, m, launches = _ingest_run(ctx, name, side)
            check_against_oracle(name, df, None, "ssb", want=orc.want[name])
            if side in frames and side == "native":
                pd.testing.assert_frame_equal(df, frames[side], check_exact=True)
            frames.setdefault(side, df)
            if m.strategy == "cuda" and launches == 0:
                raise AssertionError(f"{tag} {name}: {m.describe()} but the kernel never launched")
            row["ms"].append(ms)
            row["launches"].append(launches)
            row["captures"] += m.graph_captures
            row["replays"] += m.graph_replays
            row["strategy"], row["segments"] = m.strategy, m.segments
        if name != "topn" and "sql" in frames:
            cols = [c for c in frames["sql"].columns if c in frames["native"].columns]
            pd.testing.assert_frame_equal(frames["sql"][cols].reset_index(drop=True),
                                          frames["native"][cols].reset_index(drop=True),
                                          check_exact=True)
        out[name] = row
    return out


def check_retired(ctx, retired, what):
    """No device column, pinned host copy, arena program or warm mark of a
    retired uid is left: no graph can replay over a freed column."""
    eng = ctx.engine
    left = {
        "resident": len(retired & eng.resident_uids()),
        "pinned": sum(1 for k in eng._pipeline._pinned if k[0] in retired),
        "arena_columns": sum(1 for ck in eng._arena._by_col if ck[0] in retired),
        "programs": sum(1 for key in eng._arena.keys() if set(key[-1]) & retired),
    }
    if any(left.values()):
        raise AssertionError(f"{what}: retired uids left behind {left}")
    return left


def _arena_lineorder(ctx):
    """(lineorder programs in the arena cache, those the newest delta is
    not in: no later query can reach them)."""
    ds = ctx.catalog.get("lineorder")
    uids = {s.uid for s in ds.segments}
    newest = max((s.seq, s.uid) for s in ds.delta_segments())[1] if ds.delta_segments() else None
    mine = [k for k in ctx.engine._arena.keys() if set(k[-1]) & uids]
    return len(mine), sum(1 for k in mine if newest is not None and newest not in k[-1])


def ingest_appends(ctx, tables, orc):
    """(a): APPEND_BATCHES batches of APPEND_ROWS fact rows, values from the
    existing dictionaries, then one full delta; a query round after each."""
    acks, visible, versions = [], [], []
    captured = 0
    arena_before = len(ctx.engine._arena.keys())
    sizes = [APPEND_ROWS] * APPEND_BATCHES + [FULL_DELTA_ROWS]
    for i, n in enumerate(sizes):
        batch = ssb.fact_rows(tables, n, seed=100 + i)
        t0 = time.perf_counter()
        ack = ctx.append_rows("lineorder", batch)
        acks.append((time.perf_counter() - t0) * 1e3)
        if ack["appended"] != n:
            raise AssertionError(f"append {i}: {ack}")
        orc.add(batch)
        rows = ingest_round(ctx, orc, f"append {i}")
        visible.append(acks[-1] + rows["q1_1"]["ms"][0])
        version = ack["datasourceVersion"]
        versions.append({"version": version, **{
            n: {"captures": r["captures"], "replays": r["replays"], "launches": r["launches"],
                "ms": r["ms"], "strategy": r["strategy"], "segments": r["segments"]}
            for n, r in rows.items()}})
        captured += sum(r["captures"] for r in rows.values())
        emit("ingest_version", batch_rows=n, **versions[-1])
    lineorder_programs, unreachable = _arena_lineorder(ctx)
    row = {
        "batches": len(sizes),
        "ack_p50_ms": statistics.median(acks),
        "ack_p95_ms": float(np.percentile(acks, 95)),
        "append_to_visible_p50_ms": statistics.median(visible),
        "captures": captured,
        "replays": sum(v[n]["replays"] for v in versions for n in INGEST_QUERIES),
        "arena_programs_before": arena_before,
        "arena_programs_after": len(ctx.engine._arena.keys()),
        "arena_capacity": ctx.engine._arena.entries,
        "lineorder_programs": lineorder_programs,
        "unreachable_programs": unreachable,
        "delta_rows": ctx.catalog.get("lineorder").delta_rows,
        "delta_segments": len(ctx.catalog.get("lineorder").delta_segments()),
    }
    emit("ingest_appends", **row)
    return row


def ingest_remap(ctx, tables, orc):
    """(b): one row with a c_city no dictionary holds: every segment
    remaps (new uids); the retired ones leave the card; the first and warm
    runs after it re-upload and hold the oracle."""
    ds = ctx.catalog.get("lineorder")
    old = {s.uid for s in ds.segments}
    batch = ssb.fact_rows(tables, 1, seed=300, new_city=NEW_CITY)
    t0 = time.perf_counter()
    ctx.append_rows("lineorder", batch)
    remap_ms = (time.perf_counter() - t0) * 1e3
    if ctx.catalog.get("lineorder").dicts["c_city"].code_of(NEW_CITY) is None:
        raise AssertionError("the new city is not in the extended dictionary")
    orc.add(batch)
    left = check_retired(ctx, old, "remap")
    first = _ingest_run(ctx, "q4_1", "native")
    check_against_oracle("q4_1", first[0], None, "ssb", want=orc.want["q4_1"])
    rows = ingest_round(ctx, orc, "remap")
    warm = [_ingest_run(ctx, "q4_1", "native") for _ in range(WARM_RUNS)]
    for df, _, _, _ in warm:
        check_against_oracle("q4_1", df, None, "ssb", want=orc.want["q4_1"])
    check_retired(ctx, old, "remap, after the runs")
    row = {"remap_ms": remap_ms, "segments_remapped": len(old),
           "reupload_bytes": first[2].h2d_bytes, "reupload_ms": first[2].h2d_ms,
           "first_ms": first[1], "warm_p50_ms": statistics.median(w[1] for w in warm),
           "warm_replays": sum(w[2].graph_replays for w in warm), "left": left,
           "round_captures": sum(r["captures"] for r in rows.values())}
    emit("ingest_remap", **row)
    return row


def ingest_compact(ctx, orc, phase4_p50):
    """(c): the deltas (and the undersized historical tail) rolled into
    2^19-row segments; the answers hold the oracle and the retired uids
    leave the card; then the warm p50 of q4.1 against phase 4's."""
    ds = ctx.catalog.get("lineorder")
    retired = {s.uid for s in ds.delta_segments()}
    t0 = time.perf_counter()
    summary = ctx.compact("lineorder")
    compact_ms = (time.perf_counter() - t0) * 1e3
    after = ctx.catalog.get("lineorder")
    old_tail = {s.uid for s in ds.historical_segments()} - {s.uid for s in after.segments}
    retired |= old_tail
    if after.delta_rows or after.num_rows != ds.num_rows:
        raise AssertionError(f"compaction changed the row set: {summary}")
    left = check_retired(ctx, retired, "compaction")
    ingest_round(ctx, orc, "compaction")
    warm = [_ingest_run(ctx, "q4_1", "native") for _ in range(WARM_RUNS)]
    for df, _, _, _ in warm:
        check_against_oracle("q4_1", df, None, "ssb", want=orc.want["q4_1"])
    row = {"compact_ms": compact_ms, **summary, "absorbed_tail_segments": len(old_tail),
           "segments_after": len(after.segments), "left": left,
           "q4_1_warm_p50_ms": statistics.median(w[1] for w in warm),
           "q4_1_phase4_p50_ms": phase4_p50}
    emit("ingest_compaction", **row)
    return row


def ingest_delta_reuse(ctx, tables, orc):
    """(d): q4.1 cached (result cache on), then DELTA_REFRESHES cycles of an
    append of ODD_DELTA_ROWS rows and the cached query again: a delta
    refresh whose launches are the new delta's alone, against the oracle;
    beside it the same query in full on the new segment set (the eager
    loop a refresh saves).  Beside it DELTA_SKETCH_SQL, cached and
    refreshed after each append: its HLL and theta states merge on the
    host, and the refreshed frame equals the same query run in full (the
    sketch columns exactly)."""
    sql = ssb.QUERIES["q4_1"]
    ctx.sql("SET result_cache_entries = 64")
    try:
        for text in (sql, DELTA_SKETCH_SQL):
            ctx.sql(text)
            if ctx.last_metrics.result_cache != "miss":
                raise AssertionError(f"{text}: the first run did not execute")
        refresh_ms, full_ms = [], []
        for i in range(DELTA_REFRESHES):
            batch = ssb.fact_rows(tables, ODD_DELTA_ROWS, seed=400 + i)
            ctx.append_rows("lineorder", batch)
            orc.add(batch)
            ds = ctx.catalog.get("lineorder")
            in_scope = len(segments_in_scope(ssb.NATIVE_QUERIES["q4_1"], ds))
            before = cuda_groupby.LAUNCHES
            t0 = time.perf_counter()
            df = ctx.sql(sql)
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
            m = ctx.last_metrics
            launches = cuda_groupby.LAUNCHES - before
            on_card = ctx.engine.device.type == "cuda"
            if m.strategy != "result-cache-delta" or m.segments != 1 or launches != on_card:
                raise AssertionError(f"delta refresh {i}: {launches} launches, {m.describe()}")
            check_against_oracle("q4_1", df, None, "ssb", want=orc.want["q4_1"])
            full, ms, fm, flaunch = _ingest_run(ctx, "q4_1", "native")
            if on_card and flaunch != in_scope:
                raise AssertionError(f"full run {i}: {flaunch} launches over {in_scope} segments")
            check_against_oracle("q4_1", full, None, "ssb", want=orc.want["q4_1"])
            full_ms.append(ms)
            sketch = ctx.sql(DELTA_SKETCH_SQL)
            if ctx.last_metrics.strategy != "result-cache-delta":
                raise AssertionError(f"sketch refresh {i}: {ctx.last_metrics.describe()}")
            _same_sketch_frame(sketch, ctx.execute_rewrite(ctx.plan_sql(DELTA_SKETCH_SQL),
                                                           use_result_cache=False))
        stats = ctx.serve.result_cache.to_dict()
    finally:
        ctx.sql("SET result_cache_entries = 0")
    row = {"refresh_p50_ms": statistics.median(refresh_ms), "refresh_ms": refresh_ms,
           "full_first_run_p50_ms": statistics.median(full_ms), "full_ms": full_ms,
           "launches_per_refresh": 1, "delta_rows": ODD_DELTA_ROWS, "cache": stats}
    emit("ingest_delta_reuse", **row)
    return row


def _same_sketch_frame(got, want):
    """A delta-refreshed DELTA_SKETCH_SQL frame against the full run's: the
    keys and the sketch estimates equal, the revenue within KERNEL_RTOL
    (the kernel folds the rows in another order)."""
    got, want = (f.sort_values("c_region").reset_index(drop=True) for f in (got, want))
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        raise AssertionError(f"sketch refresh: frame {list(got.columns)} x {len(got)}")
    for c in ("c_region", "u_hll", "u_theta"):
        if not np.array_equal(np.asarray(got[c]), np.asarray(want[c])):
            raise AssertionError(f"sketch refresh: {c} differs from the full run")
    np.testing.assert_allclose(np.asarray(got["revenue"], np.float64),
                               np.asarray(want["revenue"], np.float64), rtol=KERNEL_RTOL)


def ingest_http(ctx, tables, orc):
    """(e): the server's ingest route on the card's context: an append as
    columns, visible to the next served query; a held ingest slot gives
    503 with Retry-After."""
    from spark_druid_olap_tpu_torch.server import OlapServer

    batch = ssb.fact_rows(tables, 512, seed=500)
    body = {"columns": {k: [v.item() if hasattr(v, "item") else v for v in col]
                        for k, col in batch.items()},
            "context": {"queryId": "phase15-ingest"}}
    srv = OlapServer(ctx, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        t0 = time.perf_counter()
        status, headers, raw = _http(base, "/druid/v2/ingest/lineorder", body)
        ack_ms = (time.perf_counter() - t0) * 1e3
        ack = json.loads(raw)
        if status != 200 or ack["appended"] != 512 or headers.get("X-Druid-Query-Id") != "phase15-ingest":
            raise AssertionError(f"ingest route: {status} {raw[:200]!r}")
        orc.add(batch)
        q = json.loads(json.dumps(ssb.NATIVE_QUERIES["q1_1"].to_druid(), default=str))
        status, _, raw = _http(base, "/druid/v2", q)
        got = float(json.loads(raw)[0]["event"]["revenue"])
        want = orc.want["q1_1"]
        if status != 200 or abs(got - want) > ORACLE_RTOL * abs(want):
            raise AssertionError(f"served q1_1 after the append: {got} vs oracle {want}")
        adm = ctx.resilience.ingest_admission
        adm.queue_timeout_ms = 50.0
        held = [adm.acquire() for _ in range(adm.max_concurrent)]
        try:
            full = _http(base, "/druid/v2/ingest/lineorder", body)
        finally:
            for _ in held:
                adm.release()
            adm.queue_timeout_ms = float(ctx.config.ingest_queue_timeout_ms)
        if full[0] != 503 or int(full[1].get("Retry-After", 0)) < 1:
            raise AssertionError(f"a held ingest slot: {full[0]} {full[1].get('Retry-After')}")
        status, _, raw = _http(base, "/status/health")
        health = json.loads(raw)
    finally:
        srv.shutdown()
    row = {"ack_status": 200, "ack_ms": ack_ms, "served_q1_1": got,
           "held_slot_status": full[0], "retry_after_s": int(full[1]["Retry-After"]),
           "ingest_admission": health["ingest_admission"]}
    emit("ingest_http", **row)
    return row


def _restart_frames(ctx):
    out = {}
    for name in INGEST_QUERIES:
        native = _ingest_run(ctx, name, "native")[0]
        out[name] = (native, ctx.sql(TOPN_SQL if name == "topn" else ssb.QUERIES[name]))
    return out


def ingest_restart(device, seed=7):
    """(f): a fresh SSB context at RESTART_SCALE with `storage_dir` in a
    temporary directory (removed at the end), registered through the
    sharded ingest (`ssb.register_streamed`): append, flush, append again
    (a WAL tail); a new context on the directory recovers (snapshot mmap
    and WAL replay) and serves frames bit-identical to the old one's; the
    first cold query reads the memory-mapped columns.  Then `load_table`
    and the SQL load of a saved directory answer alike."""
    import shutil
    import tempfile

    import pandas as pd

    root = tempfile.mkdtemp(prefix="sdol-phase15-")
    cfg = dict(result_cache_entries=0, storage_dir=os.path.join(root, "store"))
    try:
        t0 = time.perf_counter()
        ctx = TPUOlapContext(SessionConfig(**cfg), device=device)
        tables = ssb.register_streamed(ctx, RESTART_SCALE, seed=seed, chunk_rows=1 << 20,
                                       workers=STREAM_WORKERS)
        register_s = time.perf_counter() - t0
        ctx.append_rows("lineorder", ssb.fact_rows(tables, APPEND_ROWS, seed=600))
        t0 = time.perf_counter()
        ctx.storage.flush("lineorder")
        flush_ms = (time.perf_counter() - t0) * 1e3
        ctx.append_rows("lineorder", ssb.fact_rows(tables, APPEND_ROWS, seed=601,
                                                   new_city=NEW_CITY))
        before = _restart_frames(ctx)
        ctx.close()
        del ctx
        t0 = time.perf_counter()
        again = TPUOlapContext(SessionConfig(**cfg), device=device)
        recover_ms = (time.perf_counter() - t0) * 1e3
        rec = again.storage.last_recovery
        if rec["replayed_rows"] != APPEND_ROWS:
            raise AssertionError(f"recovery replayed {rec}")
        ds = again.catalog.get("lineorder")
        # the remap at replay reads every historical segment's c_city; the
        # other columns stay memory-mapped until a query reads them
        if not any(is_disk_backed(s.metrics["lo_revenue"]) for s in ds.segments):
            raise AssertionError("the restored columns are not disk-backed")
        first = _ingest_run(again, "q4_1", "native")
        after = _restart_frames(again)
        for name in INGEST_QUERIES:
            for a, b in zip(after[name], before[name]):
                pd.testing.assert_frame_equal(a, b, check_exact=True)
        pd.testing.assert_frame_equal(first[0], before["q4_1"][0], check_exact=True)
        warm = [_ingest_run(again, "q4_1", "native")[1] for _ in range(RESTART_WARM)]
        saved = os.path.join(root, "saved")
        t0 = time.perf_counter()
        again.save_table("lineorder", saved)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        again.load_table(saved, name="lineorder_loaded")
        load_ms = (time.perf_counter() - t0) * 1e3
        status = again.sql(f"CREATE TABLE lineorder_sql USING tpu_olap OPTIONS (path '{saved}')")
        q = ssb.NATIVE_QUERIES["q4_1"]
        for name in ("lineorder_loaded", "lineorder_sql"):
            got = again.engine.execute(dataclasses.replace(q, datasource=name),
                                       again.catalog.get(name))
            pd.testing.assert_frame_equal(got, before["q4_1"][0], check_exact=True)
        again.close()
        row = {"scale": RESTART_SCALE, "rows": ds.num_rows, "segments": len(ds.segments),
               "register_streamed_s": register_s, "flush_ms": flush_ms,
               "recover_ms": recover_ms, "replayed_rows": rec["replayed_rows"],
               "first_cold_ms": first[1], "first_cold_h2d_bytes": first[2].h2d_bytes,
               "warm_p50_ms": statistics.median(warm), "save_table_ms": save_ms,
               "load_table_ms": load_ms, "sql_load": status["status"][0],
               "bit_identical": True}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("ingest_restart", **row)
    return row


def ingest_sys(ctx):
    """(g): SYS_TICKS sampler ticks around a known number of queries, then
    SQL over `__sys` on the card."""
    from spark_druid_olap_tpu_torch.obs.telemetry import SYS_TABLE, SysSampler

    sampler = SysSampler(ctx, max_series=ctx.config.sys_sampler_max_series)
    sampler.sample_once()
    for _ in range(SYS_TICKS - 1):
        for name in ("q1_1", "q4_1"):
            _ingest_run(ctx, name, "native")
        sampler.sample_once()
    sql = f"SELECT sum(delta) AS d FROM {SYS_TABLE} WHERE metric = 'sdol_queries_total'"
    before = cuda_groupby.LAUNCHES
    t0 = time.perf_counter()
    df = ctx.sql(sql)
    ms = (time.perf_counter() - t0) * 1e3
    want = 2 * (SYS_TICKS - 1)
    on_card = ctx.engine.device.type == "cuda"
    if float(df["d"].iloc[0]) != want or (on_card and cuda_groupby.LAUNCHES == before):
        raise AssertionError(f"__sys: {df} (want {want}), {ctx.last_metrics.describe()}")
    row = {"ticks": sampler.ticks, "rows": ctx.catalog.get(SYS_TABLE).num_rows,
           "queries_counted": want, "sql_ms": ms, "strategy": ctx.last_metrics.strategy,
           "launches": cuda_groupby.LAUNCHES - before, "errors": sampler.errors}
    emit("ingest_sys", **row)
    return row


def run_ingest(ctxs, workloads, main_rows):
    """Phase 15 on phase 14's resident SSB SF10 context, then the restart
    on its own SSB SF1 context."""
    ctx = ctxs["ssb"]
    ctx.sql("SET result_cache_entries = 0")
    ctx.sql("SET fusion_window_ms = 0")
    tables = workloads["dims"]["ssb"]
    orc = IngestOracle(workloads["ssb"][1])
    phase4 = next(r["p50_ms"] for r in main_rows if r["query"] == "q4_1")
    out = {"appends": ingest_appends(ctx, tables, orc)}
    out["remap"] = ingest_remap(ctx, tables, orc)
    out["compaction"] = ingest_compact(ctx, orc, phase4)
    out["delta_reuse"] = ingest_delta_reuse(ctx, tables, orc)
    out["http"] = ingest_http(ctx, tables, orc)
    out["sys"] = ingest_sys(ctx)
    out["restart"] = ingest_restart(ctx.engine.device)
    return out


# -- phase 13: streaming ---------------------------------------------------------


def stream_query():
    """BASELINE config #4 as `bench.py` sends it."""
    return Q.TimeseriesQuery(
        datasource="events",
        granularity="hour",
        aggregations=(A.Count("n"), A.DoubleSum("v", "value"), A.DoubleMax("mx", "latency")),
        intervals=(datagen.event_stream_interval(),),
    )


def _stage_chunk(i: int, rows: int):
    """Chunk i of the event stream and its float64 oracle partials per hour
    of the week: rows, value sums, latency maxima."""
    c = datagen.gen_event_chunk(i, rows)
    lo, _ = datagen.event_stream_interval()
    hours = datagen.EVENT_SPAN_HOURS
    h = (c["ts"] - lo) // HOUR_MS
    mx = np.full(hours, -np.inf)
    np.maximum.at(mx, h, c["latency"].astype(np.float64))
    return c, (np.bincount(h, minlength=hours),
               np.bincount(h, weights=c["value"].astype(np.float64), minlength=hours), mx)


def stage_stream(n_chunks: int, rows: int, workers: int = STREAM_WORKERS):
    """The staged stream and its oracle.  Chunks are generated on a thread
    pool (numpy's generators release the GIL), each from its own seed, so
    their bits do not depend on the threads; then every column is read
    once, so no timing pays first-touch page faults."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(_stage_chunk, range(n_chunks), [rows] * n_chunks))
    staged = [c for c, _ in parts]
    oracle = prefix_oracle([p for _, p in parts], len(parts))
    oracle["parts"] = [p for _, p in parts]  # per chunk, for a prefix's oracle
    del parts
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sink = 0.0
    for c in staged:
        for a in c.values():
            sink += float(a.sum())
    info = {"chunks": n_chunks, "chunk_rows": rows, "rows": n_chunks * rows,
            "host_bytes": sum(a.nbytes for c in staged for a in c.values()),
            "generate_s": gen_s, "warm_s": time.perf_counter() - t0, "workers": workers,
            "checksum": sink}
    return staged, oracle, info


def prefix_oracle(parts, n: int) -> dict:
    """The stream oracle over its first `n` chunks, from per-chunk partials."""
    return {
        "n": np.sum([p[0] for p in parts[:n]], axis=0),
        "v": np.sum([p[1] for p in parts[:n]], axis=0),
        "mx": np.max([p[2] for p in parts[:n]], axis=0),
    }


def stream_resilience(device, staged, oracle, chunk_rows: int, stream_wall_s: float):
    """Phase 13's share of the resilience phase (the staged stream exists
    only here).  First `streaming.chunk_loop` with an injected deadline at
    the middle chunk (skip = chunks / 2): coverage (rows folded over the
    stream's rows) 0.5, the frame against the oracle over the first half,
    the producer thread joined and the staging ring freed: the caching host
    allocator's pinned bytes unchanged after a second cut stream (a ring
    left alive would make the next one allocate anew).
    Then a wall-clock deadline of about half the stream's wall: wall,
    overshoot and coverage, reported; failing only past a whole stream's
    wall."""
    q, ds = stream_query(), datagen.event_stream_schema()
    ex = StreamExecutor(engine=Engine(device=device))
    total = len(staged) * chunk_rows
    half = len(staged) // 2

    def cut(skip):
        _arm("streaming.chunk_loop", error_type=resilience.InjectedDeadline, skip=skip, times=1)
        try:
            with resilience.partial_scope(True) as pc:
                df, ms = _timed(lambda: ex.execute(q, ds, iter(staged), chunk_rows))
        finally:
            _disarm()
        st = ex.stats
        if not (st.truncated and st.producer_joined and st.chunks == skip and pc.is_partial):
            raise AssertionError(f"stream truncation: {dataclasses.asdict(st)}")
        return df, ms, pc

    pinned_before = _host_pinned_bytes()
    df, ms, pc = cut(half)
    if pc.rows_seen != half * chunk_rows:
        raise AssertionError(f"stream truncation: rows {pc.rows_seen}")
    err = _stream_frame_check(df, prefix_oracle(oracle["parts"], half))
    cut(min(8, half))
    pinned_after = _host_pinned_bytes()
    if pinned_after != pinned_before:
        raise AssertionError(f"pinned host bytes {pinned_after} after two cut streams, "
                             f"{pinned_before} before")
    trunc = {"chunks": len(staged), "skip": half, "coverage": pc.rows_seen / total,
             "chunks_folded": half, "wall_ms": ms, "producer_joined": True,
             "host_pinned_bytes_before": pinned_before, "host_pinned_bytes_after": pinned_after,
             "oracle_max_rel_err": err}
    emit("resilience_stream_truncation", **trunc)
    timeout = max(1, int(stream_wall_s * 1e3 / 2))
    with resilience.deadline_scope(timeout), resilience.partial_scope(True) as pc:
        df, wall = _timed(lambda: ex.execute(q, ds, iter(staged), chunk_rows))
    row = {"query": "stream", "p50_ms": stream_wall_s * 1e3, "timeout_ms": timeout,
           "wall_ms": wall, "overshoot_ms": wall - timeout, "partial": pc.is_partial,
           "coverage": pc.rows_seen / total, "chunks_folded": ex.stats.chunks,
           "producer_joined": ex.stats.producer_joined}
    emit("resilience_wall_deadline", **row)
    if wall - timeout > stream_wall_s * 1e3 or not ex.stats.producer_joined:
        raise AssertionError(f"stream deadline: {row}")
    return {"truncation": trunc, "wall_deadline": row}


def _host_pinned_bytes():
    """The pinned bytes the CUDA caching host allocator holds
    (`allocated_bytes.current`: a freed block stays cached and is handed to
    the next request, so the count grows only when a request finds no free
    block), after the device and the collector are settled; None on the
    CPU."""
    if not torch.cuda.is_available():
        return None
    gc.collect()
    torch.cuda.synchronize()
    torch.empty(1, pin_memory=True)  # the allocator processes its freed blocks' events
    return torch.cuda.host_memory_stats()["allocated_bytes.current"]


def _stream_frame_check(frame, oracle) -> float:
    """One row per hour of the week in order, counts exact, sums within
    ORACLE_RTOL, maxima exact; returns the largest relative sum error."""
    hours = datagen.EVENT_SPAN_HOURS
    lo, _ = datagen.event_stream_interval()
    if len(frame) != hours:
        raise AssertionError(f"stream: {len(frame)} buckets, want {hours}")
    want_ts = (lo + np.arange(hours, dtype=np.int64) * HOUR_MS).astype("datetime64[ms]")
    if not np.array_equal(frame["timestamp"].to_numpy().astype("datetime64[ms]"), want_ts):
        raise AssertionError("stream: bucket timestamps differ from the oracle")
    if not np.array_equal(frame["n"].to_numpy().astype(np.int64), oracle["n"]):
        raise AssertionError("stream: counts differ from the oracle")
    err = np.abs(frame["v"].to_numpy(np.float64) - oracle["v"]) / np.abs(oracle["v"])
    if not (err <= ORACLE_RTOL).all():
        raise AssertionError(f"stream: sums off by {float(err.max())} (rtol {ORACLE_RTOL})")
    if not np.array_equal(frame["mx"].to_numpy(np.float64), oracle["mx"]):
        raise AssertionError("stream: maxima differ from the oracle")
    return float(err.max())


def check_stream_whole(name: str, ex, chunks: int) -> None:
    """A stream answered clean: no deadline cut it and it folded every
    chunk (a stream publishes no QueryMetrics for `MetricsWatch`)."""
    if ex.stats.truncated or ex.stats.chunks != chunks:
        raise AssertionError(f"{name}: {dataclasses.asdict(ex.stats)} for {chunks} chunks")


def run_stream(device, staged, oracle, chunk_rows: int, ab_chunks: int):
    """The timed stream with double buffering on, checked against the
    oracle and for one kernel launch per chunk (on a card); a second run
    and a run with double buffering off, bit-identical to it; then on
    against off over the first `ab_chunks` chunks, interleaved."""
    import pandas as pd

    q, ds = stream_query(), datagen.event_stream_schema()
    engine = Engine(device=device)
    ex = {"on": StreamExecutor(engine=engine), "off": StreamExecutor(engine=engine, double_buffer=False)}

    def timed(mode, chunks):
        t0 = time.perf_counter()
        df = ex[mode].execute(q, ds, iter(chunks), chunk_rows)
        wall = time.perf_counter() - t0
        check_stream_whole(f"stream ({mode})", ex[mode], len(chunks))
        return df, wall

    for mode in ex:  # warm-up: the lowering, the staging ring, first launches
        timed(mode, staged[:1])
    cuda_groupby.LAUNCHES = 0  # count only the timed stream's launches
    frame, wall = timed("on", staged)
    launches = cuda_groupby.LAUNCHES
    stats = dataclasses.asdict(ex["on"].stats)
    if stats["strategy"] != engine._kernel_class():
        raise AssertionError(f"stream ran {stats['strategy']}, not the kernel class")
    if device.type == "cuda" and launches != len(staged):
        raise AssertionError(f"stream: {launches} kernel launches for {len(staged)} chunks")
    max_rel = _stream_frame_check(frame, oracle)
    again, wall_again = timed("on", staged)
    pd.testing.assert_frame_equal(again, frame, check_exact=True)
    serial, wall_off = timed("off", staged)
    pd.testing.assert_frame_equal(serial, frame, check_exact=True)
    ab = {"on": [], "off": []}
    ab_frames = {}
    for mode in ("on", "off", "off", "on"):
        df, w = timed(mode, staged[:ab_chunks])
        ab[mode].append(w)
        if ab_frames.setdefault(mode, df) is not df:
            pd.testing.assert_frame_equal(df, ab_frames[mode], check_exact=True)
    pd.testing.assert_frame_equal(ab_frames["on"], ab_frames["off"], check_exact=True)
    rows = stats["rows"]
    return {
        "rows": rows, "chunks": stats["chunks"], "chunk_rows": chunk_rows,
        "wall_s": wall, "rows_per_s": rows / wall, "stats": stats,
        "h2d_gb_per_s": stats["h2d_bytes"] / wall / 1e9,
        "h2d_bytes_per_row": stats["h2d_bytes"] / rows,
        "kernel_launches": launches, "oracle_max_rel_err": max_rel,
        "wall_again_s": wall_again, "wall_double_buffer_off_s": wall_off,
        "bit_identical": True,
        "ab_chunks": ab_chunks, "ab_wall_on_s": ab["on"], "ab_wall_off_s": ab["off"],
        "ab_on_over_off": sum(ab["on"]) / sum(ab["off"]),
        "count_max": int(oracle["n"].max()), "count_exact_below": 1 << 24,
    }


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(u) -> int:
    return sum(b - a for a, b in u)


def _overlap(u, w) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(u) and j < len(w):
        total += max(0, min(u[i][1], w[j][1]) - max(u[i][0], w[j][0]))
        if u[i][1] < w[j][1]:
            i += 1
        else:
            j += 1
    return total


def _profiled_intervals(prof):
    """A profiler window's device intervals in ns: HtoD copies, kernels,
    every device event; and device ms by name."""
    copies, kernels, every, names = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        every.append(iv)
        name = e.name()
        names[name] = names.get(name, 0.0) + e.duration_ns() / 1e6
        if "HtoD" in name:
            copies.append(iv)
        elif not name.startswith(("Memcpy", "Memset")):
            kernels.append(iv)
    return copies, kernels, every, names


def _event_intervals(ex, q, ds, chunks, chunk_rows: int):
    """One stream with CUDA timing events around each chunk's copies, on the
    stream that issues them, and around its compute, on the compute stream
    from after its wait on the copy to the end of its fold: (copy, compute)
    intervals in ns.  Both also hold the gaps in which a stream waited for
    the host to issue its next op, so they read more busy time than the
    profiler's device events."""
    from spark_druid_olap_tpu_torch.exec import streaming

    put, fold, prep = streaming.pipelined_put, streaming.fold_partials, ex._prep
    copies, computes = [], []

    def mark(stream=None):
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream or torch.cuda.current_stream())
        return e

    def timed_put(host, device, stream=None):
        s = stream or torch.cuda.current_stream(device)
        start = mark(s)
        out = put(host, device, stream)
        copies.append((start, mark(s)))
        return out

    def timed_prep(*args):
        computes.append([mark()])
        return prep(*args)

    def timed_fold(*args):
        out = fold(*args)
        computes[-1].append(mark())
        return out

    origin = mark()
    streaming.pipelined_put, streaming.fold_partials, ex._prep = timed_put, timed_fold, timed_prep
    try:
        ex.execute(q, ds, iter(chunks), chunk_rows)
    finally:
        streaming.pipelined_put, streaming.fold_partials = put, fold
        del ex._prep
    torch.cuda.synchronize()

    def ns(iv):
        return tuple(origin.elapsed_time(e) * 1e6 for e in iv)

    return [ns(iv) for iv in copies], [ns(iv) for iv in computes]


def _overlap_summary(copies, computes, every, wall_ms, h2d_bytes):
    """Copy ms, compute ms, the share of copy time that overlaps compute,
    the link rate, and the device's busy and idle share of `wall_ms`."""
    cu, ku = _union(copies), _union(computes)
    htod_ms = sum(b - a for a, b in copies) / 1e6
    busy_ms = _length(_union(every)) / 1e6
    return {
        "htod_ms": htod_ms, "compute_ms": sum(b - a for a, b in computes) / 1e6,
        "copy_overlap_share": _overlap(cu, ku) / _length(cu),
        "h2d_link_gb_per_s": h2d_bytes / (htod_ms / 1e3) / 1e9,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
    }


def profile_stream(device, chunks, chunk_rows: int, double_buffer: bool):
    """A stream over `chunks` unprofiled (its wall); one under CUDA timing
    events (copy and compute intervals per chunk); then one under
    torch.profiler: HtoD memcpy ms, kernel ms, the share of copy time that
    overlaps a kernel, the link rate, and the device's busy and idle share
    of the unprofiled wall.  A profiler window that recorded no HtoD copy
    or no kernel is taken again, up to PROFILE_TRIES windows; if none
    recorded both, the headline numbers are the events' (`timer`)."""
    from torch.profiler import ProfilerActivity, profile

    q, ds = stream_query(), datagen.event_stream_schema()
    ex = StreamExecutor(engine=Engine(device=device), double_buffer=double_buffer)
    ex.execute(q, ds, iter(chunks[:1]), chunk_rows)
    t0 = time.perf_counter()
    ex.execute(q, ds, iter(chunks), chunk_rows)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check_stream_whole("stream profile", ex, len(chunks))
    copies, computes = _event_intervals(ex, q, ds, chunks, chunk_rows)
    if len(copies) != len(chunks) or len(computes) != len(chunks):
        raise AssertionError(f"stream events: {len(copies)} copies and {len(computes)} "
                             f"computes for {len(chunks)} chunks")
    events = _overlap_summary(copies, computes, copies + computes, wall_ms,
                              ex.stats.h2d_bytes)
    for windows in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ex.execute(q, ds, iter(chunks), chunk_rows)
            torch.cuda.synchronize()
        copies, kernels, every, names = _profiled_intervals(prof)
        if copies and kernels:
            break
    out = {"double_buffer": double_buffer, "chunks": len(chunks), "wall_ms": wall_ms,
           "profiler_windows": windows, "events": events}
    if not (copies and kernels):
        return {**out, "timer": "events", "profiler": None,
                **{k: events[k] for k in ("copy_overlap_share", "h2d_link_gb_per_s",
                                          "device_busy_share", "device_idle_share")}}
    # three copies a chunk (time offsets, value, latency), of equal size;
    # the trace may miss the first few
    issued = 3 * ex.stats.chunks
    prof_sum = _overlap_summary(copies, kernels, every, wall_ms,
                                ex.stats.h2d_bytes * len(copies) / issued)
    profiler = {
        "htod_memcpy_ms": prof_sum["htod_ms"], "htod_copies": len(copies),
        "htod_copies_issued": issued, "kernel_ms": prof_sum["compute_ms"],
        "groupby_kernel_ms": sum(v for k, v in names.items()
                                 if "partial_pass" in k or "fold_pass" in k),
        **{k: prof_sum[k] for k in ("copy_overlap_share", "h2d_link_gb_per_s",
                                    "device_busy_ms", "device_busy_share",
                                    "device_idle_share")},
        "copy_kinds": sorted(k for k in names if "HtoD" in k),
        "top_device_ms": sorted(names.items(), key=lambda kv: -kv[1])[:6],
    }
    return {**out, "timer": "profiler", "profiler": profiler,
            **{k: profiler[k] for k in ("copy_overlap_share", "h2d_link_gb_per_s",
                                        "device_busy_share", "device_idle_share")}}

# -- phase 16: the cost model ---------------------------------------------------

COST_WARM = 2  # timed runs of each class of a query, after its first run and capture (3 until phase 18)
# the SSB queries of phase 4 (the 13, the Timeseries, the TopN) and TPC-H Q1, q3, q10
COST_QUERIES = ([("ssb", n) for n in ssb.QUERIES] + [("ssb", "timeseries"), ("ssb", "topn")]
                + [("tpch", n) for n in ("q1", "q3", "q10")])
PICK_SLACK = 1.25  # a pick within this factor of the fastest class is reported a hit
COST_SKIP = 10  # a class whose first run is this many times the fastest's is timed once
# the pick that flips between calibrations (PERF.md section 6): TPC-H q3's
# adaptive and sparse price within the constants' spread
KNOWN_FLIPS = {("tpch", "q3")}


def cost_constants(cfg) -> dict:
    """The calibrated constants of a config."""
    return {k: getattr(cfg, k) for k in CALIBRATED_FLOATS + CALIBRATED_INTS}


def calibrate_on_card(device, path):
    """(a) `plan/calibrate.calibrate` on the card into `path`, loaded back:
    every constant measured, finite and positive, the file naming this card.
    Returns (the loaded config, the file's contents)."""
    t0 = time.perf_counter()
    out = calibrate.calibrate(save_path=path, device=device)
    seconds = time.perf_counter() - t0
    cfg = SessionConfig.load_calibrated(path=path, device=device)
    consts = cost_constants(cfg)
    missing = [k for k in CALIBRATED_FLOATS if out.get(k) is None]
    bad = {k: v for k, v in consts.items() if not (np.isfinite(v) and v > 0)}
    if missing or bad or out["partial"]:
        raise AssertionError(f"calibration: unmeasured {missing}, not finite and positive {bad}")
    if out["device"] != torch.cuda.get_device_name(device) or not cfg.calibration_meta["applied"]:
        raise AssertionError(f"calibration of {out['device']} not applied: {cfg.calibration_meta}")
    emit("cost_calibration", seconds=seconds, file=path, device=out["device"],
         power_limit=out["power_limit"], constants=consts,
         per_row_dense_at=out["per_row_dense_at"], spread=out["spread"],
         meta=cfg.calibration_meta)
    return cfg, out


def _cost_case(ctx, workload, name, fresh_cfg):
    """One query of phase 16: (its plan, the plan under the fresh
    calibration, the modelled us per class, run(strategy) -> frame).  A SQL
    query's plan is its rewrite's, and `ctx.sql` runs it (the strategy
    argument aside: the context passes the plan's class, or the engine's
    pin); the native Timeseries' and TopN's is `choose_physical` at the
    engine's G, as the planner prices a SQL one, and `run` passes the
    strategy it is given (None: the engine's, its pin)."""
    dev = ctx.engine.device
    if name in ("timeseries", "topn"):
        q = ssb.TIMESERIES_QUERY if name == "timeseries" else ssb.TOPN_QUERY
        ds = ctx.catalog.get(q.datasource)
        inner = timeseries_to_groupby(q) if name == "timeseries" else topn_to_groupby(q)
        G = ctx.engine._lowering_for(groupby_with_time_granularity(inner), ds).num_groups

        def run(strategy):
            return ctx.engine.execute(q, ds, strategy)
    else:
        sql = (tpch if workload == "tpch" else ssb).QUERIES[name]
        rw = ctx.plan_sql(sql)
        q, ds, G = rw.query, ctx.catalog.get(rw.datasource), rw.num_groups

        def run(strategy):
            return ctx.sql(sql)
    phys = choose_physical(q, ds, G, ctx.config, device=dev)
    fresh = choose_physical(q, ds, G, fresh_cfg, device=dev)
    costs = query_kernel_costs(q, ds, G, ctx.config, device=dev)
    return phys, fresh, costs, run, ds


def _class_p50(ctx, name, workload, frame, run, cls, warm, best_ms=None, rtol=ORACLE_RTOL):
    """The p50 of `warm` runs of one query pinned to class `cls`
    (`ctx.engine.strategy`), after a first run (held against the oracle,
    sums within `rtol`) and a second (the capture); (p50, runs timed, the
    first run's metrics, its largest relative error).  A first run above
    COST_SKIP times `best_ms` (the fastest class so far) stands as the
    class's time, one run: a class that far behind needs no p50 to lose."""
    ctx.engine.strategy = cls
    try:
        t0 = time.perf_counter()
        first = run(None)
        first_ms = (time.perf_counter() - t0) * 1e3
        m = ctx.last_metrics
        try:
            err = check_against_oracle(name, first, frame, workload, rtol=rtol)
        except AssertionError as fault:
            raise AssertionError(f"{cls}, rtol {rtol}: {fault}") from None
        if best_ms is not None and first_ms > COST_SKIP * best_ms:
            return first_ms, 1, m, err
        run(None)
        times = _runs_ms(lambda: run(None), warm)
    finally:
        ctx.engine.strategy = "auto"
    return statistics.median(times), warm, m, err


def run_cost_picks(ctxs, workloads, tier_rows, fresh_cfg, warm=COST_WARM):
    """(b) Each query's plan and the warm p50 of every class the model
    prices (finite cost), each pinned in turn (`ctx.engine.strategy`), its
    answer held against the oracle; a class phase 8 already forced on the
    query (its path not declined) reuses phase 8's p50.  The planned run
    (the engine's strategy "auto") takes its plan's route or records a
    decline, and its answer holds against the oracle.  Every answer is held
    to ORACLE_RTOL, the scatter's pinned at G <= SCATTER_CUTOVER included
    (it accumulates a segment's sums in float64).  Reported per
    query: the pick, the pick under (a)'s fresh calibration, the modelled us
    and the p50 per class, the fastest, each class's largest relative
    error, and whether the pick's p50 is within PICK_SLACK of the fastest
    (reported, not failed); then the queries whose pick the fresh
    calibration changes, beside KNOWN_FLIPS (reported, not failed)."""
    reuse = {}
    for r in tier_rows:  # a forced class that answered itself, or the plan's
        cls = r["strategy_asked"] if r["strategy_asked"] != "auto" else r["plan"]
        if r["strategy"] == class_strategy(cls, "cuda"):
            reuse[(r["workload"], r["query"], cls)] = r["p50_ms"]
    out = []
    for workload, name in COST_QUERIES:
        ctx = ctxs[workload]
        dev = ctx.engine.device
        _, frame = workloads[workload]
        phys, fresh, costs, run, ds = _cost_case(ctx, workload, name, fresh_cfg)
        first = run(phys.strategy)
        m = ctx.last_metrics
        check_route(name, m, plan=phys.strategy, device=dev)
        err = check_against_oracle(name, first, frame, workload)
        p50, runs, reused, class_err, tol = {}, {}, [], {}, {}
        # the plan's class first: the others are timed against it
        for cls in sorted((c for c, us in costs.items() if np.isfinite(us)),
                          key=lambda c: c != phys.strategy):
            if (workload, name, cls) in reuse:
                p50[cls] = reuse[(workload, name, cls)]
                reused.append(cls)
                continue
            tol[cls] = ORACLE_RTOL
            ms, runs[cls], cm, class_err[cls] = _class_p50(
                ctx, name, workload, frame, run, cls, warm, min(p50.values(), default=None),
                rtol=tol[cls])
            check_route(f"{name} ({cls})", cm, cls, device=dev)
            p50[cls] = ms
        fastest = min(p50, key=p50.get)
        out.append({
            "query": name, "workload": workload, "num_groups": phys.num_groups,
            "pick": phys.strategy, "pick_fresh": fresh.strategy, "ran": m.strategy,
            "declines": m.tier_declines, "modelled_us": {k: v for k, v in costs.items()
                                                         if np.isfinite(v)},
            "p50_ms": p50, "runs": runs, "reused_from_phase_8": reused,
            "class_max_rel_err": class_err, "class_rtol": tol,
            "fastest": fastest,
            "pick_over_fastest": p50[phys.strategy] / p50[fastest],
            "within_slack": p50[phys.strategy] <= PICK_SLACK * p50[fastest],
            "oracle_max_rel_err": err,
        })
        emit("cost_pick", **out[-1])
    flips = [(r["workload"], r["query"]) for r in out if r["pick_fresh"] != r["pick"]]
    emit("cost_pick_agreement", queries=len(out), picks_within_slack=sum(
        r["within_slack"] for r in out), fresh_flips=flips,
         fresh_flips_beyond_known=[f for f in flips if f not in KNOWN_FLIPS])
    return out


def assist_against_rule(ctx, tables, frame, fallback_rows):
    """(c) The calibrated assist's decision on each of phase 10's twelve
    classes (phase 10 ran them under the calibrated context): assisted, or
    declined with the modelled figures.  Where the cost model declined a
    subtree, the query runs once more under the rules alone (the assist
    without its cost gate: `_assist_cost_decline` answering None), its
    answer held against the oracle, for its ms (one run: its phase-10
    decode cache is warm); elsewhere the decisions are the rule's and
    phase 10's p50 stands for both."""
    out = []
    for r in fallback_rows:
        name = r["query"]
        modelled = [d for d in r["declines"] if d.startswith("assist: modelled")]
        row = {"query": name, "executor": r["executor"], "assist_subplans": r["assist_subplans"],
               "cost_declines": modelled, "p50_ms": r["p50_ms"],
               "assist_off_p50_ms": r["assist_off_p50_ms"]}
        if modelled:
            sql = tpch.EXTENDED_QUERIES[name]
            ctx._assist_cost_decline = lambda rw, rows: None
            try:
                t0 = time.perf_counter()
                got = ctx.sql(sql)
                rule_ms = (time.perf_counter() - t0) * 1e3
                m = ctx.last_metrics
            finally:
                del ctx._assist_cost_decline
            _extended_check(f"{name} (rule)", got, tpch.extended_oracle(tables, name, frame))
            row.update(rule_ms=rule_ms, rule_assist_subplans=m.assist_subplans,
                       rule_executor=m.executor)
        else:
            row.update(rule_ms=r["p50_ms"], rule_assist_subplans=r["assist_subplans"],
                       rule_executor=r["executor"], same_as_rule=True)
        out.append(row)
        emit("cost_assist", **row)
    return out


def stream_class_check(device, cfg, chunks: int = 2):
    """(d) The stream's class at (2^21 rows, G 169) under the fresh
    calibration: the executor's strategy is the model's class there, and
    a short stream in that class holds against the oracle."""
    rows = STREAM_SHAPE[0]
    staged, oracle, _ = stage_stream(chunks, rows, workers=2)
    engine = Engine(device=device)
    engine.cost_config = cfg
    ex = StreamExecutor(engine=engine)
    q, ds = stream_query(), datagen.event_stream_schema()
    cls = choose_kernel_strategy(rows, STREAM_SHAPE[1], cfg, device=device)
    t0 = time.perf_counter()
    frame = ex.execute(q, ds, iter(staged), rows)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check_stream_whole("stream class", ex, chunks)
    if ex.stats.strategy != class_strategy(cls, device):
        raise AssertionError(f"stream ran {ex.stats.strategy}, the model's class is {cls}")
    out = {"class": cls, "strategy": ex.stats.strategy, "chunks": chunks, "wall_ms": wall_ms,
           "modelled_us": {k: v for k, v in _kernel_costs(rows, STREAM_SHAPE[1], cfg, False,
                                                          device=device) if np.isfinite(v)},
           "oracle_max_rel_err": _stream_frame_check(frame, oracle)}
    emit("cost_stream", **out)
    return out


def run_cost_model(ctxs, workloads, tier_rows, fallback_rows, device, tmp):
    """Phase 16: (a) to (d) above; returns their records."""
    cfg, cal = calibrate_on_card(device, os.path.join(tmp, "calibration.torch_cuda.json"))
    picks = run_cost_picks(ctxs, workloads, tier_rows, cfg)
    assists = assist_against_rule(ctxs["tpch"], workloads["dims"]["tpch"],
                                  workloads["tpch"][1], fallback_rows)
    stream = stream_class_check(device, cfg)
    return {"calibration": cal, "picks": picks, "assists": assists, "stream": stream}


# -- phase 17: multi-device ------------------------------------------------------

MESH_WARM = 1  # warm runs of each query's plan on a mesh, after its cold run and capture (2 until phase 18)
MESH_STREAM_CHUNKS = 32  # BASELINE config #4's stream cut to 32 chunks of 2^21 rows
MESH_DEADLINE_STEP = 3  # the local step the mesh's deadline sweep stops before
MESH_SKETCHES = ("topn_hll", "cube_theta", "quantiles")


def mesh_shapes():
    """The kernel shapes phase 17 adds: on the (2, 2) mesh each device keeps
    half of an even group domain, so every even G of MAIN_SHAPES launches
    at G / 2 (an odd one runs replicated, at G); and the stream's 2^21-row
    chunk splits into four 2^19-row shards on the (4, 1) mesh.  The
    row-shard path launches at most a segment's 2^19 rows at a time
    (`parallel.distributed.SHARD_BLOCK_ROWS`), so each is checked there."""
    out = {(R, G // 2, Ms, Mn, Mx) for R, G, Ms, Mn, Mx in MAIN_SHAPES
           if R == 524288 and G % 2 == 0 and G > 1}
    out.add((STREAM_SHAPE[0] // 4,) + STREAM_SHAPE[1:])
    return sorted(s for s in out if s not in set(MAIN_SHAPES))


MESH_SHAPES = mesh_shapes()


def mesh_kernel_checks(device):
    """Phase 3's share for phase 17's shapes: each checked against the plain
    version as the main shapes are, and timed by profiler device time over
    inputs rotated past the L2 (one partial and one fold pass a call),
    beside its bound, the wrapper's call and the plain version's."""
    rows = []
    for i, (R, G, Ms, Mn, Mx) in enumerate(MESH_SHAPES):
        args, max_abs, max_rel = check_kernel_shape(R, G, Ms, Mn, Mx, device, seed=300 + i)
        kw = dict(num_groups=G, num_min=Mn, num_max=Mx)
        set_bytes = sum(t.numel() * t.element_size() for t in args)
        n = max(20, -(-int(ROTATE_BYTES) // set_bytes))
        sets = [args] + [[t.clone() for t in args] for _ in range(n - 1)]
        ms, timer, _, events = device_ms(
            lambda j: cuda_groupby.cuda_partial_aggregate(*sets[j], **kw), n, 2 * n)
        del sets
        b_ms, b_by = bound(R, G, Ms, Mn, Mx)
        rows.append({
            "shape": (R, G, Ms, Mn, Mx), "mesh": True, "max_abs_err": max_abs,
            "max_rel_err": max_rel, "ms": ms, "timer": timer,
            "events": sum(events.values()), "rotated_sets": n,
            "call_ms": cuda_ms(lambda: cuda_groupby.cuda_partial_aggregate(*args, **kw)),
            "plain_ms": cuda_ms(lambda: cuda_groupby.plain_partial_aggregate(*args, G, Mn, Mx),
                                reps=1, warm=0),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
        })
        emit("kernel_mesh_check", **rows[-1])
    return rows


# cost constants under which the cost model picks each merge tree on the
# 2 x 2 slice mesh (`plan.cost.choose_merge_tree`): a slow link within the
# slices makes flat the cheaper tree, a slow link between them hierarchical
TREE_RATES = {"flat": {"collective_bytes_per_us": 1e3, "dcn_bytes_per_us": 1e9},
              "hierarchical": {"collective_bytes_per_us": 1e9, "dcn_bytes_per_us": 1e3}}


def mesh_list(device):
    """(label, mesh, the merge tree its rates make the cost model pick, or
    None for the session's) of each mesh phase 17 drives: the logical
    meshes on `device`, and (n, 1) over the real cards where there are two
    or more."""
    dev4 = [device] * 4
    out = [("4x1", make_mesh(4, 1, dev4), None), ("2x2", make_mesh(2, 2, dev4), None),
           ("slice2x2-flat", make_slice_mesh(2, 2, dev4), "flat"),
           ("slice2x2-hier", make_slice_mesh(2, 2, dev4), "hierarchical")]
    n = torch.cuda.device_count()
    if n >= 2:
        out.append((f"{n}x1-cards", make_mesh(n, 1), None))
    return out


MESH_BASELINE_LAUNCHES = [0]  # launches of phase 17's single-device baselines


def _baseline(fn):
    """A single-device run of phase 17, its launches counted apart from the
    meshes' (MESH_BASELINE_LAUNCHES)."""
    before = cuda_groupby.LAUNCHES
    try:
        return fn()
    finally:
        MESH_BASELINE_LAUNCHES[0] += cuda_groupby.LAUNCHES - before


def _mesh_case(ctx, workload, name):
    """(native spec, datasource, post, G) of one query of phase 17: a SQL
    query's planned rewrite with the SQL surface's host post-processing,
    or the native Timeseries and TopN."""
    if name in ("timeseries", "topn"):
        q = ssb.TIMESERIES_QUERY if name == "timeseries" else ssb.TOPN_QUERY
        ds = ctx.catalog.get(q.datasource)
        inner = timeseries_to_groupby(q) if name == "timeseries" else topn_to_groupby(q)
        G = ctx.engine._lowering_for(groupby_with_time_granularity(inner), ds).num_groups
        return q, ds, (lambda df: df), G
    rw = ctx.plan_sql((tpch if workload == "tpch" else ssb).QUERIES[name])
    ds = ctx.catalog.get(rw.datasource)
    return rw.query, ds, (lambda df, rw=rw, ds=ds: ctx._post_process(rw, ds, df)), rw.num_groups


def _same_as_single(name, got, single):
    """The mesh's frame against the single-device port's: keys and counts
    exact, sums within ORACLE_RTOL (another order of adds); for the ranked
    queries the ranked values."""
    if name in ("topn", "q3", "q10"):
        value = "revenue"
        g = np.asarray(got[value], dtype=np.float64)
        w = np.asarray(single[value], dtype=np.float64)
        if len(g) != len(w) or not (np.abs(g - w) <= ORACLE_RTOL * np.abs(w)).all():
            raise AssertionError(f"{name}: mesh ranking differs from the single device's")
        return
    floats = [c for c in single.columns if single[c].dtype.kind == "f"]
    keys = [c for c in single.columns if c not in floats]
    _frame_check(name, got[list(single.columns)], single, keys)


def _mesh_plan(eng, q, ds) -> str:
    """The class the mesh engine's cost model routes `q` to."""
    from spark_druid_olap_tpu_torch.exec.lowering import memo_key

    inner = groupby_with_time_granularity(eng._groupby_family(q, ds)[0])
    return eng._route_class(inner, ds, eng._lowering_for(inner, ds), memo_key(inner, ds))


def run_mesh_queries(ctxs, workloads, meshes, device):
    """(a) Every query of phase 16 on each mesh under the mesh's plan (the
    cost model at the query's G), on (4, 1) also pinned to every class the
    model prices; each answer against the oracle and the single-device
    port's frame under the same class, the route checked; the warm p50 of
    the plan on each mesh beside the single device's."""
    rows = []
    engines = {}
    trees = {}  # the merge trees each mesh ran
    for label, mesh, tree in meshes:
        eng = DistributedEngine(mesh)
        engines[label] = eng
        emit("mesh", label=label, **eng.describe(), merge_tree=tree or "cost model",
             rates=TREE_RATES.get(tree, {}))
    # the slice meshes and (4, 1) stack the same blocks on the same device
    for label in ("slice2x2-flat", "slice2x2-hier"):
        if label in engines and "4x1" in engines:
            engines[label]._shard_cache = engines["4x1"]._shard_cache
    for workload, name in COST_QUERIES:
        ctx = ctxs[workload]
        _, frame = workloads[workload]
        q, ds, post, G = _mesh_case(ctx, workload, name)
        costs = query_kernel_costs(q, ds, G, ctx.config, device=device)
        splan = choose_physical(q, ds, G, ctx.config, device=device).strategy
        single_p50 = _baseline(lambda: _median_ms(lambda: ctx.engine.execute(q, ds, splan),
                                                  MESH_WARM))
        singles = {}

        def single(cls):
            if cls not in singles:
                singles[cls] = _baseline(lambda: post(ctx.engine.execute(q, ds, cls)))
            return singles[cls]

        row = {"query": name, "workload": workload, "num_groups": G, "single_plan": splan,
               "single_p50_ms": single_p50, "mesh": {}}
        for label, _mesh, tree in meshes:
            eng = engines[label]
            eng.cost_config = dataclasses.replace(ctx.config, **TREE_RATES.get(tree, {}))
            pinned = [c for c, us in costs.items() if np.isfinite(us)] if label == "4x1" else []
            for cls in [None] + pinned:
                plan = _mesh_plan(eng, q, ds) if cls is None else cls
                before = cuda_groupby.LAUNCHES
                first = post(eng.execute(q, ds, cls))
                launched = cuda_groupby.LAUNCHES - before
                m = eng.last_metrics
                if not (m.distributed and m.mesh_shape == tuple(eng.mesh.shape.values())):
                    raise AssertionError(f"{label} {name}: metrics {m.describe()}")
                check_route(f"{label} {name} ({cls or 'plan'})", m, plan=plan, device=device)
                err = check_against_oracle(name, first, frame, workload)
                _same_as_single(name, first, single(plan))
                on_card = torch.device(device).type == "cuda"
                if on_card and uses_kernel(m) and launched == 0:
                    raise AssertionError(f"{label} {name}: {m.strategy} never launched the kernel")
                # flat: the row-shard path; none: an empty scope or the
                # sparse tier's all-gather
                if tree and m.merge_tree not in (tree, "flat", ""):
                    raise AssertionError(f"{label} {name}: merged by {m.merge_tree}, not {tree}")
                trees.setdefault(label, set()).add(m.merge_tree)
                entry = {"class": plan, "ran": m.strategy, "oracle_max_rel_err": err,
                         "merge_tree": m.merge_tree, "declines": m.tier_declines,
                         "launches": launched}
                if cls is None:
                    post(eng.execute(q, ds))  # the capture
                    entry["p50_ms"] = _median_ms(lambda: eng.execute(q, ds), MESH_WARM)
                    entry["graph_replays"] = eng.last_metrics.graph_replays
                    row["mesh"][label] = entry
                else:
                    row["mesh"].setdefault(f"{label}:{cls}", entry)
        rows.append(row)
        emit("mesh_query", **row)
    for label, _mesh, tree in meshes:
        if tree and tree not in trees.get(label, ()):
            raise AssertionError(f"{label}: no query merged by the {tree} tree")
    return rows, engines


def run_mesh_sketches_sql(ctxs, workloads, device):
    """(b) The sketch queries and SQL through a context whose plans take the
    (4, 1) mesh (its device list 4 x the card, the cost model off, sharing
    the SSB context's catalog): HLL and theta columns equal the single
    device's frame, quantiles equal it too (a row hashes its segment
    position) and hold the rank bound of the exact oracle;
    q4.1 as SQL, its metrics `distributed` with the mesh's shape."""
    base = ctxs["ssb"]
    mctx = TPUOlapContext(dataclasses.replace(base.config), device=device, devices=[device] * 4)
    # the SSB context's catalog and resident engine (`run_mesh` gives the
    # engine back its own session's settings after)
    mctx.catalog = base.catalog
    mctx.engine = base.engine
    mctx.sql("SET cost_model_enabled = false")
    out = []
    frame = workloads["ssb"][1]
    for name in MESH_SKETCHES:
        sql = ssb.SKETCH_QUERIES[name]
        got = mctx.sql(sql)
        m = mctx.last_metrics
        if not (m.distributed and m.mesh_shape == (4, 1)):
            raise AssertionError(f"mesh sketch {name}: {m.describe()}")
        want = _baseline(lambda: base.sql(sql))
        row = {"query": name, "rows": len(got)}
        if name == "quantiles":
            # a row's priority is its segment position's: the single device's sample
            row.update(ssb.check_sketch_answer(name, got, ssb.sketch_oracle(frame, name)))
            keys = ["d_year"]
            g = got.sort_values(keys).reset_index(drop=True)
            w = want.sort_values(keys).reset_index(drop=True)
            for c in ssb.QUANTILE_FRACTIONS:
                if not np.array_equal(np.asarray(g[c]), np.asarray(w[c])):
                    raise AssertionError(f"mesh quantiles: {c} differs from the single device")
            row["quantiles_equal_single_device"] = True
        else:
            keys = [c for c in want.columns if want[c].dtype.kind not in "f"]
            g = got.sort_values(keys, kind="stable").reset_index(drop=True)
            w = want.sort_values(keys, kind="stable").reset_index(drop=True)
            for c in want.columns:
                if c == "revenue":
                    _frame_check(name, g[[c]], w[[c]], [])
                elif not np.array_equal(np.asarray(g[c]).astype(object),
                                        np.asarray(w[c]).astype(object)):
                    raise AssertionError(f"mesh sketch {name}: column {c} differs")
            row["sketch_columns_equal_single_device"] = True
        out.append(row)
        emit("mesh_sketch", **row)
    got = mctx.sql(ssb.QUERIES["q4_1"])
    m = mctx.last_metrics
    if not (m.distributed and m.mesh_shape == (4, 1)) or m.executor != "device":
        raise AssertionError(f"mesh SQL: {m.describe()}")
    check_against_oracle("q4_1", got, frame, "ssb")
    out.append({"query": "q4_1 (SQL)", "distributed": True, "mesh_shape": m.mesh_shape,
                "strategy": m.strategy})
    emit("mesh_sql", **out[-1])
    return out, mctx


def run_mesh_stream(device, mesh):
    """(c) BASELINE config #4's stream on the (4, 1) mesh, cut to
    MESH_STREAM_CHUNKS chunks, against its oracle."""
    chunk_rows = STREAM_SHAPE[0]
    staged, oracle, info = stage_stream(MESH_STREAM_CHUNKS, chunk_rows)
    ex = StreamExecutor(engine=Engine(device=device), mesh=mesh)
    before = cuda_groupby.LAUNCHES
    df, ms = _timed(lambda: ex.execute(stream_query(), datagen.event_stream_schema(),
                                       iter(staged), chunk_rows))
    err = _stream_frame_check(df, oracle)
    launches = cuda_groupby.LAUNCHES - before
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError("mesh stream never launched the kernel")
    row = {"chunks": len(staged), "rows": ex.stats.rows, "wall_ms": ms,
           "rows_per_s": ex.stats.rows / (ms / 1e3), "strategy": ex.stats.strategy,
           "h2d_bytes": ex.stats.h2d_bytes, "launches": launches, "oracle_max_rel_err": err,
           "generate_s": info["generate_s"]}
    emit("mesh_stream", **row)
    del staged
    return row


def run_mesh_resilience(ctxs, workloads, eng, mctx):
    """(d) On the (4, 1) mesh: a deadline injected before local step K of the
    arena's step loop gives a partial answer whose coverage is the rows of
    the steps folded, equal to the oracle over those blocks; a fault at
    `mesh.dispatch` is retried once and the answer holds; the mesh's
    breaker opens under repeated faults while a single-device query still
    routes to "device"; and a fused batch runs as one arena dispatch per
    device (eager, captured, replayed), each member equal to its serial
    frame."""
    ctx = ctxs["ssb"]
    frame = workloads["ssb"][1]
    q, ds, post, _ = _mesh_case(ctx, "ssb", "q4_1")
    out = {}
    # the deadline: steps 0..K-1 folded, on every device
    inner = groupby_with_time_granularity(q)
    scope = segments_in_scope(inner, ds)
    layout = spmd_arena.plan_spmd_layout(ds, 4)
    in_scope = {s.uid for s in scope}
    blocks = sorted(layout.index[u] for u in in_scope)
    j_lo, Lk = spmd_arena.scope_window(layout, blocks)
    step = min(MESH_DEADLINE_STEP, Lk - 1)  # a step inside the window
    covered = [layout.segs[b] for b in blocks if b // 4 < j_lo + step]
    _arm("mesh.segment_loop", error_type=resilience.InjectedDeadline, skip=step, times=1)
    try:
        with resilience.partial_scope(True) as pc:
            got = post(eng.execute(q, ds, "dense"))
    finally:
        _disarm()
    rows_total = sum(s.num_rows for s in scope)
    seen = sum(s.num_rows for s in covered)
    if not pc.is_partial or pc.rows_seen != seen:
        raise AssertionError(f"mesh deadline: rows {pc.rows_seen}, want {seen}")
    err = _partial_oracle_check("q4_1", got, segments_frame(ds, covered,
                                                             SWEEP_QUERIES["q4_1"]))
    out["deadline"] = {"step": step, "window_steps": Lk, "segments": len(covered),
                       "coverage": pc.coverage(), "rows_seen": seen, "rows_total": rows_total,
                       "oracle_max_rel_err": err}
    emit("mesh_deadline", **out["deadline"])
    # a retry after a fault at mesh.dispatch
    _arm("mesh.dispatch", mode="error", times=1)
    try:
        got = post(eng.execute(q, ds))
    finally:
        _disarm()
    if eng.last_metrics.retries != 1:
        raise AssertionError(f"mesh retry: {eng.last_metrics.describe()}")
    check_against_oracle("q4_1", got, frame, "ssb")
    out["retry"] = {"retries": 1}
    emit("mesh_retry", **out["retry"])
    # the mesh breaker opens; single-device queries still route to the card
    sql = ssb.QUERIES["q4_1"]
    mctx.sql("SET fallback_execution = false")
    br = mctx.resilience.breaker_for("mesh")
    _arm("mesh.dispatch", mode="error")
    failures = 0
    try:
        while br.state == "closed" and failures < 10:
            try:
                mctx.sql(sql)
            except resilience.InjectedFault:
                failures += 1
    finally:
        _disarm()
    if br.state != "open" or mctx.resilience.breaker_for("device").state != "closed":
        raise AssertionError(f"mesh breaker {br.state} after {failures} failed queries")
    mctx.sql("SET prefer_distributed = false")
    got = _baseline(lambda: mctx.sql(sql))
    m = mctx.last_metrics
    if m.distributed or m.executor != "device" or mctx._backend_for(mctx.plan_sql(sql)) != "device":
        raise AssertionError(f"single-device route under an open mesh breaker: {m.describe()}")
    check_against_oracle("q4_1", got, frame, "ssb")
    out["breaker"] = {"failed_queries": failures, "mesh_breaker": br.state,
                      "device_breaker": mctx.resilience.breaker_for("device").state}
    emit("mesh_breaker", **out["breaker"])
    # a fused batch on the mesh
    members = [_mesh_case(ctx, "ssb", n) for n in FUSED_MEMBERS]
    serial = [_baseline(lambda: post(ctx.engine.execute(mq, mds)))
              for mq, mds, post, _ in members]
    replays = []
    for _ in range(3):  # eager, captured, replayed
        res = eng.execute_fused([mq for mq, *_ in members], ds)
        for (df, _state, mm), (_, _, post, _), want, n in zip(res, members, serial,
                                                               FUSED_MEMBERS):
            _same_as_single(n, post(df), want)
            if not mm.distributed or mm.fused_batch != len(members):
                raise AssertionError(f"mesh fused {n}: {mm.describe()}")
        replays.append(res[0][2].graph_replays)
    if eng.device.type == "cuda" and replays[-1] == 0:
        raise AssertionError(f"mesh fused batch never replayed: {replays}")
    out["fused"] = {"members": list(FUSED_MEMBERS), "graph_replays": replays}
    emit("mesh_fused", **out["fused"])
    return out


def run_mesh(ctxs, workloads, device):
    """Phase 17 on phase 4's resident SSB SF10 and TPC-H SF1."""
    meshes = mesh_list(device)
    queries, engines = run_mesh_queries(ctxs, workloads, meshes, device)
    sketches, mctx = run_mesh_sketches_sql(ctxs, workloads, device)
    stream = run_mesh_stream(device, engines["4x1"].mesh)
    res = run_mesh_resilience(ctxs, workloads, engines["4x1"], mctx)
    for eng in engines.values():
        eng.clear_cache()
    ctxs["ssb"].apply_config()  # its engine's constants, flags and breaker back
    return {"queries": queries, "sketches": sketches, "stream": stream, "resilience": res,
            "meshes": [label for label, _, _ in meshes]}


# -- phase 18: processes -----------------------------------------------------

PROC_RANKS = 2  # ranks on the card over gloo
PROC_QUERIES = ("q1_1", "q2_1", "q3_1", "q4_1", "timeseries", "topn", "topn_hll", "quantiles")
PROC_STRATEGIES = {"q2_1": "adaptive"}
PROC_NODES = ("h0", "h1")
PROC_REPLICATION = 2
# each child's device residency cap: the parent's resident SF10 and TPC-H
# SF1, two ranks and two historicals fit on one card together
PROC_RESIDENCY_MB = 12 * 1024
PROC_TIMEOUT_S = 300  # a child's budget: boot, queries and exit
PROC_KILL_AT = 6  # the cluster case before which h0 is SIGKILLed
CLUSTER_TIMESERIES_SQL = ("SELECT DATE_TRUNC('month', lo_orderdate) AS \"timestamp\", "
                          "sum(lo_revenue) AS revenue FROM lineorder "
                          "GROUP BY DATE_TRUNC('month', lo_orderdate) ORDER BY \"timestamp\"")
CLUSTER_TOPN_SQL = ("SELECT c_nation, sum(lo_revenue) AS revenue FROM lineorder "
                    "JOIN customer ON lo_custkey = c_custkey "
                    "GROUP BY c_nation ORDER BY revenue DESC LIMIT 10")
ROOT = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(cmd, log_path):
    """A child process of this run, from the checkout's root, its output to
    `log_path`."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    log = open(log_path, "w")
    try:
        return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _tail(path, n=3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def _stop(procs) -> None:
    """SIGTERM every child still running, then SIGKILL what did not exit."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def check_child_launches(label, record) -> dict:
    """A child's launch record (`cuda_groupby.launch_record`): every shape
    checked in phase 3, no launch over more rows than it was checked at."""
    checked = checked_rows()
    missing, over = [], []
    for G, Ms, Mn, Mx, count, rows in record["shapes"]:
        key = (G, Ms, Mn, Mx)
        if count and key not in checked:
            missing.append(key)
        elif rows > checked.get(key, 0):
            over.append((key, rows, checked.get(key, 0)))
    if missing or over:
        raise AssertionError(f"{label}: launches at unchecked shapes {missing} or over the "
                             f"checked rows {over}")
    return {"launches": record["launches"], "shapes": len(record["shapes"])}


def _proc_case(ctx, name):
    """(native spec, post) of one query of phase 18(b): a SQL query's
    rewrite (a sketch query's too) with the SQL surface's post-processing,
    or the native Timeseries and TopN."""
    if name in ssb.SKETCH_QUERIES:
        rw = ctx.plan_sql(ssb.SKETCH_QUERIES[name])
        ds = ctx.catalog.get(rw.datasource)
        return rw.query, (lambda df, rw=rw, ds=ds: ctx._post_process(rw, ds, df))
    q, _, post, _ = _mesh_case(ctx, "ssb", name)
    return q, post


def _proc_oracle(name, got, frame):
    if name in ssb.SKETCH_QUERIES:
        return ssb.check_sketch_answer(name, got, ssb.sketch_oracle(frame, name))
    return {"oracle_max_rel_err": check_against_oracle(name, got, frame, "ssb")}


def rank_worker(argv) -> int:
    """One rank of phase 18(b) (`python3 chip_smoke.py --rank-worker PORT RANK
    NPROC STORE SPEC OUT BACKEND`): joins the process group, boots the
    store's lineorder, runs the spec's queries on the hybrid mesh over its
    card (a card the spec names and this machine lacks raises) and pickles the frames, metrics, residency, its placed segments
    and its kernel launches to OUT."""
    import pandas as pd

    from spark_druid_olap_tpu_torch.catalog.persist import load_snapshot
    from spark_druid_olap_tpu_torch.parallel import multihost

    port, rank, nproc, store, spec_path, out, backend = argv
    t0 = time.perf_counter()
    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(f"127.0.0.1:{port}", int(nproc), int(rank), backend=backend)
    # the card (the spec names the CPU only in a rehearsal without one)
    device = (torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda"
              else torch.device("cpu"))
    ds, _, _ = load_snapshot(os.path.join(store, "lineorder"))
    eng = DistributedEngine(multihost.hybrid_mesh(devices=[device]),
                            shard_cache_bytes=spec["residency_bytes"])
    eng.cost_config = SessionConfig.load_calibrated(device=device)
    boot_s = time.perf_counter() - t0
    res = {"frames": {}, "metrics": {}, "boot_s": boot_s}
    for item in spec["queries"]:
        q = wire.query_from_druid(item["query"])
        t = time.perf_counter()
        res["frames"][item["name"]] = eng.execute(q, ds, item["strategy"])
        m = eng.last_metrics
        res["metrics"][item["name"]] = {
            "ms": (time.perf_counter() - t) * 1e3, "strategy": m.strategy,
            "merge_tree": m.merge_tree, "h2d_bytes": m.h2d_bytes}
    layout = spmd_arena.plan_spmd_layout(ds, eng._arena_mesh().size)
    mine = {r for r, _ in eng._owned_row_devices()}
    res.update(
        resident=eng.bytes_resident(), launches=cuda_groupby.launch_record(),
        placed=[layout.segs[b].segment_id for b in range(layout.B) if b % layout.ndt in mine],
        local_segments=[s.segment_id for s in multihost.local_segments(ds.segments)],
        info=multihost.process_info(devices=[device]), device=str(device),
        seconds=time.perf_counter() - t0)
    pd.to_pickle(res, out)
    multihost.shutdown()
    return 0


def run_ranks(ctx, workloads, device, store, tmp, nproc, backend):
    """(b) `nproc` ranks over `backend`, against this process's `nproc`-slice
    x 1 slice mesh (of the card for gloo, of the cards for NCCL)."""
    import pandas as pd

    frame = workloads["ssb"][1]
    cases = {name: _proc_case(ctx, name) for name in PROC_QUERIES}
    docs = {name: json.loads(json.dumps(q.to_druid(), default=str))
            for name, (q, _) in cases.items()}
    spec = {"residency_bytes": PROC_RESIDENCY_MB << 20, "device": torch.device(device).type,
            "queries": [{"name": n, "query": docs[n], "strategy": PROC_STRATEGIES.get(n)}
                        for n in PROC_QUERIES]}
    spec_path = os.path.join(tmp, f"spec-{backend}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    outs = [os.path.join(tmp, f"rank-{backend}-{i}.pkl") for i in range(nproc)]
    logs = [os.path.join(tmp, f"rank-{backend}-{i}.log") for i in range(nproc)]
    t0 = time.perf_counter()
    procs = [_child([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rank-worker",
                     str(port), str(i), str(nproc), store, spec_path, outs[i], backend], logs[i])
             for i in range(nproc)]
    try:
        # this process's slice mesh over the same specs, meanwhile
        devs = [device] * nproc if backend == "gloo" else [
            torch.device("cuda", i) for i in range(nproc)]
        eng = DistributedEngine(make_slice_mesh(nproc, 1, devs))
        eng.cost_config = SessionConfig.load_calibrated(device=device)
        ds = workloads["ssb"][0]
        single = {}
        for name in PROC_QUERIES:
            single[name] = eng.execute(wire.query_from_druid(docs[name]), ds,
                                       PROC_STRATEGIES.get(name))
        single_resident = eng.bytes_resident()
        eng.clear_cache()
        deadline = time.monotonic() + PROC_TIMEOUT_S
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {i} ({backend}) ran past {PROC_TIMEOUT_S} s:\n"
                                     f"{_tail(logs[i])}")
            if p.returncode != 0:
                raise AssertionError(f"rank {i} ({backend}) exited {p.returncode}:\n"
                                     f"{_tail(logs[i])}")
    finally:
        _stop(procs)
    wall_s = time.perf_counter() - t0
    ranks = [pd.read_pickle(o) for o in outs]
    rows = []
    for name in PROC_QUERIES:
        _, post = cases[name]
        for r, res in enumerate(ranks):
            got = res["frames"][name]
            if backend == "gloo" or nproc == 2:
                # bit-equal to the other ranks and to the one-process mesh
                pd.testing.assert_frame_equal(got, single[name], check_exact=True)
            else:  # NCCL reduces more than two cards in its own order
                _same_as_single(name, post(got), post(single[name]))
            pd.testing.assert_frame_equal(got, ranks[0]["frames"][name], check_exact=True)
        row = {"query": name, "strategy": ranks[0]["metrics"][name]["strategy"],
               "merge_tree": ranks[0]["metrics"][name]["merge_tree"],
               "rank_ms": [res["metrics"][name]["ms"] for res in ranks],
               **_proc_oracle(name, post(ranks[0]["frames"][name]), frame)}
        rows.append(row)
    launches = 0
    for r, res in enumerate(ranks):
        if res["info"]["process_count"] != nproc or res["info"]["process_index"] != r:
            raise AssertionError(f"rank {r}: {res['info']}")
        if res["resident"] * nproc != single_resident:
            raise AssertionError(f"rank {r} holds {res['resident']} B, the {nproc}-slice mesh "
                                 f"{single_resident} B: not its own share")
        if res["placed"] != res["local_segments"]:
            raise AssertionError(f"rank {r} placed other segments than its local_segments")
        launches += check_child_launches(f"rank {r}", res["launches"])["launches"]
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError(f"the ranks ({backend}) never launched the kernel")
    out = {"backend": backend, "ranks": nproc, "wall_s": wall_s,
           "boot_s": [res["boot_s"] for res in ranks], "launches": launches,
           "resident_bytes": [res["resident"] for res in ranks],
           "slice_mesh_resident_bytes": single_resident, "queries": rows}
    emit("processes_ranks", **out)
    return out


def _shaped(payload):
    """A response's rows as a frame: groupBy events, Timeseries results
    with their timestamps, a TopN's first bucket, or SQL's row objects."""
    import pandas as pd

    if not payload:
        return pd.DataFrame()
    first = payload[0]
    if "event" in first:
        return pd.DataFrame([r["event"] for r in payload])
    if "result" in first and isinstance(first["result"], list):
        return pd.DataFrame(first["result"])
    if "result" in first:
        df = pd.DataFrame([{"timestamp": r["timestamp"], **r["result"]} for r in payload])
        df["timestamp"] = pd.to_datetime(df["timestamp"], utc=True).dt.tz_localize(None)
        return df
    return pd.DataFrame(payload)


def _cluster_oracle(name, got, frame) -> float:
    """`check_against_oracle`, where an empty answer (no columns on the
    wire) must meet an empty oracle."""
    if len(got) == 0:
        want = oracle("ssb", name, frame)
        if isinstance(want, float) or len(want):
            raise AssertionError(f"cluster {name}: an empty answer, the oracle has rows")
        return 0.0
    return check_against_oracle(name, got, frame, "ssb")


def _cluster_cases():
    """(name, native spec, SQL, the single context's native and SQL frames)
    of (c): the 13 SSB queries, the Timeseries and the TopN."""
    out = []
    for name in list(ssb.NATIVE_QUERIES) + ["timeseries", "topn"]:
        q = (ssb.TIMESERIES_QUERY if name == "timeseries" else ssb.TOPN_QUERY
             if name == "topn" else ssb.NATIVE_QUERIES[name])
        sql = (CLUSTER_TIMESERIES_SQL if name == "timeseries" else CLUSTER_TOPN_SQL
               if name == "topn" else ssb.QUERIES[name])
        out.append((name, q, sql))
    return out


def _post_json(base, path, body):
    status, headers, raw = _http(base, path, body)
    if status != 200:
        raise AssertionError(f"{path}: {status} {raw[:400]!r}")
    return headers, raw


def _scatter_failures(reg) -> dict:
    """{node: failed attempts} of the broker's `sdol_cluster_scatter_total`."""
    out = {}
    for key, v in reg.counter("sdol_cluster_scatter_total", labels=("node", "outcome")) \
            .snapshot().items():
        node, outcome = key.split(",", 1)
        if outcome != "ok" and v:
            out[node] = out.get(node, 0) + v
    return out


def _kill(proc) -> None:
    import signal

    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)


def run_cluster(broker, ctxs, workloads, device, nodes):
    """(c) The broker over the historicals `nodes` ({id: (process, url,
    log)}): every case native and SQL through the broker's server, h0
    killed mid-sequence, the federated scrape, both killed."""
    from spark_druid_olap_tpu_torch.cluster import ClusterClient
    from spark_druid_olap_tpu_torch.obs import get_registry
    from spark_druid_olap_tpu_torch.server import OlapServer

    import pandas as pd

    frame = workloads["ssb"][1]
    sctx = ctxs["ssb"]
    reg = get_registry()
    fails0 = _scatter_failures(reg)
    client = ClusterClient(broker, nodes={n: url for n, (_, url, _) in nodes.items()},
                           replication=PROC_REPLICATION).attach()
    srv = OlapServer(broker, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    rows, launches, killed, answers = [], {}, [], {}

    def new_failures():
        now = _scatter_failures(reg)
        return {n: v - fails0.get(n, 0) for n, v in now.items() if v > fails0.get(n, 0)}

    def kill(node):
        st, _, raw = _http(nodes[node][1], "/status/kernels")
        if st != 200:
            raise AssertionError(f"{node}: /status/kernels answered {st}")
        launches[node] = check_child_launches(node, json.loads(raw))
        bad = {n: v for n, v in new_failures().items() if n not in killed}
        if bad:
            raise AssertionError(f"failed RPCs to live nodes before killing {node}: {bad}")
        _kill(nodes[node][0])
        killed.append(node)

    def run_case(name, q, sql):
        body = json.loads(json.dumps(q.to_druid(), default=str))
        row = {"query": name}
        raws = []
        for _ in range(2):
            t = time.perf_counter()
            _, raw = _post_json(base, "/druid/v2", body)
            row.setdefault("native_ms", []).append((time.perf_counter() - t) * 1e3)
            raws.append(raw)
        if raws[0] != raws[1]:
            raise AssertionError(f"cluster {name}: native responses differ from run to run")
        row["native_executor"] = broker.last_metrics.executor
        got = _shaped(json.loads(raws[0]))
        want = _shaped(json.loads(_envelope_bytes(wire.druid_result_shape(
            q, NATIVE_FRAMES[("ssb", name)]))))
        row["native_oracle_max_rel_err"] = _cluster_oracle(name, got, frame)
        if len(want) or len(got):
            _same_as_single(name, got, want)
        sraws = []
        for _ in range(2):
            t = time.perf_counter()
            _, raw = _post_json(base, "/druid/v2/sql", {"query": sql})
            row.setdefault("sql_ms", []).append((time.perf_counter() - t) * 1e3)
            sraws.append(raw)
        if sraws[0] != sraws[1]:
            raise AssertionError(f"cluster {name}: SQL responses differ from run to run")
        row["sql_executor"] = broker.last_metrics.executor
        got = pd.DataFrame(json.loads(sraws[0]))
        if name == "timeseries":
            got["timestamp"] = pd.to_datetime(got["timestamp"], utc=True).dt.tz_localize(None)
        row["sql_oracle_max_rel_err"] = _cluster_oracle(name, got, frame)
        want = sctx.sql(sql)
        if len(want) or len(got):
            _same_as_single(name, got, want)
        answers[name] = (raws[0], sraws[0])
        return row

    t0 = time.perf_counter()
    try:
        cases = _cluster_cases()
        specs = {name: q for name, q, _ in cases}
        for i, (name, q, sql) in enumerate(cases):
            if i == PROC_KILL_AT:
                kill("h0")
                # a covered query answered before: its replica answers with
                # the same bytes (the fold runs in chain order)
                for again in ("q1_1", "topn"):
                    if again in answers:
                        _, raw = _post_json(base, "/druid/v2", json.loads(
                            json.dumps(specs[again].to_druid(), default=str)))
                        if raw != answers[again][0]:
                            raise AssertionError(f"{again} after h0's kill: other bytes")
                        if broker.last_metrics.executor != "cluster":
                            raise AssertionError(f"{again} after h0's kill did not scatter")
            rows.append(run_case(name, q, sql))
            emit("processes_cluster_query", **rows[-1])
        # what the broker covers (G <= 4096, no tier; a DATE_TRUNC group
        # has no wire form, so the SQL Timeseries answers on the broker)
        scattered = {way: [r["query"] for r in rows if r[f"{way}_executor"] == "cluster"]
                     for way in ("native", "sql")}
        want = {"q1_1", "q1_2", "q1_3", "q4_1", "topn"}
        if not (want | {"timeseries"} <= set(scattered["native"])
                and want <= set(scattered["sql"])):
            raise AssertionError(f"the broker scattered only {scattered}")
        status, _, text = _http(base, "/status/metrics?cluster=1")
        text = text.decode()
        stale = {ln.split('node="')[1].split('"')[0]: ln.rsplit(" ", 1)[-1]
                 for ln in text.splitlines() if ln.startswith("sdol_cluster_scrape_stale{")}
        if status != 200 or stale.get("h0") != "1" or stale.get("h1") != "0" \
                or 'node="h1"' not in text:
            raise AssertionError(f"federated scrape: {status} {stale}")
        kill("h1")
        q1 = ssb.NATIVE_QUERIES["q1_1"]
        body = dict(json.loads(json.dumps(q1.to_druid(), default=str)),
                    context={"partialResults": True})
        status, headers, raw = _http(base, "/druid/v2", body)
        rc = json.loads(headers.get("X-Druid-Response-Context", "{}") or "{}")
        if status != 200 or not rc.get("partial") or rc.get("coverage") != 0.0:
            raise AssertionError(f"both historicals killed: {status} {rc} {raw[:300]!r}")
        partial = {"status": status, "coverage": rc.get("coverage")}
        unexpected = {n: v for n, v in new_failures().items() if n not in killed}
        if unexpected:
            raise AssertionError(f"failed RPCs to live nodes: {unexpected}")
        state = client.state()
    finally:
        srv.shutdown()
        client.close()
    out = {"queries": len(rows), "scattered": scattered, "seconds": time.perf_counter() - t0,
           "killed": killed, "failed_rpcs_to_killed": new_failures(),
           "launches": sum(v["launches"] for v in launches.values()),
           "node_launches": launches, "both_killed": partial,
           "stale": stale, "epoch": state["epoch"], "segments_lost": state["segments_lost"]}
    emit("processes_cluster", **out)
    if torch.device(device).type == "cuda" and out["launches"] == 0:
        raise AssertionError("the historicals never launched the kernel")
    return out


def start_historicals(store, tmp, device):
    """The historicals of (c) as processes on `device`, each under the
    residency cap; returns {id: (process, announce path, log)}."""
    procs = {}
    for node in PROC_NODES:
        ann = os.path.join(tmp, f"{node}.json")
        log = os.path.join(tmp, f"{node}.log")
        cmd = [sys.executable, "-m", "spark_druid_olap_tpu_torch.cluster.historical",
               "--storage-dir", store, "--node-id", node, "--port", "0", "--announce", ann,
               "--residency-mb", str(PROC_RESIDENCY_MB)]
        if torch.device(device).type != "cuda":
            cmd += ["--device", "cpu"]
        procs[node] = (_child(cmd, log), ann, log)
    return procs


def await_historicals(procs) -> dict:
    """{id: (process, url, log)} once every historical announced itself."""
    deadline = time.monotonic() + PROC_TIMEOUT_S
    out = {}
    for node, (p, ann, log) in procs.items():
        while not os.path.exists(ann):
            if p.poll() is not None:
                raise AssertionError(f"historical {node} exited {p.returncode}:\n{_tail(log)}")
            if time.monotonic() > deadline:
                raise AssertionError(f"historical {node} never announced:\n{_tail(log)}")
            time.sleep(0.2)
        with open(ann) as f:
            doc = json.load(f)
        if torch.cuda.is_available() and not doc["device"].startswith("cuda"):
            raise AssertionError(f"historical {node} serves on {doc['device']}")
        out[node] = (p, doc["url"], log)
    return out


def run_processes(ctxs, workloads, device, tmp):
    """Phase 18: the store, the ranks, the cluster."""
    t0 = time.perf_counter()
    store = os.path.join(tmp, "store")
    broker = TPUOlapContext(dataclasses.replace(ctxs["ssb"].config, storage_dir=store),
                            device=device)
    broker.engine = ctxs["ssb"].engine  # phase 4's resident segments: the same uids
    dims = workloads["dims"]["ssb"]
    broker.register_datasource(workloads["ssb"][0], star_schema=ssb.STAR_SCHEMA)
    broker.register_table("dwdate", dims["dwdate"], time_column="d_datekey")
    for name in ("customer", "supplier", "part"):
        broker.register_table(name, dims[name])
    write_s = time.perf_counter() - t0
    emit("processes_store", seconds=write_s, segments=len(workloads["ssb"][0].segments),
         bytes=sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(store)
                   for f in fs))
    children = start_historicals(store, tmp, device)
    try:
        ranks = [run_ranks(ctxs["ssb"], workloads, device, store, tmp, PROC_RANKS, "gloo")]
        n = torch.cuda.device_count()
        if torch.device(device).type == "cuda" and n >= 2:
            ranks.append(run_ranks(ctxs["ssb"], workloads, device, store, tmp, n, "nccl"))
        nodes = await_historicals(children)
        cluster = run_cluster(broker, ctxs, workloads, device, nodes)
    finally:
        _stop([p for p, _, _ in children.values()])
        broker.close()
    return {"store_s": write_s, "ranks": ranks, "cluster": cluster,
            "seconds": time.perf_counter() - t0}


# -- phase 19: CSV ingest through the native decoder ------------------------------

CSV_SCALE = 1.0  # SSB SF1: 6M lineorder rows
CSV_SHARDS = 8  # lineorder's sharded files (the build's phase-1 shards)
CSV_RTOL = 1e-6
# lineorder's build, in every load: the flat star's columns, time-sorted
# 512K-row segments as the main path's
CSV_BUILD = dict(dimension_cols=ssb.FLAT_DIMS, metric_cols=ssb.FLAT_METRICS,
                 time_col="lo_orderdate", rows_per_segment=1 << 19)
# the flat lineorder's CSV columns: the date's attributes follow lo_orderdate
# (its key), then each dimension table's, then the metrics
CSV_DIM_COLUMNS = {
    "dwdate": ["d_datekey", "d_year", "d_yearmonthnum", "d_yearmonth", "d_weeknuminyear"],
    "customer": ["c_region", "c_nation", "c_city"],
    "supplier": ["s_region", "s_nation", "s_city"],
    "part": ["p_mfgr", "p_category", "p_brand1"],
}
CSV_FACT_HEADER = (["lo_orderdate"] + CSV_DIM_COLUMNS["dwdate"][1:]
                   + CSV_DIM_COLUMNS["customer"] + CSV_DIM_COLUMNS["supplier"]
                   + CSV_DIM_COLUMNS["part"] + ssb.FLAT_METRICS)


def _fragments(table, cols):
    """Each row of a dimension table as its CSV text, comma-terminated."""
    vals = [[str(v) for v in np.asarray(table[c]).tolist()] for c in cols]
    return np.array([",".join(r) + "," for r in zip(*vals)], dtype=object)


def _fact_lines(tables, frags, lo):
    """The flat lineorder rows of fact chunk `lo` as CSV lines.  A fact row
    joins its dimension rows' text (`frags`: each dimension row rendered
    once) to its metrics: quantity and discount as integers, the prices in
    cents (extendedprice rounded; revenue and supplycost derived from it as
    the generator derives them, truncated to the cent), so the file holds
    decimals that any reader parses to the same doubles."""
    ints = frags["ints"]
    cents = frags["cents"]
    ext = np.rint(np.asarray(lo["lo_extendedprice"], np.float64) * 100).astype(np.int64)
    disc = np.asarray(lo["lo_discount"]).astype(np.int64)
    rev = ext * (100 - disc) // 100
    cost = ext * 60 // 100
    day = ssb._fk_row_index(lo, "lo_orderdate", "dwdate", tables["dwdate"])
    pieces = [
        frags["dwdate"][day], frags["customer"][lo["lo_custkey"]],
        frags["supplier"][lo["lo_suppkey"]], frags["part"][lo["lo_partkey"]],
        frags["intc"][np.asarray(lo["lo_quantity"]).astype(np.int64)],
        ints[ext // 100], cents[ext % 100],
        frags["intc"][disc],
        ints[rev // 100], cents[rev % 100],
        ints[cost // 100], cents[cost % 100],
        ints[lo["lo_custkey"]],
    ]
    return "\n".join(map("".join, zip(*(p.tolist() for p in pieces)))) + "\n"


def write_ssb_csv(tables, root, shards=CSV_SHARDS):
    """SSB's flat lineorder as `shards` CSV files and as one file (the
    shards' rows in order, under one header), and the four dimension tables
    as CSV, under `root`; returns the paths and the bytes written."""
    import pandas as pd

    lo = tables["lineorder"]
    n = len(lo["lo_orderdate"])
    frags = {name: _fragments(tables[name], cols) for name, cols in CSV_DIM_COLUMNS.items()}
    frags["ints"] = np.array([str(i) for i in range(100_000)], dtype=object)
    frags["intc"] = frags["ints"] + ","
    frags["cents"] = np.array([f".{i:02d}," for i in range(100)], dtype=object)
    header = ",".join(CSV_FACT_HEADER) + "\n"
    whole = os.path.join(root, "lineorder.csv")
    paths = []
    with open(whole, "w") as out:
        out.write(header)
        for i, idx in enumerate(np.array_split(np.arange(n), shards)):
            body = _fact_lines(tables, frags, {k: v[idx] for k, v in lo.items()})
            paths.append(os.path.join(root, f"lineorder_{i:02d}.csv"))
            with open(paths[-1], "w") as f:
                f.write(header)
                f.write(body)
            out.write(body)
    dims = {}
    for name in CSV_DIM_COLUMNS:
        dims[name] = os.path.join(root, f"{name}.csv")
        pd.DataFrame(tables[name]).to_csv(dims[name], index=False)
    nbytes = sum(os.path.getsize(p) for p in [whole, *paths, *dims.values()])
    return {"lineorder": whole, "shards": paths, "dims": dims, "bytes": nbytes}


def _csv_context(session, device):
    ctx = TPUOlapContext(dataclasses.replace(session), device=device)
    # every group-by on the kernel: G <= 4096 on the dense class, wider ones
    # through the adaptive tier's presence and compacted passes
    ctx.engine.strategy = "adaptive"
    return ctx


def _register_csv_dims(ctx, files):
    for name, path in files["dims"].items():
        ctx.register_table(name, path, time_column="d_datekey" if name == "dwdate" else None)
        if ctx.last_ingest.decoders != ["native"]:
            raise AssertionError(f"{name}.csv: {ctx.last_ingest}")


def _same_segments(what, a, b):
    """Two builds of one table: the same dictionaries, segments, codes,
    metrics and zone maps (row counts, mins and maxs)."""
    if {k: d.values for k, d in a.dicts.items()} != {k: d.values for k, d in b.dicts.items()}:
        raise AssertionError(f"{what}: dictionaries differ")
    if [s.num_rows for s in a.segments] != [s.num_rows for s in b.segments]:
        raise AssertionError(f"{what}: segment row counts differ")
    for sa, sb in zip(a.segments, b.segments):
        if sa.stats != sb.stats or sa.interval != sb.interval:
            raise AssertionError(f"{what}: {sa.segment_id} zone maps differ")
        for kind in ("dims", "metrics"):
            ca, cb = getattr(sa, kind), getattr(sb, kind)
            if list(ca) != list(cb) or any(
                    ca[k].dtype != cb[k].dtype or not np.array_equal(ca[k], cb[k]) for k in ca):
                raise AssertionError(f"{what}: {sa.segment_id} {kind} differ")


def _csv_answer_check(name, got, want):
    """Keys, counts and integer columns exact, sums within CSV_RTOL; returns
    (largest relative error, bit-identical)."""
    keys = [c for c in want.columns if want[c].dtype.kind not in "f"]
    err = _frame_check(name, got[list(want.columns)], want, keys, CSV_RTOL)
    same = list(got.columns) == list(want.columns) and all(
        np.asarray(got[c]).tobytes() == np.asarray(want[c]).tobytes()
        if np.asarray(want[c]).dtype.kind != "O" else list(got[c]) == list(want[c])
        for c in want.columns)
    return err, same


def prepare_csv(root, scale=CSV_SCALE, seed=7) -> dict:
    """Phase 19's host-only half: SSB at `scale` written as CSV under `root`
    (`write_ssb_csv`); the one lineorder file decoded by `pd.read_csv` and
    then by the native decoder, back to back, each timed alone over the
    file just written (both from the page cache); then the reference load:
    pandas' frame through the sharded build, saved to
    `root/pandas_lineorder` (`catalog.persist.save_datasource`).  Returns
    (and writes to `root/prepared.json`) the files, rows and seconds."""
    import pandas as pd

    from spark_druid_olap_tpu_torch import native
    from spark_druid_olap_tpu_torch.catalog.ingest import _from_pandas
    from spark_druid_olap_tpu_torch.catalog.persist import save_datasource
    from spark_druid_olap_tpu_torch.ingest.shard import build_datasource_sharded
    from spark_druid_olap_tpu_torch.native import csv_decode

    out = {"scale": scale}
    t0 = time.perf_counter()
    tables = ssb.gen_tables(scale, seed=seed)
    out["rows"] = len(tables["lineorder"]["lo_orderdate"])
    out["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["files"] = write_ssb_csv(tables, root)
    out["write_s"] = time.perf_counter() - t0
    del tables
    t0 = time.perf_counter()
    frame = pd.read_csv(out["files"]["lineorder"])
    out["pandas_decode_s"] = time.perf_counter() - t0
    native.load()  # the first use builds the library: not decode time
    t0 = time.perf_counter()
    cols, _ = csv_decode.read_csv_encoded(out["files"]["lineorder"])
    out["native_decode_s"] = time.perf_counter() - t0
    del cols
    out["native_rows_per_s"] = out["rows"] / out["native_decode_s"]
    out["pandas_rows_per_s"] = out["rows"] / out["pandas_decode_s"]
    t0 = time.perf_counter()
    ds = build_datasource_sharded("lineorder", _from_pandas(frame), **CSV_BUILD)
    out["pandas_build_s"] = time.perf_counter() - t0
    del frame
    out["pandas_datasource"] = os.path.join(root, "pandas_lineorder")
    save_datasource(ds, out["pandas_datasource"], ssb.STAR_SCHEMA)
    with open(os.path.join(root, "prepared.json"), "w") as f:
        json.dump(out, f)
    return out


def csv_worker(argv) -> int:
    """`python3 chip_smoke.py --csv-worker ROOT SCALE`: `prepare_csv` in its
    own process, beside the card phases (it uses no card)."""
    root, scale = argv
    prepare_csv(root, float(scale))
    return 0


def start_csv_worker(scale=CSV_SCALE):
    """Starts phase 19's `csv_worker` in the background; (process, root,
    log).  The root directory and a still-running worker are removed at
    exit whatever happens."""
    import atexit
    import shutil

    root = tempfile.mkdtemp(prefix="sdol-phase19-")
    log = os.path.join(root, "worker.log")
    proc = _child([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--csv-worker",
                   root, str(scale)], log)
    atexit.register(shutil.rmtree, root, True)
    atexit.register(_stop, [proc])
    return proc, root, log


def await_csv_worker(proc, root, log, timeout_s=600) -> dict:
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        _stop([proc])
        raise AssertionError(f"the CSV worker ran past {timeout_s} s:\n{_tail(log)}")
    if rc != 0:
        raise AssertionError(f"the CSV worker exited {rc}:\n{_tail(log)}")
    with open(os.path.join(root, "prepared.json")) as f:
        return json.load(f)


def run_csv_ingest(session, device, prepared) -> dict:
    """Phase 19 on the card over `prepared` (`prepare_csv`'s files and its
    pandas-loaded reference): lineorder loaded through the native decoder
    as one file (`register_table`) and as sharded files
    (`build_datasource_from_csv`), segments equal to the reference's; the
    13 SSB queries as SQL on the card over each load, every group-by through
    the kernel, answered as the reference answers."""
    from spark_druid_olap_tpu_torch.catalog.ingest import IngestReport
    from spark_druid_olap_tpu_torch.catalog.persist import load_datasource
    from spark_druid_olap_tpu_torch.ingest.shard import build_datasource_from_csv
    from spark_druid_olap_tpu_torch.native import csv_decode

    out = {k: v for k, v in prepared.items() if k not in ("files", "pandas_datasource")}
    files = prepared["files"]
    rows = prepared["rows"]
    out["csv_bytes"] = files["bytes"]
    pandas_ds, _ = load_datasource(prepared["pandas_datasource"])
    ctxs = {k: _csv_context(session, device) for k in ("pandas", "native", "sharded")}
    ctxs["pandas"].register_datasource(pandas_ds, star_schema=ssb.STAR_SCHEMA)
    # the one file through register_table; its native decode timed apart by
    # a shim around the decoder's entry point (the file written minutes
    # before, with the stream's staging since: the page cache may not hold it)
    decode_s = []
    read = csv_decode.read_csv_encoded

    def timed_read(path):
        t = time.perf_counter()
        try:
            return read(path)
        finally:
            decode_s.append(time.perf_counter() - t)

    csv_decode.read_csv_encoded = timed_read
    try:
        t0 = time.perf_counter()
        one = ctxs["native"].register_table(
            "lineorder", files["lineorder"], star_schema=ssb.STAR_SCHEMA,
            dimensions=CSV_BUILD["dimension_cols"], metrics=CSV_BUILD["metric_cols"],
            time_column=CSV_BUILD["time_col"], rows_per_segment=CSV_BUILD["rows_per_segment"])
        out["native_register_s"] = time.perf_counter() - t0
    finally:
        csv_decode.read_csv_encoded = read
    if ctxs["native"].last_ingest != IngestReport(decoders=["native"]):
        raise AssertionError(f"lineorder.csv: {ctxs['native'].last_ingest}")
    out["register_decode_s"] = decode_s[0]
    out["register_decode_rows_per_s"] = rows / decode_s[0]
    # the shards through the sharded build
    report = IngestReport()
    t0 = time.perf_counter()
    sharded = build_datasource_from_csv("lineorder", files["shards"], report=report,
                                        **CSV_BUILD)
    out["sharded_build_s"] = time.perf_counter() - t0
    if report != IngestReport(decoders=["native"] * len(files["shards"])):
        raise AssertionError(f"sharded lineorder: {report}")
    ctxs["sharded"].register_datasource(sharded, star_schema=ssb.STAR_SCHEMA)
    for c in ctxs.values():
        _register_csv_dims(c, files)
    _same_segments("native one file against pandas", one, pandas_ds)
    _same_segments("native shards against pandas", sharded, pandas_ds)
    out["segments"] = len(one.segments)
    shapes = KernelShapes().start()
    cuda_groupby.LAUNCHES = 0
    queries = []
    for name, sql in ssb.QUERIES.items():
        row = {"query": name}
        answers = {}
        for k in ("pandas", "native", "sharded"):
            before = cuda_groupby.LAUNCHES
            t0 = time.perf_counter()
            answers[k] = ctxs[k].sql(sql)
            row[f"{k}_ms"] = (time.perf_counter() - t0) * 1e3
            m = ctxs[k].last_metrics
            launches = cuda_groupby.LAUNCHES - before
            # the kernel carries every pass: the dense class, or the
            # adaptive tier's presence passes and its compacted pass (none
            # where the filter keeps no group)
            carried = uses_kernel(m) or (m.strategy == "adaptive" and m.compact_groups == 0)
            if torch.device(device).type == "cuda" and (not carried or launches == 0):
                raise AssertionError(f"{name} over the {k} load: {m.describe()}, "
                                     f"{launches} launches")
            row[f"{k}_launches"] = launches
        row.update(strategy=m.strategy, num_groups=m.num_groups, compact_groups=m.compact_groups)
        for k in ("native", "sharded"):
            err, same = _csv_answer_check(f"{name} ({k})", answers[k], answers["pandas"])
            row[f"{k}_max_rel_err"] = err
            row[f"{k}_bit_identical"] = same
        queries.append(row)
        emit("csv_query", **row)
    out["launches"] = cuda_groupby.LAUNCHES
    shapes.stop()
    shapes.check()
    out["queries"] = queries
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ssb-scale", type=float, default=10.0)
    ap.add_argument("--tpch-scale", type=float, default=1.0)
    ap.add_argument("--stream-chunks", type=int, default=STREAM_CHUNKS)
    ap.add_argument("--rank-worker", nargs=7, default=None,
                    metavar=("PORT", "RANK", "NPROC", "STORE", "SPEC", "OUT", "BACKEND"),
                    help="run one rank of phase 18 (the run starts its ranks itself)")
    ap.add_argument("--csv-worker", nargs=2, default=None, metavar=("ROOT", "SCALE"),
                    help="prepare phase 19's files (the run starts its worker itself)")
    args = ap.parse_args(argv)
    if args.rank_worker is not None:
        return rank_worker(args.rank_worker)
    if args.csv_worker is not None:
        return csv_worker(args.csv_worker)
    run_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = cuda_groupby.build()
    emit("build", seconds=time.perf_counter() - t0, library=lib.name,
         ptxas=[l for l in cuda_groupby.BUILD_LOG.splitlines() if "registers" in l])

    _, timed = kernel_phase(device)
    # phase 19's CSV files and pandas-loaded reference, made by a worker
    # process beside phases 4 onwards (host work on other cores)
    csv_worker_run = start_csv_worker()

    workloads = build_workloads(args.ssb_scale, args.tpch_scale)
    # one context per workload: its engine drives that workload through
    # phases 4 to 6, which share its residency.  Each routes by the card's
    # calibration (`SessionConfig.load_calibrated`: the committed
    # calibration.torch_cuda.json when it names this card), with the
    # result cache off: phases 6 to 12 time and count every execution
    # (phase 14 turns it on for its repeat pass)
    calibrated = SessionConfig.load_calibrated(device=device)
    emit("calibration", nvidia_smi=card, meta=calibrated.calibration_meta,
         constants=cost_constants(calibrated))
    session = dataclasses.replace(calibrated, result_cache_entries=0)
    ctxs = {w: TPUOlapContext(dataclasses.replace(session), device=device)
            for w in ("ssb", "tpch")}
    engines = {w: c.engine for w, c in ctxs.items()}
    for e in engines.values():  # phase 4's native runs: the engine's own ladder
        e.cost_config = session

    def resident():
        return sum(e.bytes_resident() for e in engines.values())

    torch.cuda.reset_peak_memory_stats(device)
    shapes = KernelShapes().start()  # every launch of phases 4 to 16 and 13
    WATCH.install()  # nothing degraded unseen in phases 4 to 11
    cuda_groupby.LAUNCHES = 0  # count only the main path's launches
    t0 = time.perf_counter()
    queries = run_main_path(engines, workloads)
    launches = cuda_groupby.LAUNCHES
    emit("main_path", queries=len(queries), seconds=time.perf_counter() - t0,
         kernel_launches=launches, bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device),
         ssb_scale=args.ssb_scale, tpch_scale=args.tpch_scale)
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    profile_queries(engines, workloads, queries)
    WATCH.check("main_path")

    reg_s = register_sql(ctxs, workloads)
    cuda_groupby.LAUNCHES = 0  # count only the SQL path's launches
    t0 = time.perf_counter()
    sql = run_sql_path(ctxs, workloads)
    sql_launches = sum(q["kernel_launches"] for q in sql)
    emit("sql", queries=len(sql), seconds=time.perf_counter() - t0,
         register_seconds=reg_s, kernel_launches=sql_launches,
         bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if sql_launches == 0:
        raise AssertionError("the SQL path never launched the kernel")
    WATCH.check("sql")

    t0 = time.perf_counter()
    ops = sketch_op_checks(ctxs["ssb"])
    rho = rho_check(device)
    checks_s = time.perf_counter() - t0
    cuda_groupby.LAUNCHES = 0  # count only the sketch path's launches
    sketches = run_sketch_queries(ctxs["ssb"], workloads["ssb"][1])
    sketch_launches = cuda_groupby.LAUNCHES
    profile_sketch_queries(ctxs["ssb"], sketches)
    emit("sketches", queries=len(sketches), seconds=time.perf_counter() - t0,
         checks_seconds=checks_s, op_checks=len(ops), rho_values=rho["values"], kernel_launches=sketch_launches,
         bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if sketch_launches == 0:
        raise AssertionError("the sketch path never launched the kernel")
    WATCH.check("sketches")

    t0 = time.perf_counter()
    dims = workloads["dims"]["ssb"]
    exact = TPUOlapContext(dataclasses.replace(session), device=device)
    exact.engine = ctxs["ssb"].engine  # the same segments, already resident
    exact.register_datasource(
        ssb.key_dimension_datasource(workloads["ssb"][0], len(dims["customer"]["c_custkey"])),
        star_schema=ssb.KEYED_STAR_SCHEMA)
    exact.sql("SET count_distinct_mode = 'exact'")
    tier_ops = tier_op_checks([
        ("q3_2", ctxs["ssb"], ssb.QUERIES["q3_2"]),
        ("exact_inner", exact, ssb.EXACT_DISTINCT_QUERIES["topn_exact"]),
    ])
    checks_s = time.perf_counter() - t0
    cuda_groupby.LAUNCHES = 0  # count only the tier phase's launches
    tiers = run_tier_queries(ctxs, workloads)
    distinct = run_exact_distinct(exact, workloads["ssb"][1])
    tier_launches = cuda_groupby.LAUNCHES
    emit("tiers", queries=len(tiers), exact_distinct_queries=len(distinct),
         seconds=time.perf_counter() - t0, checks_seconds=checks_s, op_checks=len(tier_ops),
         kernel_launches=tier_launches, bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if tier_launches == 0:
        raise AssertionError("the tier phase never launched the kernel")
    WATCH.check("tiers")

    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only the arena phase's launches
    arena_rows = run_arena_queries(ctxs, workloads)
    cold = run_cold_pipeline(ctxs["ssb"], workloads)
    emit("cold_pipeline", **cold)
    arena_launches = cuda_groupby.LAUNCHES
    emit("arena", queries=len(arena_rows), seconds=time.perf_counter() - t0,
         replayed=sum(1 for r in arena_rows if r["graph_replays"]),
         declined=sum(1 for r in arena_rows if r["declines"]),
         kernel_launches=arena_launches, bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    WATCH.check("arena")

    t0 = time.perf_counter()
    tctx = ctxs["tpch"]
    tpch.register_extended(tctx, workloads["dims"]["tpch"])
    reg_s = time.perf_counter() - t0
    cuda_groupby.LAUNCHES = 0  # count only the fallback phase's launches
    fallback = run_fallback_queries(tctx, workloads["dims"]["tpch"], workloads["tpch"][1],
                                    shapes)
    fallback_launches = cuda_groupby.LAUNCHES
    emit("fallback", queries=len(fallback), seconds=time.perf_counter() - t0,
         register_seconds=reg_s, kernel_launches=fallback_launches,
         assisted_queries=sum(1 for q in fallback if q["assist_subplans"]),
         bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    WATCH.check("fallback")

    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only the native phase's launches
    native = run_native_surface(ctxs, workloads)
    native_launches = cuda_groupby.LAUNCHES
    emit("native", queries=len(native), seconds=time.perf_counter() - t0,
         p50_ms={r["query"]: r.get("p50_ms", r.get("ms")) for r in native},
         kernel_launches=native_launches, bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if native_launches == 0:
        raise AssertionError("the native phase never launched the kernel")
    WATCH.check("native")
    WATCH.uninstall()  # phase 12 checks its own queries

    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only the resilience phase's launches
    res = run_resilience(ctxs, workloads, p50s={
        "cube_theta": next(q["p50_ms"] for q in sketches if q["query"] == "cube_theta"),
        "fallback:q18": next(q["p50_ms"] for q in fallback if q["query"] == "q18")})
    resilience_launches = cuda_groupby.LAUNCHES
    emit("resilience", seconds=time.perf_counter() - t0, kernel_launches=resilience_launches,
         sweeps=len(res["sweeps"]), armed_queries=len(res["armed"]),
         armed_over_off=[r["armed_over_off"] for r in res["armed"]],
         overshoot_ms={r["query"]: r["overshoot_ms"] for r in res["wall_deadlines"]},
         retry_wall_ms={r["error"]: r["retry_wall_ms"] for r in res["retries"]},
         degraded_p50_ms=res["breaker"]["degraded_p50_ms"],
         card_p50_ms=res["breaker"]["card_p50_ms"],
         first_refinement_ms=res["progressive"]["first_refinement_ms"],
         bytes_resident=resident(), peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if resilience_launches == 0:
        raise AssertionError("the resilience phase never launched the kernel")

    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only the serving phase's launches
    serving = run_serving(ctxs, workloads)
    serving_launches = cuda_groupby.LAUNCHES
    mix = {r["run"]: r for r in serving["mix"]}
    emit("serving", seconds=time.perf_counter() - t0, kernel_launches=serving_launches,
         requests=len(serving["single"]),
         queries_per_s={k: mix[k]["queries_per_s"] for k in ("fusion_off", "fusion_on")},
         lanes={k: mix[k]["lanes"] for k in ("fusion_off", "fusion_on")},
         mean_fused_batch=mix["fusion_on"]["mean_fused_batch"],
         fused_graph_warm_ms=serving["fused"]["warm_p50_ms"],
         fused_graph_serial_ms=serving["fused"]["serial_sum_p50_ms"],
         dashboard_fused_batches=serving["dashboard"]["fused_batches"],
         dashboard_fused_graph_replays=serving["dashboard"]["fused_graph_replays"],
         dashboard_refresh_p50_ms={k: serving["dashboard"][k]["refresh_p50_ms"]
                                   for k in ("fusion_off", "fusion_on")},
         bytes_resident=resident(), peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if serving_launches == 0:
        raise AssertionError("the serving phase never launched the kernel")

    # phase 16 before phase 15, whose appends change the SSB data under the
    # oracles of phases 4 to 14; the serving flags back off
    for c in ctxs.values():
        c.sql("SET result_cache_entries = 0")
        c.sql("SET fusion_window_ms = 0")
    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only the cost model phase's launches
    with tempfile.TemporaryDirectory() as tmp:
        cost = run_cost_model(ctxs, workloads, tiers, fallback, device, tmp)
    cost_launches = cuda_groupby.LAUNCHES
    picks = cost["picks"]
    emit("cost_model", seconds=time.perf_counter() - t0, kernel_launches=cost_launches,
         queries=len(picks), within_slack=sum(1 for r in picks if r["within_slack"]),
         picks={r["query"]: r["pick"] for r in picks},
         fresh_picks_differ=[r["query"] for r in picks if r["pick_fresh"] != r["pick"]],
         assists_declined_by_cost=[r["query"] for r in cost["assists"] if r["cost_declines"]],
         stream_class=cost["stream"]["class"],
         bytes_resident=resident(), peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if cost_launches == 0:
        raise AssertionError("the cost model phase never launched the kernel")

    # phase 17 before phase 15 too: the meshes read phase 4's data
    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only the mesh phase's launches
    mesh = run_mesh(ctxs, workloads, device)
    mesh_baseline_launches = MESH_BASELINE_LAUNCHES[0]
    mesh_launches = cuda_groupby.LAUNCHES - mesh_baseline_launches
    emit("mesh_p50", nvidia_smi=card, table={
        r["query"]: {"single": r["single_p50_ms"],
                     **{k: v["p50_ms"] for k, v in r["mesh"].items() if "p50_ms" in v}}
        for r in mesh["queries"]})
    emit("mesh", seconds=time.perf_counter() - t0, kernel_launches=mesh_launches,
         baseline_kernel_launches=mesh_baseline_launches,
         meshes=mesh["meshes"], queries=len(mesh["queries"]),
         stream_rows_per_s=mesh["stream"]["rows_per_s"],
         deadline_coverage=mesh["resilience"]["deadline"]["coverage"],
         bytes_resident=resident(), peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if mesh_launches == 0:
        raise AssertionError("the mesh phase never launched the kernel")

    # phase 18 before phase 15 too: the store holds phase 4's data
    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only this process's launches of phase 18
    with tempfile.TemporaryDirectory() as tmp:
        procs = run_processes(ctxs, workloads, device, tmp)
    proc_launches = cuda_groupby.LAUNCHES
    multihost_launches = sum(r["launches"] for r in procs["ranks"])
    cluster_launches = procs["cluster"]["launches"]
    emit("processes", nvidia_smi=card, seconds=time.perf_counter() - t0,
         store_seconds=procs["store_s"], ranks_seconds=[r["wall_s"] for r in procs["ranks"]],
         cluster_seconds=procs["cluster"]["seconds"], kernel_launches=proc_launches,
         launches_multihost=multihost_launches, launches_cluster=cluster_launches,
         scattered=procs["cluster"]["scattered"], bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))

    t0 = time.perf_counter()
    cuda_groupby.LAUNCHES = 0  # count only the ingest phase's launches
    ingest = run_ingest(ctxs, workloads, queries)
    ingest_launches = cuda_groupby.LAUNCHES
    emit("ingest", seconds=time.perf_counter() - t0, kernel_launches=ingest_launches,
         ack_p50_ms=ingest["appends"]["ack_p50_ms"], ack_p95_ms=ingest["appends"]["ack_p95_ms"],
         append_to_visible_p50_ms=ingest["appends"]["append_to_visible_p50_ms"],
         remap_ms=ingest["remap"]["remap_ms"], compact_ms=ingest["compaction"]["compact_ms"],
         delta_refresh_p50_ms=ingest["delta_reuse"]["refresh_p50_ms"],
         full_first_run_p50_ms=ingest["delta_reuse"]["full_first_run_p50_ms"],
         recover_ms=ingest["restart"]["recover_ms"],
         restart_first_cold_ms=ingest["restart"]["first_cold_ms"],
         bytes_resident=resident(), peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if ingest_launches == 0:
        raise AssertionError("the ingest phase never launched the kernel")

    del ctxs, engines, exact, workloads, dims, tctx  # phase 13 needs host memory
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chunk_rows = STREAM_SHAPE[0]
    staged, oracle, staging = stage_stream(args.stream_chunks, chunk_rows)
    emit("stream_data", **staging)
    stream = run_stream(device, staged, oracle, chunk_rows,
                        min(STREAM_AB_CHUNKS, len(staged)))
    stream_launches = stream["kernel_launches"]
    emit("stream_run", **stream)
    profiles = [profile_stream(device, staged[:STREAM_PROFILE_CHUNKS], chunk_rows, db)
                for db in (True, False)]
    for p in profiles:
        emit("stream_profile", **p)
    cuda_groupby.LAUNCHES = 0
    stream_res = stream_resilience(device, staged, oracle, chunk_rows, stream["wall_s"])
    resilience_launches += cuda_groupby.LAUNCHES
    shapes.stop()
    emit("stream", seconds=time.perf_counter() - t0, rows=stream["rows"],
         rows_per_s=stream["rows_per_s"], h2d_gb_per_s=stream["h2d_gb_per_s"],
         timer=profiles[0]["timer"], copy_overlap_share=profiles[0]["copy_overlap_share"],
         device_idle_share=profiles[0]["device_idle_share"],
         kernel_launches=stream_launches,
         stream_truncation_coverage=stream_res["truncation"]["coverage"],
         stream_deadline_overshoot_ms=stream_res["wall_deadline"]["overshoot_ms"],
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    del staged
    shapes.check()
    gc.collect()

    t0 = time.perf_counter()
    csv = run_csv_ingest(session, device, await_csv_worker(*csv_worker_run))
    csv_launches = csv["launches"]
    emit("csv_rates", nvidia_smi=card, rows=csv["rows"], csv_bytes=csv["csv_bytes"],
         native_rows_per_s=csv["native_rows_per_s"], pandas_rows_per_s=csv["pandas_rows_per_s"],
         register_decode_rows_per_s=csv["register_decode_rows_per_s"])
    emit("csv_ingest", seconds=time.perf_counter() - t0, kernel_launches=csv_launches,
         queries=len(csv["queries"]),
         bit_identical=sum(1 for q in csv["queries"]
                           if q["native_bit_identical"] and q["sharded_bit_identical"]),
         **{k: v for k, v in csv.items() if k not in ("queries", "launches")},
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if csv_launches == 0:
        raise AssertionError("the CSV phase never launched the kernel")
    del csv
    gc.collect()
    torch.cuda.empty_cache()
    emit("total", nvidia_smi=card, seconds=time.perf_counter() - run_t0)

    head = next(t for t in timed if t["shape"] == HEADLINE and t["layout"] == "random")
    print(json.dumps({"kernels": [{
        "name": "groupby_partial",
        "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/groupby_partial.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_groupby.py:65",
        "launches": (launches + sql_launches + sketch_launches + tier_launches
                     + arena_launches + fallback_launches + native_launches
                     + resilience_launches + serving_launches + ingest_launches
                     + cost_launches + mesh_launches + mesh_baseline_launches
                     + proc_launches + multihost_launches + cluster_launches
                     + stream_launches + csv_launches),
        "launches_native": launches,
        "launches_sql": sql_launches,
        "launches_sketch": sketch_launches,
        "launches_tier": tier_launches,
        "launches_arena": arena_launches,
        "launches_fallback": fallback_launches,
        "launches_native_surface": native_launches,
        "launches_resilience": resilience_launches,
        "launches_serving": serving_launches,
        "launches_ingest": ingest_launches,
        "launches_cost_model": cost_launches,
        "launches_mesh": mesh_launches,
        "launches_mesh_baseline": mesh_baseline_launches,
        "launches_processes": proc_launches,
        "launches_multihost": multihost_launches,
        "launches_cluster": cluster_launches,
        "launches_stream": stream_launches,
        "launches_csv": csv_launches,
        "max_abs_err": max(t["max_abs_err"] for t in timed),
        "max_rel_err": max(t["max_rel_err"] for t in timed),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "call_ms": head["call_ms"],
        "bound_share": head["bound_share"],
        "shape": head["shape"],
        "shapes": timed,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
