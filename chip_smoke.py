#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_tpu_torch``) on one GPU, and
on several cards of one host where more than one is visible.

    python3 chip_smoke.py [--cards N]

``--cards N`` makes fewer than N visible cards a failure; phase 23 runs
when at least two are visible (``python3 tools/chip_phases.py cards`` runs
it alone, on a host with four cards).

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles the grouped-accumulate kernel (K1), the all-to-all
   kernel (K2) and ``lpt_assign`` from ``spark_tpu_torch/csrc/`` with
   ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, started together; prints
   ``-Xptxas -v`` (registers, spills) and the atomics in K1's SASS;
3. kernel check — K1's two entries against their plain PyTorch versions
   on the card, bit-exact: the columns entry (the main path's) at the
   hash-agg query's own plane specs (captured from one warm-up run), at
   each value width with NULLs and dtype extremes (sums that wrap),
   with dead-chunk rows, at N > 2^23 and at B = 10,000 with more planes
   than one accumulator pass holds; the planes entry at the main path's
   planes stacked, the edge shapes of the Pallas kernel's tests, dead
   chunks, N > 2^23 and B = 10,000; both at N = 2^24 rows in one bucket
   with every limb 255, also with the flush forced every 5,000 rows.
   Then each entry's time at the main-path shape — per call (CUDA
   events, the kernels line's ``ms``), back to back, the kernel alone
   (``torch.profiler``) and the wrapper's host time per call — beside its
   byte bound, its plain version's time and, for the planes entry, the
   one-call ``index_add_`` yardstick (which the port never calls); and
   the launch's grid, shared memory and cluster size;
4. slice — a ``SparkSession`` on the default device (the card) runs the
   hash-agg lane (2^22 rows, 1,024 groups) and TPC-DS q3 at SF1 row
   counts through the DataFrame API, on the default lane: each query's
   first run builds its stage-cache entry (an eager warm-up, then a CUDA
   graph capture) and later runs replay the graph.  Each result is held
   against a numpy oracle computed here (integers exact); the hash-agg
   query's first run must call K1 twice through the columns entry (the
   warm-up's launch and the captured one) and no ``aten::stack``; each
   query's warm wall time is the median of 5 runs;
5. SQL — the same session registers the hash-agg table and q3's tables
   as temp views and runs through ``spark.sql`` the hash-agg query
   (exactly one K1 launch, through the columns entry), q3's SQL text,
   and the queries of ``testing.SQL_QUERIES`` over q3's tables: UNION
   ALL, INTERSECT, EXCEPT, q3 with an IN subquery, a scalar and a
   correlated EXISTS subquery, LIKE, and one UDF per lane (the row
   lane's host copies reported); each result is held against its numpy
   oracle (``spark_tpu_torch/testing.py``); the SQL hash-agg and q3
   walls in turns with the DataFrame ones, each query's warm wall (with
   and without decoding the rows) and profile line; then q3's SQL text
   at ``spark.tpu.mesh.shards = 4``, where K2's launch count must rise;
6. stage — the stage cache: hash-agg and q3, each from the DataFrame API
   and from SQL text, as captured graphs.  Per query the build (warm-up
   plus capture) timed apart from 5 warm replays; the result against its
   oracle and bit for bit against the eager lane
   (``spark.sql.codegen.wholeStage=false``) and the per-operator lane
   (``spark.tpu.stage.fusion=false``); a profile of each lane (host
   launch calls, device kernels, device-busy share; the hash-agg replay
   must run K1 exactly once); the graph's pool bytes beside
   ``_plan_reserve_bytes``; walls in turns eager, graph, graph, eager,
   with and without the row decode.  Then one guard miss (the same
   shape on keys too wide for the bucket table) and its re-capture, one
   slotted-literal pair that shares an entry, and one
   ``HBMOutOfMemoryError`` raised before dispatch;
7. breadth — expression and aggregate breadth, grouping sets and window
   functions at the main path's sizes, through ``spark.sql`` on the
   graph lane (the texts and numpy oracles of
   ``testing.BREADTH_QUERIES``): q3's join with ``GROUP BY ROLLUP(d_year,
   i_brand_id)`` and ``grouping_id()``; over q3's join the revenue per
   (brand, year) with ``SUM(SUM(...)) OVER (PARTITION BY i_brand_id)``,
   ``rank() OVER (PARTITION BY d_year ORDER BY SUM(...) DESC)`` and
   ``lag(...) OVER (PARTITION BY i_brand_id ORDER BY d_year)`` (the q98
   shape); ``upper(i_brand)`` and ``substr(i_brand, 1, 7)`` as group
   keys of q3; ``stddev_samp(v)``, ``var_pop(v)`` and ``round(avg(v), 2)``
   per key of the hash-agg table.  Each result against its oracle
   (integers and decimals exactly, the statistics within rtol 1e-9) and
   bit for bit against the eager lane; per text the build, the warm wall
   with and without the row decode and a profile line; K1's launches in
   the phase's run.  Then the window text at
   ``spark.tpu.mesh.shards = 4``: K2's launch count must rise and the
   rows must equal the single-device ones;
8. mesh slice — the same session with ``spark.tpu.mesh.shards = 4`` (all
   four shards on the card) runs the hash-agg lane, q3 with its
   broadcast joins and q3 with ``spark.sql.autoBroadcastJoinThreshold =
   0`` (both joins shuffled through the skew join), each one stage-cache
   entry: its first run (the stage cache emptied before) an eager
   warm-up that records every K2 call's inputs and every
   ``lpt_assign`` call's counts, then the capture of one CUDA graph
   (K2's and ``lpt_assign``'s launches captured, build ms, the graph
   pool beside the mesh reserve ``_plan_reserve_bytes(pq, 4)``, which
   must cover it); each result held against the same numpy oracle; a
   warm run must be a replay (dispatches + 1, no build, no K2 wrapper
   call, K2's replayed launches counted on the host) whose rows equal
   the eager mesh lane's (``spark.sql.codegen.wholeStage=false``) bit for
   bit; warm walls (median of 5) in turns graph, eager, eager, graph; a
   profile of each lane (host launch calls, device-busy share); then a
   second seeded data set of the same shapes (hash-agg's table, q3's
   store_sales) through the same entries, each equal to its oracle,
   hash-agg's a replay of the same variant.  The phase prints its
   seconds;
9. K2 check — K2 against its plain PyTorch version on the card,
   bit-exact, at every exchange the three mesh queries made, at n = 2, 4
   and 8 with bool planes and int32 run tables whose blocks are not
   multiples of 16 bytes, at cap = 1, in the gather form and with 50
   planes (a wide pointer table); K2's cross-process pull
   (``pull_kernel``) against ``pull_plain`` at ``_pull_cases`` (1 to 4
   senders; bool, int32, int64 and float64 planes; rows of 0, 1, 15, 17
   and an odd count above one ring stage; sources off 16-byte alignment;
   a zero-byte plane between two others; below one stage, one stage and
   many), from slices of a local ``cuda_a2a.Arena``, the bytes past each
   row's block untouched; then K2's time at the largest recorded
   all-to-all (CUDA events, warm-up, median of 25; 25 launches back to
   back, which hides the wrapper's host work; and the kernel alone under
   ``torch.profiler``) beside its byte bound,
   its plain version's time and the one-call
   ``transpose(0, 1).contiguous()`` yardstick on the same bytes
   pre-stacked (which the port never calls), per call and back to back,
   and alone in turns with the kernel alone (K2, transpose, transpose,
   K2);
   then ``lpt_assign`` against its plain version, bit-exact, at every
   call of the mesh queries' warm-ups (each ranked in the kernel: no
   sort in the mesh entries) and at random, tied, two-valued and small
   counts at 1, 2, 3, 4, 8, 9, 16, 32 and 33 shards (one thread's
   registers, a warp's lanes, shared memory; ranked in the kernel up to
   512 buckets, sorted past it), at 70 shards and with no bucket, and
   its time at the main path's 128 buckets (per call, back to back,
   alone in turns with the parent commit's kernel where
   ``build/lpt_old/lpt_assign.cu`` holds its source) beside its latency
   floor (the kernel at no bucket), its bound and its plain version's;
10. complex — arrays, maps and structs at SF1 row counts
   (``testing.basket_tables``: store_sales as ~240,000 tickets of 8-16
   line items, 18,000 items; ``spark.tpu.collect.maxArrayLen`` = 16, the
   largest basket): the texts of ``testing.COMPLEX_QUERIES`` — baskets
   (``collect_list`` / ``collect_set`` per ticket with size,
   ``sort_array(...)[0]``, ``element_at``, ``array_contains``,
   ``array_distinct``, ``slice``, ``array_max``), explode back to rows
   (``posexplode`` and a dynamic ``element_at``, joined to item, count
   and sum by ``i_manufact_id``), the higher-order functions with a map
   and a struct — and ``sample`` / ``rand`` / ``randn`` /
   ``monotonically_increasing_id`` over store_sales, each through the
   graph lane against its numpy oracle (rand and the ids bit for bit,
   randn within rtol 1e-12) and bit for bit against the eager lane; per
   text the build, the warm walls with and without the decode, the graph
   pool beside ``_plan_reserve_bytes`` and a profile line; K1's launches
   in the phase's run.  Then the baskets text (without its ORDER BY) and
   ``spark_partition_id()`` at 4 shards: K2's launches rise, the rows
   equal the one-device run, every partition id is in 0..3;
11. server — ``SQLServer`` on the card session, on an ephemeral port of
   127.0.0.1, its root session holding the hash-agg table and q3's
   tables at SF1 row counts as temp views (each server session sees the
   same plans): four client threads, each on its own server session,
   POST two rounds of the SQL phase's statements; every reply equals its
   numpy oracle and every cacheable round-2 reply is a plan-cache hit;
   per statement the HTTP walls of each round (p50, p90),
   ``planningSkippedMs`` and the host launch calls of a hit; one client
   alone, a miss's and five hits' HTTP walls; a hit in process in turns
   with the stage cache alone; then a literal variant that builds
   nothing, a SET of a planning conf that invalidates, a 429 over
   ``maxConcurrentStatements``, a cancelled queued statement that never
   runs, a mesh statement (K2's count rises, its repeat hits) and every
   evicted graph's bytes back on the card;
12. tpcds — the port's TPC-DS tables (``spark_tpu_torch/tpcds``, at
    ``TPCDS_SF_ROWS``) in the root session and in sqlite (answering on
    ``ORACLE_THREADS`` connections at once, ``ORACLE_OVERRIDES`` for
    the texts sqlite cannot run as written); each of the 99 texts
    POSTed twice, held against sqlite by the rule of
    ``tests/test_tpcds.py``; each repeat a plan-cache hit but for the 13
    texts whose plans hold a window (``WINDOW_QUERIES``), which the
    plan cache counts uncacheable, as the reference's does — the phase
    checks that count; then the baskets text POSTed once over the
    basket tables, every list of the reply equal to the oracle;
13. scan — files in and out (``spark_tpu_torch/io.py``), under a
    temporary directory deleted at the end: the port's writers put
    hash-agg's table (2^22 rows) and store_sales (SF1's 2,880,404 rows,
    sorted by ``ss_sold_date_sk``, row groups of 2^18) as parquet,
    date_dim as CSV with a header and item as a catalog table
    (``saveAsTable``), each write timed; at the default
    ``spark.tpu.scan.maxBatchRows`` (2^20) hash-agg over the parquet file
    streams through the multi-batch runner in 4 batches and must equal
    the in-memory answer, then the limit is 2^23.  On the graph lane: (a) hash-agg's SQL text over the
    parquet file (K1: 2 launches in its first run, warm-up and capture, 1
    per replay; K1 held against its plain version on (a)'s own inputs),
    (b) q3's TPC-DS text over the three file-backed tables, (c) a count
    and sum over one twelfth of store_sales' dates (row groups skipped by
    their footer statistics), each equal to the in-memory run of the same
    tables exactly, with its cold wall (the first run: decode, copy to
    the card, warm-up and capture), warm wall (median of 5, a relation
    cache hit), host decode ms, bytes copied to the card per run and that
    copy's ms beside its bound over the host link, device time, host
    launch calls and ``SCAN_STATS``; the relation cache's pinned bytes;
    (d) ANALYZE TABLE item FOR ALL COLUMNS, DESCRIBE EXTENDED and q3 again
    (join order before and after); (e) INSERT INTO item, after which the
    row count grows, q3's stage key changes and its answer equals the
    in-memory run over the grown table.  (a) at 4 shards (K2 launches
    1, rows equal).  A SQL server over the file-backed tables: q3 POSTed
    twice (the second a plan-cache hit whose leaves were re-read), a
    second client's INSERT, a third POST showing the new rows, the
    invalidation count.  Then the 13 texts of
    ``tests/test_tpcds_filebacked.py``'s ``SMOKE`` over the [tpcds]
    phase's tables with their fact tables as parquet (3 part files each,
    default limit), each equal to sqlite by the [tpcds] rule;
14. ooc — out-of-core execution (``sql/multibatch.py``,
    ``sql/stages.py``) at TPC-DS SF10 row counts
    (``testing.ooc_tables``: store_sales 28,800,991 rows as tickets of
    8-16 line items, store_returns 2,875,432 drawn from its rows,
    date_dim, item 102,000, reason 45; hash-agg's table at 2^25 rows)
    written by the port's writers (parquet in row groups of 2^20,
    date_dim as CSV, item a catalog table), streamed at the default
    ``spark.tpu.scan.maxBatchRows`` (2^20) on the graph lane: (a)
    hash-agg (multi-batch runner, 32 batches), (b) TPC-DS q3 (stage DAG,
    date_dim and item broadcast into the step), (c) TPC-DS q93 (a grace
    hash join of store_sales and store_returns), (d) a top-k ORDER BY
    over store_sales.  Each a cold run and ``OOC_WARM`` warm runs, every
    one equal to its numpy oracle (integers, keys and order exactly;
    q93's sums within rtol 1e-9 of the exact cents), with its wall split
    into host decode, copies to the card (beside 64 GB/s), step
    dispatch, packed read-backs, host merge, (c)'s grace partitioning
    and bucket joins; device time (and its mean per batch) and the
    device-busy share from the last warm run, which runs under the
    profiler; graph builds and guard misses (0 on warm runs), peak
    device bytes,
    (c)'s buckets and spills.  Then (d) without its LIMIT, spilled to disk
    (``hostMemoryRows`` 2^22) and merged, against the oracle and the
    top-k; (a) and (b) as one 2^25-row batch (equal answers; the
    streamed peaks below a quarter of theirs, (c)'s and (d)'s below
    (b)'s); (b) POSTed twice to the SQL server (the second a plan-cache
    hit); (a) and (c) at 4 shards over SF1 row counts in 2^18-row batches
    (equal to their oracles, q93's sums by the same rule; K2 launches in
    (c), and every K2 call of both runs bit-exact against its plain
    version on its own planes); the seconds of each step;
15. cache — cached relations (``memory.DeviceCacheManager``,
    ``DataFrame.cache`` / ``persist`` / ``checkpoint``) and the C++
    sketches, after [ooc] and over its SF10 files: (a) hash_t and q3's
    store_sales projection at SF1 cached at DEVICE (each plan reads a
    cached leaf), hash-agg and q3 over them equal to their oracles, the
    warm walls (median of 5) in turns with the uncached runs, 0 graph
    builds and 0 guard misses in the warm runs, K1's launches in the
    first run over the cache (warm-up and capture) and K1 bit-exact
    against its plain version on the cached leaf's planes, then hash-agg
    over the cache at 4 shards with every K2 call bit-exact; (b) the
    projection at HOST and at HOST_COMPRESSED (each column's scheme, the
    compressed bytes against the dense), q3's first and warm walls, the
    host entries pinned; (c) a session whose device memory budget holds
    store_sales' projection, or hash_t with hash-agg's working set over
    it, but not both relations: putting the second demotes the first to
    HOST_COMPRESSED, hash-agg over the first promotes it and demotes the
    other, each move with its ms; (d) [ooc]'s SF10 store_sales projected
    to q3's columns cached on the card, q3 over it equal to [ooc]'s
    streamed q3 with its warm wall beside [ooc] (b)'s; (e) an eager and
    a lazy checkpoint of the SF1 projection under the temporary
    directory (the lazy one written at its first action, not by
    explain), q3 over each equal to its oracle; (f) a ``BloomFilter``
    and a ``CountMinSketch`` over SF1's ``ss_item_sk`` through the C++
    library, bit-exact against their numpy plain versions, with times;
16. crossproc — cross-process SQL over the host shuffle
    (``parallel/crossproc.py``, ``parallel/hostshuffle.py``): two worker
    processes started here on the one card (``python -m
    spark_tpu_torch.testing crossproc-worker <pid> 2 <dir> card``), each a
    ``cuda`` session with ``enableHostShuffle`` on one temporary
    directory and ``spark.tpu.memory.hbmBudget`` at its share of the free
    device memory, holding contiguous halves of hash-agg's table (2^22
    rows), SF1 store_sales (q3's) and [ooc]'s SF1 store_sales and
    store_returns, with date_dim, item and a second copy of hash_t whole
    in both: the texts of ``testing.CARD_TEXTS`` — (a) hash-agg on the
    fast path, (b) q3 with its dimensions replicated (fast path), (b2) q3
    with item partitioned (broadcast lane), (c) q93's join of
    store_sales and store_returns on the hash lane, on the range lane
    (its two-column key packed into one), with 1 MiB spill thresholds
    (spilled sides) and with ``spark.tpu.memory.hostBudget`` at 4 MiB and
    64 grace buckets as well (grace buckets in both reducers), (d) DISTINCT over a window (generic path), (e) hash-agg
    over the replicated copy (generic path, K1's columns entry).  Each
    text a cold run and a warm run under the profiler (the card's
    activity alone); each answer
    equal to this process's single-process answer over the whole tables
    (floats within 1e-9, unordered texts as multisets) and each lane's
    counter fired in every worker's warm run;
    per worker the warm wall split into
    local runs, bucketing on the card, read-back, write, commit and
    barrier waits, fetch and decode, and merge, with blocks and bytes
    written, the ledger's peak and the card's busy share; every K1
    launch in the workers counted where the kernel starts
    (``cuda_agg.ENTRY_LAUNCHES``) and, outside a capture, bit-exact
    against its plain version on its own inputs, its graph replays
    counted in the warm runs' profiles, (e)'s in each worker; K2
    launches 0;
17. ici — the cross-process device tier: two ``cuda`` workers as in
    16 (``crossproc-worker <pid> 2 <dir> ici-card``) with
    ``spark.tpu.shuffle.ici.enabled`` by the auto probe (both on one
    card: one domain) run q93's join on the hash lane, the range lane
    and spilled, and q3 (string sides: the host tier): each cold with
    every cross-process K2 pull held bit-exact against its plain version
    over the bytes each sender packed (``ici.CHECK_ENV``), then warm in
    turns device, host, host, device tier; c_hash once with
    ``tierOverride`` 0,1; c_hash and c_range on the host tier with run
    codes (run-coded columns on the wire, lazy to the receiving stage,
    the run counters the JAX package moves); ``ici_unavailable`` in
    worker 1 (its fold-back counted there only).  Every answer equal to
    the single-process answer; per device run the split pack, sidecar,
    pull (CUDA events) and unpack with the bytes pulled beside their
    bound; then K2's pull with the peer process IDLE (``testing
    arena-peer`` holds an arena and runs nothing) at the battery's
    largest pull and at 64 MiB from one sender, and from three slots of
    the arena (``ICI_THREE_ROWS`` int64 rows each), beside the library
    call that computes the same pull (``torch.Tensor.copy_`` per block
    from a tensor over the IPC-mapped arena) and its plain version, all
    equal to the peer's bytes: per call, back to back, alone
    (``torch.profiler``) and the wrapper's host time; then process 1
    of a recovery pair dies at the copy point and process 0 recovers in
    an epoch, its ledger at 0 B;
18. recovery — four scenarios, each two worker processes on the card
    (``python -m spark_tpu_torch.testing recovery-worker <pid> 2 <dir>
    card-<x>``, ``spark.tpu.memory.hbmBudget`` a share of the free
    memory, the heartbeat a deployment runs with: a beat each second,
    dead after 10 s) that write their contiguous halves to parquet and
    read them back, run the text twice without a fault (cold, warm),
    then with a ``FaultInjector`` plan killing process 1: (a) q93's join
    on the hash lane, process 1 dead after its put — process 0 agrees on
    the loss, re-reads the dead half's files and re-executes in epoch 1;
    (b) the same with ``maxStageRetries=0`` — a bounded
    ``ExchangeFetchFailed`` naming host-1; (c) the block service on, no
    budget, process 1's right-side block lost and process 1 dead after
    its last seal — adopted from the store with zero re-execution; (d)
    hash-agg over a UNION ALL of two partitioned file sets (the generic
    lane), process 1 dead after its put of the second — K1 launches in
    the re-executed epoch, its eager launch bit-exact.  Each equal to the
    single-process answer, with detection (from the victim's death to
    the failure), the agreement round, the re-read and the re-executed
    epoch, the faulted wall beside the no-fault warm wall, graphs
    captured, and the ledger back at 0 B;
19. pool — hash_t and q3's SF1 tables as catalog tables under a
    warehouse; a server without the pool answers hash-agg and q3 over
    HTTP (cold, warm: the local runs); then a server with
    ``spark.tpu.server.pool.enabled`` (1 to 2 workers, each ``python -m
    spark_tpu_torch.serving.pool --worker`` a ``cuda`` session with its
    share of the card, K1 held against its plain version in the worker)
    offloads both, every reply served by a worker and equal to the local
    run; four client threads grow the pool to 2, idle rounds reap one
    through hysteresis, its block-service lease handed to the
    supervisor; spawn-to-ready, offloaded and local walls, counters;
20. stream — Structured Streaming on the Yahoo Streaming Benchmark's
    shape at full width: 8 parquet files of 2^20 ad events (user_id,
    page_id, ad_id, ad_type, event_type, event_time, ip_address; the ids
    int64, not UUID strings), written by the port's writer, 100
    campaigns of 10 ads; ``FileStreamSource`` with maxFilesPerTrigger 1,
    one file appearing before each trigger.  (a) views joined to the ad
    table, counted per campaign per 10 s window under a 10 s watermark,
    update mode; (b) the same in append mode (each window once); (c)
    dropDuplicates(user_id, event_time) under a 20 s watermark (~2 M
    keys of state, its bytes flat from trigger 2 on); (d) views ⋈ clicks on (ad_id, user_id), 2^16 events
    a side a trigger, the watermark on the views; (e) per-user session
    counts by flatMapGroupsWithState with an event-time timeout, 2^14
    events of 1,000 users (host-bound); each trigger against its numpy
    oracle (``spark_tpu_torch/testing.py``), (a) with 0 stage rebuilds
    from trigger 2; per trigger the decode, the copy to the card, the
    query below the stateful operator, the state merge (device ms), the
    sink and commit, the wall, events/s and the card's busy share (a
    profile of the trigger).  (f) (a) with a checkpoint and a json sink:
    a fault-free lifetime here, then ``stream-worker`` processes on the
    card, one killed by ``die_after_state_commit`` at trigger 3, the
    restart resuming (time to recover: from its start to its first
    commit), its last commit entry torn and replayed; the sink equal to
    the fault-free one byte for byte.  (g) foreachBatch hash-agg over
    each micro-batch: K1 once per trigger in the stage cache, its eager
    launch bit-exact.  (h) ``POST /stream`` of (a) as a spec (watermark
    + SQL), ``GET /stream/<id>`` per trigger against the oracle, a second
    POST over ``maxStandingQueries`` refused, ``DELETE``;
21. analysis — the analysis package, the jdbc source and the command
    line (``spark_tpu_torch/analysis/``, ``jdbc.py``, ``cli.py``): (a)
    the SQL phase's hash-agg and q3 texts on a session with
    ``spark.tpu.analysis.verifyPlans=on``, each stage built anew (the
    logical and physical plans and the stage contract verified), equal to
    the SQL phase's answers, ``plans_verified`` > 0, K1's launches
    counted and its eager one bit-exact; each warm wall with the verifier
    on in turns with the root session's (off) and ``plan_verify_ms`` per
    run beside it; (b) two ``cuda`` workers (``python -m
    spark_tpu_torch.testing analysis-worker <pid> 2 <dir> card``) run
    q93's join on the hash lane over the device tier with the runtime
    checks on, cold (every K2 pull held bit-exact against its plain
    version) and warm: equal to the single-process answer, the
    decision-trace checks and divergences (0) printed; (c) the same join
    once more with ``skew_decision`` armed in worker 1: both workers end
    in ``PlanInvariantError`` naming the diverged component, the time to
    that error printed; (d) q3 with date_dim and item read through jdbc
    from a sqlite file the port's writer wrote, equal to the in-memory
    q3; (e) ``python -m spark_tpu_torch.cli sql -e`` with a hash-agg text
    over a parquet copy of hash_t in a process of its own on the card,
    its table equal to this process's ``show``.  The phase prints its
    seconds;
22. ml — RDD, ML and GraphX (``spark_tpu_torch/rdd/``, ``ml/``,
    ``graphx/``) with the listener bus, the event log, the history page
    (``ui.py``) and the CSV metric sink, on a session whose
    ``spark.eventLog.dir`` and ``spark.tpu.metrics.csv.dir`` are set
    before its first query: (a) an RDD word count of 2^20 records of 8
    words (vocabulary 2^16, 8 partitions) equal to a Counter oracle, then
    ``toDF`` of 2^20 (k, v) rows and hash-agg's ``groupBy(k).agg(sum,
    count)`` (1,024 keys): K1 twice through the columns entry (warm-up,
    capture), the eager launch bit-exact; (b) VectorAssembler over 28
    float64 columns of 2^22 rows in the UCI HIGGS shape → StandardScaler →
    binomial IRLS (25 steps) → areaUnderROC, against numpy's IRLS
    (coefficients within 1e-8 absolute, AUC within 1e-9); (c) KMeans,
    k = 10, 20 steps over 2^22 × 20 points around 10 Gaussian centres
    (HiBench's k-means shape), against numpy's Lloyd steps from the same
    starts (centres within rtol 1e-9, assignments equal but near-ties);
    (d) a Graph500 R-MAT graph of scale 22, edge factor 16, made on the
    card: ``page_rank`` (20 iterations) against scipy within rtol 1e-9,
    ``connected_components`` equal to scipy's per-component minimum
    vertex id; (e) one SQLExecutionStart / SQLExecutionEnd pair per
    execution of (a)–(d) in the log and on a listener, none failed, the
    history page listing them, one CSV per metrics source.  Each part
    prints its wall (median of 3 after a warm-up; the word count once),
    one profiled run's device ms per op and the bytes held on the card,
    and its oracle's ms; the phase prints its seconds;
23. cards — with two or more cards visible (on one it prints ``[cards]
    not run: 1 card visible``): (1) each card's name and power limit and
    the peer-access matrix (a pair without it fails); the fused
    exchange's arrive-and-wait alone (the guards' gather to card 0, 200
    back to back on every card, each card's epoch, arrival and done slots
    read back, advanced by 200; its time from the host, in one graph per
    card and alone per card), half a flag round trip between two cards
    (the latency floor), the old order's barrier_kernel (200 back to
    back and in graphs, its slots read back) and its plain version, and
    the exchange launched on card 0 alone at a 50 ms limit, which must
    time out naming a peer and raise; (2) the three mesh queries of
    phase 8 at 4 shards, one per
    card: each equal to its oracle and bit for bit to the one-card mesh
    lane's rows (a child process under ``CUDA_VISIBLE_DEVICES=0``), one
    stage-cache entry of 4 graphs whose graph bytes per card sit under
    its per-card reserve, a warm run a replay (K2's copy launches and
    arrive-and-wait launches per card counted on the host: only cards
    1-3 arrive and wait, in the gathers to card 0), equal to the eager
    lane, warm walls
    in turns graph, eager, eager, graph, a profile's device-busy share
    per card, and a second data set through the same graphs; (3) q3's
    SQL text with ``spark.tpu.mesh.shards = 0`` runs as 4 shards on the
    4 cards; (4) [ooc]'s (a) streamed at 4 shards across the cards; (5)
    every K2 call of (2)'s warm-ups bit-exact against its plain version,
    the largest shuffled-q3 exchange timed (per call, through the
    wrapper and launched directly, and alone per card, the fused launch
    in turns with the old order of barrier, copy, barrier; ``copy_`` per
    peer block, the bound, the one-card K2 at the same bytes), and a
    shard that raises before its second collective
    ending every shard in an error, no card left waiting; (6) two
    ``crossproc`` workers on ``cuda:0`` and ``cuda:1`` run q93's hash lane
    on the device tier in one domain, every pull bit-exact, then the pull
    alone over NVLink from an idle card, its sentinel bytes kept;
24. a ``{"kernels": [...]}`` line (each kernel's ``sql_launches``: its
   launches in the SQL phase's counted run; ``breadth_launches``: K1's in
   the breadth phase's graph-lane run, K2's in its window text at 4
   shards; ``complex_launches``: K1's in the complex phase's graph-lane
   run of its five texts, K2's in its two queries at 4 shards;
   ``server_launches``: K1's in the four clients' two rounds,
   K2's in the two mesh statements; ``scan_launches``: K1's in the
   [scan] phase's first run of (a), K2's in (a) at 4 shards;
   ``ooc_launches``: K1's in [ooc]'s one-batch run of (a) (the streamed
   runs launch none: their partial aggregate is the sort-based one),
   K2's in (c) at 4 shards; ``cache_launches``: K1's in [cache] (a)'s
   first hash-agg run over the cached hash_t, K2's in its run at 4
   shards; ``crossproc_launches``: K1's in the [crossproc] workers (each
   entry's own count, from 0 before each worker's battery), K2's there
   (0), and ``crossproc_replayed_launches``: their graph replays that the
   profiles of the workers' warm runs saw; K2's ``ici_launches``: its
   cross-process pulls in the [ici] workers (from 0 before each
   battery), with ``ici_pull_ms`` / ``ici_pull_bound_ms`` of the largest
   warm pull; ``recovery_launches``: K1's
   in the survivors' faulted statements of [recovery] (each from 0 just
   before it), K2's there (0); ``pool_launches``: K1's in the pool
   workers (from their start), K2's (0); ``stream_launches``: K1's
   wrapper launches in [stream] (g) (warm-up and capture), with
   ``stream_replayed_launches`` its launches that the replays of (g)'s
   stage graph carried (``cuda_agg.REPLAYED_LAUNCHES``), K2's (0: no
   exchange on one card); K2's
   ``ici_pull_idle_ms`` / ``ici_pull_library_ms`` (the idle-peer pull
   and its ``copy_`` yardstick at the battery's largest bytes), with
   ``ici_pull_alone_ms``, ``ici_pull_b2b_ms``, ``ici_pull_host_ms`` and
   ``ici_pull_three_senders_ms``; the pull kernel's own entry
   (``pull``), its launches K2's ``ici_launches`` and its times the
   idle-peer pull's; ``analysis_launches``: K1's in [analysis] (a), the
   pull's in (b)'s two clean runs of both workers, K2's all-to-all's
   there (0); ``ml_launches``: K1's in [ml] (a) (2 through the columns
   entry), K2's and the pull's in the whole [ml] phase (0); each
   counted from 0 just
   before that run; K1's ``captured_launches``: those of its launches made while a
   graph was captured, and ``replayed_launches``: its launches the
   profiler saw in one replay of each hash-agg query),
   K2's ``mesh``: per mesh query its first-run, build and captured and
   eager warm walls, graph pool and reserve bytes, launches eager,
   captured and replayed, host launch calls and busy shares, and
   ``replayed_launches``: its launches in one replay of each; the
   ``lpt_assign`` entry, its ``launches`` the wrapper's in the mesh
   queries' first runs (warm-up and capture) and its replayed launches
   per query; on several cards also ``k2_cards``, ``barrier`` and
   ``pull_cards`` from phase 23),
   the card line, and as the last line ``{"ok": true, "device": {...}}``.

Every profile line gives, beside the largest kernels, each hand-written
kernel's own device time, its launches and its share of the run's
device time.  Since the mesh lane is captured, K2's count in a phase
is its runs on the card counted on the host (``k2_runs``): the wrapper's
launches outside a capture plus those the replayed graphs carried.

Query data are made with numpy from fixed seeds, the kernels' extra
check inputs with seeded torch generators.  The script imports neither
JAX nor the JAX package.
"""

import contextlib
import io
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
MAIN_N, MAIN_GROUPS = 1 << 22, 1024
Q3_ROWS = {"store_sales": 2_880_404, "date_dim": 73_049, "item": 18_000}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def cuda_ms(fn, warmup=3, reps=25):
    """Median device time of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_back_to_back(fn, warmup=3, reps=25):
    """Device time per call over ``reps`` calls enqueued back to back
    between one pair of CUDA events: the host's enqueue work overlaps the
    device's, so this is the kernel's time without the wrapper's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, warmup=3, reps=25):
    """Median host time of one call from an idle device: the wrapper's
    work up to its last enqueue, not the device's."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def zero_counts():
    """Every kernel's launch count to 0, just before a main-path run."""
    from spark_tpu_torch import cuda_a2a, cuda_agg, cuda_lpt
    cuda_agg.LAUNCHES = 0
    for entry in cuda_agg.ENTRY_LAUNCHES:
        cuda_agg.ENTRY_LAUNCHES[entry] = 0
        cuda_agg.CAPTURED_LAUNCHES[entry] = 0
    cuda_a2a.LAUNCHES = 0
    cuda_a2a.CAPTURED_LAUNCHES = cuda_a2a.REPLAYED_LAUNCHES = 0
    for counts in (cuda_a2a.CARD_LAUNCHES, cuda_a2a.CARD_CAPTURED,
                   cuda_a2a.CARD_REPLAYED, cuda_a2a.CARD_BARRIERS,
                   cuda_a2a.CARD_CAPTURED_BARRIERS,
                   cuda_a2a.CARD_REPLAYED_BARRIERS):
        counts.clear()
    cuda_lpt.LAUNCHES = 0
    cuda_lpt.CAPTURED_LAUNCHES = cuda_lpt.REPLAYED_LAUNCHES = 0


def clear_stage_cache():
    """Drop every captured graph, so the next run of each query builds
    (warm-up and capture) its entry anew."""
    from spark_tpu_torch.sql.stagecompile import stage_cache
    stage_cache().clear()


def wall_ms(fn, warmup=1, reps=5):
    """Median host wall time of a call that ends in a device sync."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {card}",
          flush=True)
    return card


def phase_build():
    from spark_tpu_torch import cuda_a2a, cuda_agg, cuda_build, cuda_lpt
    t0 = time.perf_counter()
    paths = cuda_build.build_all([cuda_agg.SOURCE, cuda_a2a.SOURCE,
                                  cuda_lpt.SOURCE], verbose=True)
    print(f"[build] {', '.join(os.path.relpath(p) for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)", flush=True)
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", paths[0]], capture_output=True,
                          text=True, timeout=120).stdout
    atomics = {}
    for tok in sass.replace(";", " ").split():
        if tok.startswith(("ATOMS", "ATOMG", "RED")):
            atomics[tok] = atomics.get(tok, 0) + 1
    print(f"[build] K1 SASS atomics (instructions): {atomics}", flush=True)


def _random_inputs(n, B, P, n_active, seed, dead_rows=0):
    """Rows in live chunks; ``dead_rows`` padding rows parked at B-1 with
    zero planes (the chunk past n_active when B is wide enough)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    live_b = min(B, n_active * 512)
    bucket = rng.integers(0, live_b, n).astype(np.int32)
    planes = rng.integers(0, 256, (n, P)).astype(np.uint8)
    if dead_rows:
        bucket[-dead_rows:] = B - 1
        planes[-dead_rows:] = 0
    dev = torch.device("cuda")
    return (torch.from_numpy(bucket).to(dev), torch.from_numpy(planes).to(dev),
            torch.tensor([n_active], dtype=torch.int32, device=dev), B)


#: value columns of the fused entry's checks: dtype name, as the grouped
#: aggregate hands them over (a decimal is its int64 unscaled value)
VALUE_KINDS = ("int8", "int16", "int32", "int64", "bool", "decimal")


def _sum_planes(value, mask):
    """The planes one Sum/Avg of ``value`` makes, as
    ``kernels._mxu_grouped_aggregate`` describes them: limbs, then the
    count of its non-NULL rows."""
    from spark_tpu_torch import cuda_agg
    n_limbs = value.element_size()
    offset = -(1 << 63) if n_limbs == 8 else 1 << (8 * n_limbs - 1)
    return [cuda_agg.Plane(mask, value, i, offset) for i in range(n_limbs)] \
        + [cuda_agg.Plane(mask)]


def _column_inputs(n, B, n_active, kinds, seed, nullable=True,
                   dead_rows=0, bucket=None):
    """Columns on the card and the planes of a grouped aggregate over
    them: plane 0 counts live rows (a row mask), then per value column a
    Count plane and the Sum planes.  Values hold each dtype's extremes, so
    the limb sums recombine to wrapping int64 sums; ``dead_rows`` rows
    sit in the chunk past n_active with nonzero planes."""
    import torch
    from spark_tpu_torch import cuda_agg
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    if bucket is None:
        bucket = torch.randint(0, min(B, n_active * 512), (n,), generator=g,
                               device=dev, dtype=torch.int32)
        if dead_rows:
            bucket[-dead_rows:] = torch.randint(
                n_active * 512, B, (dead_rows,), generator=g, device=dev,
                dtype=torch.int32)
    live = torch.rand(n, generator=g, device=dev) < 0.9
    planes = [cuda_agg.Plane(live)]
    for kind in kinds:
        if kind == "bool":
            x = torch.rand(n, generator=g, device=dev) < 0.5
        else:
            dt = getattr(torch, "int64" if kind == "decimal" else kind)
            info = torch.iinfo(dt)
            lo, hi = (-10 ** 17, 10 ** 17) if kind == "decimal" else \
                (info.min, info.max)
            x = torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dt)
            x[:4] = torch.tensor([info.min, info.max, info.max, -1], dtype=dt)
        m = live
        if nullable:
            m = (live & (torch.rand(n, generator=g, device=dev) < 0.7)
                 ).contiguous()
        planes.append(cuda_agg.Plane(m))
        planes.extend(_sum_planes(x, m))
    return (bucket, planes,
            torch.tensor([n_active], dtype=torch.int32, device=dev), B)


def _stacked(planes, n):
    """The (N, P) uint8 plane matrix of ``planes``, built in plain torch."""
    import torch
    from spark_tpu_torch import cuda_agg
    return torch.stack([cuda_agg.plane_values(p, n, "cuda") for p in planes],
                       dim=1).contiguous()


#: idle seconds kept inside each profiler window before the first launch
#: and after the last kernel ends: kineto drops a device record whose
#: span, on the host's clock, falls outside the window, so a kernel that
#: ends just before the window closes can go missing
PROFILE_PAD_S = 0.05

#: marker kernels launched at the start of each profiler window, then
#: waited for, before the timed launches: a profile has lost its first
#: two device records whatever the idle pad (the first marker and the
#: first launch, ``KKKKm`` for five launches, in every profile of a run),
#: and these markers take those places
PROFILE_LEAD_MARKERS = 8


def kernel_device_ms(fn, name, reps=20, attempts=3, multiple=False):
    """Mean device time of the kernel named ``name`` over ``reps`` calls,
    from ``torch.profiler`` (the kernel alone: no wrapper, no fill).  In
    each profile the timed launches sit between two marker kernels (a
    one-element fill), inside ``PROFILE_PAD_S`` of idle at both ends:
    kineto has dropped the record at a window's edge (PERF.md §6), and
    the markers take those places.  One profile must see all ``reps``
    launches; a profile that saw fewer is printed with its device
    records in order and taken again, at most ``attempts`` times in
    all, each time with four times the idle pad.  The window opens with
    ``PROFILE_LEAD_MARKERS`` markers, waited for and followed by the
    pad, so that the records a profile drops at its start are
    markers.  With ``multiple`` a call may launch the kernel several
    times (a library call split into pieces): the count must be a
    positive multiple of ``reps``, and the time is per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device="cuda")
    fn()
    marker.fill_(1.0)
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        pad = PROFILE_PAD_S * 4 ** (attempt - 1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(PROFILE_LEAD_MARKERS):
                marker.fill_(1.0)
            torch.cuda.synchronize()
            time.sleep(pad)
            for _ in range(reps):
                fn()
            marker.fill_(1.0)
            torch.cuda.synchronize()
            time.sleep(pad)
        hits = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)), e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key]
        us, count = sum(h[0] for h in hits), sum(h[1] for h in hits)
        if count == reps or (multiple and count and count % reps == 0):
            return us / reps / 1e3
        records = sorted((e.time_range.start, e.name) for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        seq = "".join("K" if name in n else "m" if "FillFunctor" in n
                      else "?" for _t, n in records)
        print(f"[profile] attempt {attempt} (idle pad {pad:.2f} s): the "
              f"profiler saw {count} "
              f"launches of {name}, expected {reps}; device records in "
              f"order (K the kernel, m a marker): {seq}; others "
              f"{sorted({n[:80] for _t, n in records if name not in n and 'FillFunctor' not in n})}",
              flush=True)
    check(False, f"profiler saw {count} launches of {name}, expected "
          f"{reps}, in each of {attempts} profiles")


def _check_cases(name, cases, fn, plain):
    """Each case's kernel result against its plain version, bit-exact;
    returns the largest absolute difference (0)."""
    import torch
    max_err = 0
    for case, args in cases:
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name} differs from its plain "
              f"version at {case} (max abs err {err})")
        print(f"[kernel] {name} {case}: bit-exact", flush=True)
    return max_err


def _stress_cases(n):
    """N rows in one bucket, every limb plane 255: the int32 lanes take
    every row's 255 with no carry, the int64 sums exceed 2^32."""
    import torch
    from spark_tpu_torch import cuda_agg
    dev = torch.device("cuda")
    bucket = torch.full((n,), 7, dtype=torch.int32, device=dev)
    na = torch.tensor([1], dtype=torch.int32, device=dev)
    x = torch.full((n,), (1 << 63) - 1, dtype=torch.int64, device=dev)
    planes = [cuda_agg.Plane()] + _sum_planes(x, None)
    mat = torch.full((n, 10), 255, dtype=torch.uint8, device=dev)
    return (bucket, mat, na, 512), (bucket, planes, na, 512)


def phase_kernel_check(session, hash_df):
    """K1's two entries against their plain versions, bit-exact; timings
    at the main path's inputs.  Returns the entries for the kernels line
    (launches filled in by the slice phase)."""
    import torch
    from spark_tpu_torch import cuda_agg

    # the main path's own inputs: the first run of the hash-agg query on
    # the graph lane calls K1 twice, in its eager warm-up and in its
    # capture; the warm-up's inputs hold data
    captured = []
    launch = cuda_agg.grouped_accumulate_columns

    def spy(bucket32, planes, n_active, B):
        captured.append((bucket32, list(planes), n_active, B))
        return launch(bucket32, planes, n_active, B)

    clear_stage_cache()
    zero_counts()
    cuda_agg.grouped_accumulate_columns = spy
    try:
        hash_df.collect()
    finally:
        cuda_agg.grouped_accumulate_columns = launch
    check(len(captured) == 2 and cuda_agg.CAPTURED_LAUNCHES[
        "grouped_accumulate_columns"] == 1,
          f"hash-agg query's first run made {len(captured)} K1 calls "
          f"({cuda_agg.CAPTURED_LAUNCHES} captured), expected 2: the "
          "warm-up's and the capture's")
    main = captured[0]
    b, planes, na, B = main
    n, P = b.shape[0], len(planes)
    print(f"[kernel] main-path inputs: N={n} B={B} P={P} "
          f"n_active={int(na)}; columns read: "
          f"{', '.join(d for d, _ in _columns(planes).values()) or 'none'}",
          flush=True)
    check((n, B, P, int(na)) == (MAIN_N, 4096, 10, 2),
          "main-path K1 shape is not N=2^22, B=4096, P=10, n_active=2")
    main_planes = (b, _stacked(planes, n), na, B)

    # planes in: the one-to-one counterpart of the Pallas kernel
    cases = [("main path (its planes, stacked)", main_planes)]
    for i, (cn, cb, cp) in enumerate([(1000, 512, 3), (4096, 4096, 11),
                                      (70, 100, 1), (2048, 1024, 24)]):
        cases.append((f"edge N={cn} B={cb} P={cp}",
                      _random_inputs(cn, cb, cp, -(-cb // 512), 10 + i)))
    cases.append(("dead chunks N=3000 B=4096 P=5 n_active=1",
                  _random_inputs(3000, 4096, 5, 1, 20, dead_rows=10)))
    cases.append(("N>2^23 N=8388685 B=1024 P=3",
                  _random_inputs((1 << 23) + 77, 1024, 3, 2, 21)))
    cases.append(("B=10000 N=100000 P=4",
                  _random_inputs(100_000, 10_000, 4, 20, 22)))
    cases.append(("B=10000 N=100000 P=19 (several accumulator passes)",
                  _random_inputs(100_000, 10_000, 19, 20, 23)))
    stress_planes, stress_columns = _stress_cases(1 << 24)
    cases.append(("N=2^24 in one bucket, planes 255", stress_planes))
    planes_err = _check_cases("planes in", cases, cuda_agg.grouped_accumulate,
                              cuda_agg.grouped_accumulate_plain)

    # columns in: the fused entry the main path calls
    cases = [("main path (its own specs)", main)]
    for i, kind in enumerate(VALUE_KINDS):
        cases.append((f"{kind} values, nullable", _column_inputs(
            1 << 20, 2048, 2, [kind], 30 + i)))
    cases.append(("int64 values, no NULLs", _column_inputs(
        1 << 20, 2048, 2, ["int64"], 40, nullable=False)))
    cases.append(("dead chunks N=3000 B=4096 n_active=1", _column_inputs(
        3000, 4096, 1, ["int32"], 41, dead_rows=50)))
    cases.append(("N>2^23 N=8388685 B=1024", _column_inputs(
        (1 << 23) + 77, 1024, 2, ["int64", "int16"], 42)))
    wide = _column_inputs(100_000, 10_000, 20, ["int64", "int64"], 43)
    cases.append((f"B=10000 N=100000 P={len(wide[1])} (several accumulator "
                  "passes)", wide))
    cases.append(("N=2^24 in one bucket, limbs 255", stress_columns))
    columns_err = _check_cases("columns in", cases,
                               cuda_agg.grouped_accumulate_columns,
                               cuda_agg.grouped_accumulate_columns_plain)

    # exactness past ROWS_PER_FLUSH: the same stress with the flush every
    # few tiles, so every CTA flushes and re-zeroes many times
    rows_per_flush = cuda_agg.ROWS_PER_FLUSH
    cuda_agg.ROWS_PER_FLUSH = 5000
    try:
        planes_err = max(planes_err, _check_cases(
            "planes in", [("N=2^24 one bucket, flush every 5000 rows",
                           stress_planes)],
            cuda_agg.grouped_accumulate, cuda_agg.grouped_accumulate_plain))
        columns_err = max(columns_err, _check_cases(
            "columns in", [("N=2^24 one bucket, flush every 5000 rows",
                            stress_columns)],
            cuda_agg.grouped_accumulate_columns,
            cuda_agg.grouped_accumulate_columns_plain))
    finally:
        cuda_agg.ROWS_PER_FLUSH = rows_per_flush
    del stress_planes, stress_columns, wide, cases

    entries = []
    for name, fn, plain, args, err, row_width in (
            ("grouped_accumulate", cuda_agg.grouped_accumulate,
             cuda_agg.grouped_accumulate_plain, main_planes, planes_err, P),
            ("grouped_accumulate_columns",
             cuda_agg.grouped_accumulate_columns,
             cuda_agg.grouped_accumulate_columns_plain, main, columns_err,
             sum(b for _, b in _columns(planes).values()))):
        entries.append(_time_k1(name, fn, plain, args, err, P, row_width))
    return entries


def _columns(planes):
    """The distinct columns ``planes`` read: {key: (role and dtype, bytes
    a row)}."""
    seen = {}
    for p in planes:
        for role, t in (("mask", p.mask), ("value", p.value)):
            if t is not None:
                seen.setdefault((t.data_ptr(), t.dtype), (
                    f"{role} {str(t.dtype).replace('torch.', '')}",
                    t.element_size()))
    return seen


def _time_k1(name, fn, plain, args, max_err, P, row_width):
    """One K1 entry's numbers at the main path's inputs: ``P`` planes from
    ``row_width`` input bytes a row beside the bucket code."""
    import torch
    from spark_tpu_torch import cuda_agg
    b, _planes, na, B = args
    n = b.shape[0]
    per_call = cuda_ms(lambda: fn(*args))
    b2b = cuda_ms_back_to_back(lambda: fn(*args))
    kernel = kernel_device_ms(lambda: fn(*args), "grouped_accumulate_kernel")
    host = host_ms(lambda: fn(*args))
    launch = cuda_agg.launch_shape(name == "grouped_accumulate_columns", n,
                                   P, B, row_width)
    plain_ms = cuda_ms(lambda: plain(*args))
    library_ms = None
    if name == "grouped_accumulate":
        # yardstick: one library call on the same inputs (every main-path
        # row lies in a live chunk, so no masking is needed)
        b64, p64 = b.long(), args[1].long()
        out = torch.zeros((B, p64.shape[1]), dtype=torch.int64,
                          device=b.device)
        check(torch.equal(out.index_add_(0, b64, p64), plain(*args)),
              "index_add_ yardstick disagrees with the plain version")
        library_ms = cuda_ms(lambda: out.index_add_(0, b64, p64))
    nbytes = n * (4 + row_width) + B * P * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[kernel] {name} at the main path: {per_call:.4f} ms per call, "
          f"{b2b:.4f} ms back to back (CUDA events: wrapper and output fill "
          f"included); kernel alone {kernel:.4f} ms (profiler, "
          f"{bound_ms / kernel:.1%} of the bound's rate); wrapper host time "
          f"{host:.4f} ms per call; bound {bound_ms:.4f} ms by bytes "
          f"({nbytes} B at 3.35 TB/s); plain {plain_ms:.4f} ms; index_add_ "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}; "
          f"launch {launch}", flush=True)
    return {"name": name, "route": "cuda",
            "source": "spark_tpu_torch/csrc/grouped_accumulate.cu",
            "replaces": "spark_tpu/pallas_agg.py:56",
            "launches": None, "max_abs_err": max_err, "ms": per_call,
            "kernel_ms": per_call, "kernel_alone_ms": kernel,
            "ms_back_to_back": b2b, "host_ms": host, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "launch": launch}


def phase_slice(session, hash_df, hash_table, k1_entries):
    from spark_tpu_torch import cuda_agg
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.testing import (hash_agg_oracle, q3_oracle,
                                         q3_query, q3_tables)

    t0 = time.perf_counter()
    tables = q3_tables(Q3_ROWS["store_sales"], Q3_ROWS["item"],
                       Q3_ROWS["date_dim"])
    q3_df = q3_query(session, F, T, tables)
    print(f"[slice] q3 tables at SF1 row counts {Q3_ROWS} made and moved "
          f"to the card in {time.perf_counter() - t0:.2f} s", flush=True)

    # the main path's run: counts zeroed just before, read just after.
    # On the graph lane each query's first run builds its entry: the
    # wrapper launches K1 once in the eager warm-up and once more while
    # the graph is captured (replays launch it without the wrapper; the
    # [stage] phase counts those from the profiler)
    clear_stage_cache()
    zero_counts()
    hash_rows = hash_df.collect()
    hash_launches = dict(cuda_agg.ENTRY_LAUNCHES)
    hash_captured = dict(cuda_agg.CAPTURED_LAUNCHES)
    q3_rows = q3_df.collect()
    q3_launches = cuda_agg.LAUNCHES - sum(hash_launches.values())
    check(hash_launches == {"grouped_accumulate": 0,
                            "grouped_accumulate_columns": 2}
          and hash_captured["grouped_accumulate_columns"] == 1,
          f"hash-agg query's K1 launches {hash_launches} ({hash_captured} "
          "captured), expected two through the columns entry: one in the "
          "warm-up, one captured")
    for entry in k1_entries:
        entry["launches"] = cuda_agg.ENTRY_LAUNCHES[entry["name"]]
        entry["captured_launches"] = \
            cuda_agg.CAPTURED_LAUNCHES[entry["name"]]

    got = sorted((r["k"], r["s"], r["c"]) for r in hash_rows)
    check(got == hash_agg_oracle(hash_table),
          "hash-agg result differs from the numpy oracle")
    want_q3 = q3_oracle(tables)
    got_q3 = [tuple(r) for r in q3_rows]
    check(len(want_q3) > 0, "q3 oracle selected no rows")
    check(got_q3 == want_q3, f"q3 result differs from the numpy oracle "
          f"(first rows {got_q3[:2]} vs {want_q3[:2]})")
    print(f"[slice] hash-agg: {len(got)} groups equal to the oracle; K1 "
          f"wrapper launches during the query's first run: {hash_launches} "
          f"(MXU-form branch; {hash_captured} of them captured)",
          flush=True)
    branch = "MXU-form (K1)" if q3_launches else "sort-based"
    print(f"[slice] q3: {len(got_q3)} rows equal to the oracle; K1 launches "
          f"during the query: {q3_launches} ({branch} branch)", flush=True)

    hash_ms = wall_ms(hash_df.collect)
    q3_ms = wall_ms(q3_df.collect)
    print(f"[slice] warm wall time, median of 5: hash-agg {hash_ms:.2f} ms "
          f"(N={MAIN_N}, {MAIN_GROUPS} groups); q3 {q3_ms:.2f} ms", flush=True)
    stacks = stacked_shapes(hash_df.collect)
    check(not [s for s in stacks if any(t and t[0] == MAIN_N for t in s)],
          f"hash-agg stacked {MAIN_N}-row planes: {stacks}")
    print(f"[slice] hash-agg: no torch.stack of {MAIN_N}-row planes (every "
          f"torch.stack's inputs: {stacks})", flush=True)
    profile_query("hash-agg", hash_df.collect)
    profile_query("q3", q3_df.collect)
    return tables, q3_df


def stacked_shapes(fn):
    """The input shapes of every ``torch.stack`` call one run of ``fn``
    makes."""
    import torch
    seen = []
    stack = torch.stack

    def spy(tensors, *args, **kwargs):
        tensors = list(tensors)
        seen.append([tuple(t.shape) for t in tensors])
        return stack(tensors, *args, **kwargs)

    torch.stack = spy
    try:
        fn()
    finally:
        torch.stack = stack
    return seen


#: the hand-written kernels by the name of their ``__global__`` function
OWN_KERNELS = (("K1", "grouped_accumulate_kernel"),
               ("K2", "all_to_all_kernel"), ("lpt", "lpt_assign_kernel"))


#: CUDA runtime/driver calls that put work on a stream: a profile's host
#: launch calls are its CPU-side events of these names
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchKernelEx", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
                     "cudaMemset")


def profile_query(name, fn, top=6, cpu=True, own_kernels=OWN_KERNELS):
    """Where one warm run's time goes: device time summed over the kernels
    ``torch.profiler`` saw, against the run's wall time under the
    profiler (which adds host overhead), the host's launch calls, each
    hand-written kernel's own time, launches and share of the device
    time, and the largest kernels.  ``cpu`` False records the card's
    activity alone: no host operators, whose records take tens of
    seconds to sort out after a streamed run of many seconds.  Returns
    those numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    rows, host_calls = [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key in HOST_LAUNCH_CALLS:
                host_calls[e.key] = host_calls.get(e.key, 0) + e.count
            continue
        # device kernels only: an aten op's row repeats its kernels' time
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.count, e.key))
    device_ms = sum(us for us, _c, _k in rows) / 1e3
    h2d_ms = sum(us for us, _c, k in rows if k.startswith("Memcpy HtoD")) / 1e3
    rows.sort(reverse=True)
    own, own_txt = {}, []
    for kid, fn_name in own_kernels:
        hits = [(us, c) for us, c, k in rows if fn_name in k]
        ms = sum(us for us, _c in hits) / 1e3
        count = sum(c for _u, c in hits)
        share = ms / device_ms if device_ms else 0.0
        own[kid] = (count, ms)
        own_txt.append(f"{kid} {fn_name} x{count} {ms:.4f} ms ({share:.2%} "
                       "of device time)")
    tops = "; ".join(f"{k[:60]} x{c} {us / 1e3:.3f} ms"
                     for us, c, k in rows[:top])
    n_device = sum(c for _u, c, _k in rows)
    n_host = sum(host_calls.values())
    print(f"[profile] {name}: wall {wall:.2f} ms under the profiler, device "
          f"busy {device_ms:.3f} ms ({device_ms / wall:.1%}), "
          f"{n_device} device kernels and copies from {n_host} host launch "
          f"calls {host_calls}; {'; '.join(own_txt)}; top: {tops}",
          flush=True)
    return {"wall_ms": wall, "device_ms": device_ms, "busy": device_ms / wall,
            "device_ops": n_device, "host_launch_calls": n_host,
            "host_calls": host_calls, "own": own, "h2d_ms": h2d_ms}


def phase_sql(session, hash_df, hash_table, q3_df, tables, k1_entries):
    """``spark.sql`` on the card: the hash-agg query and q3 from SQL text,
    and the set-operation, subquery, LIKE and UDF queries over q3's tables
    (``testing.SQL_QUERIES``), each held against its numpy oracle; SQL
    q3 again on the mesh lane.  Returns K2's launches in that mesh run."""
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import udf
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL, SQL_QUERIES,
                                         hash_agg_oracle, q3_oracle,
                                         register_sql_tables,
                                         register_sql_udfs)

    t0 = time.perf_counter()
    register_sql_tables(session, hash_table, tables, T)
    register_sql_udfs(session, torch)
    print(f"[sql] temp views hash_t, store_sales, date_dim, item registered "
          f"(moved to the card) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    queries = [("hash-agg", HASH_AGG_SQL,
                lambda t: hash_agg_oracle(hash_table), False),
               ("q3", Q3_SQL, q3_oracle, True)]
    queries += [(name, sql, oracle, ordered)
                for name, (sql, oracle, ordered) in SQL_QUERIES.items()]
    frames = [(name, session.sql(sql)) for name, sql, _o, _d in queries]

    # the SQL path's run: counts zeroed just before, read just after; each
    # query builds its stage entry (K1: warm-up launch + captured launch)
    results = []
    clear_stage_cache()
    zero_counts()
    for name, df in frames:
        before = (dict(cuda_agg.ENTRY_LAUNCHES), dict(udf.HOST_COPIES))
        rows = df.collect()
        results.append((rows, {k: v - before[0][k] for k, v in
                               cuda_agg.ENTRY_LAUNCHES.items()},
                        {k: v - before[1][k] for k, v in
                         udf.HOST_COPIES.items()}))
    for entry in k1_entries:
        entry["sql_launches"] = cuda_agg.ENTRY_LAUNCHES[entry["name"]]

    for (name, _sql, oracle, ordered), (rows, k1, copies) in \
            zip(queries, results):
        got = [tuple(r) for r in rows]
        want = oracle(tables)
        check(len(want) > 0, f"SQL {name}: the oracle selected no rows")
        if not ordered:
            got, want = sorted(got), sorted(want)
        check(got == want, f"SQL {name} differs from its numpy oracle "
              f"(first rows {got[:2]} vs {want[:2]})")
        if name == "hash-agg":
            check(k1 == {"grouped_accumulate": 0,
                         "grouped_accumulate_columns": 2},
                  f"SQL hash-agg's K1 launches {k1}, expected two through "
                  "the columns entry: the warm-up's and the capture's")
        extra = ""
        if copies["to_host"] or copies["to_device"]:
            extra = (f"; UDF row lane: {copies['to_host']} device->host "
                     f"copy ({copies['to_host_bytes']} B), "
                     f"{copies['to_device']} host->device copy "
                     f"({copies['to_device_bytes']} B)")
        print(f"[sql] {name}: {len(got)} rows equal to the oracle; K1 "
              f"launches {k1}{extra}", flush=True)

    # the SQL front end's host cost: SQL and DataFrame walls in turns
    for name, df in (("hash-agg", hash_df), ("q3", q3_df)):
        sql_df = dict(frames)[name]
        walls = [wall_ms(df.collect), wall_ms(sql_df.collect),
                 wall_ms(sql_df.collect), wall_ms(df.collect)]
        print(f"[sql] {name} warm wall time, median of 5, in turns "
              f"DataFrame, SQL, SQL, DataFrame: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms", flush=True)
    for name, df in frames:
        # _execute: the same run up to the host batch, without turning
        # its rows into Python objects
        print(f"[sql] {name}: warm wall time, median of 5: "
              f"{wall_ms(df.collect):.2f} ms ({wall_ms(df._execute):.2f} ms "
              "without decoding the rows)", flush=True)
        profile_query(f"sql {name}", df.collect)

    # SQL q3 on the mesh lane
    _mesh(session, MESH_SHARDS)
    try:
        zero_counts()
        rows = session.sql(Q3_SQL).collect()
        k2 = k2_runs()
        check(k2 > 0, "K2 was not launched during SQL q3 on the mesh lane")
        got = [tuple(r) for r in rows]
        check(got == q3_oracle(tables), f"mesh SQL q3 differs from the "
              f"oracle (first rows {got[:2]})")
        print(f"[sql] mesh q3 x{MESH_SHARDS} shards: {len(got)} rows equal "
              f"to the oracle; K2 launches during the query: {k2}",
              flush=True)
        mesh_q3 = session.sql(Q3_SQL)
        print(f"[sql] mesh q3 x{MESH_SHARDS}: warm wall time, median of 5: "
              f"{wall_ms(mesh_q3.collect):.2f} ms", flush=True)
        profile_query(f"sql mesh q3 x{MESH_SHARDS}", mesh_q3.collect)
    finally:
        _mesh(session, 1)
    return k2


def host_split(session, plan):
    """Median host ms of each step before a replay: analysis,
    optimization, planning (each on the previous step's output) and the
    stage key."""
    from spark_tpu_torch.sql.planner import QueryExecution, stage_key
    qe = QueryExecution(session, plan)
    analyzed, optimized, planned = qe.analyzed, qe.optimized, qe.planned

    def step(**done):
        def run():
            q = QueryExecution(session, plan)
            for k, v in done.items():
                setattr(q, k, v)
            return q
        return run

    return {
        "analyze": host_ms(lambda: step()().analyzed, warmup=1, reps=5),
        "optimize": host_ms(lambda: step(_analyzed=analyzed)().optimized,
                            warmup=1, reps=5),
        "plan": host_ms(lambda: step(_optimized=optimized)().planned,
                        warmup=1, reps=5),
        "stage key": host_ms(lambda: stage_key(session, planned),
                             warmup=1, reps=5),
    }


LANES = {"eager": {"spark.sql.codegen.wholeStage": "false"},
         "per-op": {"spark.tpu.stage.fusion": "false"},
         "graph": {}}


def _lane(session, lane):
    """Select one of the single-device lanes for the session."""
    for conf in LANES.values():
        for key in conf:
            session.conf.unset(key)
    for key, value in LANES[lane].items():
        session.conf.set(key, value)


def _grouped_oracle(table, where=None):
    """(k, sum(v), count) rows of ``table`` (``where``: a row mask), for
    keys of any range."""
    import numpy as np
    k, v = table["k"], table["v"]
    if where is not None:
        k, v = k[where], v[where]
    keys, inv = np.unique(k, return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, v)
    counts = np.bincount(inv, minlength=len(keys))
    return sorted(zip(keys.tolist(), sums.tolist(), counts.tolist()))


def phase_stage(session, hash_df, hash_table, q3_df, tables):
    """The stage cache on the card: hash-agg and q3, each from the
    DataFrame API and from SQL text, as captured graphs.  Per query: the
    build (warm-up plus capture) timed apart from 5 warm replays; the
    result against its numpy oracle and bit for bit against the eager
    and per-op lanes; each lane's profile (host launch calls, device
    kernels, device-busy share; K1 once per hash-agg replay); the entry's
    graph pool and static buffers beside ``_plan_reserve_bytes``; walls
    in turns eager, graph, graph, eager, with and without the row
    decode.  Then one guard miss and its re-capture, one slotted-literal
    pair sharing an entry, and one ``HBMOutOfMemoryError`` raised before
    dispatch.  Returns K1's replayed launches per hash-agg query."""
    import numpy as np
    import torch
    from spark_tpu_torch import config as C
    from spark_tpu_torch.memory import HBMOutOfMemoryError, MemoryManager
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.planner import (QueryExecution,
                                             _plan_reserve_bytes)
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL,
                                         assert_parts_equal, batch_parts,
                                         hash_agg_query, q3_oracle)

    cache = stage_cache()
    hash_rows = _grouped_oracle(hash_table)
    q3_want = q3_oracle(tables)
    queries = [
        ("hash-agg", hash_df, lambda rows: sorted(
            (r["k"], r["s"], r["c"]) for r in rows) == hash_rows),
        ("q3", q3_df, lambda rows: [tuple(r) for r in rows] == q3_want),
        ("sql hash-agg", session.sql(HASH_AGG_SQL), lambda rows: sorted(
            (r["k"], r["s"], r["c"]) for r in rows) == hash_rows),
        ("sql q3", session.sql(Q3_SQL),
         lambda rows: [tuple(r) for r in rows] == q3_want),
    ]
    k1_replays = {}
    for name, df, correct in queries:
        _lane(session, "graph")
        clear_stage_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = df.collect()
        first_ms = (time.perf_counter() - t0) * 1e3
        check(correct(rows), f"[stage] {name}: first run differs from the "
              "numpy oracle")
        build = cache.stats()
        (entry,) = cache.entries()
        replay_ms = wall_ms(df.collect, warmup=0, reps=5)
        after = cache.stats()
        check(correct(df.collect()), f"[stage] {name}: replay differs from "
              "the numpy oracle")
        check((build["builds"], build["variants"], after["builds"],
               after["variants"], after["guard_misses"]) == (1, 1, 1, 1, 0),
              f"[stage] {name}: replays built again: {after}")
        variant = entry.variants[-1]
        check(variant.pool_bytes > 0, f"[stage] {name}: no segment of the "
              "graph's private pool in the allocator's snapshot")
        reserve = _plan_reserve_bytes(
            QueryExecution(session, df._plan).planned)
        print(f"[stage] {name}: build (warm-up + capture) "
              f"{build['compile_ms']:.2f} ms of a first run of "
              f"{first_ms:.2f} ms; 5 warm replays, median wall "
              f"{replay_ms:.2f} ms; {entry.n_ops} operators in one graph; "
              f"graph pool {variant.pool_bytes} B + static inputs "
              f"{variant.static_bytes} B beside _plan_reserve_bytes "
              f"{reserve} B; {variant.n_guards} guard flag(s); storage "
              f"charged {session._memory.storage_used} B", flush=True)

        # bit for bit against the eager and per-op lanes
        parts = {}
        for lane in ("graph", "eager", "per-op"):
            _lane(session, lane)
            parts[lane] = batch_parts(df._execute())
        for lane in ("eager", "per-op"):
            assert_parts_equal(parts["graph"], parts[lane])
        print(f"[stage] {name}: graph lane bit-exact against the eager and "
              f"per-op lanes ({len(parts['graph'].names)} columns, "
              f"capacity {parts['graph'].capacity})", flush=True)

        # each lane's launches and device-busy share
        prof = {}
        for lane in ("eager", "per-op", "graph"):
            _lane(session, lane)
            df.collect()                      # warm
            prof[lane] = profile_query(f"stage {name} {lane}", df.collect)
        if "hash-agg" in name:
            count, ms = prof["graph"]["own"]["K1"]
            check(count == 1, f"[stage] {name}: the profiler saw K1 x{count} "
                  "in one replay, expected exactly one")
            k1_replays[name] = count
            print(f"[stage] {name}: one replay ran K1 x{count}, "
                  f"{ms:.4f} ms on the device", flush=True)
        print(f"[stage] {name}: host launch calls per query eager "
              f"{prof['eager']['host_launch_calls']}, per-op "
              f"{prof['per-op']['host_launch_calls']}, graph "
              f"{prof['graph']['host_launch_calls']}; device-busy share "
              f"eager {prof['eager']['busy']:.1%}, per-op "
              f"{prof['per-op']['busy']:.1%}, graph "
              f"{prof['graph']['busy']:.1%}", flush=True)

        # the host's share of a replayed query: analysis, optimization,
        # planning and the stage key, each per query.  A serving plan-cache
        # hit skips the last two (its fingerprint is taken after the
        # optimizer)
        _lane(session, "graph")
        split = host_split(session, df._plan)
        print(f"[stage] {name}: host time per query, median of 5: analyze "
              f"{split['analyze']:.3f} ms, optimize {split['optimize']:.3f} "
              f"ms, plan {split['plan']:.3f} ms (analyze + optimize + plan "
              f"{split['analyze'] + split['optimize'] + split['plan']:.3f} "
              f"ms), stage key {split['stage key']:.3f} ms", flush=True)

        # walls in turns
        walls = []
        for lane in ("eager", "graph", "graph", "eager"):
            _lane(session, lane)
            walls.append((wall_ms(df.collect), wall_ms(df._execute)))
        print(f"[stage] {name}: warm wall, median of 5, in turns eager, "
              f"graph, graph, eager: "
              f"{', '.join(f'{a:.2f}' for a, _b in walls)} ms; without "
              f"decoding the rows: "
              f"{', '.join(f'{b:.2f}' for _a, b in walls)} ms", flush=True)
    _lane(session, "graph")

    # one guard miss and its re-capture: the same shape on keys whose
    # range does not fit the bucket table
    rng = np.random.default_rng(29)
    wide = {"k": rng.choice(rng.integers(0, 10 ** 12, 5000), MAIN_N),
            "v": rng.integers(0, 100, MAIN_N).astype(np.int64)}
    wide_df = hash_agg_query(session, F, wide)
    hash_df.collect()
    before = cache.stats()
    got = sorted((r["k"], r["s"], r["c"]) for r in wide_df.collect())
    miss = cache.stats()
    check(got == _grouped_oracle(wide), "[stage] guard-miss result differs "
          "from the numpy oracle")
    check((miss["builds"], miss["guard_misses"], miss["variants"]) ==
          (before["builds"], before["guard_misses"] + 1,
           before["variants"] + 1),
          f"[stage] wide keys did not miss the guard: {before} -> {miss}")
    again = sorted((r["k"], r["s"], r["c"]) for r in wide_df.collect())
    check(again == got and cache.stats()["guard_misses"]
          == miss["guard_misses"], "[stage] the re-captured variant did not "
          "serve the wide keys")
    print(f"[stage] guard miss: hash-agg on {len(got)} keys spread over "
          f"10^12 (same shape) failed the recorded fits-the-bucket-table "
          f"guard, re-ran eagerly (sorted form) and captured a second "
          f"variant ({miss['compile_ms'] - before['compile_ms']:.2f} ms); "
          "its replay serves the next run; results equal the oracle",
          flush=True)

    # one slotted-literal pair sharing an entry
    text = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM hash_t WHERE v < {} " \
        "GROUP BY k"
    pair = []
    for bound in (50, 80):
        before = cache.stats()
        rows = sorted((r["k"], r["s"], r["c"])
                      for r in session.sql(text.format(bound)).collect())
        pair.append(cache.stats()["builds"] - before["builds"])
        check(rows == _grouped_oracle(hash_table, hash_table["v"] < bound),
              f"[stage] v < {bound} differs from the numpy oracle")
    check(pair == [1, 0], f"[stage] the literal pair built {pair} entries")
    print("[stage] slotted literals: v < 50 built one entry, v < 80 "
          "replayed it with the new value; both equal the oracle",
          flush=True)

    # one HBMOutOfMemoryError before dispatch
    reserve = _plan_reserve_bytes(QueryExecution(session, hash_df._plan)
                                  .planned)
    saved = session._memory
    session._memory = MemoryManager(
        C.Conf({"spark.tpu.memory.hbmBudget": reserve // 2}), session.device)
    before = cache.stats()["dispatches"]
    try:
        hash_df.collect()
        check(False, "[stage] a half-size budget ran hash-agg")
    except HBMOutOfMemoryError as e:
        message = str(e)
    finally:
        session._memory = saved
    check(cache.stats()["dispatches"] == before, "[stage] the refused query "
          "was dispatched")
    print(f"[stage] budget {reserve // 2} B: HBMOutOfMemoryError before "
          f"dispatch: {message}", flush=True)
    print(f"[stage] cache {cache.stats()}", flush=True)
    return k1_replays


def phase_breadth(session, hash_table, tables, k1_entries):
    """Expression and aggregate breadth, grouping sets and windows on the
    card, at the main path's sizes (q3's tables at SF1 row counts, the
    hash-agg table): the texts of ``testing.BREADTH_QUERIES`` — q3's join
    with ROLLUP and grouping_id(), the q98 shape of windows over q3's
    aggregate, upper/substr group keys, stddev_samp/var_pop/round(avg)
    per key — each through the graph lane against its numpy oracle and
    bit for bit against the eager lane; per text the build, the warm wall
    (with and without the row decode) and a profile line.  Then the
    window text at 4 shards: K2's launches rise and the rows equal the
    single-device ones.  Returns K2's launches in that run."""
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (BREADTH_QUERIES, assert_parts_equal,
                                         batch_parts, breadth_rows_match)

    cache = stage_cache()
    frames = {name: session.sql(sql)
              for name, (sql, _o, _a, _r) in BREADTH_QUERIES.items()}
    _lane(session, "graph")
    clear_stage_cache()
    # the breadth path's run: counts zeroed just before, read just after;
    # each text builds its stage entry (warm-up, then the capture)
    zero_counts()
    results, builds = {}, {}
    for name, df in frames.items():
        before = cache.stats()["compile_ms"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = [tuple(r) for r in df.collect()]
        builds[name] = (cache.stats()["compile_ms"] - before,
                        (time.perf_counter() - t0) * 1e3)
    k1_run = dict(cuda_agg.ENTRY_LAUNCHES)
    for entry in k1_entries:
        entry["breadth_launches"] = k1_run[entry["name"]]
    for name, (_sql, oracle, approx, rtol) in BREADTH_QUERIES.items():
        got, want = results[name], oracle(tables, hash_table)
        check(len(want) > 0, f"[breadth] {name}: the oracle selected no rows")
        bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
               if not breadth_rows_match([g], [w], approx, rtol)]
        check(len(got) == len(want) and not bad,
              f"[breadth] {name} differs from its numpy oracle: {len(got)} "
              f"rows against {len(want)}, first differing (row, got, want) "
              f"{bad[:2]}")
        df = frames[name]
        graph = batch_parts(df._execute())
        _lane(session, "eager")
        eager = batch_parts(df._execute())
        _lane(session, "graph")
        assert_parts_equal(graph, eager)
        print(f"[breadth] {name}: {len(got)} rows equal to the oracle "
              f"(columns {list(approx)} within rtol {rtol}, the rest "
              f"exactly), graph lane bit-exact against the eager lane; build "
              f"(warm-up + capture) {builds[name][0]:.2f} ms of a first run "
              f"of {builds[name][1]:.2f} ms; warm wall, median of 5: "
              f"{wall_ms(df.collect):.2f} ms ({wall_ms(df._execute):.2f} ms "
              "without decoding the rows)", flush=True)
        profile_query(f"breadth {name}", df.collect)
    print(f"[breadth] K1 launches in the graph-lane run of the four texts "
          f"(counted from 0 just before, read just after): {k1_run}; stage "
          f"cache {cache.stats()}", flush=True)

    # the window text on the mesh lane: one hash exchange per window spec
    sql = BREADTH_QUERIES["window"][0]
    _mesh(session, MESH_SHARDS)
    try:
        zero_counts()
        rows = [tuple(r) for r in session.sql(sql).collect()]
        k2 = k2_runs()
        check(k2 > 0, "[breadth] K2 was not launched during the window text "
              "on the mesh lane")
        check(rows == results["window"], "[breadth] the window text at "
              f"{MESH_SHARDS} shards differs from the single-device rows "
              f"(first rows {rows[:2]} vs {results['window'][:2]})")
        mesh_df = session.sql(sql)
        print(f"[breadth] window x{MESH_SHARDS} shards: {len(rows)} rows "
              f"equal to the single-device ones; K2 launches during the "
              f"query: {k2}; warm wall time, median of 5: "
              f"{wall_ms(mesh_df.collect):.2f} ms", flush=True)
        profile_query(f"breadth window x{MESH_SHARDS}", mesh_df.collect)
    finally:
        _mesh(session, 1)
    return k2


MESH_SHARDS = 4
SHARDS_KEY = "spark.tpu.mesh.shards"
THRESHOLD_KEY = "spark.sql.autoBroadcastJoinThreshold"


def _mesh(session, shards, threshold=None):
    session.conf.set(SHARDS_KEY, str(shards))
    if threshold is None:
        session.conf.unset(THRESHOLD_KEY)
    else:
        session.conf.set(THRESHOLD_KEY, str(threshold))


def _a2a_bytes(planes, gather):
    """Bytes one exchange moves: every (sender, receiver) block once."""
    n = len(planes[0])
    return sum(x.numel() * x.element_size() * (n if gather else 1)
               for shards in planes for x in shards)


def _a2a_desc(planes, gather):
    n = len(planes[0])
    kinds = ", ".join(f"{str(p[0].dtype).replace('torch.', '')}"
                      f"{tuple(p[0].shape)}" for p in planes)
    return f"n={n} {'gather ' if gather else ''}planes [{kinds}]"


def _random_planes(n, specs, seed, gather=False):
    """Planes on the card: ``specs`` is a list of (dtype, trailing shape);
    each sender's plane is (n, *shape), or (*shape) in the gather form."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    planes = []
    for dtype, shape in specs:
        full = tuple(shape) if gather else (n,) + tuple(shape)
        if dtype == torch.bool:
            make = lambda: torch.rand(full, generator=g,  # noqa: E731
                                      device="cuda") < 0.5
        elif dtype.is_floating_point:
            make = lambda: torch.randn(full, generator=g,  # noqa: E731
                                       device="cuda", dtype=dtype)
        else:
            make = lambda: torch.randint(  # noqa: E731
                -1000, 1000, full, generator=g, device="cuda", dtype=dtype)
        planes.append([make() for _ in range(n)])
    return planes


def _pull_cases(stage_rows):
    """The pull's edge cases: (name, senders, [(dtype, row width, slot
    stride in rows, source offset in bytes, unpadded output rows)]);
    ``stage_rows`` int64 rows fill one ring stage."""
    odd = 6 * stage_rows + 1
    return (
        [(f"{n} sender(s): bool 17, int32 15, int64 1, float64 0 (a "
          f"zero-byte plane between two others), int64 {odd:,} (odd, 7 "
          f"stages)", n,
          [("bool", 17, 32, 0, False), ("int32", 15, 16, 0, False),
           ("int64", 1, 2, 0, False), ("float64", 0, 4, 0, False),
           ("int64", odd, 8 * stage_rows, 0, False)]) for n in (1, 2, 3, 4)]
        + [("3 senders, sources off 16-byte alignment (int64 +8, bool +3, "
            "int32 +4)", 3,
            [("int64", 4_099, 4_099, 8, False),
             ("bool", 1_001, 1_001, 3, False), ("int32", 37, 37, 4, False)]),
           ("3 senders, unpadded rows at the slots' stride (heads and tails "
            "peeled)", 3,
            [("int32", 4_099, 4_099, 4, True),
             ("bool", 1_001, 1_001, 5, True)]),
           ("2 senders, int32 100 (below one stage)", 2,
            [("int32", 100, 128, 0, False)]),
           (f"1 sender, int64 {stage_rows:,} (exactly one stage)", 1,
            [("int64", stage_rows, stage_rows, 0, False)]),
           ("4 senders, int64 and float64 2^20 + 3 (many stages)", 4,
            [("int64", (1 << 20) + 3, 1 << 21, 0, False),
             ("float64", (1 << 20) + 3, 1 << 21, 0, False)])])


def _k2_pull_check():
    """K2's cross-process pull (``pull_kernel``) against ``pull_plain``,
    bit-exact, at ``_pull_cases``: sources are slices of a local
    ``cudaMalloc`` arena (``cuda_a2a.Arena``) of random bytes; outputs
    start as a sentinel, and the bytes past each row's block must keep
    it.  Returns the cases checked."""
    import numpy as np
    import torch
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch.parallel.ici import _padded_rows
    dev = torch.device("cuda")
    nbytes = 128 << 20
    arena = cuda_a2a.Arena(dev, nbytes)
    try:
        raw = torch.as_tensor(_DevicePointer(arena.ptr, nbytes), device=dev)
        g = torch.Generator(device="cuda").manual_seed(60)
        raw.copy_(torch.randint(0, 256, (nbytes,), generator=g, device=dev,
                                dtype=torch.uint8))
        cases = _pull_cases(cuda_a2a.PULL_STAGE_BYTES // 8)
        for name, n, planes in cases:
            sources, outs, lens, blocks, rows, at = [], [], [], [], [], 0
            for dtype, width, slot, off, unpadded in planes:
                dt = getattr(torch, dtype)
                isz = torch.empty(0, dtype=dt).element_size()
                base = at + off
                srcs = [base + s * slot * isz for s in range(n)]
                at = -(-(base + n * slot * isz) // 256) * 256
                row = width if unpadded else _padded_rows(width, isz)
                if dtype == "bool":       # a bool plane holds 0 and 1
                    raw[base:base + n * slot].bitwise_and_(1)
                sources.append([arena.ptr + a for a in srcs])
                outs.append(torch.full((n * row * isz,), 0xA5, device=dev,
                                       dtype=torch.uint8).view(dt)
                            .view(n, row))
                lens.append(width * isz)
                blocks.append([raw[a:a + width * isz].clone().view(dt)
                               for a in srcs])
                rows.append(row)
            check(at <= nbytes, f"K2 pull case {name}: {at} B of sources")
            cuda_a2a.pull(sources, outs, lens)
            want = cuda_a2a.pull_plain(blocks, rows)
            torch.cuda.synchronize()
            for k, (got, w, nb) in enumerate(zip(outs, want, lens)):
                gb, wb = got.view(torch.uint8), w.view(torch.uint8)
                check(torch.equal(gb[:, :nb], wb[:, :nb]), f"K2's pull "
                      f"differs from its plain version at {name}, plane {k}")
                check(bool((gb[:, nb:] == 0xA5).all()), f"K2's pull wrote "
                      f"past a row's block at {name}, plane {k}")
            print(f"[k2] pull {name}: bit-exact, padding untouched",
                  flush=True)
        return len(cases)
    finally:
        arena.free()


def phase_k2_check(captured, launches):
    """K2 against its plain version, bit-exact, at every recorded mesh
    exchange and at edge shapes, and its cross-process pull at its edge
    cases; timings at the largest recorded all-to-all.  Returns the
    kernel's entry for the kernels line."""
    import torch
    from spark_tpu_torch import cuda_a2a

    cases = [(f"{query} call {i}", planes, gather)
             for i, (query, planes, gather) in enumerate(captured)]
    i32, i64, f64, b8 = torch.int32, torch.int64, torch.float64, torch.bool
    for n in (2, 4, 8):
        specs = [(i64, (1000,)), (f64, (1000,)), (b8, (1000,)),
                 (i32, (3 + n,))]
        cases.append((f"n={n} int64/float64/bool cap=1000, int32 runs "
                      f"{3 + n}", _random_planes(n, specs, 30 + n), False))
        cases.append((f"n={n} cap=1", _random_planes(
            n, [(i64, (1,)), (b8, (1,)), (i32, (1,))], 40 + n), False))
    cases.append(("n=4 cap=2^20+3 (chunk tails)", _random_planes(
        4, [(i64, ((1 << 20) + 3,)), (b8, ((1 << 20) + 3,))], 50), False))
    cases.append(("n=4 gather int64/bool cap=37", _random_planes(
        4, [(i64, (37,)), (b8, (37,)), (i32, ())], 51, gather=True), True))
    cases.append(("n=8 50 planes (a 32 KB pointer table)", _random_planes(
        8, [(i32, (9,))] * 25 + [(b8, (13,))] * 25, 52), False))
    max_err = 0
    for name, planes, gather in cases:
        got = cuda_a2a.all_to_all(planes, gather)
        want = cuda_a2a.all_to_all_plain(planes, gather)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"K2 output {g.dtype}{tuple(g.shape)} vs plain "
                  f"{w.dtype}{tuple(w.shape)} at {name}")
            if g.dtype != torch.bool and g.numel():
                max_err = max(max_err, float((g.double() - w.double())
                                             .abs().max()))
            check(torch.equal(g, w), f"K2 differs from its plain version "
                  f"at {name}")
        print(f"[k2] {name}: bit-exact", flush=True)
    t_pull = time.perf_counter()
    pull_cases = _k2_pull_check()
    print(f"[k2] pull: {pull_cases} cases in "
          f"{time.perf_counter() - t_pull:.2f} s", flush=True)

    query, planes, gather = max((c for c in captured if not c[2]),
                                key=lambda c: _a2a_bytes(c[1], c[2]))
    n = len(planes[0])
    kernel_ms = cuda_ms(lambda: cuda_a2a.all_to_all(planes, gather))
    plain_ms = cuda_ms(lambda: cuda_a2a.all_to_all_plain(planes, gather))
    b2b_ms = cuda_ms_back_to_back(lambda: cuda_a2a.all_to_all(planes, gather))
    # yardstick: the same bytes pre-stacked as one (n, n, bytes) tensor,
    # moved by one library call
    per_plane = [torch.stack(list(p)).view(torch.uint8).reshape(n, n, -1)
                 for p in planes]
    stacked = torch.cat(per_plane, dim=2)
    want = torch.cat([o.view(torch.uint8).reshape(n, n, -1) for o in
                      cuda_a2a.all_to_all_plain(planes, gather)], dim=2)
    check(torch.equal(stacked.transpose(0, 1).contiguous(), want),
          "transpose yardstick disagrees with the plain version")
    del want
    library_ms = cuda_ms(lambda: stacked.transpose(0, 1).contiguous())
    library_b2b_ms = cuda_ms_back_to_back(
        lambda: stacked.transpose(0, 1).contiguous())
    # the kernel and the library call alone, in turns: kernel, library,
    # library, kernel
    alone, library_alone = [], []
    for turn in ("k2", "library", "library", "k2"):
        if turn == "k2":
            alone.append(kernel_device_ms(
                lambda: cuda_a2a.all_to_all(planes, gather),
                "all_to_all_kernel", reps=5))
        else:
            library_alone.append(_library_alone_ms(
                lambda: stacked.transpose(0, 1).contiguous(), "copy",
                reps=5))
    alone_ms = min(alone)
    del stacked
    nbytes = 2 * _a2a_bytes(planes, gather)       # read once, write once
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[k2] all_to_all at the largest exchange ({query}), "
          f"{_a2a_desc(planes, gather)}: "
          f"{kernel_ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, {nbytes} "
          f"B at 3.35 TB/s); plain {plain_ms:.4f} ms; transpose "
          f"{library_ms:.4f} ms; back to back {b2b_ms:.4f} ms per call, "
          f"transpose back to back {library_b2b_ms:.4f} ms per call; "
          f"alone (profiler) in turns K2, transpose, transpose, K2: "
          f"{alone[0]:.4f}, {_fmt_ms(library_alone[0])}, "
          f"{_fmt_ms(library_alone[1])}, {alone[1]:.4f} ms", flush=True)
    return {"name": "all_to_all", "route": "cuda",
            "source": "spark_tpu_torch/csrc/all_to_all.cu",
            "replaces": "spark_tpu/parallel/ici.py:352",
            "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "kernel_alone_ms": alone_ms,
            "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms,
            "library_ms_back_to_back": library_b2b_ms,
            "alone_turns_ms": alone, "library_alone_turns_ms": library_alone}


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _library_alone_ms(fn, name, reps=5):
    """A library call's kernels alone, per call (``kernel_device_ms`` over
    the kernels whose names hold ``name``, however many a call
    launches), or None where no profile saw a whole number per call: a
    yardstick, so it never stops the script."""
    try:
        return kernel_device_ms(fn, name, reps=reps, multiple=True)
    except RuntimeError as e:
        print(f"[profile] the library call's kernel alone not measured: "
              f"{e}", flush=True)
        return None


def k2_runs():
    """K2's runs on the card, counted on the host: the wrapper's launches
    outside a capture and those the replays of captured graphs carried
    (a launch made while a graph is captured records the kernel into the
    graph; it runs only when the graph is replayed)."""
    from spark_tpu_torch import cuda_a2a
    return cuda_a2a.LAUNCHES - cuda_a2a.CAPTURED_LAUNCHES \
        + cuda_a2a.REPLAYED_LAUNCHES


def _k2_counts():
    from spark_tpu_torch import cuda_a2a, cuda_lpt
    return {"wrapper": cuda_a2a.LAUNCHES,
            "captured": cuda_a2a.CAPTURED_LAUNCHES,
            "replayed": cuda_a2a.REPLAYED_LAUNCHES,
            "lpt": cuda_lpt.LAUNCHES,
            "lpt_captured": cuda_lpt.CAPTURED_LAUNCHES,
            "lpt_replayed": cuda_lpt.REPLAYED_LAUNCHES}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _mesh_entry(cache, keys_before):
    """The mesh entry (``dist4|…``) a query used last: one built since
    ``keys_before`` or the most recently used."""
    mesh = [e for e in cache.entries() if e.key.startswith(
        f"dist{MESH_SHARDS}|")]
    new = [e for e in mesh if e.key not in keys_before]
    return max(new or mesh, key=lambda e: e.last_used)


#: seed of the mesh phase's second data set (the main tables' seeds are
#: the generators' defaults)
MESH_SECOND_SEED = 29


def phase_mesh(session, hash_df, hash_table, q3_df, tables):
    """The mesh lane's three queries at 4 shards on the card, each one
    stage-cache entry captured as a CUDA graph.  Returns every K2 call's
    inputs from the warm-up runs (the capture's calls run nothing), as
    (query, planes, gather), K2's wrapper launches over the counted first
    runs, the mesh numbers for the kernels line, every ``lpt_assign``
    call's counts from those runs and its wrapper launches over them."""
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_lpt
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (hash_agg_oracle, hash_agg_query,
                                         hash_agg_table, q3_oracle,
                                         q3_query, q3_tables)

    t_phase = time.perf_counter()
    want_hash = hash_agg_oracle(hash_table)
    want_q3 = q3_oracle(tables)
    runs = [("hash-agg", hash_df, None),
            ("q3 broadcast joins", q3_df, None),
            ("q3 shuffled joins", q3_df, 0)]

    def rows_of(df):
        if df is hash_df:
            return sorted((r["k"], r["s"], r["c"]) for r in df.collect())
        return [tuple(r) for r in df.collect()]

    # every mesh query's first run below builds its entry: the earlier
    # phases' graphs go, so none of these is a replay of theirs
    clear_stage_cache()
    cache = stage_cache()
    mem = session._memory
    reserves = []
    acquire = mem.acquire_execution

    def spy_reserve(owner, nbytes):
        if owner.startswith("mesh:"):
            reserves.append(nbytes)
        return acquire(owner, nbytes)

    # record every K2 call's inputs for the kernel check (the spy only
    # passes the call on: the count rises inside the wrapper it calls),
    # and every lpt_assign call's counts, outside the capture
    captured, lpt_inputs = [], []
    launch, assign = cuda_a2a.all_to_all, cuda_lpt.lpt_assign
    query = [None]

    def spy(planes, gather=False):
        if not torch.cuda.is_current_stream_capturing():
            captured.append((query[0], [list(p) for p in planes], gather))
        return launch(planes, gather)

    def spy_lpt(counts, n_shards):
        if not torch.cuda.is_current_stream_capturing():
            lpt_inputs.append((counts.clone(), n_shards))
        return assign(counts, n_shards)

    # the mesh lane's run: counts zeroed just before, read just after
    first = {}
    cuda_a2a.all_to_all, cuda_lpt.lpt_assign = spy, spy_lpt
    mem.acquire_execution = spy_reserve
    try:
        zero_counts()
        for name, df, threshold in runs:
            _mesh(session, MESH_SHARDS, threshold)
            query[0] = name
            keys = {e.key for e in cache.entries()}
            s0, c0, r0 = cache.stats(), _k2_counts(), len(reserves)
            t0 = time.perf_counter()
            got = rows_of(df)
            ms = (time.perf_counter() - t0) * 1e3
            s1, c1 = cache.stats(), _k2_counts()
            entry = _mesh_entry(cache, keys)
            first[name] = {"rows": got, "ms": ms, "k2": _delta(c1, c0),
                           "builds": s1["builds"] - s0["builds"],
                           "variants": s1["variants"] - s0["variants"],
                           "build_ms": s1["compile_ms"] - s0["compile_ms"],
                           "entry": entry, "reserve": max(reserves[r0:])}
        launches, lpt_launches = cuda_a2a.LAUNCHES, cuda_lpt.LAUNCHES
    finally:
        cuda_a2a.all_to_all, cuda_lpt.lpt_assign = launch, assign
        mem.acquire_execution = acquire
    mesh_numbers = {}
    for name, df, threshold in runs:
        f = first[name]
        k2 = f["k2"]
        check(k2["captured"] > 0 and k2["wrapper"] > k2["captured"],
              f"[mesh] {name}: K2 was not launched in the warm-up and "
              f"captured ({k2})")
        check(f["variants"] >= 1 and f["entry"].variants
              and f["entry"].variants[-1].graph is not None,
              f"[mesh] {name}: its first run captured no graph")
        check(f["rows"] == (want_hash if df is hash_df else want_q3),
              f"[mesh] {name} differs from the oracle")
        v = f["entry"].variants[-1]
        # the shards' allocations went to the graph's pool, and the
        # memory pre-flight covered it
        check(v.pool_bytes <= f["reserve"], f"[mesh] {name}: graph pool "
              f"{v.pool_bytes} B above the reserve {f['reserve']} B")
        print(f"[mesh] {name} x{MESH_SHARDS} shards, first run (eager "
              f"warm-up, then the capture): {len(f['rows'])} rows equal to "
              f"the oracle; {f['ms']:.2f} ms; stage builds {f['builds']}, "
              f"variants {f['variants']}, build {f['build_ms']:.2f} ms; K2 "
              f"launches {k2['wrapper'] - k2['captured']} eager + "
              f"{k2['captured']} captured, lpt_assign "
              f"{k2['lpt'] - k2['lpt_captured']} eager + "
              f"{k2['lpt_captured']} captured; graph pool "
              f"{v.pool_bytes} B + static {v.static_bytes} B beside the "
              f"reserve {f['reserve']} B", flush=True)
    for query_name, planes, gather in captured:
        print(f"[k2]   {query_name}: {_a2a_desc(planes, gather)}: "
              f"{_a2a_bytes(planes, gather)} B", flush=True)

    for name, df, threshold in runs:
        _mesh(session, MESH_SHARDS, threshold)
        f = first[name]
        # a warm run is one replay: dispatches + 1, no build, no eager
        # rerun (K2's wrapper not called), K2 counted from the graph
        s0, c0 = cache.stats(), _k2_counts()
        got = rows_of(df)
        s1, k2 = cache.stats(), _delta(_k2_counts(), c0)
        check(got == f["rows"], f"[mesh] {name}: the replay differs from "
              "the first run")
        check(s1["dispatches"] == s0["dispatches"] + 1
              and s1["variants"] == s0["variants"]
              and s1["guard_misses"] == s0["guard_misses"]
              and k2["wrapper"] == 0 and k2["replayed"] > 0,
              f"[mesh] {name}: the warm run was no replay (stage cache "
              f"{s0} -> {s1}, K2 {k2})")
        _lane(session, "eager")
        try:
            e0 = _k2_counts()
            eager = rows_of(df)
            k2_eager = _delta(_k2_counts(), e0)
        finally:
            _lane(session, "graph")
        check(eager == got, f"[mesh] {name}: the captured lane's rows "
              "differ from the eager mesh lane's")
        # walls in turns: graph, eager, eager, graph
        walls = []
        for lane in ("graph", "eager", "eager", "graph"):
            _lane(session, lane)
            walls.append(wall_ms(df.collect))
        _lane(session, "graph")
        prof = profile_query(f"mesh {name} x{MESH_SHARDS} captured",
                             df.collect)
        _lane(session, "eager")
        prof_eager = profile_query(f"mesh {name} x{MESH_SHARDS} eager",
                                   df.collect)
        _lane(session, "graph")
        v = f["entry"].variants[-1]
        mesh_numbers[name] = {
            "first_ms": f["ms"], "build_ms": f["build_ms"],
            "graph_walls_ms": [walls[0], walls[3]],
            "eager_walls_ms": [walls[1], walls[2]],
            "pool_bytes": v.pool_bytes, "static_bytes": v.static_bytes,
            "reserve_bytes": f["reserve"],
            "k2_eager": k2_eager["wrapper"], "k2_captured":
                f["k2"]["captured"], "k2_replayed": k2["replayed"],
            "lpt_replayed": k2["lpt_replayed"],
            "host_launch_calls": prof["host_launch_calls"],
            "host_launch_calls_eager": prof_eager["host_launch_calls"],
            "busy": prof["busy"], "busy_eager": prof_eager["busy"],
            "device_ms": prof["device_ms"]}
        print(f"[mesh] {name} x{MESH_SHARDS}: warm run a replay (dispatches "
              f"+1, no build, K2 {k2['replayed']} replayed launch(es) and "
              f"no wrapper call, lpt_assign {k2['lpt_replayed']} replayed); "
              f"rows equal to the eager mesh lane bit for bit (eager K2 "
              f"launches {k2_eager['wrapper']}); warm wall, median of 5, in "
              f"turns graph, eager, eager, graph: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms; host launch "
              f"calls {prof['host_launch_calls']} captured vs "
              f"{prof_eager['host_launch_calls']} eager; device busy "
              f"{prof['busy']:.1%} captured vs {prof_eager['busy']:.1%} "
              f"eager", flush=True)

    # a second seeded data set of the same shapes through the same
    # entries: hash-agg's table anew, q3's store_sales anew (item and
    # date_dim, whose dictionaries the variant depends on, kept)
    hash2 = hash_agg_table(MAIN_N, MAIN_GROUPS, seed=MESH_SECOND_SEED)
    sales2 = q3_tables(Q3_ROWS["store_sales"], Q3_ROWS["item"],
                       Q3_ROWS["date_dim"],
                       seed=MESH_SECOND_SEED)["store_sales"]
    tables2 = dict(tables, store_sales=sales2)
    second = [("hash-agg", hash_agg_query(session, F, hash2), None,
               hash_agg_oracle(hash2)),
              ("q3 broadcast joins", q3_query(session, F, T, tables2), None,
               q3_oracle(tables2)),
              ("q3 shuffled joins", q3_query(session, F, T, tables2), 0,
               q3_oracle(tables2))]
    for name, df, threshold, want in second:
        _mesh(session, MESH_SHARDS, threshold)
        s0, c0 = cache.stats(), _k2_counts()
        if name == "hash-agg":
            got = sorted((r["k"], r["s"], r["c"]) for r in df.collect())
        else:
            got = [tuple(r) for r in df.collect()]
        s1, k2 = cache.stats(), _delta(_k2_counts(), c0)
        check(got == want, f"[mesh] {name} on the second data set differs "
              f"from its oracle")
        replay = s1["builds"] == s0["builds"] \
            and s1["variants"] == s0["variants"]
        if name == "hash-agg":
            check(replay and k2["replayed"] > 0, f"[mesh] {name} on the "
                  f"second data set was no replay ({s0} -> {s1})")
        mesh_numbers[name]["second_replay"] = replay
        print(f"[mesh] {name} x{MESH_SHARDS}, second data set (seed "
              f"{MESH_SECOND_SEED}): {len(got)} rows equal to its oracle; "
              f"{'a replay of the same variant' if replay else 'built'} "
              f"(builds +{s1['builds'] - s0['builds']}, variants "
              f"+{s1['variants'] - s0['variants']}, guard misses "
              f"+{s1['guard_misses'] - s0['guard_misses']}); K2 "
              f"{k2['replayed']} replayed, {k2['wrapper']} wrapper "
              "launches", flush=True)
    _mesh(session, 1)
    print(f"[mesh] stage cache {cache.stats()}", flush=True)
    clear_stage_cache()
    print(f"[mesh] phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return captured, launches, mesh_numbers, lpt_inputs, lpt_launches


#: [lpt]: the kernel of the parent commit, when a run put its source here
#: (``git show HEAD:spark_tpu_torch/csrc/lpt_assign.cu``), is timed in
#: turns with this one; without it the old time is PERF.md's row
LPT_OLD_SOURCE = os.path.join("build", "lpt_old", "lpt_assign.cu")


def _lpt_cases(recorded):
    """``lpt_assign``'s check inputs: the main path's counts, then random
    and tied counts at 1 to 33 shards (one thread's registers, a warp's
    lanes, shared memory; ranked in the kernel up to ``RANK_MAX`` buckets,
    sorted past it), many more shards, and no bucket at all."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(70)
    cases = [(f"[mesh] call {i} (n_fine {c.shape[0]}, {n} shards)", c, n)
             for i, (c, n) in enumerate(recorded)]
    for n in (1, 2, 3, 4, 8, 9, 16, 32, 33):
        cases.append((f"random counts, {n} shards", torch.randint(
            0, 10**6, (32 * n,), generator=g, device="cuda"), n))
        cases.append((f"every count tied, {n} shards", torch.full(
            (32 * n,), 3, dtype=torch.int64, device="cuda"), n))
        few = torch.full((32 * n,), 5, dtype=torch.int64, device="cuda")
        few[torch.randint(0, 32 * n, (4,), generator=g, device="cuda")] = 9
        cases.append((f"two values, {n} shards", few, n))
        cases.append((f"small counts with ties, {n} shards", torch.randint(
            0, 4, (32 * n,), generator=g, device="cuda"), n))
    cases.append(("70 shards (three lanes' worth), 4,480 buckets",
                  torch.randint(0, 1000, (70 * 64,), generator=g,
                                device="cuda"), 70))
    cases.append(("no bucket", torch.zeros(0, dtype=torch.int64,
                                           device="cuda"), 4))
    return cases


def _lpt_old():
    """The parent commit's ``lpt_assign`` (its source at
    ``LPT_OLD_SOURCE``), built beside this one: a function of (counts,
    n_shards), or None without the source."""
    import ctypes

    import torch
    from spark_tpu_torch import cuda_build
    if not os.path.exists(LPT_OLD_SOURCE):
        return None

    def bind(lib):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.spark_lpt_assign.argtypes = [vp, vp, i, i, vp, vp, vp]
        lib.spark_lpt_assign.restype = i

    lib = cuda_build.load(os.path.abspath(LPT_OLD_SOURCE), bind)

    def run(counts, n):
        order = torch.sort(-counts, stable=True).indices
        assign = torch.empty(counts.shape[0], dtype=torch.int32,
                             device=counts.device)
        loads = torch.empty(n, dtype=torch.int64, device=counts.device)
        rc = lib.spark_lpt_assign(counts.data_ptr(), order.data_ptr(),
                                  counts.shape[0], n, assign.data_ptr(),
                                  loads.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"[lpt] the parent's kernel: CUDA error {rc}")
        return assign, loads
    return run


def phase_lpt_check(recorded, launches, replayed):
    """``lpt_assign`` against its plain version on the card, bit-exact,
    at every call the mesh queries made and at edge inputs; its time at
    the main path's shape (per call, back to back, alone), beside its
    latency floor (the kernel at no bucket) and, in turns, the parent
    commit's kernel.  Returns its entry for the kernels line."""
    import torch
    from spark_tpu_torch import cuda_lpt
    check(recorded, "[lpt] the mesh queries made no lpt_assign call")
    # the mesh entries' calls are ranked in the kernel: no sort node
    sorted_calls = [c.shape[0] for c, _n in recorded
                    if c.shape[0] > cuda_lpt.RANK_MAX]
    check(not sorted_calls, f"[lpt] mesh calls past the kernel's ranking "
          f"({sorted_calls} buckets): their graphs hold a sort")
    for name, counts, n in _lpt_cases(recorded):
        got = cuda_lpt.lpt_assign(counts, n)
        want = cuda_lpt.lpt_assign_plain(counts, n)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"[lpt] lpt_assign differs from its plain version at "
                  f"{name}")
        print(f"[lpt] {name}: bit-exact", flush=True)
    counts, n = recorded[0]
    n_fine = counts.shape[0]
    ms = cuda_ms(lambda: cuda_lpt.lpt_assign(counts, n))
    b2b = cuda_ms_back_to_back(lambda: cuda_lpt.lpt_assign(counts, n))
    none = torch.zeros(0, dtype=torch.int64, device="cuda")
    old = _lpt_old()
    alone, old_alone = [], []
    for turn in ("new", "old", "old", "new") if old else ("new", "new"):
        if turn == "new":
            alone.append(kernel_device_ms(
                lambda: cuda_lpt.lpt_assign(counts, n), "lpt_assign_kernel",
                reps=5))
        else:
            got = old(counts, n)
            want = cuda_lpt.lpt_assign_plain(counts, n)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  "[lpt] the parent's kernel differs from the plain version")
            old_alone.append(kernel_device_ms(
                lambda: old(counts, n), "lpt_assign_kernel", reps=5))
    floor = kernel_device_ms(lambda: cuda_lpt.lpt_assign(none, n),
                             "lpt_assign_kernel", reps=5)
    plain_ms = cuda_ms(lambda: cuda_lpt.lpt_assign_plain(counts, n),
                       warmup=1, reps=5)
    # the counts read once, the assignment and loads written once; the
    # ranking's n_fine^2 and the packing's n_fine * n comparisons at the
    # card's 32-bit non-tensor rate (67 TFLOP/s)
    nbytes = n_fine * (8 + 4) + n * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (n_fine * n_fine + n_fine * n) / 67e12 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    old_txt = (f"the parent's kernel alone {', '.join(f'{x:.4f}' for x in old_alone)} ms "
               f"(in turns new, old, old, new: {alone[0]:.4f}, "
               f"{old_alone[0]:.4f}, {old_alone[1]:.4f}, {alone[1]:.4f})"
               if old else "the parent's kernel not built (no "
               f"{LPT_OLD_SOURCE}; PERF.md's row has its time)")
    print(f"[lpt] lpt_assign at the main path's shape ({n_fine} buckets, "
          f"{n} shards, ranked in the kernel): {ms:.4f} ms per call (CUDA "
          f"events), {b2b:.4f} ms back to back, kernel alone "
          f"{', '.join(f'{x:.4f}' for x in alone)} ms (profiler); {old_txt}; "
          f"latency floor (the kernel at no bucket, alone) {floor:.4f} ms; "
          f"plain {plain_ms:.4f} ms; bound {bound_ms:.7f} ms by "
          f"{'bytes' if bytes_ms >= ops_ms else 'operations'} ({nbytes} B "
          f"at 3.35 TB/s); no PyTorch call computes the greedy packing",
          flush=True)
    return {"name": "lpt_assign", "route": "cuda",
            "source": "spark_tpu_torch/csrc/lpt_assign.cu",
            "replaces": "spark_tpu/parallel/collective.py:106",
            "launches": launches, "replayed_launches": replayed,
            "max_abs_err": 0, "ms": ms, "ms_back_to_back": b2b,
            "kernel_alone_ms": min(alone), "alone_turns_ms": alone,
            "old_alone_turns_ms": old_alone, "latency_floor_ms": floor,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# ---------------------------------------------------------------------------
# [complex]: arrays, maps and structs, explode, rand / sample
# ---------------------------------------------------------------------------

#: spark.tpu.collect.maxArrayLen of the phase: the largest basket (16
#: line items), so no array truncates
COMPLEX_MAX_LEN = 16
#: spark.sql.agg.outputCapacity of the phase: room for SF1's ~240,000
#: tickets in one aggregate output (the default 65,536 would take one
#: adaptive retry per first run)
COMPLEX_AGG_ROWS = 1 << 18


def _complex_session(session, tables):
    """A session of its own (the SQL phase's store_sales and item stay
    q3's) over the basket tables, at the phase's array width."""
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import register_basket_tables
    cs = session.newSession()
    cs.conf.set("spark.tpu.collect.maxArrayLen", str(COMPLEX_MAX_LEN))
    cs.conf.set("spark.sql.agg.outputCapacity", str(COMPLEX_AGG_ROWS))
    register_basket_tables(cs, tables, T)
    return cs


def _sample_offset(session, df):
    """The row offset of the plan's sample operator (its op id << 33)."""
    from spark_tpu_torch.sql import physical as P
    from spark_tpu_torch.sql.planner import QueryExecution
    node = QueryExecution(session, df._plan).planned.physical
    while not isinstance(node, P.PSample):
        node = node.children[0]
    return node.row_offset


def phase_complex(session, k1_entries, k2_entry):
    """Arrays on the card at SF1 row counts (``testing.basket_tables``:
    store_sales as ~240,000 tickets of 8-16 line items, 18,000 items):
    the three texts of ``testing.COMPLEX_QUERIES`` (collect per ticket
    with the array functions; explode back to rows, joined to item and
    aggregated; the higher-order functions, a map and a struct) and the
    sampling text (``sample``, ``rand``, ``randn``,
    ``monotonically_increasing_id`` over store_sales), each on the graph
    lane against its numpy oracle and bit for bit against the eager lane;
    per text the build, the warm walls with and without the decode, the
    graph pool beside ``_plan_reserve_bytes`` and a profile line.  Then
    the baskets text at 4 shards (K2's gather; the rows equal the
    one-device run) and ``spark_partition_id()`` at 4 shards.  Returns
    (tables, the baskets oracle) for the HTTP run after [tpcds]."""
    import numpy as np
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.planner import (QueryExecution,
                                             _plan_reserve_bytes)
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (
        COMPLEX_QUERIES, SAMPLE_FRACTION, SAMPLE_SEED, assert_parts_equal,
        basket_tables, batch_parts, complex_mismatch, rand_oracle,
        randn_oracle, result_columns, sample_oracle, unordered)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tables = basket_tables()
    cs = _complex_session(session, tables)
    n = len(tables["store_sales"]["ss_ticket_number"])
    n_tickets = len(np.unique(tables["store_sales"]["ss_ticket_number"]))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = {name: oracle(tables, COMPLEX_MAX_LEN)
            for name, (_sql, oracle) in COMPLEX_QUERIES.items()}
    oracle_s = time.perf_counter() - t0
    print(f"[complex] store_sales {n} rows in {n_tickets} tickets, item "
          f"{len(tables['item']['i_item_sk'])} rows, made and moved to the "
          f"card in {setup_s:.2f} s; numpy oracles {oracle_s:.2f} s; "
          f"maxArrayLen {COMPLEX_MAX_LEN}", flush=True)
    ss = cs.table("store_sales")
    frames = {name: cs.sql(sql) for name, (sql, _o) in
              COMPLEX_QUERIES.items()}
    frames["sample"] = ss.sample(SAMPLE_FRACTION, seed=SAMPLE_SEED).agg(
        F.count("*").alias("n"), F.sum("ss_ticket_number").alias("t"))
    frames["rand and ids"] = ss.select(
        F.rand(SAMPLE_SEED).alias("r"), F.randn(SAMPLE_SEED).alias("g"),
        F.monotonically_increasing_id().alias("id"))
    offset = _sample_offset(cs, frames["sample"])
    n_kept, t_sum = sample_oracle(tables, offset)
    want["sample"] = {"n": np.array([n_kept], np.int64),
                      "t": np.array([t_sum], np.int64)}
    ids_offset = 1 << 33                    # the projection is operator 1
    want["rand and ids"] = {
        "r": rand_oracle(n, SAMPLE_SEED, ids_offset),
        "g": randn_oracle(n, SAMPLE_SEED, ids_offset),
        "id": np.arange(n, dtype=np.int64) + ids_offset}
    rtol = {"rand and ids": 1e-12}

    # the complex path's run: counts zeroed just before, read just after;
    # each text builds its stage entry (warm-up, then the capture)
    cache = stage_cache()
    _lane(cs, "graph")
    zero_counts()
    graph, builds, pools = {}, {}, {}
    for name, df in frames.items():
        clear_stage_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph[name] = batch_parts(df._execute())
        builds[name] = (cache.stats()["compile_ms"],
                        (time.perf_counter() - t0) * 1e3)
        (entry,) = cache.entries()
        pools[name] = (entry.variants[-1].pool_bytes,
                       _plan_reserve_bytes(
                           QueryExecution(cs, df._plan).planned))
    k1_run = dict(cuda_agg.ENTRY_LAUNCHES)
    for entry in k1_entries:
        entry["complex_launches"] = k1_run[entry["name"]]
    for name, df in frames.items():
        got = graph[name]
        if name == "rand and ids":
            cols = result_columns(got)
            check(np.array_equal(cols["r"], want[name]["r"])
                  and np.array_equal(cols["id"], want[name]["id"]),
                  "[complex] rand(7) / monotonically_increasing_id() differ "
                  "from the numpy formula")
            check(np.allclose(cols["g"], want[name]["g"], rtol=1e-12,
                              atol=1e-15), "[complex] randn(7) differs from "
                  "the numpy formula beyond rtol 1e-12")
        else:
            why = complex_mismatch(got, want[name])
            check(why is None, f"[complex] {name} differs from its numpy "
                  f"oracle: {why}")
        _lane(cs, "eager")
        eager = batch_parts(df._execute())
        _lane(cs, "graph")
        assert_parts_equal(got, eager, rtol=rtol.get(name, 0.0))
        pool, reserve = pools[name]
        n_rows = got.capacity if got.row_valid is None \
            else int(got.row_valid.sum())
        # 2.88M rows of Python objects: the decode is host work of seconds
        decoded = df.collect if n_rows < 1_000_000 else None
        with_decode = f"{wall_ms(decoded):.2f} ms" if decoded \
            else f"not measured ({n_rows} rows)"
        print(f"[complex] {name}: {n_rows} rows equal to "
              f"the oracle ({'randn within rtol 1e-12, ' if name in rtol else ''}"
              f"the rest exactly), graph lane bit-exact against the eager "
              f"lane; build (warm-up + capture) {builds[name][0]:.2f} ms of "
              f"a first run of {builds[name][1]:.2f} ms; graph pool {pool} B "
              f"beside _plan_reserve_bytes {reserve} B; warm wall, median of "
              f"5: {with_decode} ({wall_ms(df._execute):.2f} ms without "
              "decoding the rows)", flush=True)
        profile_query(f"complex {name}", decoded or df._execute)
    branch = "MXU-form (K1)" if k1_run["grouped_accumulate_columns"] \
        else "sort-based"
    print(f"[complex] K1 launches in the graph-lane run of the five texts "
          f"(counted from 0 just before, read just after): {k1_run} "
          f"(explode's aggregate by i_manufact_id: the {branch} form); "
          f"stage cache {cache.stats()}", flush=True)

    # the baskets text and spark_partition_id() on the mesh lane
    base = batch_parts(cs.sql(unordered(COMPLEX_QUERIES["baskets"][0]))
                       ._execute())
    _mesh(cs, MESH_SHARDS)
    try:
        zero_counts()
        mesh_df = cs.sql(unordered(COMPLEX_QUERIES["baskets"][0]))
        four = batch_parts(mesh_df._execute())
        parts_df = ss.select(F.spark_partition_id().alias("p")) \
            .groupBy("p").count()
        pid = sorted(tuple(r) for r in parts_df.collect())
        k2 = k2_runs()
        k2_entry["complex_launches"] = k2
        check(k2 > 0, "[complex] K2 was not launched on the mesh lane")
        why = complex_mismatch(four, want["baskets"])
        check(why is None, f"[complex] baskets at {MESH_SHARDS} shards "
              f"differs from its oracle: {why}")
        assert_parts_equal(base, four)
        # every value in 0..3; the rows split in contiguous slices of the
        # padded capacity, so a shard may hold padding only (at 2,880,404
        # rows in 2^22 slots, shard 3)
        check(set(p for p, _c in pid) <= set(range(MESH_SHARDS))
              and len(pid) > 1 and sum(c for _p, c in pid) == n,
              f"[complex] spark_partition_id() at {MESH_SHARDS} shards: "
              f"{pid}")
        print(f"[complex] baskets x{MESH_SHARDS} shards: {n_tickets} rows "
              f"equal to the oracle and to the one-device run; "
              f"spark_partition_id() x{MESH_SHARDS}: rows per partition "
              f"{pid}; K2 launches in the two queries (counted from 0 just "
              f"before): {k2}; baskets warm wall, median of 5: "
              f"{wall_ms(mesh_df._execute):.2f} ms without the decode",
              flush=True)
        profile_query(f"complex baskets x{MESH_SHARDS}", mesh_df._execute)
    finally:
        _mesh(cs, 1)
    # the phase's graphs are charged to its own session's memory manager:
    # drop them before the server's sessions reserve theirs
    clear_stage_cache()
    print(f"[complex] phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return tables, want["baskets"]


def _plane_lists(plane, sent):
    """An oracle's 2-D column as the server's JSON lists: each row's
    elements that are not the sentinel."""
    import numpy as np
    live = plane != sent
    flat = plane[live].tolist()
    ends = np.cumsum(live.sum(axis=1)).tolist()
    return [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]


def phase_complex_http(session, srv, tables, want):
    """The baskets text POSTed once to the server, over the basket tables
    in its root session: the reply's columns and lists equal the oracle."""
    import numpy as np
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import (COMPLEX_QUERIES,
                                         register_basket_tables)
    t0 = time.perf_counter()
    session.conf.set("spark.tpu.collect.maxArrayLen", str(COMPLEX_MAX_LEN))
    session.conf.set("spark.sql.agg.outputCapacity", str(COMPLEX_AGG_ROWS))
    register_basket_tables(session, tables, T)
    status, body, ms = _http(srv.port, "/sql", "POST",
                             {"query": COMPLEX_QUERIES["baskets"][0]})
    check(status == 200, f"[complex] POST of baskets: {status} "
          f"{str(body)[:300]}")
    check(body["columns"] == list(want), f"[complex] POST columns "
          f"{body['columns']}")
    cols = list(zip(*body["rows"]))
    for j, (name, w) in enumerate(want.items()):
        if w.ndim == 2:
            sent = np.iinfo(w.dtype).min
            ok = list(cols[j]) == _plane_lists(w, sent)
        else:
            ok = list(cols[j]) == w.tolist()
        check(ok, f"[complex] POST column {name} differs from the oracle")
    print(f"[complex] baskets over HTTP: {len(body['rows'])} rows whose "
          f"columns and lists equal the oracle; HTTP wall {ms:.2f} ms "
          f"(server {body['durationMs']} ms); the step "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# [server] and [tpcds]: the SQL server on the card
# ---------------------------------------------------------------------------

SERVER_CLIENTS = 4

#: rows of store_sales in the [tpcds] phase (the other tables scale off
#: it, as in ``spark_tpu_torch/tpcds/datagen.py``): the largest scale
#: ``tools/tpcds_scale.py`` showed to keep the whole script within about
#: three minutes on the card (the tests' scale is 20,000)
TPCDS_SF_ROWS = 50_000

#: sqlite connections the [tpcds] oracle runs its texts on at once
ORACLE_THREADS = 4

#: the TPC-DS texts whose plans hold a window: the plan cache cannot
#: fingerprint a window spec (the reference's rule), so each POST of them
#: counts as uncacheable (q70's window sits in its IN subquery)
WINDOW_QUERIES = ("q12 q20 q44 q47 q49 q51 q53 q57 q63 q67 q70 q89 "
                  "q98").split()


def _http(port, path, method="GET", body=None):
    """(HTTP status, JSON reply, wall ms) of one request to the server on
    127.0.0.1."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, json.loads(raw), (time.perf_counter() - t0) * 1e3


def _wait_for(cond, what, timeout_s=30.0):
    """Poll ``cond`` until it holds; fail after ``timeout_s``."""
    end = time.monotonic() + timeout_s
    while not cond():
        check(time.monotonic() < end, f"[server] timed out waiting for "
              f"{what}")
        time.sleep(0.01)


def _json_rows(rows):
    """Oracle rows in the server's JSON form."""
    from spark_tpu_torch.server import _json_safe
    return [[_json_safe(v) for v in r] for r in rows]


def _pct(values, q):
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _share_root(session, server_session):
    """The root session's temp views (and its persistent tables, as
    views of their file relations) and UDFs in a server session: the
    same plans and function objects, so statements over them share plan
    fingerprints across sessions."""
    for name in session.catalog.listTables():
        server_session.catalog.register(name, session.catalog.lookup(name))
    for name in session.catalog.listFunctions():
        server_session.catalog.register_function(
            name, session.catalog.lookup_function(name))


def phase_server(session, hash_table, tables, k1_entries, k2_entry, card):
    """``SQLServer`` on the card session, on an ephemeral port of
    127.0.0.1: four client threads, each on its own server session, POST
    two rounds of the SQL phase's statements; then a literal variant,
    one SET of a planning conf, one statement over
    ``maxConcurrentStatements``, one cancelled queued statement, one
    mesh statement and an evicted graph's pool back on the card.
    Returns the server, for the [tpcds] phase."""
    import threading

    import torch
    from spark_tpu_torch import config as C
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL, SQL_QUERIES,
                                         hash_agg_oracle, q3_oracle)

    srv = SQLServer(session, host="127.0.0.1", port=0,
                    workers=SERVER_CLIENTS).start()
    port = srv.port
    print(f"[server] SQLServer on http://127.0.0.1:{port} ({session.device},"
          f" {SERVER_CLIENTS} workers)", flush=True)
    queries = [("hash-agg", HASH_AGG_SQL,
                lambda t: hash_agg_oracle(hash_table), False),
               ("q3", Q3_SQL, q3_oracle, True)]
    queries += [(name, sql, oracle, ordered)
                for name, (sql, oracle, ordered) in SQL_QUERIES.items()]
    want = {name: _json_rows(oracle(tables))
            for name, _s, oracle, _o in queries}
    ordered = {name: o for name, _s, _f, o in queries}
    #: the row-lane UDF statement runs on the eager lane: nothing cached
    uncacheable = {"UDF row"}

    def equal(name, rows):
        if ordered[name]:
            return rows == want[name]
        return sorted(rows, key=repr) == sorted(want[name], key=repr)

    sids = []
    for _ in range(SERVER_CLIENTS):
        status, body, _ms = _http(port, "/session", "POST")
        check(status == 200, f"[server] POST /session: {status} {body}")
        sids.append(body["sessionId"])
        _share_root(session, srv._sessions[body["sessionId"]].session)

    # the main path's run: counts zeroed just before, read just after
    clear_stage_cache()
    zero_counts()
    replies = {(c, r): {} for c in range(SERVER_CLIENTS) for r in (1, 2)}
    barrier = threading.Barrier(SERVER_CLIENTS)
    errors = []

    def client(c):
        try:
            for rnd in (1, 2):
                barrier.wait()
                for name, sql, _o, _d in queries:
                    replies[(c, rnd)][name] = _http(
                        port, "/sql", "POST",
                        {"query": sql, "session": sids[c]})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rounds_s = time.perf_counter() - t0
    check(not errors, f"[server] client threads failed: {errors}")
    k1_server = dict(cuda_agg.ENTRY_LAUNCHES)
    for (c, rnd), by_name in replies.items():
        for name, (status, body, _ms) in by_name.items():
            check(status == 200, f"[server] client {c} round {rnd} {name}: "
                  f"HTTP {status} {str(body)[:300]}")
            check(equal(name, body["rows"]), f"[server] client {c} round "
                  f"{rnd} {name}: rows differ from the numpy oracle (first "
                  f"{body['rows'][:2]} vs {want[name][:2]})")
            if rnd == 2 and name not in uncacheable:
                check(body["cacheHit"] is True, f"[server] client {c} "
                      f"round 2 {name}: not a plan-cache hit")
    check(k1_server["grouped_accumulate_columns"] > 0,
          f"[server] K1 was not launched through /sql: {k1_server}")
    for entry in k1_entries:
        entry["server_launches"] = k1_server[entry["name"]]
    print(f"[server] {SERVER_CLIENTS} clients x 2 rounds x {len(queries)} "
          f"statements in {rounds_s:.2f} s: every reply equal to its numpy "
          f"oracle; every round-2 reply a plan-cache hit (but "
          f"{', '.join(sorted(uncacheable))}: the row-lane UDF runs "
          f"eager, uncacheable); K1 wrapper launches through /sql "
          f"{k1_server}; captures and pool releases waited for one "
          f"another {stage_cache().stats()['capture_waits']} times",
          flush=True)
    for name, sql, _o, _d in queries:
        walls = {rnd: [replies[(c, rnd)][name][2]
                       for c in range(SERVER_CLIENTS)] for rnd in (1, 2)}
        hits1 = sum(replies[(c, 1)][name][1]["cacheHit"]
                    for c in range(SERVER_CLIENTS))
        skipped = [replies[(c, 2)][name][1]["planningSkippedMs"]
                   for c in range(SERVER_CLIENTS)]
        server_ms = [replies[(c, 2)][name][1]["durationMs"]
                     for c in range(SERVER_CLIENTS)]
        print(f"[server] {name}: {len(want[name])} rows; HTTP wall round 1 "
              f"p50 {_pct(walls[1], 50):.2f} ms p90 {_pct(walls[1], 90):.2f}"
              f" ms ({hits1} of {SERVER_CLIENTS} hits: another session had "
              f"built it); round 2 p50 {_pct(walls[2], 50):.2f} ms p90 "
              f"{_pct(walls[2], 90):.2f} ms (durationMs p50 "
              f"{_pct(server_ms, 50):.2f}); planningSkippedMs p50 "
              f"{_pct(skipped, 50):.1f}", flush=True)
    # where a hit's time goes, once per statement: the same call the
    # server makes, in this thread, through a server session
    ss = srv._sessions[sids[0]].session
    for name, sql, _o, _d in queries:
        ss.sql(sql).collect()
        prof = profile_query(f"server {name} (plan-cache hit)",
                             lambda: ss.sql(sql).collect())
        check(name in uncacheable or ss._last_plan_cache_info["hit"],
              f"[server] {name}: the profiled run was not a hit")
        print(f"[server] {name}: host launch calls on the graph lane "
              f"{prof['host_launch_calls']} (plan-cache hit)", flush=True)
    # one client alone: a statement's miss (plan, build) and its hits
    for name, sql in (("hash-agg", HASH_AGG_SQL), ("q3", Q3_SQL)):
        srv._plan_cache.invalidate_all()
        clear_stage_cache()
        runs = [_http(port, "/sql", "POST", {"query": sql, "session": sids[0]})
                for _ in range(6)]
        check([r[1]["cacheHit"] for r in runs] == [False] + [True] * 5,
              f"[server] {name} alone: hits {[r[1]['cacheHit'] for r in runs]}")
        hits = [r[2] for r in runs[1:]]
        print(f"[server] {name}, one client alone: HTTP wall of the miss "
              f"(plan, warm-up, capture) {runs[0][2]:.2f} ms, of 5 hits p50 "
              f"{_pct(hits, 50):.2f} ms p90 {_pct(hits, 90):.2f} ms "
              f"(durationMs p50 {_pct([r[1]['durationMs'] for r in runs[1:]], 50):.2f})",
              flush=True)

    # what a hit saves on the host: the same statement in turns without
    # the plan cache (the stage cache alone) and through it
    from spark_tpu_torch.serving.plancache import fingerprint
    from spark_tpu_torch.sql.planner import QueryExecution
    plain = session.newSession()
    _share_root(session, plain)
    for name, sql in (("hash-agg", HASH_AGG_SQL), ("q3", Q3_SQL)):
        walls = [wall_ms(lambda: s_.sql(sql).collect())
                 for s_ in (plain, ss, ss, plain)]
        check(ss._last_plan_cache_info["hit"], f"[server] {name}: the "
              "in-process run through the server session was not a hit")
        optimized = QueryExecution(ss, ss.sql(sql)._plan).optimized
        fp_ms = host_ms(lambda: fingerprint(ss, optimized), warmup=1,
                        reps=5)
        print(f"[server] {name}: in-process warm wall with the decode, "
              f"median of 5, in turns stage cache alone, plan-cache hit, "
              f"hit, stage cache alone: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms; the hit's "
              f"fingerprint {fp_ms:.3f} ms of host time", flush=True)
    status, st, _ms = _http(port, "/status")
    check(status == 200, f"[server] GET /status: {status}")
    print(f"[server] /status planCache {st['planCache']}; stageCache "
          f"{st['stageCache']}; serving gauges {st['metrics']['serving']}",
          flush=True)

    # one literal variant: v < 50 builds (once, in whichever session came
    # first), v < 80 builds no new entry
    text = ("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM hash_t WHERE v < {} "
            "GROUP BY k")
    variant = {}
    for bound in (50, 80):
        before = (srv._plan_cache.stats(), stage_cache().stats())
        got = [_http(port, "/sql", "POST",
                     {"query": text.format(bound), "session": sid})
               for sid in sids]
        after = (srv._plan_cache.stats(), stage_cache().stats())
        oracle = _json_rows(_grouped_oracle(hash_table,
                                            hash_table["v"] < bound))
        for status, body, _ms in got:
            check(status == 200 and sorted(body["rows"]) == oracle,
                  f"[server] v < {bound}: differs from the numpy oracle")
        variant[bound] = (after[0]["entries"] - before[0]["entries"],
                          after[1]["builds"] - before[1]["builds"],
                          sum(b["cacheHit"] for _s, b, _m in got))
    check(variant[80] == (0, 0, SERVER_CLIENTS),
          f"[server] the literal variant v < 80 built: {variant}")
    print(f"[server] literal variant: v < 50 new plan entries, stage builds,"
          f" hits {variant[50]}; v < 80 {variant[80]} (no new entry, every "
          "session a hit); both equal to the oracle", flush=True)

    # one SET of a planning conf: invalidates, and the next run misses
    before = srv._plan_cache.stats()["invalidations"]
    status, body, _ms = _http(port, "/sql", "POST", {
        "query": "SET spark.sql.join.outputCapacityFactor=1.5",
        "session": sids[0]})
    check(status == 200, f"[server] SET: {status} {body}")
    invalidated = srv._plan_cache.stats()["invalidations"] - before
    status, body, _ms = _http(port, "/sql", "POST",
                              {"query": Q3_SQL, "session": sids[0]})
    check(invalidated > 0 and status == 200 and body["cacheHit"] is False
          and body["rows"] == want["q3"],
          f"[server] SET did not invalidate ({invalidated}) or q3 after it "
          f"hit / differs: {str(body)[:300]}")
    _http(port, "/sql", "POST", {
        "query": "SET spark.sql.join.outputCapacityFactor=1.0",
        "session": sids[0]})
    print(f"[server] SET spark.sql.join.outputCapacityFactor=1.5: "
          f"{invalidated} entries invalidated; q3 after it missed and "
          "equals the oracle", flush=True)

    # one statement over maxConcurrentStatements: 429 naming the limit
    session.conf.set(C.SERVER_MAX_CONCURRENT_STATEMENTS.key, "1")
    wedged = srv._sessions[sids[1]]
    wedged.lock.acquire()
    held = {}
    try:
        th = threading.Thread(target=lambda: held.update(r=_http(
            port, "/sql", "POST", {"query": "SELECT 1 AS one",
                                   "session": sids[1]})))
        th.start()
        _wait_for(lambda: srv._admission.stats()["active"] == 1,
                  "the wedged statement's admission")
        status, body, _ms = _http(port, "/sql", "POST", {
            "query": "SELECT 2 AS two", "session": sids[2]})
    finally:
        wedged.lock.release()
    th.join()
    session.conf.unset(C.SERVER_MAX_CONCURRENT_STATEMENTS.key)
    check(status == 429 and body.get("limit") == "maxConcurrentStatements",
          f"[server] over the cap: {status} {body}")
    check(held["r"][0] == 200 and held["r"][1]["rows"] == [[1]],
          f"[server] the admitted statement: {held}")
    print(f"[server] over maxConcurrentStatements=1: HTTP {status} "
          f"{body['error']}", flush=True)

    # one cancelled queued statement never runs
    wedged = srv._sessions[sids[3]]
    runs_before = wedged.session._query_count
    codes = {}
    wedged.lock.acquire()
    try:
        head = threading.Thread(target=lambda: codes.update(head=_http(
            port, "/sql", "POST", {"query": "SELECT 3 AS three",
                                   "session": sids[3], "id": "smoke-head"})))
        head.start()
        # queued, then taken by the session's drainer (``draining`` is
        # set as the head is queued), which waits on the wedged lock
        _wait_for(lambda: "smoke-head" in srv._statements
                  and wedged.draining and not any(
                      item[0].id == "smoke-head"
                      for item in list(wedged.queue)),
                  "the head statement on the session's worker")
        tail = threading.Thread(target=lambda: codes.update(tail=_http(
            port, "/sql", "POST", {"query": Q3_SQL, "session": sids[3],
                                   "id": "smoke-tail"})))
        tail.start()
        _wait_for(lambda: any(item[0].id == "smoke-tail"
                              for item in list(wedged.queue)),
                  "the tail statement in the session's queue")
        status, body, _ms = _http(port, "/cancel", "POST",
                                  {"id": "smoke-tail"})
        tail.join()
    finally:
        wedged.lock.release()
    head.join()
    ran = wedged.session._query_count - runs_before
    _s, stmt, _ms = _http(port, "/statement/smoke-tail")
    check(status == 200 and body["status"] == "cancelled"
          and codes["tail"][0] == 499 and codes["head"][0] == 200
          and ran == 1 and stmt["status"] == "cancelled",
          f"[server] queued cancel: {body}, tail {codes.get('tail')}, "
          f"statements run {ran}")
    print(f"[server] a queued statement cancelled: HTTP "
          f"{codes['tail'][0]}, status {stmt['status']}; the session ran "
          f"{ran} statement (the head)", flush=True)

    # one mesh statement: K2 launches, and its repeat is a hit
    sid = sids[0]
    _http(port, "/sql", "POST", {"query": f"SET {SHARDS_KEY}={MESH_SHARDS}",
                                 "session": sid})
    mesh = []
    # the mesh statements' run: counts zeroed just before, read just after
    mesh_variants = stage_cache().stats()["variants"]
    zero_counts()
    for _ in range(2):
        before = k2_runs()
        status, body, ms = _http(port, "/sql", "POST",
                                 {"query": Q3_SQL, "session": sid})
        mesh.append((status, body, k2_runs() - before, ms))
    k2_entry["server_launches"] = k2_runs()
    _http(port, "/sql", "POST", {"query": f"SET {SHARDS_KEY}=1",
                                 "session": sid})
    for status, body, k2, _ms in mesh:
        check(status == 200 and body["rows"] == want["q3"] and k2 > 0,
              f"[server] mesh q3: HTTP {status}, K2 launches {k2}, rows "
              f"{str(body)[:200]}")
    check(mesh[1][1]["cacheHit"] is True, "[server] the mesh repeat was "
          "not a hit")
    print(f"[server] mesh q3 x{MESH_SHARDS}: K2 runs {mesh[0][2]} then "
          f"{mesh[1][2]} (captured {cuda_a2a.CAPTURED_LAUNCHES}, replayed "
          f"{cuda_a2a.REPLAYED_LAUNCHES}; graph builds "
          f"{stage_cache().stats()['variants'] - mesh_variants}); HTTP wall "
          f"{mesh[0][3]:.2f} then {mesh[1][3]:.2f} ms; the repeat a "
          "plan-cache hit through run_staged; rows equal the oracle",
          flush=True)

    # an evicted graph's pool goes back to the card
    torch.cuda.synchronize()
    held_bytes = stage_cache().stats()["graph_bytes"]
    pool_bytes = sum(v.pool_bytes for e in stage_cache().entries()
                     for v in e.variants)
    free0, total = torch.cuda.mem_get_info()
    reserved0 = torch.cuda.memory_reserved()
    # each entry is evicted through the memory manager it is charged to
    # (the eviction callback's path); sessions charge their own
    managers = {id(e.charged_to): e.charged_to
                for e in stage_cache().entries() if e.charged_to is not None}
    evicted = sum(stage_cache().evict(m, 1 << 62)
                  for m in managers.values())
    free1, _t = torch.cuda.mem_get_info()
    reserved1 = torch.cuda.memory_reserved()
    # the private pools' segments hold nothing else: all of them go back.
    # A static input buffer may share a segment with a live tensor, so
    # the card need not get every one of those bytes back
    check(len(stage_cache()) == 0 and free1 - free0 >= pool_bytes,
          f"[server] eviction returned {free1 - free0} B of the graph "
          f"pools' {pool_bytes} B; {len(stage_cache())} entries left")
    again = torch.empty(pool_bytes, dtype=torch.uint8, device="cuda")
    again.fill_(1)
    torch.cuda.synchronize()
    free2, _t = torch.cuda.mem_get_info()
    del again
    print(f"[server] evicted every stage entry ({evicted} B charged: graph "
          f"pools {pool_bytes} B + static inputs {held_bytes - pool_bytes} "
          f"B): card free memory {free0} -> {free1} B (+{free1 - free0}), "
          f"reserved {reserved0} -> {reserved1} B; a {pool_bytes} B tensor "
          f"then allocated (card free {free2} B of {total} B) | {card}",
          flush=True)
    return srv


def _tpcds_compare(got, exp):
    """The rule of ``tests/test_tpcds.py``: rows sorted NULL-stably,
    floats within rel_tol = abs_tol = 1e-6, everything else equal, each
    side normalized by ``oracle.norm_value`` after ``_json_safe``."""
    import math
    from spark_tpu_torch.server import _json_safe
    from spark_tpu_torch.tpcds.oracle import norm_value, row_key
    got = sorted((tuple(norm_value(v) for v in r) for r in got),
                 key=row_key)
    exp = sorted((tuple(norm_value(_json_safe(v)) for v in r) for r in exp),
                 key=row_key)
    if len(got) != len(exp):
        return f"{len(got)} rows != oracle {len(exp)}"
    for i, (g, e) in enumerate(zip(got, exp)):
        if len(g) != len(e):
            return f"row {i}: arity {len(g)} != {len(e)}"
        for j, (a, b) in enumerate(zip(g, e)):
            if isinstance(a, float) and isinstance(b, float):
                ok = math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-6)
            else:
                ok = a == b
            if not ok:
                return f"row {i} col {j}: {a!r} != {b!r}"
    return None


def _sqlite_answers(tables, texts, threads=ORACLE_THREADS):
    """sqlite's rows for each of ``texts`` ({name: SQL}): one database
    loaded from ``tables``, copied into ``threads`` connections, the
    texts run on them in parallel (sqlite lets go of the GIL while a
    statement runs).  Returns ({name: rows}, seconds to load)."""
    import queue
    import sqlite3
    from concurrent.futures import ThreadPoolExecutor

    from spark_tpu_torch.tpcds.oracle import load_sqlite, sqlite_text
    t0 = time.perf_counter()
    src = sqlite3.connect(":memory:")
    load_sqlite(src, tables)
    free = queue.Queue()
    for _ in range(threads):
        con = sqlite3.connect(":memory:", check_same_thread=False)
        src.backup(con)
        free.put(con)
    src.close()
    load_s = time.perf_counter() - t0

    def run(name):
        con = free.get()
        try:
            return name, con.execute(sqlite_text(texts[name])).fetchall()
        finally:
            free.put(con)

    with ThreadPoolExecutor(threads) as pool:
        out = dict(pool.map(run, texts))
    while not free.empty():
        free.get().close()
    return out, load_s


def phase_tpcds(session, srv, sf_rows=TPCDS_SF_ROWS):
    """The port's TPC-DS tables (its own ``datagen``) in the server's root
    session and in sqlite; each ported text POSTed twice and held
    against sqlite, each repeat a plan-cache hit; each other text
    refused naming its construct and slice.  Returns the phase's
    seconds by part."""
    from spark_tpu_torch.tpcds import ORACLE_OVERRIDES, QUERIES, generate

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tables = generate(sf_rows)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, cols in tables.items():
        session.createDataFrame(cols).createOrReplaceTempView(name)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # sqlite cannot run the ROLLUP texts as written: their overrides
    answers, sqlite_load_s = _sqlite_answers(
        tables, {q: ORACLE_OVERRIDES.get(q, QUERIES[q]) for q in QUERIES})
    oracle_s = time.perf_counter() - t0
    print(f"[tpcds] sf_rows {sf_rows}: {len(tables)} tables made in "
          f"{gen_s:.2f} s, moved to the card in {load_s:.2f} s; sqlite "
          f"loaded in {sqlite_load_s:.2f} s and answered the "
          f"{len(QUERIES)} texts in {oracle_s - sqlite_load_s:.2f} s on "
          f"{ORACLE_THREADS} threads", flush=True)
    first, repeat = [], []
    uncacheable0 = srv._plan_cache.stats()["uncacheable"]
    t0 = time.perf_counter()
    for q in QUERIES:
        got = [_http(srv.port, "/sql", "POST", {"query": QUERIES[q]})
               for _ in range(2)]
        for status, body, _ms in got:
            check(status == 200, f"[tpcds] {q}: HTTP {status} "
                  f"{str(body)[:300]}")
        check(len(answers[q]) > 0, f"[tpcds] {q}: the oracle returned no "
              "rows")
        for status, body, _ms in got:
            why = _tpcds_compare(body["rows"], answers[q])
            check(why is None, f"[tpcds] {q} differs from sqlite: {why}")
        hit = got[1][1]["cacheHit"]
        check(hit is (q not in WINDOW_QUERIES),
              f"[tpcds] {q}: the repeat's cacheHit is {hit}")
        first.append(got[0][2])
        repeat.append(got[1][2])
    server_s = time.perf_counter() - t0
    uncacheable = srv._plan_cache.stats()["uncacheable"] - uncacheable0
    check(uncacheable == 2 * len(WINDOW_QUERIES),
          f"[tpcds] {uncacheable} uncacheable statements, expected two "
          f"POSTs of each of the {len(WINDOW_QUERIES)} window texts")
    print(f"[tpcds] {len(QUERIES)} texts, each POSTed twice in "
          f"{server_s:.2f} s: all equal to sqlite; every repeat of the "
          f"{len(QUERIES) - len(WINDOW_QUERIES)} cacheable texts a "
          f"plan-cache hit, the {len(WINDOW_QUERIES)} window texts "
          f"uncacheable ({uncacheable} statements); HTTP wall first p50 "
          f"{_pct(first, 50):.2f} ms p90 {_pct(first, 90):.2f} ms, repeat "
          f"p50 {_pct(repeat, 50):.2f} ms p90 {_pct(repeat, 90):.2f} ms",
          flush=True)
    print(f"[tpcds] /status planCache {srv._plan_cache.stats()}", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[tpcds] phase {phase_s:.2f} s at sf_rows {sf_rows}", flush=True)
    return {"generate": gen_s, "to card": load_s, "oracle": oracle_s,
            "server": server_s, "phase": phase_s, "tables": tables,
            "answers": answers}


#: the H100 SXM's host link, PCIe Gen5 x16, one direction (NVIDIA's data
#: sheet gives 128 GB/s for both directions together)
PCIE_BYTES_PER_S = 64e9
#: the scan limit the [scan] phase reads its SF1 tables under: above
#: store_sales' 2,880,404 rows and hash-agg's 2^22, so each file relation
#: is one batch in both packages (``spark.tpu.scan.maxBatchRows``)
SCAN_LIMIT = 1 << 23
SCAN_LIMIT_KEY = "spark.tpu.scan.maxBatchRows"
#: (c): one twelfth of store_sales' 1,827 sale days (1998-01-02 ..
#: 2002-12-31), in a date-clustered file
PRUNED_LO, PRUNED_HI = 2450816 + 760, 2450816 + 760 + 151
PRUNED_SQL = ("SELECT count(*) AS n, sum(ss_ext_sales_price) AS s FROM "
              f"store_sales WHERE ss_sold_date_sk BETWEEN {PRUNED_LO} AND "
              f"{PRUNED_HI}")
#: the file-backed TPC-DS subset: ``SMOKE`` of tests/test_tpcds_filebacked.py
FILEBACKED_TEXTS = ("q3 q7 q17 q19 q23 q25 q42 q52 q55 q68 q79 q96 "
                    "q98").split()
#: INSERTs into the catalog table ``item`` ((e), then [server]): a copy of
#: each manufacturer-28 item under another brand, so q3's answer changes
ITEM_INSERT = ("INSERT INTO item SELECT i_item_sk, CAST(i_brand_id + {d} AS "
               "INT), concat(i_brand, '{tag}'), i_manufact_id FROM item "
               "WHERE i_manufact_id = 28 AND i_brand_id < 6000000")


def _grown_item(item, inserts):
    """q3's ``item`` after ``ITEM_INSERT`` with each (d, tag), in numpy:
    the table every INSERT reads is the one the earlier INSERTs made."""
    import numpy as np
    cols = {k: np.asarray(v) for k, v in item.items()}
    for d, tag in inserts:
        sel = (cols["i_manufact_id"] == 28) & (cols["i_brand_id"] < 6000000)
        new = {"i_item_sk": cols["i_item_sk"][sel],
               "i_brand_id": (cols["i_brand_id"][sel] + d).astype(np.int32),
               "i_brand": np.char.add(cols["i_brand"][sel].astype(str), tag),
               "i_manufact_id": cols["i_manufact_id"][sel]}
        cols = {k: np.concatenate([cols[k], new[k]]) for k in cols}
    return cols


def _in_memory(session, hash_table, tables, item=None):
    """A sibling session holding the hash-agg table and q3's tables (with
    ``item`` in place of q3's own when given) as in-memory temp views on
    the card: the runs the file-backed ones are held against."""
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import register_sql_tables
    mem = session.newSession()
    if item is not None:
        tables = dict(tables, item=item)
    register_sql_tables(mem, hash_table, tables, T)
    return mem


def _join_order(session, sql):
    """The base relations of ``sql``'s optimized plan in left-deep join
    order: a file by its directory's name, a temp view's batch as
    ``memory``."""
    from spark_tpu_torch.sql import logical as L
    from spark_tpu_torch.sql.planner import QueryExecution
    order = []

    def walk(n):
        if isinstance(n, L.FileRelation):
            order.append(os.path.basename(n.paths[0].rstrip("/")))
        elif isinstance(n, L.LocalRelation):
            order.append("memory")
        for c in n.children:
            walk(c)

    walk(QueryExecution(session, session.sql(sql)._plan).optimized)
    return order


def _file_leaves(session, df):
    """The file leaves (pinned host batches) one run of ``df`` copies to
    the card, from a planning of it (a relation-cache hit)."""
    from spark_tpu_torch.sql.planner import QueryExecution
    return [b for b in QueryExecution(session, df._plan).planned.leaves
            if b.source is not None]


def _copy_numbers(leaves):
    """(bytes, ms, bound ms, pinned) of the leaves' copy to the card: the
    ``non_blocking`` copies of every tensor into device buffers, CUDA
    events, median of 25."""
    import torch
    from spark_tpu_torch.memory import batch_nbytes
    from spark_tpu_torch.sql.stagecompile import _leaf_tensors
    src = _leaf_tensors(leaves)
    dst = [torch.empty_like(t, device="cuda") for t in src]

    def copy():
        for d, t in zip(dst, src):
            d.copy_(t, non_blocking=True)
    nbytes = sum(batch_nbytes(b) for b in leaves)
    ms = cuda_ms(copy)
    return nbytes, ms, nbytes / PCIE_BYTES_PER_S * 1e3, \
        all(b.is_pinned() for b in leaves)


def phase_scan(session, hash_table, tables, k1_entries, k2_entry, tpcds):
    """Files in and out on the card (see the module's docstring, 13):
    the SF1 tables written by the port's own writers into a temporary
    directory (deleted at the end), read back through parquet, CSV and a
    catalog table, and each answer held against the in-memory run of the
    same tables exactly; the out-of-core boundary; ANALYZE and INSERT on
    the catalog table; the mesh lane; the SQL server over the files; the
    file-backed TPC-DS subset against sqlite."""
    import shutil
    import tempfile

    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch import io as tio
    from spark_tpu_torch import types as T
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.sql.planner import QueryExecution, stage_key
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL,
                                         hash_agg_oracle, read_scan_tables,
                                         write_scan_tables)

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    try:
        # 1. the writes, through the port's DataFrameWriter
        scan = session.newSession()
        scan.conf.set("spark.sql.warehouse.dir", os.path.join(root, "wh"))
        write_ms = write_scan_tables(scan, hash_table, tables, T, root)
        read_scan_tables(scan, root)
        print(f"[scan] written under a temporary directory: hash_t "
              f"{MAIN_N} rows parquet {write_ms['hash_t']:.1f} ms, "
              f"store_sales {Q3_ROWS['store_sales']} rows parquet (sorted by "
              f"ss_sold_date_sk, row groups of 2^18) "
              f"{write_ms['store_sales']:.1f} ms, date_dim "
              f"{Q3_ROWS['date_dim']} rows CSV {write_ms['date_dim']:.1f} ms,"
              f" item {Q3_ROWS['item']} rows saveAsTable "
              f"{write_ms['item']:.1f} ms", flush=True)

        # 2. at the default limit hash-agg's file streams, then the SF1
        #    limit reads each file relation as one batch
        from spark_tpu_torch.sql import multibatch as MB
        MB.reset_stream_stats()
        streamed = sorted(tuple(r) for r in scan.sql(HASH_AGG_SQL).collect())
        n_streamed = MB.STREAM_STATS["batches"]
        check(streamed == [tuple(x) for x in hash_agg_oracle(hash_table)]
              and n_streamed == MAIN_N // (1 << 20),
              f"[scan] hash-agg over {MAIN_N} parquet rows at the default "
              f"{SCAN_LIMIT_KEY}: {n_streamed} batches, equal to the "
              "in-memory answer "
              f"{streamed == [tuple(x) for x in hash_agg_oracle(hash_table)]}")
        scan.conf.set(SCAN_LIMIT_KEY, str(SCAN_LIMIT))
        print(f"[scan] default {SCAN_LIMIT_KEY}=2^20: hash-agg streamed in "
              f"{n_streamed} batches through the multi-batch runner, equal "
              f"to the in-memory answer; {SCAN_LIMIT_KEY} set to "
              f"{SCAN_LIMIT} (2^23): each file relation is one batch",
              flush=True)

        # 3-4. (a)-(c) on the graph lane, against the in-memory runs
        m = _in_memory(session, hash_table, tables)
        mem = {"a": sorted(tuple(r) for r in m.sql(HASH_AGG_SQL).collect()),
               "b": [tuple(r) for r in m.sql(Q3_SQL).collect()],
               "c": [tuple(r) for r in m.sql(PRUNED_SQL).collect()]}
        check(mem["a"] == [tuple(x) for x in hash_agg_oracle(hash_table)],
              "in-memory hash-agg differs from its oracle")
        texts = {"a": ("hash-agg", HASH_AGG_SQL), "b": ("q3", Q3_SQL),
                 "c": ("row-group-pruned", PRUNED_SQL)}
        captured = []
        launch = cuda_agg.grouped_accumulate_columns

        def spy(bucket32, planes, n_active, B):
            captured.append((bucket32, list(planes), n_active, B))
            return launch(bucket32, planes, n_active, B)

        k1_scan = {}
        numbers = {}
        # each text reads its own files or columns: its first run decodes
        tio.clear_relation_cache()
        for key, (name, sql) in texts.items():
            df = scan.sql(sql)
            tio.reset_scan_stats()
            zero_counts()
            if key == "a":
                cuda_agg.grouped_accumulate_columns = spy
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                rows = df.collect()
                torch.cuda.synchronize()
            finally:
                cuda_agg.grouped_accumulate_columns = launch
            cold = (time.perf_counter() - t0) * 1e3
            stats = dict(tio.SCAN_STATS)
            if key == "a":
                k1_scan = dict(cuda_agg.ENTRY_LAUNCHES)
            got = [tuple(r) for r in rows]
            if key == "a":
                got = sorted(got)
            check(got == mem[key], f"[scan] ({key}) {name} over files differs"
                  f" from the in-memory run (first rows {got[:2]} vs "
                  f"{mem[key][:2]})")
            warm = wall_ms(df.collect)
            mem_df = m.sql(sql)
            turns = [wall_ms(mem_df.collect), wall_ms(df.collect),
                     wall_ms(df.collect), wall_ms(mem_df.collect)]
            split = host_split(scan, df._plan)
            leaves = _file_leaves(scan, df)
            nbytes, copy_ms, bound_ms, pinned = _copy_numbers(leaves)
            prof = profile_query(f"scan ({key}) {name}", df.collect)
            numbers[key] = (cold, warm, stats, prof)
            print(f"[scan] ({key}) {name}: {len(got)} rows equal to the "
                  f"in-memory run; cold wall (first run after the write: "
                  f"decode, copy, warm-up and capture) {cold:.2f} ms, warm "
                  f"wall {warm:.2f} ms (median of 5, relation-cache hit); "
                  f"host decode {stats['decode_ms']:.2f} ms; copied to the "
                  f"card per run {nbytes} B from "
                  f"{'pinned' if pinned else 'PAGEABLE'} memory in "
                  f"{copy_ms:.4f} ms (bound "
                  f"{bound_ms:.4f} ms at 64 GB/s, {bound_ms / copy_ms:.1%}); "
                  f"device {prof['device_ms']:.3f} ms from "
                  f"{prof['host_launch_calls']} host launch calls; "
                  f"SCAN_STATS files {stats['files']}, columns read "
                  f"{stats['columns_read']}, row groups {stats['row_groups']}"
                  f", skipped {stats['row_groups_skipped']}, rows "
                  f"{stats['rows']}", flush=True)
            print(f"[scan] ({key}) warm walls in turns in-memory, files, "
                  f"files, in-memory: "
                  f"{', '.join(f'{w:.2f}' for w in turns)} ms; host ms over "
                  f"the files: "
                  f"{', '.join(f'{k} {v:.3f}' for k, v in split.items())}",
                  flush=True)
            check(pinned, f"[scan] ({key}) a file leaf is not pinned")
            if key == "a":
                check(k1_scan == {"grouped_accumulate": 0,
                                  "grouped_accumulate_columns": 2},
                      f"[scan] (a) K1 launches {k1_scan} on the first run, "
                      "expected 2 through the columns entry")
                check(prof["own"]["K1"][0] == 1,
                      f"[scan] (a) K1 x{prof['own']['K1'][0]} in a replay, "
                      "expected 1")
                print(f"[scan] (a) K1 launches: {k1_scan} on the first run "
                      f"(warm-up and capture), x{prof['own']['K1'][0]} per "
                      "replay (profiler)", flush=True)
            if key == "c":
                check(stats["row_groups_skipped"] > 0,
                      "[scan] (c) skipped no row group")
        del m, mem_df
        for entry in k1_entries:
            entry["scan_launches"] = k1_scan[entry["name"]]
        check(len(captured) == 2, f"[scan] (a) made {len(captured)} K1 "
              "calls through the columns entry, expected 2")
        if captured:
            err = _check_cases("columns in", [("[scan] (a)'s own inputs",
                                               captured[0])],
                               cuda_agg.grouped_accumulate_columns,
                               cuda_agg.grouped_accumulate_columns_plain)
            print(f"[scan] K1 on (a)'s inputs equal to its plain version "
                  f"(max abs err {err})", flush=True)
        del captured
        n_batches, pinned_bytes = tio.relation_cache_bytes()
        print(f"[scan] the relation cache holds {n_batches} host batches, "
              f"{pinned_bytes} B of pinned memory", flush=True)

        # (d) ANALYZE TABLE ... FOR COLUMNS, DESCRIBE EXTENDED, q3 again
        before = _join_order(scan, Q3_SQL)
        out = scan.sql("ANALYZE TABLE item COMPUTE STATISTICS FOR ALL "
                       "COLUMNS").collect()
        check(out[0]["persisted"] == "true", f"[scan] (d) ANALYZE: {out}")
        desc = [tuple(r) for r in
                scan.sql("DESCRIBE EXTENDED item").collect()]
        check(desc[-1] == ("# rows", "", str(Q3_ROWS["item"])),
              f"[scan] (d) DESCRIBE EXTENDED: {desc}")
        got = [tuple(r) for r in scan.sql(Q3_SQL).collect()]
        check(got == mem["b"], "[scan] (d) q3 after ANALYZE differs")
        after = _join_order(scan, Q3_SQL)
        print(f"[scan] (d) ANALYZE TABLE item: {out[0]['rows']} rows, "
              f"{out[0]['columns_analyzed']} columns; DESCRIBE EXTENDED "
              f"{desc}; q3 equal to the in-memory run; join order before "
              f"{before}, after {after}", flush=True)

        # (e) INSERT INTO the catalog table, q3 again
        q3_df = scan.sql(Q3_SQL)
        key0 = stage_key(scan, QueryExecution(scan, q3_df._plan).planned)[0]
        n0 = scan.sql("SELECT count(*) FROM item").collect()[0][0]
        scan.sql(ITEM_INSERT.format(d=1, tag="-b"))
        n1 = scan.sql("SELECT count(*) FROM item").collect()[0][0]
        key1 = stage_key(scan, QueryExecution(scan, q3_df._plan).planned)[0]
        got = [tuple(r) for r in scan.sql(Q3_SQL).collect()]
        want = [tuple(r) for r in _in_memory(
            session, hash_table, tables,
            _grown_item(tables["item"], [(1, "-b")])).sql(Q3_SQL).collect()]
        check(n1 > n0 and key1 != key0 and got == want and got != mem["b"],
              f"[scan] (e) INSERT: rows {n0} -> {n1}, stage key changed "
              f"{key1 != key0}, q3 equal to the in-memory run over the grown "
              f"table {got == want} (and unlike the first answer "
              f"{got != mem['b']})")
        print(f"[scan] (e) INSERT INTO item: {n0} -> {n1} rows; the stage "
              f"key changed; q3 ({len(got)} rows) equal to the in-memory run "
              "over the grown table", flush=True)

        # 5. (a) on the mesh lane
        _mesh(scan, MESH_SHARDS)
        try:
            zero_counts()
            rows = sorted(tuple(r) for r in scan.sql(HASH_AGG_SQL).collect())
            k2 = k2_runs()
        finally:
            _mesh(scan, 1)
        check(k2 == 1 and rows == mem["a"],
              f"[scan] (a) x{MESH_SHARDS} shards: K2 launches {k2}, rows "
              f"equal {rows == mem['a']}")
        k2_entry["scan_launches"] = k2
        print(f"[scan] (a) at {MESH_SHARDS} shards: K2 launches {k2}; rows "
              "equal to the single-device run", flush=True)

        # 6. the SQL server over the file-backed tables
        srv = SQLServer(scan, host="127.0.0.1", port=0, workers=2).start()
        try:
            sids = []
            for _ in range(2):
                status, body, _ms = _http(srv.port, "/session", "POST")
                check(status == 200, f"[scan] POST /session: {status}")
                sids.append(body["sessionId"])
                _share_root(scan, srv._sessions[body["sessionId"]].session)
            post = {"query": Q3_SQL, "session": sids[0]}
            replies = [_http(srv.port, "/sql", "POST", post)]
            hits0 = tio.SCAN_STATS["cache_hits"]
            replies.append(_http(srv.port, "/sql", "POST", post))
            reread = tio.SCAN_STATS["cache_hits"] - hits0
            inv0 = srv._plan_cache.stats()["invalidations"]
            status, body, _ms = _http(srv.port, "/sql", "POST", {
                "query": ITEM_INSERT.format(d=2, tag="-c"),
                "session": sids[1]})
            check(status == 200, f"[scan] INSERT over HTTP: {status} {body}")
            inv = srv._plan_cache.stats()["invalidations"] - inv0
            replies.append(_http(srv.port, "/sql", "POST", post))
        finally:
            srv.stop()
        want3 = _json_rows(_in_memory(
            session, hash_table, tables,
            _grown_item(tables["item"], [(1, "-b"), (2, "-c")]))
            .sql(Q3_SQL).collect())
        for status, body, _ms in replies:
            check(status == 200, f"[scan] q3 over HTTP: {status}")
        check(replies[0][1]["rows"] == replies[1][1]["rows"]
              == _json_rows(got) and not replies[0][1]["cacheHit"]
              and replies[1][1]["cacheHit"] and reread > 0,
              "[scan] the second POST of q3 is not a hit that re-read its "
              "leaves through the relation cache with the same rows")
        check(inv > 0 and replies[2][1]["rows"] == want3,
              f"[scan] the third POST after the other client's INSERT: "
              f"{inv} invalidations, rows equal to the in-memory run over "
              f"the grown table {replies[2][1]['rows'] == want3}")
        print(f"[scan] server: q3 POSTed twice (second a plan-cache hit, "
              f"{reread} leaves re-read through the relation cache), a "
              f"second client's INSERT INTO item invalidated {inv} entries, "
              f"the third POST shows the new rows (equal to the in-memory "
              f"run); HTTP walls {', '.join(f'{r[2]:.2f}' for r in replies)}"
              " ms", flush=True)
        tio.clear_relation_cache()

        # 7. the file-backed TPC-DS subset at the [tpcds] phase's sf_rows
        from spark_tpu_torch.tpcds import QUERIES
        from spark_tpu_torch.tpcds.oracle import FACT_TABLES
        t0 = time.perf_counter()
        fb = session.newSession()
        fb.conf.unset(SCAN_LIMIT_KEY)      # the default: below it, one batch
        for name, cols in tpcds["tables"].items():
            # the [tpcds] phase's tables (the root session's views of them
            # have been replaced since by [complex]'s)
            full = fb.createDataFrame(cols)
            if name not in FACT_TABLES:
                full.createOrReplaceTempView(name)
                continue
            d = os.path.join(root, "tpcds", name)
            n = len(next(iter(cols.values())))
            step = -(-n // 3)
            for i in range(3):
                part = {c: v[i * step:(i + 1) * step]
                        for c, v in cols.items()}
                fb.createDataFrame(part, schema=full.schema).write \
                    .mode("append").parquet(d)
            fb.read.parquet(d).createOrReplaceTempView(name)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for q in FILEBACKED_TEXTS:
            rows = [tuple(r) for r in fb.sql(QUERIES[q]).collect()]
            check(len(tpcds["answers"][q]) > 0, f"[scan] {q}: no oracle rows")
            why = _tpcds_compare(_json_rows(rows), tpcds["answers"][q])
            check(why is None, f"[scan] file-backed {q} differs from "
                  f"sqlite: {why}")
        print(f"[scan] file-backed TPC-DS: {len(FILEBACKED_TEXTS)} texts "
              f"over parquet fact tables (3 part files each, sf_rows "
              f"{TPCDS_SF_ROWS}, written in {write_s:.2f} s) equal to sqlite "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        tio.clear_relation_cache()
    print(f"[scan] phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return numbers


#: [ooc]: the default spark.tpu.scan.maxBatchRows the SF10 files stream
#: at, the limit of the one-batch runs they are held against, and the
#: batch the SF1 files stream at on the mesh lane
OOC_BATCH = 1 << 20
OOC_ONE_BATCH = 1 << 25
OOC_MESH_BATCH = 1 << 18
#: hash-agg's table at 8x [scan]'s rows (32 batches of 2^20)
OOC_HASH_ROWS = 1 << 25
#: the spill budget of (d)'s full sort (the runs of 4 batches in RAM)
OOC_SPILL_ROWS = 1 << 22
#: warm runs per text (median), after one cold run, the last of them
#: under the profiler; (c) (~13 s a run on the card) and (d) take one (a
#: cut of repetitions for the script's time)
OOC_WARM = {"a": 3, "b": 3, "c": 1, "d": 1}


def _ooc_run(session, fn):
    """One run of ``fn`` over ``session`` with what the streamed runners
    did in it: its wall, host decode ms, bytes copied to the card,
    batches through a step and the host ms in the steps' dispatch, their
    read-backs and the mergers,
    graph builds and guard misses of the stage cache, grace buckets and
    spills, and the peak device bytes above the run's start (the peak
    counter reset just before).  The session's last query (which holds
    its planned leaves, on the card for an in-memory write) is let go
    first, so that no memory the run frees hides its own peak."""
    import gc

    import torch
    from spark_tpu_torch import io as tio
    from spark_tpu_torch.sql import multibatch as MB
    from spark_tpu_torch.sql.stagecompile import stage_cache
    session._last_qe = None
    gc.collect()                 # the base holds no garbage of earlier runs
    st0 = stage_cache().stats()
    dec0 = tio.SCAN_STATS["decode_ms"]
    MB.reset_stream_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    st1 = stage_cache().stats()
    m = dict(MB.STREAM_STATS)
    m.update(wall_ms=wall, decode_ms=tio.SCAN_STATS["decode_ms"] - dec0,
             builds=st1["variants"] - st0["variants"],
             guard_misses=st1["guard_misses"] - st0["guard_misses"],
             peak_bytes=torch.cuda.max_memory_allocated() - base)
    return out, m


def _ooc_report(tag, name, runs, prof, extra=""):
    """Print one text's cold run and the median of its warm runs (the
    last of which ran under the profiler), with the wall split into host
    decode, copies to the card, step dispatch, packed read-backs, merge
    and (grace joins) partitioning and bucket joins; the device time,
    its mean per batch and the device-busy share come from the profiled
    run (copies included).  Returns the numbers kept."""
    import numpy as np
    cold, warm = runs[0], runs[1:]

    def med(key):
        return float(np.median([r[key] for r in warm]))
    batches = warm[0]["batches"]
    nbytes = warm[0]["bytes_to_device"]
    bound_ms = nbytes / PCIE_BYTES_PER_S * 1e3
    wall = med("wall_ms")
    step_dev = (prof["device_ms"] - prof["h2d_ms"]) / max(batches, 1)
    # the profiled run's own wall (its gc pass and the profiler's idle
    # pads left out)
    prof_wall = warm[-1]["wall_ms"]
    busy = prof["device_ms"] / prof_wall
    warm_txt = ", ".join(f"{r['wall_ms']:.2f}" for r in warm)
    print(f"[ooc] ({tag}) {name}: cold wall {cold['wall_ms']:.2f} ms "
          f"(decode {cold['decode_ms']:.2f}, builds {cold['builds']}, guard "
          f"misses {cold['guard_misses']}, peak device bytes "
          f"{cold['peak_bytes']}); warm walls {warm_txt} ms (the last "
          f"under the profiler), median "
          f"{wall:.2f}; split (medians over the warm runs): host decode "
          f"{med('decode_ms'):.2f} ms (prefetch thread), {batches} batches "
          f"through the step, {nbytes} B of host leaves copied to the card "
          f"(bound {bound_ms:.2f} ms at 64 GB/s; the profiled run's "
          f"host-to-device copies {prof['h2d_ms']:.2f} ms of device time), "
          f"step dispatch (host) {med('step_ms'):.2f} ms, packed "
          f"read-backs (host, waiting for the steps' kernels) "
          f"{med('readback_ms'):.2f} ms, grace partitioning "
          f"{med('partition_ms'):.2f} ms and bucket joins "
          f"{med('bucket_join_ms'):.2f} ms, host merge/fold "
          f"{med('merge_ms'):.2f} ms; device time under the profiler "
          f"{prof['device_ms']:.3f} ms (a mean of {step_dev:.3f} ms of "
          f"kernels per batch, copies to the card left out), device busy "
          f"{busy:.1%} of the profiled run's {prof_wall:.2f} ms; warm "
          f"builds "
          f"{max(r['builds'] for r in warm)}, guard misses "
          f"{max(r['guard_misses'] for r in warm)}{extra}", flush=True)
    return {"cold_ms": cold["wall_ms"], "warm_ms": wall, "batches": batches,
            "decode_ms": med("decode_ms"), "bytes": nbytes,
            "h2d_ms": prof["h2d_ms"], "bound_ms": bound_ms,
            "step_ms": med("step_ms"), "readback_ms": med("readback_ms"),
            "step_device_ms": step_dev,
            "merge_ms": med("merge_ms"), "busy": busy,
            "cold_peak": cold["peak_bytes"],
            "warm_builds": max(r["builds"] for r in warm),
            "warm_misses": max(r["guard_misses"] for r in warm)}


def phase_ooc(session, k1_entries, k2_entry, root):
    """Out-of-core execution on the card (see the module's docstring,
    14): TPC-DS SF10 row counts as files under ``root``, streamed at the
    default ``spark.tpu.scan.maxBatchRows``.  Returns what [cache] reads
    of it: its numbers, its session (whose catalog holds the SF10
    tables), the SF10 directory and the SF10 q3 oracle."""
    import numpy as np
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch import types as T
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.testing import (HASH_AGG_SQL, OOC_SF1, OOC_SF10,
                                         OOC_SORT_SQL, OOC_TOPK_SQL, Q3_SQL,
                                         hash_agg_oracle, hash_agg_table,
                                         ooc_tables, q3_oracle, q93_oracle,
                                         read_ooc_tables, sorted_run_mismatch,
                                         topk_oracle, write_ooc_tables)
    from spark_tpu_torch.tpcds import QUERIES
    Q93_SQL = QUERIES["q93"]

    t_phase = time.perf_counter()
    # 1. the SF10 tables and hash_t, written by the port's writers
    t0 = time.perf_counter()
    tables, sale_rows = ooc_tables(OOC_SF10)
    hash_table = hash_agg_table(OOC_HASH_ROWS, MAIN_GROUPS)
    gen_s = time.perf_counter() - t0
    ooc = session.newSession()
    ooc.conf.set("spark.sql.warehouse.dir", os.path.join(root, "wh"))
    sf10 = os.path.join(root, "sf10")
    write_ms = write_ooc_tables(ooc, tables, T, sf10)
    t0 = time.perf_counter()
    ooc.createDataFrame(hash_table).write \
        .option("rowGroupSize", OOC_BATCH) \
        .parquet(os.path.join(sf10, "hash_t"))
    write_ms["hash_t"] = (time.perf_counter() - t0) * 1e3
    read_ooc_tables(ooc, sf10)
    ooc.read.parquet(os.path.join(sf10, "hash_t")) \
        .createOrReplaceTempView("hash_t")
    print(f"[ooc] SF10 tables generated in {gen_s:.2f} s and written "
          f"by the port's writers: "
          f"{', '.join(f'{k} {v:.1f} ms' for k, v in write_ms.items())}"
          f" (store_sales {OOC_SF10['store_sales']}, store_returns "
          f"{OOC_SF10['store_returns']}, date_dim {OOC_SF10['date_dim']}"
          f" CSV, item {OOC_SF10['item']} catalog table, reason "
          f"{OOC_SF10['reason']}, hash_t {OOC_HASH_ROWS} rows)",
          flush=True)
    check(ooc.conf.get(SCAN_LIMIT_KEY) == OOC_BATCH,
          "[ooc] the session is not at the default scan batch")

    # 2. the oracles, in numpy over the generated arrays
    t0 = time.perf_counter()
    want = {"a": [tuple(x) for x in hash_agg_oracle(hash_table)],
            "b": q3_oracle(tables),
            "c": q93_oracle(tables, sale_rows),
            "d": topk_oracle(tables)}
    print(f"[ooc] numpy oracles in {time.perf_counter() - t0:.2f} s",
          flush=True)

    def rows_a(df):
        return sorted(tuple(r) for r in df.collect())

    def rows_b(df):
        return [(y, bi, bn, float(s)) for y, bi, bn, s in df.collect()]

    def rows_c(df):
        return [(int(c), float(s)) for c, s in df.collect()]

    def rows_d(df):
        b = df._execute()
        n = int(b.num_rows())
        return np.stack([v.data[:n].cpu().numpy().astype(np.int64)
                         for v in b.vectors], axis=1)

    def ok_q93(got, want_c):
        """Customers and their order exactly, each sum within rtol
        1e-9 of the oracle's exact cents."""
        return [g[0] for g in got] == [w[0] for w in want_c] and all(
            abs(g[1] * 100 - w[1]) <= 1e-9 * max(abs(w[1]), 1)
            for g, w in zip(got, want_c))

    texts = {
        "a": ("hash-agg (multi-batch runner, DPartialAggregate)",
              HASH_AGG_SQL, rows_a, lambda g: g == want["a"]),
        "b": ("TPC-DS q3 (stage DAG: date_dim and item broadcast into "
              "the step)", Q3_SQL, rows_b, lambda g: g == want["b"]),
        "c": ("TPC-DS q93 (stage DAG: grace join of store_sales and "
              "store_returns)", Q93_SQL, rows_c,
              lambda g: ok_q93(g, want["c"])),
        "d": ("top-k ORDER BY ... LIMIT 1000 (multi-batch runner)",
              OOC_TOPK_SQL, rows_d,
              lambda g: np.array_equal(g, want["d"])),
    }
    clear_stage_cache()
    numbers = {}
    step_s = {"tables": gen_s + sum(write_ms.values()) / 1e3}
    k1_stream = None
    for key, (name, sql, rows, ok) in texts.items():
        t_text = time.perf_counter()
        df = ooc.sql(sql)
        runs = []
        for i in range(1 + OOC_WARM[key]):
            zero_counts()
            box = []

            def one_run():
                box.append(_ooc_run(ooc, lambda: rows(df)))
            if i < OOC_WARM[key]:
                one_run()
            else:
                prof = profile_query(f"ooc ({key}) warm", one_run,
                                     cpu=False)
            got, m = box[0]
            if key == "a" and i == 0:
                k1_stream = cuda_agg.LAUNCHES
            check(ok(got), f"[ooc] ({key}) {name} differs from its "
                  f"numpy oracle (run {i})")
            runs.append(m)
        step_s[key] = time.perf_counter() - t_text
        extra = ""
        if key == "c":
            c = runs[1]
            extra = (f"; grace joins {c['grace_joins']}, buckets "
                     f"{c['buckets']}, {c['bucket_rows']} rows / "
                     f"{c['bucket_bytes']} B bucketed, "
                     f"{c['bucket_spill_bytes']} B spilled")
            check(c["grace_joins"] == 1, f"[ooc] (c) made "
                  f"{c['grace_joins']} grace joins, expected 1")
        numbers[key] = _ooc_report(key, name, runs, prof, extra)
        numbers[key]["runs"] = runs
        n = numbers[key]
        check(n["warm_builds"] == 0 and n["warm_misses"] == 0,
              f"[ooc] ({key}) warm runs built {n['warm_builds']} graphs "
              f"with {n['warm_misses']} guard misses")
        check(n["batches"] >= OOC_SF10["store_sales"] // OOC_BATCH
              if key != "a" else n["batches"] == OOC_HASH_ROWS
              // OOC_BATCH, f"[ooc] ({key}) {n['batches']} batches")
    check(k1_stream == 0, f"[ooc] (a) streamed launched K1 "
          f"{k1_stream} times: the per-batch aggregate is the sort-based "
          "partial")

    # (d) without its LIMIT: sorted runs spilled to disk, merged
    t_step = time.perf_counter()
    ooc.conf.set("spark.tpu.spill.hostMemoryRows", str(OOC_SPILL_ROWS))
    try:
        sort_df = ooc.sql(OOC_SORT_SQL)
        full, m = _ooc_run(ooc, lambda: rows_d(sort_df))
    finally:
        ooc.conf.unset("spark.tpu.spill.hostMemoryRows")
    why = sorted_run_mismatch(tables, full[:, 0], full[:, 1], full[:, 2])
    check(why is None, f"[ooc] (d) full sort: {why}")
    check(np.array_equal(full[:1000], want["d"]),
          "[ooc] (d) the full sort's first 1000 rows differ from the "
          "top-k")
    check(m["spill_files"] > 0, "[ooc] (d) the full sort spilled "
          "nothing")
    numbers["d_sort"] = m
    step_s["d full sort"] = time.perf_counter() - t_step
    print(f"[ooc] (d) full sort (no LIMIT, hostMemoryRows "
          f"{OOC_SPILL_ROWS}): {len(full)} rows, sorted and every row "
          f"of store_sales once, its first 1000 the top-k's; wall "
          f"{m['wall_ms']:.2f} ms (decode {m['decode_ms']:.2f}, "
          f"{m['batches']} batches, step dispatch {m['step_ms']:.2f}, "
          f"read-backs {m['readback_ms']:.2f}, merge "
          f"{m['merge_ms']:.2f} ms); {m['spill_files']} spill files, "
          f"{m['spill_bytes']} B; peak device bytes {m['peak_bytes']}",
          flush=True)
    del full

    # 3. (a) and (b) as one batch each, against the streamed answers
    t_step = time.perf_counter()
    one = ooc.newSession()
    one.conf.set(SCAN_LIMIT_KEY, str(OOC_ONE_BATCH))
    for name in ("hash_t", "store_sales", "date_dim", "item"):
        if name != "item":
            one.catalog.register(name, ooc.catalog.lookup(name))
    k1_one = None
    for key in ("a", "b"):
        name, sql, rows, ok = texts[key]
        clear_stage_cache()
        zero_counts()
        got, m = _ooc_run(one, lambda: rows(one.sql(sql)))
        if key == "a":
            k1_one = cuda_agg.LAUNCHES
        check(ok(got) and m["batches"] == 0,
              f"[ooc] ({key}) one batch of {OOC_ONE_BATCH} rows differs "
              f"from the streamed run (or streamed: {m['batches']})")
        streamed_peak = numbers[key]["cold_peak"]
        check(streamed_peak * 4 < m["peak_bytes"],
              f"[ooc] ({key}) streamed peak {streamed_peak} B is not "
              f"below a quarter of the one-batch peak "
              f"{m['peak_bytes']} B")
        numbers[key]["one_batch"] = m
        print(f"[ooc] ({key}) one batch ({SCAN_LIMIT_KEY} "
              f"{OOC_ONE_BATCH}): equal to the streamed answer; cold "
              f"wall {m['wall_ms']:.2f} ms, peak device bytes "
              f"{m['peak_bytes']} (streamed {streamed_peak}, "
              f"{streamed_peak / m['peak_bytes']:.1%})"
              + (f"; K1 launches {k1_one}" if key == "a" else ""),
              flush=True)
    b_peak = numbers["b"]["one_batch"]["peak_bytes"]
    for key, peak in (("c", numbers["c"]["cold_peak"]),
                      ("d", numbers["d"]["cold_peak"]),
                      ("d full sort", numbers["d_sort"]["peak_bytes"])):
        check(peak < b_peak, f"[ooc] ({key}) peak {peak} B is not below "
              f"(b)'s one-batch peak {b_peak} B")
    for entry in k1_entries:
        entry["ooc_launches"] = k1_one if \
            entry["name"] == "grouped_accumulate_columns" else 0
    del one
    step_s["one batch"] = time.perf_counter() - t_step

    # 4. (b) through the SQL server: the second POST a plan-cache hit
    t_step = time.perf_counter()
    srv = SQLServer(ooc, host="127.0.0.1", port=0, workers=2).start()
    try:
        status, body, _ms = _http(srv.port, "/session", "POST")
        check(status == 200, f"[ooc] POST /session: {status}")
        sid = body["sessionId"]
        _share_root(ooc, srv._sessions[sid].session)
        post = {"query": Q3_SQL, "session": sid}
        replies = [_http(srv.port, "/sql", "POST", post)
                   for _ in range(2)]
        kinds = dict(srv._plan_cache.stats())
    finally:
        srv.stop()
    for status, body, _ms in replies:
        check(status == 200 and body["rows"] == _json_rows(want["b"]),
              f"[ooc] (b) over HTTP: {status}")
    check(not replies[0][1]["cacheHit"] and replies[1][1]["cacheHit"],
          "[ooc] (b)'s second POST is not a plan-cache hit")
    check(kinds["stage_hits"] >= 1, f"[ooc] server plan cache {kinds}")
    print(f"[ooc] (b) POSTed twice to the SQL server over the files: "
          f"equal to the oracle, the second a plan-cache hit through "
          f"run_staged('stages') (stage hits {kinds['stage_hits']}); "
          f"HTTP walls {replies[0][2]:.2f}, {replies[1][2]:.2f} ms",
          flush=True)

    step_s["server"] = time.perf_counter() - t_step

    # 5. (a) and (c) at 4 shards, SF1 row counts, 2^18-row batches
    t_step = time.perf_counter()
    del tables, sale_rows, hash_table
    t1, rows1 = ooc_tables(OOC_SF1, seed=19)
    hash1 = hash_agg_table(MAIN_N, MAIN_GROUPS)
    mesh = session.newSession()
    mesh.conf.set("spark.sql.warehouse.dir",
                  os.path.join(root, "wh1"))
    sf1 = os.path.join(root, "sf1")
    write_ooc_tables(mesh, t1, T, sf1)
    mesh.createDataFrame(hash1).write.parquet(os.path.join(sf1, "hash_t"))
    read_ooc_tables(mesh, sf1)
    mesh.read.parquet(os.path.join(sf1, "hash_t")) \
        .createOrReplaceTempView("hash_t")
    mesh.conf.set(SCAN_LIMIT_KEY, str(OOC_MESH_BATCH))
    _mesh(mesh, MESH_SHARDS)
    want_q93 = q93_oracle(t1, rows1)

    # record every K2 call of the two runs that runs at once, its output
    # included (the spy only passes the call on: the count rises inside
    # the wrapper); a call made while a graph is captured runs nothing
    # then, and its replays never reach the wrapper
    captured = []
    launch = cuda_a2a.all_to_all

    def spy(planes, gather=False):
        out = launch(planes, gather)
        if not torch.cuda.is_current_stream_capturing():
            captured.append((key, [list(p) for p in planes], gather, out))
        return out
    k2, eager = {}, {}
    cuda_a2a.all_to_all = spy
    try:
        for key, sql, rows, ok in (
                ("a", HASH_AGG_SQL, rows_a,
                 lambda g: g == [tuple(x) for x in
                                 hash_agg_oracle(hash1)]),
                ("c", Q93_SQL, rows_c, lambda g: ok_q93(g, want_q93))):
            zero_counts()
            got, m = _ooc_run(mesh, lambda: rows(mesh.sql(sql)))
            k2[key] = k2_runs()
            eager[key] = cuda_a2a.LAUNCHES - cuda_a2a.CAPTURED_LAUNCHES
            check(ok(got) and m["batches"] > 0, f"[ooc] ({key}) at "
                  f"{MESH_SHARDS} shards differs from its oracle")
            print(f"[ooc] ({key}) at {MESH_SHARDS} shards, SF1 row "
                  f"counts, {OOC_MESH_BATCH}-row batches: equal to its "
                  f"oracle; wall {m['wall_ms']:.2f} ms, {m['batches']} "
                  f"batches, grace joins {m['grace_joins']}, K2 launches "
                  f"{k2[key]} (captured {cuda_a2a.CAPTURED_LAUNCHES}, "
                  f"replayed {cuda_a2a.REPLAYED_LAUNCHES}), graph builds "
                  f"{m['builds']}", flush=True)
    finally:
        cuda_a2a.all_to_all = launch
    check(k2["c"] >= 1, f"[ooc] (c) at {MESH_SHARDS} shards launched K2 "
          f"{k2['c']} times")
    check(len(captured) == eager["a"] + eager["c"], f"[ooc] the spy saw "
          f"{len(captured)} K2 calls, the counts {eager} outside a capture "
          f"({k2} with the replays)")
    for i, (key, planes, gather, out) in enumerate(captured):
        plain = cuda_a2a.all_to_all_plain(planes, gather)
        check(len(out) == len(plain) and all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(out, plain)),
            f"[ooc] ({key}) at {MESH_SHARDS} shards: K2 call {i} "
            f"differs from its plain version ({_a2a_desc(planes, gather)})")
    print(f"[ooc] K2 at {MESH_SHARDS} shards: all {len(captured)} calls "
          f"of (a) and (c) outside a capture bit-exact against "
          f"all_to_all_plain on their own planes; K2 runs with the "
          f"replays {k2}", flush=True)
    del captured
    k2_entry["ooc_launches"] = k2["c"]
    k2_entry["ooc_launches_hash_agg"] = k2["a"]
    step_s["4 shards"] = time.perf_counter() - t_step
    print(f"[ooc] step seconds: "
          f"{', '.join(f'{k} {v:.2f}' for k, v in step_s.items())}",
          flush=True)
    print(f"[ooc] phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {"numbers": numbers, "session": ooc, "sf10": sf10,
            "want_q3": want["b"]}


# ---------------------------------------------------------------------------
# [cache]: cached relations, checkpoints and the C++ sketches
# ---------------------------------------------------------------------------

#: [cache] (c): the pressure session's budget above what it must hold
CACHE_BUDGET_MARGIN = 1 << 20


def _timed(fn):
    """(fn's result, its wall ms, synchronized)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _substituted(session, df):
    """Whether the analyzed plan of ``df`` reads a cached relation."""
    from spark_tpu_torch.sql import logical as L
    from spark_tpu_torch.sql.planner import QueryExecution

    def walk(node):
        return isinstance(node, L.CachedRelation) or any(
            walk(c) for c in node.children)
    return walk(QueryExecution(session, df._plan).analyzed)


def _cache_views(session, hash_table, tables):
    """hash_t and q3's tables as temp views of ``session``.  hash_t and
    store_sales are projections (a LocalRelation itself is never
    substituted): the DataFrames to cache are returned."""
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import Q3_SCHEMAS

    def frame(name):
        schema = T.StructType([T.StructField(c, T.type_for_name(t))
                               for c, t in Q3_SCHEMAS[name]])
        return session.createDataFrame(tables[name], schema=schema)
    hash_df = session.createDataFrame(hash_table).select("k", "v")
    ss = frame("store_sales").select(
        *[c for c, _t in Q3_SCHEMAS["store_sales"]])
    hash_df.createOrReplaceTempView("hash_t")
    ss.createOrReplaceTempView("store_sales")
    frame("date_dim").createOrReplaceTempView("date_dim")
    frame("item").createOrReplaceTempView("item")
    return hash_df, ss


def phase_cache(session, hash_table, tables, k1_entries, k2_entry, ooc,
                root):
    """Cached relations on the card (see the module's docstring, 15):
    (a) DEVICE at SF1, K1 and K2 on the cached path; (b) HOST and
    HOST_COMPRESSED; (c) demotion and promotion under a small budget;
    (d) [ooc]'s SF10 store_sales cached on the card; (e) checkpoints;
    (f) the C++ sketches against their numpy plain versions."""
    import numpy as np
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch.memory import HBM_BUDGET
    from spark_tpu_torch.native import build as native_build
    from spark_tpu_torch.native import sketch as SK
    from spark_tpu_torch.sql import logical as L
    from spark_tpu_torch.sql.planner import (QueryExecution,
                                             _plan_reserve_bytes)
    from spark_tpu_torch.sql.session import SparkSession
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SCHEMAS, Q3_SQL,
                                         hash_agg_oracle, q3_oracle)

    t_phase = time.perf_counter()
    step_s = {}
    want = {"hash-agg": [tuple(x) for x in hash_agg_oracle(hash_table)],
            "q3": q3_oracle(tables)}

    def rows(name, df):
        got = [tuple(r) for r in df.collect()]
        return sorted(got) if name == "hash-agg" else got

    def entry(sess, df):
        return sess.cacheManager._entries[df._cached]

    # (a) DEVICE at SF1: hash_t and q3's store_sales projection
    t_step = time.perf_counter()
    u = session.newSession()            # the uncached runs
    _cache_views(u, hash_table, tables)
    c = session.newSession()
    hash_src, ss_src = _cache_views(c, hash_table, tables)
    texts = {"hash-agg": HASH_AGG_SQL, "q3": Q3_SQL}
    dfs = {n: c.sql(t) for n, t in texts.items()}
    udfs = {n: u.sql(t) for n, t in texts.items()}
    for name, df in udfs.items():
        check(rows(name, df) == want[name],
              f"[cache] (a) uncached {name} differs from its oracle")
    clear_stage_cache()          # every graph over the cache built anew
    put_ms = {}
    for name, src in (("hash_t", hash_src), ("store_sales", ss_src)):
        _, put_ms[name] = _timed(src.cache)
        check(entry(c, src).level == "DEVICE",
              f"[cache] (a) {name} is {entry(c, src).level}, not DEVICE")
    sizes = {"hash_t": entry(c, hash_src).nbytes,
             "store_sales": entry(c, ss_src).nbytes}
    for name, df in dfs.items():
        check(_substituted(c, df), f"[cache] (a) {name}'s plan reads no "
              "cached relation")
    # the main path's run over the cache: counts zeroed just before
    captured = []
    launch = cuda_agg.grouped_accumulate_columns

    def spy(bucket32, planes, n_active, B):
        captured.append((bucket32, list(planes), n_active, B))
        return launch(bucket32, planes, n_active, B)
    zero_counts()
    cuda_agg.grouped_accumulate_columns = spy
    try:
        got, first_ms = _timed(lambda: rows("hash-agg", dfs["hash-agg"]))
    finally:
        cuda_agg.grouped_accumulate_columns = launch
    k1_cache = dict(cuda_agg.ENTRY_LAUNCHES)
    check(got == want["hash-agg"], "[cache] (a) hash-agg over the cached "
          "hash_t differs from its oracle")
    check(k1_cache == {"grouped_accumulate": 0,
                       "grouped_accumulate_columns": 2},
          f"[cache] (a) K1 launches {k1_cache} in the first run over the "
          "cache, expected 2 through the columns entry (warm-up, capture)")
    for e in k1_entries:
        e["cache_launches"] = k1_cache[e["name"]]
    err = _check_cases("columns in", [("[cache] (a)'s cached leaf",
                                       captured[0])],
                       cuda_agg.grouped_accumulate_columns,
                       cuda_agg.grouped_accumulate_columns_plain)
    del captured
    got_q3, first_q3_ms = _timed(lambda: rows("q3", dfs["q3"]))
    check(got_q3 == want["q3"], "[cache] (a) q3 over the cached "
          "store_sales differs from its oracle")
    # working set of hash-agg over the cached hash_t beyond the relation
    # (for (c)'s budget)
    hash_reserve = _plan_reserve_bytes(
        QueryExecution(c, dfs["hash-agg"]._plan).planned)
    for df in udfs.values():       # the uncached graphs, built again
        df.collect()
    st0 = stage_cache().stats()
    walls = {}
    for name in texts:
        walls[name] = [wall_ms(udfs[name].collect),
                       wall_ms(dfs[name].collect),
                       wall_ms(dfs[name].collect),
                       wall_ms(udfs[name].collect)]
    st1 = stage_cache().stats()
    builds = st1["variants"] - st0["variants"]
    misses = st1["guard_misses"] - st0["guard_misses"]
    check(builds == 0 and misses == 0, f"[cache] (a) warm runs built "
          f"{builds} graphs with {misses} guard misses")
    print(f"[cache] (a) DEVICE at SF1: hash_t ({MAIN_N} rows, "
          f"{sizes['hash_t']} B) cached in {put_ms['hash_t']:.2f} ms, "
          f"store_sales' q3 projection ({Q3_ROWS['store_sales']} rows, "
          f"{sizes['store_sales']} B) in {put_ms['store_sales']:.2f} ms; "
          f"both plans read a cached leaf (substituted); first runs over "
          f"the cache (warm-up and capture) hash-agg {first_ms:.2f} ms, q3 "
          f"{first_q3_ms:.2f} ms; K1 launches {k1_cache} (max abs err "
          f"{err} against its plain version on the cached leaf's planes)",
          flush=True)
    for name, w in walls.items():
        print(f"[cache] (a) {name} warm walls in turns uncached, cached, "
              f"cached, uncached (median of 5 each): "
              f"{', '.join(f'{x:.2f}' for x in w)} ms; warm graph builds "
              f"{builds}, guard misses {misses}", flush=True)
    profile_query("cache (a) hash-agg over the cached hash_t",
                  dfs["hash-agg"].collect)
    profile_query("cache (a) q3 over the cached store_sales",
                  dfs["q3"].collect)
    # hash-agg over the cached relation at 4 shards: K2's exchange
    captured = []
    a2a = cuda_a2a.all_to_all

    def spy_a2a(planes, gather=False):
        out = a2a(planes, gather)
        if not torch.cuda.is_current_stream_capturing():
            captured.append(([list(p) for p in planes], gather, out))
        return out
    _mesh(c, MESH_SHARDS)
    zero_counts()
    cuda_a2a.all_to_all = spy_a2a
    try:
        got, mesh_ms = _timed(lambda: rows("hash-agg", dfs["hash-agg"]))
    finally:
        cuda_a2a.all_to_all = a2a
        _mesh(c, 1)
    k2_cache = k2_runs()
    k2_eager = cuda_a2a.LAUNCHES - cuda_a2a.CAPTURED_LAUNCHES
    check(got == want["hash-agg"] and k2_cache >= 1,
          f"[cache] (a) hash-agg over the cache at {MESH_SHARDS} shards: "
          f"K2 launches {k2_cache}, equal {got == want['hash-agg']}")
    check(len(captured) == k2_eager, f"[cache] the spy saw "
          f"{len(captured)} K2 calls, the count outside a capture "
          f"{k2_eager}")
    for i, (planes, gather, out) in enumerate(captured):
        plain = cuda_a2a.all_to_all_plain(planes, gather)
        check(all(g.dtype == w.dtype and torch.equal(g, w)
                  for g, w in zip(out, plain)) and len(out) == len(plain),
              f"[cache] K2 call {i} differs from its plain version "
              f"({_a2a_desc(planes, gather)})")
    del captured
    k2_entry["cache_launches"] = k2_cache
    print(f"[cache] (a) hash-agg over the cached hash_t at {MESH_SHARDS} "
          f"shards: equal to the oracle in {mesh_ms:.2f} ms, K2 launches "
          f"{k2_cache}, each bit-exact against all_to_all_plain", flush=True)
    step_s["a"] = time.perf_counter() - t_step

    # (b) HOST and HOST_COMPRESSED at SF1: the store_sales projection
    t_step = time.perf_counter()
    ss_src.unpersist()
    for level in ("HOST", "HOST_COMPRESSED"):
        _, ms = _timed(lambda: ss_src.cache(level))
        e = entry(c, ss_src)
        check(e.level == level, f"[cache] (b) store_sales is {e.level}")
        detail = ""
        if level == "HOST_COMPRESSED":
            names, cols = e.blocks[0], e.blocks[1]
            dense = sum(enc.dtype.itemsize * int(np.prod(enc.shape))
                        for enc, *_r in cols)
            detail = (f"; schemes {', '.join(f'{n} {enc.scheme}' for n, (enc, *_r) in zip(names, cols))}"
                      f"; {e.nbytes} B compressed against {dense} B dense "
                      f"({e.nbytes / dense:.1%})")
        got, first = _timed(lambda: rows("q3", dfs["q3"]))
        check(got == want["q3"], f"[cache] (b) q3 over store_sales at "
              f"{level} differs from its oracle")
        check(e.batch is not None and e.batch.is_pinned(),
              f"[cache] (b) the {level} entry is not in pinned memory")
        warm = wall_ms(dfs["q3"].collect)
        print(f"[cache] (b) store_sales at {level}: cached in {ms:.2f} ms"
              f"{detail}; q3's first run {first:.2f} ms"
              f"{' (decompress once)' if 'COMP' in level else ''}, warm "
              f"{warm:.2f} ms (median of 5; the entry stays on the host, "
              f"copied into the graph's buffers per run)", flush=True)
        ss_src.unpersist()
    step_s["b"] = time.perf_counter() - t_step

    # (c) pressure: a budget that holds store_sales' projection, or
    #     hash_t with hash-agg's working set over it, but not both
    #     relations.  Each relation is computed by (a)'s session and put
    #     under the pressure session's own plan key (what cache() does
    #     after its query: the caching query's working set, an in-memory
    #     source counted twice, would not fit this budget); the graphs
    #     are charged to (a)'s session, which built them
    t_step = time.perf_counter()
    r1, r2 = sizes["hash_t"], sizes["store_sales"]
    budget = max(r2, hash_reserve + r1) + CACHE_BUDGET_MARGIN
    check(budget < r1 + r2, f"[cache] (c) budget {budget} B holds both "
          f"relations ({r1} + {r2} B)")
    batches = {"hash_t": hash_src._execute(), "store_sales": ss_src._execute()}
    conf = session.conf_obj.clone()
    conf.set(HBM_BUDGET.key, str(budget))
    active = SparkSession._active
    p = SparkSession(conf)
    SparkSession._active = active
    srcs = dict(zip(("hash_t", "store_sales"),
                    _cache_views(p, hash_table, tables)))
    moves = []

    def move(what, fn, expect):
        out, ms = _timed(fn)
        levels = {n: p.cacheManager.level(df._cached)
                  for n, df in srcs.items() if df._cached is not None}
        check(levels == expect, f"[cache] (c) after {what}: {levels}, "
              f"expected {expect}")
        moves.append(f"{what} {ms:.2f} ms -> {levels}")
        return out

    def put(name):
        df = srcs[name]
        df._cached = L.plan_cache_key(QueryExecution(p, df._plan).analyzed)
        p.cacheManager.put(df._cached, batches[name], "DEVICE")
    hq = p.sql(HASH_AGG_SQL)
    move("cache hash_t", lambda: put("hash_t"), {"hash_t": "DEVICE"})
    move("cache store_sales", lambda: put("store_sales"),
         {"hash_t": "HOST_COMPRESSED", "store_sales": "DEVICE"})
    for what in ("hash-agg over hash_t (decompress, promote)",
                 "hash-agg again"):
        got = move(what, lambda: rows("hash-agg", hq),
                   {"hash_t": "DEVICE", "store_sales": "HOST_COMPRESSED"})
        check(got == want["hash-agg"], f"[cache] (c) {what} differs from "
              "its oracle")
    print(f"[cache] (c) budget {budget} B (hash_t {r1} B, hash-agg's "
          f"reserve over it {hash_reserve} B, store_sales {r2} B): "
          f"{'; '.join(moves)}; every answer equal to the oracle; storage "
          f"held {p.memoryManager.storage_used} B", flush=True)
    p.stop()
    check(p.memoryManager.storage_used == 0, "[cache] (c) stop() left "
          "storage charged")
    del batches
    step_s["c"] = time.perf_counter() - t_step

    # (d) [ooc]'s SF10 store_sales, projected to q3's columns, on the card
    t_step = time.perf_counter()
    src = ooc["session"]
    d = src.newSession()
    for name in ("date_dim",):
        d.catalog.register(name, src.catalog.lookup(name))
    ss10 = d.read.parquet(os.path.join(ooc["sf10"], "store_sales")).select(
        *[col for col, _t in Q3_SCHEMAS["store_sales"]])
    ss10.createOrReplaceTempView("store_sales")
    _, put10 = _timed(ss10.cache)
    e10 = entry(d, ss10)
    check(e10.level == "DEVICE", f"[cache] (d) SF10 store_sales is "
          f"{e10.level}")
    q3_10 = d.sql(Q3_SQL)
    check(_substituted(d, q3_10), "[cache] (d) q3 reads no cached relation")
    got, first10 = _timed(lambda: rows("q3", q3_10))
    check(got == ooc["want_q3"], "[cache] (d) q3 over the cached SF10 "
          "store_sales differs from [ooc]'s streamed q3")
    warm10 = wall_ms(q3_10.collect, reps=3)
    streamed = ooc["numbers"]["b"]["warm_ms"]
    print(f"[cache] (d) SF10 store_sales ({e10.batch.capacity} rows of "
          f"capacity) cached on the card in {put10:.2f} ms (one streamed "
          f"read of the parquet files), {e10.nbytes} B of device memory; "
          f"q3 over it equal to [ooc]'s streamed answer: first run "
          f"{first10:.2f} ms, warm {warm10:.2f} ms (median of 3) against "
          f"[ooc] (b)'s streamed warm {streamed:.2f} ms ({streamed / warm10:.1f}x)",
          flush=True)
    d.stop()
    step_s["d"] = time.perf_counter() - t_step

    # (e) checkpoints of q3's fact input at SF1, eager and lazy
    t_step = time.perf_counter()
    ckpt = os.path.join(root, "checkpoints")
    c.conf.set("spark.tpu.checkpoint.dir", ckpt)
    c.conf.set(SCAN_LIMIT_KEY, str(SCAN_LIMIT))
    eager, eager_ms = _timed(ss_src.checkpoint)
    check(len(os.listdir(ckpt)) == 1, "[cache] (e) the eager checkpoint "
          "wrote nothing")
    lazy = ss_src.checkpoint(eager=False)
    eager.createOrReplaceTempView("store_sales")
    got_eager, eager_q_ms = _timed(lambda: rows("q3", c.sql(Q3_SQL)))
    lazy.createOrReplaceTempView("store_sales")
    with contextlib.redirect_stdout(io.StringIO()) as shown:
        c.sql(Q3_SQL).explain()
    check("Scan" in shown.getvalue(), "[cache] (e) explain showed no plan")
    check(len(os.listdir(ckpt)) == 1, "[cache] (e) explain wrote the lazy "
          "checkpoint")
    got_lazy, lazy_q_ms = _timed(lambda: rows("q3", c.sql(Q3_SQL)))
    check(len(os.listdir(ckpt)) == 2, "[cache] (e) the lazy checkpoint "
          "was not written at its first action")
    check(got_eager == want["q3"] and got_lazy == want["q3"],
          "[cache] (e) q3 over a checkpoint differs from its oracle")
    print(f"[cache] (e) checkpoints of store_sales' q3 projection: eager "
          f"written in {eager_ms:.2f} ms, q3 over it {eager_q_ms:.2f} ms; "
          f"lazy: explain wrote nothing, q3's first action wrote it and "
          f"ran in {lazy_q_ms:.2f} ms; both equal to the oracle",
          flush=True)
    c.stop()
    u.stop()
    step_s["e"] = time.perf_counter() - t_step

    # (f) the C++ sketches over SF1's ss_item_sk
    t_step = time.perf_counter()
    items = tables["store_sales"]["ss_item_sk"]
    _, lib_ms = _timed(native_build.load_library)
    bf, bf_plain = SK.BloomFilter.create(len(items)), \
        SK.BloomFilter.create(len(items))
    cms, cms_plain = SK.CountMinSketch.create(), SK.CountMinSketch.create()
    _, bf_ms = _timed(lambda: bf.put_long(items))
    _, bfp_ms = _timed(lambda: SK.bloom_put_plain(bf_plain, items))
    _, cms_ms = _timed(lambda: cms.add_long(items))
    _, cmsp_ms = _timed(lambda: SK.cms_add_plain(cms_plain, items))
    check(np.array_equal(bf.bits, bf_plain.bits), "[cache] (f) the Bloom "
          "filter's bits differ from the numpy plain version")
    check(np.array_equal(cms.table, cms_plain.table), "[cache] (f) the "
          "count-min table differs from the numpy plain version")
    hits, probe_ms = _timed(lambda: bf.might_contain_long(items))
    check(bool(hits.all()), "[cache] (f) the Bloom filter has a false "
          "negative")
    est = cms.estimate_count(items)
    true = np.bincount(items)[items]
    check(bool((est >= true).all()), "[cache] (f) the count-min sketch "
          "under-counts")
    print(f"[cache] (f) sketches over {len(items)} ss_item_sk values (C++ "
          f"library loaded or built in {lib_ms:.1f} ms): BloomFilter "
          f"({bf.num_bits} bits, {bf.num_hashes} hashes) put {bf_ms:.2f} "
          f"ms against the numpy plain version's {bfp_ms:.2f} ms, probe "
          f"{probe_ms:.2f} ms, no false negative; CountMinSketch "
          f"({cms.depth} x {cms.width}) add {cms_ms:.2f} ms against "
          f"{cmsp_ms:.2f} ms; bits and table bit-exact", flush=True)
    step_s["f"] = time.perf_counter() - t_step
    print(f"[cache] step seconds: "
          f"{', '.join(f'{k} {v:.2f}' for k, v in step_s.items())}",
          flush=True)
    print(f"[cache] phase {time.perf_counter() - t_phase:.2f} s", flush=True)


#: the [crossproc] phase: worker processes on the card and the exchange
#: timeout they run under
CROSSPROC_WORKERS = 2
CROSSPROC_TIMEOUT_S = 120.0
#: the workers' answers without an ORDER BY: compared as multisets
CROSSPROC_UNORDERED = ("a", "e")


def _rows_match(got, want, rtol=1e-9):
    """Result rows equal: floats within ``rtol``, everything else
    exactly."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None or abs(a - b) > \
                        rtol * max(abs(a), abs(b)) + 1e-12:
                    return False
            elif a != b:
                return False
    return True


def _start_crossproc_workers(root, n):
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(n):
        log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "spark_tpu_torch.testing",
             "crossproc-worker", str(pid), str(n), root, "card",
             str(CROSSPROC_TIMEOUT_S), "cuda"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here), log))
    return procs


def phase_crossproc(session, k1_entries, k2_entry):
    """Cross-process SQL on the card (see the module's docstring, 16):
    two worker processes, each a ``cuda`` session with
    ``enableHostShuffle`` on one temporary directory, run
    ``testing.CARD_TEXTS`` over their shares of SF1 tables while this
    process answers the same texts over the whole tables; every answer
    must equal that one, every lane's counter must fire, and every K1
    launch in the workers must equal its plain version."""
    import torch
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import (CARD_TEXTS, OOC_SF1,
                                         jsonable_rows,
                                         register_card_tables)

    t_phase = time.perf_counter()
    n = CROSSPROC_WORKERS
    root = tempfile.mkdtemp(prefix="chip_smoke_crossproc_")
    procs = []
    try:
        free, _total = torch.cuda.mem_get_info()
        # each worker's device memory budget is its share of what is free
        # (the default, the card's whole memory, would let both claim it)
        budget = int(free * 0.8) // n
        spec = {"hash_rows": MAIN_N, "hash_groups": MAIN_GROUPS,
                "q3": Q3_ROWS, "ooc": OOC_SF1, "ooc_seed": 19,
                "conf": {"spark.tpu.memory.hbmBudget": str(budget)}}
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        procs = _start_crossproc_workers(root, n)
        # the single-process answers, on this process's card session,
        # while the workers run
        one = session.newSession()
        register_card_tables(one, T, spec)
        want = {key: jsonable_rows(tuple(r) for r in one.sql(sql).collect())
                for key, _what, sql, _lane, _confs in CARD_TEXTS}
        one.stop()
        answers_s = time.perf_counter() - t0
        deadline = time.monotonic() + 900
        for p, _log in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        workers_s = time.perf_counter() - t0
        results = []
        for pid, (p, log) in enumerate(procs):
            log.close()
            with open(os.path.join(root, f"log-p{pid}.txt")) as f:
                text = f.read()
            check(p.returncode == 0, f"[crossproc] worker {pid} exited "
                  f"{p.returncode}:\n{text[-4000:]}")
            with open(os.path.join(root, f"result-p{pid}.json")) as f:
                results.append(json.load(f))
        setup = ", ".join(f"{r['setup_ms']:.0f}" for r in results)
        print(f"[crossproc] {n} worker processes on the card (device "
              f"memory budget {budget} B each), {len(CARD_TEXTS)} texts "
              f"x 2 runs (cold, warm under the profiler): workers done in "
              f"{workers_s:.2f} s (setup {setup} ms); the single-process "
              f"answers took {answers_s:.2f} s beside them", flush=True)
        for key, what, _sql, lane, _confs in CARD_TEXTS:
            qs = [r["queries"][key] for r in results]
            exp = want[key]
            for pid, q in enumerate(qs):
                got = q["rows"]
                if key in CROSSPROC_UNORDERED:
                    got, exp_cmp = sorted(got), sorted(exp)
                else:
                    exp_cmp = exp
                check(_rows_match(got, exp_cmp), f"[crossproc] ({key}) "
                      f"worker {pid}'s {len(got)} rows differ from the "
                      f"single-process answer ({len(exp)} rows)")
                check(q["warm_delta"].get(lane, 0) > 0, f"[crossproc] "
                      f"({key}) worker {pid}: the {lane} counter did not "
                      f"fire ({q['warm_delta']})")
                if key == "c_spill":
                    check(q["warm_delta"].get("spill_events", 0) > 0,
                          f"[crossproc] ({key}) worker {pid} spilled "
                          "nothing")
                check(all(v >= 0 for v in q["replayed"].values()),
                      f"[crossproc] ({key}) worker {pid}: the profile saw "
                      f"fewer kernels than the wrappers launched "
                      f"({q['replayed']}, {q['k1_launches']})")
                if key == "e":
                    # the local run's first pass launches K1 (warm-up and
                    # capture), the warm run replays it
                    check(q["k1_launches"]["grouped_accumulate_columns"]
                          > 0 and q["profiled"]["k1"] > 0,
                          f"[crossproc] (e) worker {pid}: K1 launched "
                          f"{q['k1_launches']}, in the warm profile "
                          f"{q['profiled']}")
            walls = [q["wall_ms"] for q in qs]
            lanes = ", ".join(str(q["warm_delta"][lane]) for q in qs)
            print(f"[crossproc] ({key}) {what}: {len(exp)} rows, equal in "
                  f"every worker and to the single-process answer; lane "
                  f"{lane} {lanes} by worker; warm wall {max(walls):.2f} "
                  f"ms (cold {max(q['cold_ms'] for q in qs):.2f} ms)",
                  flush=True)
            for pid, q in enumerate(qs):
                sp = q["split"]
                busy = "not measured" if q["busy_ms"] is None \
                    else f"{q['busy_ms']:.3f} ms of the wall " \
                         f"({q['busy_ms'] / q['wall_ms']:.1%})"
                print(f"[crossproc]   worker {pid}: wall "
                      f"{q['wall_ms']:.2f} ms = local runs "
                      f"{sp['local_ms']:.2f}, bucketing on the card "
                      f"{sp['bucket_ms']:.3f} (device), read-back "
                      f"{sp['readback_ms']:.2f} ({int(sp['bytes_readback'])}"
                      f" B), write {sp['encode_ms'] + sp['write_ms']:.2f} "
                      f"(encode {sp['encode_ms']:.2f}, on the writer "
                      f"thread), commit wait {sp['commit_wait_ms']:.2f}, "
                      f"barrier wait {sp['barrier_ms']:.2f}, fetch and "
                      f"decode {sp['fetch_ms']:.2f} (decode "
                      f"{sp['decode_ms']:.2f}), merge {sp['merge_ms']:.2f}; "
                      f"{q['warm_delta'].get('blocks_written', 0)} blocks, "
                      f"{q['warm_delta'].get('bytes_written', 0)} B written"
                      f", {q['warm_delta'].get('spill_bytes', 0)} B "
                      f"spilled; ledger peak {q['peak_host_bytes']} B; "
                      f"card busy {busy}", flush=True)
        k1 = [r["queries"]["_k1"] for r in results]
        k1_launches = {e: sum(x["launches"][e] for x in k1)
                       for e in k1[0]["launches"]}
        k1_captured = sum(sum(x["captured"].values()) for x in k1)
        texts = [q for r in results for key, q in r["queries"].items()
                 if not key.startswith("_")]
        replayed = {kid: sum(q["replayed"].get(kid, 0) for q in texts)
                    for kid in ("k1", "k2")}
        k2_calls = sum(q["k2_launches"] for q in texts)
        check(k1_launches["grouped_accumulate_columns"] > 0,
              "[crossproc] no K1 launch in the workers")
        check(all(x["equal"] for x in k1) and sum(x["checked"] for x in k1),
              f"[crossproc] K1 differs from its plain version in a worker "
              f"({k1})")
        print(f"[crossproc] K1 in the workers (cuda_agg.ENTRY_LAUNCHES, "
              f"from 0 before each battery): {k1_launches} "
              f"({k1_captured} while a graph was captured), "
              f"{sum(x['checked'] for x in k1)} held against the plain "
              f"version on their own inputs: bit-exact (max abs err "
              f"{max(x['max_abs_err'] for x in k1)}); graph replays of K1 "
              f"in the warm runs' profiles: {replayed['k1']}; K2: "
              f"{k2_calls} launches, {replayed['k2']} replayed (no mesh in "
              "a worker)", flush=True)
        for entry in k1_entries:
            entry["crossproc_launches"] = k1_launches[entry["name"]]
            entry["crossproc_replayed_launches"] = replayed["k1"] \
                if entry["name"] == "grouped_accumulate_columns" else 0
        k2_entry["crossproc_launches"] = k2_calls
        k2_entry["crossproc_replayed_launches"] = replayed["k2"]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(root, ignore_errors=True)
    print(f"[crossproc] phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)


#: [ici]: the device tier's workers and their exchange timeout, and the
#: heartbeat of its recovery scenario (a dead peer found within ~3 s)
ICI_WORKERS = 2
ICI_TIMEOUT_S = 120.0
ICI_HEARTBEAT = {"spark.tpu.cluster.heartbeatIntervalMs": "500",
                 "spark.tpu.cluster.heartbeatTimeoutMs": "3000"}


def _start_ici_workers(root, n):
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(n):
        log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "spark_tpu_torch.testing",
             "crossproc-worker", str(pid), str(n), root, "ici-card",
             str(ICI_TIMEOUT_S), "cuda"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here), log))
    return procs


#: [ici]'s idle-peer pull: the planes of one pull, a second, large size
#: beside the battery's largest pull, and the three-sender case: three
#: slots of the peer's arena at a power-of-two capacity, each holding an
#: odd row count, as ``device_pull`` reads a domain of four processes
ICI_IDLE_PLANES = 6
ICI_IDLE_BIG_BYTES = 64 << 20
ICI_THREE_SENDERS = 3
ICI_THREE_ROWS = 1_000_003
ICI_THREE_CAP = 1 << 20


class _DevicePointer:
    """Bytes at a device address, as ``torch.as_tensor`` takes them
    (``__cuda_array_interface__``): a tensor over a peer's IPC-mapped
    arena without a copy."""

    def __init__(self, ptr, nbytes):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3}


def _pull_times(pull, library, plain, want, outs, rows, what):
    """One pull checked against the peer's bytes (``want[k]`` per plane,
    ``rows`` of each output row read), then timed: per call (two rounds),
    back to back, the kernel alone, the wrapper's host time, the plain
    version and the library call per call."""
    import torch

    def check_equal(route):
        torch.cuda.synchronize()
        for k, (o, w) in enumerate(zip(outs, want)):
            check(torch.equal(o[:, :rows].cpu(), w), f"[ici] {route} "
                  f"of {what} differs from the peer's bytes (plane {k})")
        for o in outs:
            o.fill_(-1)

    pull()
    check_equal("the pull")
    library()
    check_equal("copy_")
    t = {"ms": min(cuda_ms(pull), cuda_ms(pull)),
         "b2b_ms": cuda_ms_back_to_back(pull),
         "alone_ms": kernel_device_ms(pull, "pull_kernel", reps=20),
         "host_ms": host_ms(pull), "library_ms": cuda_ms(library),
         "plain_ms": cuda_ms(plain)}
    pull()
    check_equal("the timed pull")
    return t


def _ici_idle_pull(k2_entry, sizes):
    """K2's cross-process pull with the peer process IDLE (it holds its
    arena and runs nothing: ``testing arena-peer``), beside the library
    call that computes the same pull, one ``torch.Tensor.copy_`` per
    (plane, sender) block from a tensor over the peer's IPC-mapped arena
    into the receiver's buffer; both equal to the peer's bytes.  At
    ``sizes`` with one sender, then with three senders of
    ``ICI_THREE_ROWS`` int64 rows each (no byte loop: rows padded to 16
    bytes, slots at a power-of-two capacity).  Each timed by
    ``_pull_times``.  Fills the pull fields of ``k2_entry`` and returns
    the pull kernel's entry for the kernels line."""
    import numpy as np
    import torch
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch.parallel.ici import _padded_rows
    from spark_tpu_torch.testing import arena_pattern
    dev = torch.device("cuda")
    align = 8 * ICI_IDLE_PLANES
    sizes = [max(align, -(-n // align) * align) for n in sizes]
    three_slot = ICI_THREE_CAP * 8
    arena_bytes = max(max(sizes),
                      ICI_IDLE_PLANES * ICI_THREE_SENDERS * three_slot)
    root = tempfile.mkdtemp(prefix="chip_smoke_arena_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) \
        + os.pathsep + env.get("PYTHONPATH", "")
    log = open(os.path.join(root, "peer.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_tpu_torch.testing", "arena-peer",
         root, str(arena_bytes)], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    base = None
    t0 = time.perf_counter()
    try:
        _wait_for(lambda: os.path.exists(os.path.join(root, "arena.json"))
                  or proc.poll() is not None, "[ici] the arena peer", 120)
        check(proc.poll() is None, "[ici] the arena peer exited: "
              + open(os.path.join(root, "peer.txt")).read()[-2000:])
        with open(os.path.join(root, "arena.json")) as f:
            base = cuda_a2a.open_handle(dev, json.load(f)["handle"])
        full = arena_pattern(arena_bytes)
        rows = []
        for nbytes in sizes + [None]:
            n_src = 1 if nbytes else ICI_THREE_SENDERS
            width = nbytes // ICI_IDLE_PLANES // 8 if nbytes \
                else ICI_THREE_ROWS
            slot = width * 8 if nbytes else three_slot
            offs = [[(k * n_src + s) * slot for s in range(n_src)]
                    for k in range(ICI_IDLE_PLANES)]
            sources = [[base + o for o in per] for per in offs]
            outs = [torch.empty((n_src, _padded_rows(width, 8)),
                                dtype=torch.int64, device=dev)
                    for _ in range(ICI_IDLE_PLANES)]
            views = [[torch.as_tensor(_DevicePointer(a, width * 8),
                                      device=dev).view(torch.int64)
                      for a in per] for per in sources]
            want = [torch.from_numpy(np.stack(
                [full[o:o + width * 8].view(np.int64) for o in per]))
                for per in offs]

            def pull():
                cuda_a2a.pull(sources, outs, [width * 8] * ICI_IDLE_PLANES)

            def library():
                for o, vs in zip(outs, views):
                    for s, v in enumerate(vs):
                        o[s, :width].copy_(v)

            def plain():
                cuda_a2a.pull_plain(views)

            moved = ICI_IDLE_PLANES * n_src * width * 8
            what = f"{moved:,} B from {n_src} sender(s)"
            t = _pull_times(pull, library, plain, want, outs, width, what)
            t.update(bytes=moved, senders=n_src,
                     bound_ms=2 * moved / HBM_BYTES_PER_S * 1e3)
            rows.append(t)
            print(f"[ici] idle-peer pull of {what} ({ICI_IDLE_PLANES} "
                  f"int64 planes of {width:,} rows, output rows padded to "
                  f"16 B): cuda_a2a.pull {t['ms']:.4f} ms per call (CUDA "
                  f"events, the better of two rounds), {t['b2b_ms']:.4f} "
                  f"back to back, {t['alone_ms']:.4f} alone (profiler), "
                  f"wrapper host {t['host_ms']:.4f} ms; the library call "
                  f"(torch.Tensor.copy_ per block from the IPC-mapped "
                  f"arena) {t['library_ms']:.4f} ms; plain version "
                  f"{t['plain_ms']:.4f} ms; byte bound {t['bound_ms']:.4f} "
                  f"ms ({100 * t['bound_ms'] / t['alone_ms']:.1f}% of it "
                  f"alone); all equal to the peer's bytes", flush=True)
        one, three = rows[0], rows[-1]
        k2_entry["ici_pull_idle_ms"] = one["ms"]
        k2_entry["ici_pull_idle_bytes"] = one["bytes"]
        k2_entry["ici_pull_library_ms"] = one["library_ms"]
        k2_entry["ici_pull_library_call"] = \
            "torch.Tensor.copy_ per plane from the IPC-mapped arena"
        k2_entry["ici_pull_alone_ms"] = one["alone_ms"]
        k2_entry["ici_pull_b2b_ms"] = one["b2b_ms"]
        k2_entry["ici_pull_host_ms"] = one["host_ms"]
        k2_entry["ici_pull_idle_large"] = rows[-2]
        k2_entry["ici_pull_three_senders_ms"] = three["ms"]
        k2_entry["ici_pull_three_senders"] = three
        print(f"[ici] idle-peer pulls in {time.perf_counter() - t0:.2f} s",
              flush=True)
        return {"name": "pull", "route": "cuda",
                "source": "spark_tpu_torch/csrc/all_to_all.cu",
                "replaces": "spark_tpu/parallel/ici.py:352",
                "max_abs_err": 0, "ms": one["ms"],
                "ms_back_to_back": one["b2b_ms"],
                "kernel_alone_ms": one["alone_ms"],
                "host_ms": one["host_ms"], "plain_ms": one["plain_ms"],
                "bound_ms": one["bound_ms"], "bound_by": "bytes",
                "library_ms": one["library_ms"], "bytes": one["bytes"],
                "large": rows[-2], "three_senders": three}
    finally:
        if base is not None:
            cuda_a2a.close_handle(dev, base)
        open(os.path.join(root, "done"), "w").close()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(root, ignore_errors=True)


def _ici_recovery(session, spec, want_q93):
    """[ici]'s fault scenario: two ``cuda`` workers (recovery-worker mode
    ``card-ici``: q93's hash lane over parquet halves, the device tier by
    the auto probe) run the text twice, then process 1 dies at the device
    tier's copy point of the faulted statement's left exchange; process 0
    must recover in an epoch to the single-process answer, its ledger at
    0 B."""
    import threading
    from spark_tpu_torch.parallel.faults import FaultPlan as P
    from spark_tpu_torch.testing import _scenario, check_scenario, \
        run_scenario
    root = tempfile.mkdtemp(prefix="chip_smoke_ici_recover_")
    try:
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(dict(spec, heartbeat=ICI_HEARTBEAT), f)
        sc = _scenario("ici-die", "recovery-worker", "card-ici", 2,
                       ICI_TIMEOUT_S,
                       {1: lambda: P().die_mid_device_copy("xq000003-jL")},
                       {0: "OK", 1: "DIED"})
        box = {}
        runner = threading.Thread(target=lambda: box.update(
            out=run_scenario(sc, root, "cuda", deadline_s=600)))
        runner.start()
        runner.join()
        results, elapsed = box["out"]
        bad = check_scenario(sc, results, elapsed)
        check(not bad, f"[ici] (recovery) {bad}: " + " | ".join(
            out[-3000:] for _rc, out in results.values()))
        check("dying mid device copy in 'xq000003-jL'" in results[1][1],
              "[ici] (recovery) process 1 did not die at the copy point")
        with open(os.path.join(root, "result-p0.json")) as f:
            r = json.load(f)
        with open(os.path.join(root, "died-p1")) as f:
            died_at = float(f.read())
        rec, c = r["recovery"], r["counters"]
        check(_rows_match(r["rows"], want_q93), f"[ici] (recovery) process "
              f"0's {len(r['rows'])} rows differ from the single-process "
              f"answer ({len(want_q93)} rows)")
        check(r["ledger_used"] == 0, f"[ici] (recovery) the ledger holds "
              f"{r['ledger_used']} B after the statement")
        check(c["stage_retries"] == 1 and r["gauges"]["epoch"] == 1,
              f"[ici] (recovery) no recovery epoch: {c}")
        detect = ((rec["failed_at"] - died_at) * 1e3
                  if rec["failed_at"] else float("nan"))
        print(f"[ici] (recovery) q93's hash lane on the device tier, "
              f"process 1 dies at the copy point of its left exchange "
              f"(spans packed, no arena or sidecar written): process 0 "
              f"sees the death at the commit barrier {detect:.1f} ms after "
              f"it (heartbeat "
              f"{ICI_HEARTBEAT['spark.tpu.cluster.heartbeatTimeoutMs']} ms)"
              f", recovery round {rec['round_ms']:.2f} ms, re-read "
              f"{rec['adopt_ms']:.2f} ms, re-executed epoch "
              f"{rec['rerun_ms']:.2f} ms; {len(r['rows'])} rows equal to the"
              f" single-process answer; faulted wall {r['wall_ms']:.2f} ms "
              f"beside the warm {r['warm_ms']:.2f} ms; ledger 0 B after",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_ici(session, k2_entry):
    """The cross-process device tier on the card (see the module's
    docstring, 17): two ``cuda`` workers share the card as in
    [crossproc] and run ``testing._ici_card_battery``; every answer must
    equal this process's single-process answer, q93's join sides take
    the device tier (K2 pulls across processes, each held bit-exact
    against its plain version), q3's string sides stay on the host tier,
    run codes fire on the host tier, a one-sided ``ici_unavailable``
    folds back in worker 1 only, and a death at the copy point is
    recovered.  Returns the pull kernel's entry for the kernels line
    (``_ici_idle_pull``), its launches those of the workers' batteries."""
    import torch
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import (CARD_TEXTS, ICI_CARD_KEYS,
                                         ICI_RUN_COUNTERS, OOC_SF1,
                                         jsonable_rows,
                                         register_card_tables)

    t_phase = time.perf_counter()
    n = ICI_WORKERS
    pull_entry = None
    root = tempfile.mkdtemp(prefix="chip_smoke_ici_")
    procs = []
    texts = {k: (what, sql, lane) for k, what, sql, lane, _c in CARD_TEXTS
             if k in ICI_CARD_KEYS}
    try:
        free, _total = torch.cuda.mem_get_info()
        budget = int(free * 0.8) // n
        spec = {"hash_rows": MAIN_N, "hash_groups": MAIN_GROUPS,
                "q3": Q3_ROWS, "ooc": OOC_SF1, "ooc_seed": 19,
                "conf": {"spark.tpu.memory.hbmBudget": str(budget)}}
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        procs = _start_ici_workers(root, n)
        one = session.newSession()
        register_card_tables(one, T, spec)
        want = {k: jsonable_rows(tuple(r) for r in one.sql(sql).collect())
                for k, (_w, sql, _l) in texts.items()}
        one.stop()
        deadline = time.monotonic() + 900
        for p, _log in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        workers_s = time.perf_counter() - t0
        results = []
        for pid, (p, log) in enumerate(procs):
            log.close()
            with open(os.path.join(root, f"log-p{pid}.txt")) as f:
                text = f.read()
            check(p.returncode == 0, f"[ici] worker {pid} exited "
                  f"{p.returncode}:\n{text[-4000:]}")
            with open(os.path.join(root, f"result-p{pid}.json")) as f:
                results.append(json.load(f))
        print(f"[ici] {n} worker processes on the card (device memory "
              f"budget {budget} B each), spark.tpu.shuffle.ici.enabled by "
              f"the auto probe (both on one card: one domain): workers done "
              f"in {workers_s:.2f} s", flush=True)
        qs = [r["queries"] for r in results]
        for pid, r in enumerate(results):
            check(r["counters"]["tier_split_peers"] == 1, f"[ici] worker "
                  f"{pid}: tier_split_peers {r['counters']['tier_split_peers']}")
        pulls_bytes, pulls_ms = [], []
        for key, (what, _sql, lane) in texts.items():
            device_side = key != "b"
            for pid, q in enumerate(qs):
                runs = [q[key]["cold"]] + q[key]["warm"]
                for i, run in enumerate(runs):
                    check(_rows_match(run["rows"], want[key]),
                          f"[ici] ({key}) worker {pid} run {i} "
                          f"({'device' if run['tier'] else 'host'} tier): "
                          f"{len(run['rows'])} rows differ from the "
                          f"single-process answer ({len(want[key])})")
                    d = run["delta"]
                    check(d.get(lane, 0) > 0, f"[ici] ({key}) worker {pid}"
                          f" run {i}: the {lane} counter did not fire ({d})")
                    check(d.get("dcn_fallback_exchanges", 0) == 0,
                          f"[ici] ({key}) worker {pid} run {i}: a fold-back "
                          f"with no fault injected ({d})")
                    if run["tier"] and device_side:
                        check(d.get("ici_exchanges", 0) >= 2
                              and d.get("ici_pulls", 0) >= 1
                              and run["pull_launches"] >= 1,
                              f"[ici] ({key}) worker {pid} run {i}: the "
                              f"join sides did not take the device tier "
                              f"({d}, {run['pull_launches']} pulls)")
                    else:
                        check(d.get("ici_exchanges", 0) == 0
                              and run["pull_launches"] == 0,
                              f"[ici] ({key}) worker {pid} run {i}: device "
                              f"tier used where the host tier was due ({d})")
            dev = [q[key]["warm"][j] for q in qs for j in (0, 3)]
            host = [q[key]["warm"][j] for q in qs for j in (1, 2)]

            def wall(rs):
                return max(r["wall_ms"] for r in rs)
            line = (f"[ici] ({key}) {what}: {len(want[key])} rows, equal in "
                    f"every run of every worker and to the single-process "
                    f"answer; warm wall (the slower worker, in turns "
                    f"device, host, host, device) device tier "
                    f"{qs[0][key]['warm'][0]['wall_ms']:.2f}/"
                    f"{qs[1][key]['warm'][0]['wall_ms']:.2f}, "
                    f"{qs[0][key]['warm'][3]['wall_ms']:.2f}/"
                    f"{qs[1][key]['warm'][3]['wall_ms']:.2f} ms, host tier "
                    f"{qs[0][key]['warm'][1]['wall_ms']:.2f}/"
                    f"{qs[1][key]['warm'][1]['wall_ms']:.2f}, "
                    f"{qs[0][key]['warm'][2]['wall_ms']:.2f}/"
                    f"{qs[1][key]['warm'][2]['wall_ms']:.2f} ms (max device "
                    f"{wall(dev):.2f}, max host {wall(host):.2f})")
            if not device_side:
                line += ("; its string sides stay on the host tier "
                         "(ici_exchanges 0, no fold-back)")
            print(line, flush=True)
            if not device_side:
                continue
            for pid, q in enumerate(qs):
                for j in (0, 3):
                    sp = q[key]["warm"][j]["split"]
                    nbytes = int(sp["bytes_pulled"])
                    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
                    pulls_bytes.append(nbytes)
                    pulls_ms.append(sp["pull_ms"])
                    print(f"[ici]   worker {pid} device run {j}: pack "
                          f"{sp['pack_ms']:.2f} ms (host pack, copy to the "
                          f"arena, stream sync), sidecar "
                          f"{sp['sidecar_ms']:.3f}, pull {sp['pull_ms']:.4f} "
                          f"ms on the card (CUDA events, {int(sp['pulls'])} "
                          f"launch(es), {nbytes} B; bound {bound:.4f} ms: "
                          f"each byte read and written once at 3.35 TB/s), "
                          f"unpack {sp['unpack_ms']:.2f} ms", flush=True)
        for pid, q in enumerate(qs):
            ov = q["override"]
            check(_rows_match(ov["rows"], want["c_hash"])
                  and ov["delta"].get("ici_exchanges", 0) >= 2
                  and ov["delta"].get("dcn_fallback_exchanges", 0) == 0,
                  f"[ici] (override) worker {pid}: {ov['delta']}")
        print(f"[ici] (override) c_hash with tierOverride 0,1: equal, "
              f"{qs[0]['override']['delta'].get('ici_exchanges', 0)} device"
              f" sides per worker, wall "
              f"{max(q['override']['wall_ms'] for q in qs):.2f} ms",
              flush=True)
        for key in ("c_hash", "c_range"):
            rc = [q["runcodes"][key] for q in qs]
            for pid, run in enumerate(rc):
                check(_rows_match(run["rows"], want[key]), f"[ici] (runs) "
                      f"({key}) worker {pid}: rows differ")
            enc = [run["delta"].get("rle_columns_encoded", 0) for run in rc]
            # every host-tier run of the text (run codes are on by
            # default): the stage's graph is captured at the first, and a
            # plane expands inside a stage at its warm-up and capture only
            host_runs = rc + [q[key]["warm"][j] for q in qs for j in (1, 2)]
            moved = {c: sum(run["runs"][c] for run in host_runs)
                     for c in rc[0]["runs"]}
            check(sum(enc) > 0, f"[ici] (runs) ({key}): no run- or "
                  f"delta-coded column on the wire ({enc})")
            if key == "c_range":
                # presorted spans: the probe shard's runs reach the join's
                # stage as planes, which the join expands inside it (the
                # counters tests/test_torch_runs.py holds to the JAX
                # package's on this text's shape)
                for c in ICI_RUN_COUNTERS:
                    check(moved[c] > 0, f"[ici] (runs) ({key}): {c} did "
                          f"not move ({moved})")
            print(f"[ici] (runs) ({key}) host tier, "
                  f"spark.tpu.shuffle.wire.runCodes=true: equal; "
                  f"rle_columns_encoded (run or delta) {enc} by worker, "
                  f"run_bytes_saved "
                  f"{[run['delta'].get('run_bytes_saved', 0) for run in rc]}"
                  f"; run counters over both workers and all host-tier runs "
                  f"{moved}; wall {max(r['wall_ms'] for r in rc):.2f} ms",
                  flush=True)
        un = [q["unavailable"] for q in qs]
        for pid, run in enumerate(un):
            check(_rows_match(run["rows"], want["c_hash"]),
                  f"[ici] (fault) worker {pid}: rows differ")
            check(run["delta"].get("dcn_fallback_exchanges", 0)
                  == (1 if pid == 1 else 0), f"[ici] (fault) worker {pid}: "
                  f"dcn_fallback_exchanges {run['delta']}")
        print(f"[ici] (fault) ici_unavailable in worker 1 on c_hash's first "
              f"device attempt: equal in both; dcn_fallback_exchanges "
              f"{[r['delta'].get('dcn_fallback_exchanges', 0) for r in un]} "
              f"by worker, ici_exchanges "
              f"{[r['delta'].get('ici_exchanges', 0) for r in un]}; wall "
              f"{max(r['wall_ms'] for r in un):.2f} ms", flush=True)
        chk = [q["_check"] for q in qs]
        launches = sum(q["_pull_launches"] for q in qs)
        check(all(c["equal"] for c in chk) and sum(c["checked"] for c in chk)
              > 0 and not any(c.get("missing") for c in chk),
              f"[ici] K2's cross-process pulls differ from their plain "
              f"version ({chk})")
        check(launches > 0, "[ici] no cross-process K2 launch")
        max_err = max(c["max_abs_err"] for c in chk)
        print(f"[ici] K2 across processes (cuda_a2a.PULL_LAUNCHES, from 0 "
              f"before each battery): {launches} launches in the two "
              f"workers; {sum(c['checked'] for c in chk)} pulls of the cold "
              f"runs held against the plain version over the bytes each "
              f"sender packed: bit-exact (max abs err {max_err})",
              flush=True)
        k2_entry["ici_launches"] = launches
        k2_entry["ici_max_abs_err"] = max_err
        if pulls_bytes:
            i = max(range(len(pulls_bytes)), key=lambda j: pulls_bytes[j])
            k2_entry["ici_pull_bytes"] = pulls_bytes[i]
            k2_entry["ici_pull_ms"] = pulls_ms[i]
            k2_entry["ici_pull_bound_ms"] = \
                2 * pulls_bytes[i] / HBM_BYTES_PER_S * 1e3
            pull_entry = _ici_idle_pull(
                k2_entry, [pulls_bytes[i], ICI_IDLE_BIG_BYTES])
            pull_entry["launches"] = launches
            pull_entry["max_abs_err"] = max_err
        _ici_recovery(session, spec, want["c_hash"])
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(root, ignore_errors=True)
    check(pull_entry is not None, "[ici] no device-tier pull to time")
    print(f"[ici] phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return pull_entry


#: [recovery]: the exchange timeout of the workers, and the heartbeat a
#: deployment runs with (the conf's defaults, as Spark's
#: spark.executor.heartbeatInterval beside a 10 s network timeout): the
#: detection of a dead peer is the timeout
RECOVERY_TIMEOUT_S = 120.0
RECOVERY_HEARTBEAT = {"spark.tpu.cluster.heartbeatIntervalMs": "1000",
                      "spark.tpu.cluster.heartbeatTimeoutMs": "10000"}


def _recovery_scenarios():
    """(key, worker mode, what, process 1's fault plan, process 0's
    verdict) of [recovery].  The workers run the text twice without a
    fault first, so the faulted statement is ``xq000003``."""
    from spark_tpu_torch.parallel.faults import FaultPlan as P
    return [
        ("a", "card-a", "q93's join on the hash lane, process 1 dies after "
         "its put in the join's left exchange",
         lambda: P().die_after_put("xq000003-jL"), "OK"),
        ("b", "card-b", "the same with spark.tpu.recovery.maxStageRetries=0",
         lambda: P().die_after_put("xq000003-jL"), "FAILED"),
        ("c", "card-c", "q93's join with the block service on and no retry "
         "budget: process 1's right-side block to process 0 is lost, and "
         "process 1 dies after sealing its last registration",
         lambda: P().drop(exchange="xq000003-jR", receiver=0)
         .die_after_manifest("xq000003-gather"), "OK"),
        ("d", "card-d", "hash-agg over a UNION ALL of two partitioned file "
         "sets (generic lane), process 1 dies after its put of the second "
         "set", lambda: P().die_after_put("xq000003-leaf1"), "OK"),
    ]


def phase_recovery(session, k1_entries, k2_entry):
    """Lineage recovery on the card (see the module's docstring, 18): for
    each scenario two ``cuda`` workers write their contiguous halves of
    the tables to parquet and read them back, run the text without a
    fault (cold, warm), then with process 1 killed at the planned point;
    process 0 must land the single-process answer (or, without a retry
    budget, fail bounded naming host-1), its ledger back to zero, and in
    (d) K1 must launch in the re-executed epoch, bit-exact."""
    import threading

    import torch
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import (
        OOC_SF1, _card_recovery_views, _scenario, check_scenario,
        jsonable_rows, run_scenario)

    t_phase = time.perf_counter()
    free, _total = torch.cuda.mem_get_info()
    budget = int(free * 0.8) // 2
    spec = {"hash_rows": MAIN_N, "hash_groups": MAIN_GROUPS,
            "ooc": OOC_SF1, "ooc_seed": 19, "heartbeat": RECOVERY_HEARTBEAT,
            "conf": {"spark.tpu.memory.hbmBudget": str(budget)}}
    print(f"[recovery] 2 worker processes per scenario on the card (device "
          f"memory budget {budget} B each), exchange timeout "
          f"{RECOVERY_TIMEOUT_S:.0f} s, heartbeat every "
          f"{int(RECOVERY_HEARTBEAT['spark.tpu.cluster.heartbeatIntervalMs'])}"
          f" ms, a peer dead after "
          f"{int(RECOVERY_HEARTBEAT['spark.tpu.cluster.heartbeatTimeoutMs'])}"
          f" ms of silence", flush=True)
    want = {}
    k1_sum = {e["name"]: 0 for e in k1_entries}
    k2_sum = 0
    for key, mode, what, plan, verdict in _recovery_scenarios():
        root = tempfile.mkdtemp(prefix=f"chip_smoke_recovery_{key}_")
        try:
            with open(os.path.join(root, "spec.json"), "w") as f:
                json.dump(spec, f)
            sc = _scenario(key, "recovery-worker", mode, 2,
                           RECOVERY_TIMEOUT_S, {1: plan},
                           {0: verdict, 1: "DIED"})
            box = {}
            runner = threading.Thread(target=lambda: box.update(
                out=run_scenario(sc, root, "cuda", deadline_s=600)))
            runner.start()
            text_key = "union" if mode == "card-d" else "q93"
            if text_key not in want:
                # the single-process answer, on this process's card
                # session, while the workers run
                one = session.newSession()
                text, _ms = _card_recovery_views(one, T, spec, mode, root,
                                                 None, 2)
                want[text_key] = jsonable_rows(
                    tuple(r) for r in one.sql(text).collect())
                one.stop()
            runner.join()
            results, elapsed = box["out"]
            bad = check_scenario(sc, results, elapsed)
            check(not bad, f"[recovery] ({key}) {bad}: "
                  + " | ".join(out[-3000:] for _rc, out in results.values()))
            with open(os.path.join(root, "result-p0.json")) as f:
                r = json.load(f)
            with open(os.path.join(root, "died-p1")) as f:
                died_at = float(f.read())
            rec = r["recovery"]
            detect = ((rec["failed_at"] - died_at) * 1e3
                      if rec["failed_at"] else None)
            check(r["ledger_used"] == 0, f"[recovery] ({key}) the ledger "
                  f"holds {r['ledger_used']} B after the statement")
            if verdict == "FAILED":
                check(r["outcome"] == "ExchangeFetchFailed"
                      and r["lost_hosts"] == ["host-1"]
                      and r["elapsed_s"] < 2 * RECOVERY_TIMEOUT_S
                      and r["counters"]["stage_retries"] == 0,
                      f"[recovery] ({key}) not a bounded failure naming "
                      f"host-1: {r}")
                print(f"[recovery] ({key}) {what}: failed bounded with "
                      f"{r['outcome']} naming {r['lost_hosts']} after "
                      f"{r['elapsed_s'] * 1e3:.1f} ms of the statement "
                      f"(bound {2 * RECOVERY_TIMEOUT_S:.0f} s); detection "
                      f"{detect:.1f} ms after the death; stage_retries 0; "
                      f"no-fault warm wall {r['warm_ms']:.2f} ms (cold "
                      f"{r['cold_ms']:.2f}); ledger 0 B after", flush=True)
                continue
            check(_rows_match(r["rows"], want[text_key]),
                  f"[recovery] ({key}) process 0's {len(r['rows'])} rows "
                  f"differ from the single-process answer "
                  f"({len(want[text_key])} rows)")
            c = r["counters"]
            if mode == "card-c":
                check(c["stage_retries"] == 0 and r["gauges"]["epoch"] == 0
                      and c["blocks_adopted"] >= 1,
                      f"[recovery] ({key}) not adopted with zero "
                      f"re-execution: {c}")
                split = (f"no recovery epoch: {c['blocks_adopted']} block(s)"
                         f" adopted from the block service "
                         f"({c['blockserver_fallback_reads']} fallback "
                         f"read(s)), stage_retries 0, epoch 0")
            else:
                check(c["stage_retries"] == 1 and r["gauges"]["epoch"] == 1
                      and rec["epochs"] == 1,
                      f"[recovery] ({key}) no recovery epoch: {c}")
                split = (f"detection {detect:.1f} ms after the death (the "
                         f"failure {rec['fail_ms']:.1f} ms into the "
                         f"statement), recovery round "
                         f"{rec['round_ms']:.2f} ms, lost leaves re-read "
                         f"{rec['adopt_ms']:.2f} ms, re-executed epoch "
                         f"{rec['rerun_ms']:.2f} ms; stage_retries "
                         f"{c['stage_retries']}, recovered_partitions "
                         f"{c['recovered_partitions']}, epoch "
                         f"{r['gauges']['epoch']}")
            print(f"[recovery] ({key}) {what}: {len(r['rows'])} rows equal "
                  f"to the single-process answer; {split}; faulted wall "
                  f"{r['wall_ms']:.2f} ms beside the no-fault warm wall "
                  f"{r['warm_ms']:.2f} ms (cold {r['cold_ms']:.2f}); graphs "
                  f"captured in the faulted statement {r['graph_builds']} "
                  f"({r['stage_builds']} new stage entries); ledger "
                  f"0 B after; parquet written in {r['write_ms']:.0f} ms",
                  flush=True)
            k1 = r["k1"]
            for e in k1_sum:
                k1_sum[e] += k1["launches"][e]
            k2_sum += r["k2_launches"]
            check(k1["equal"], f"[recovery] ({key}) K1 differs from its "
                  f"plain version: {k1}")
            if mode == "card-d":
                check(k1["launches"]["grouped_accumulate_columns"] > 0
                      and k1["checked"] > 0,
                      f"[recovery] (d) K1 did not launch in the "
                      f"re-executed epoch: {k1}")
                print(f"[recovery] (d) K1 in process 0's re-executed epoch "
                      f"(cuda_agg.ENTRY_LAUNCHES from 0 before the faulted "
                      f"statement): {k1['launches']} ({k1['captured']} while "
                      f"a graph was captured); {k1['checked']} eager "
                      f"launch(es) held against the plain version on their "
                      f"own inputs: bit-exact (max abs err "
                      f"{k1['max_abs_err']})", flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    check(k1_sum["grouped_accumulate_columns"] > 0,
          "[recovery] no K1 launch in the survivors")
    for entry in k1_entries:
        entry["recovery_launches"] = k1_sum[entry["name"]]
    k2_entry["recovery_launches"] = k2_sum
    print(f"[recovery] K1 launches in the survivors' faulted statements: "
          f"{k1_sum}; K2: {k2_sum} (no mesh in a worker)", flush=True)
    print(f"[recovery] phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)


#: [pool]: four client threads in the burst
POOL_CLIENTS = 4


def phase_pool(session, hash_table, tables, k1_entries, k2_entry):
    """The elastic worker pool on the card (see the module's docstring,
    19): hash_t and q3's tables as catalog tables under a warehouse; a
    server without the pool answers hash-agg and q3 (the local runs);
    then a server with the pool (1 to 2 workers, each a ``cuda`` session
    with its share of the card) offloads both, and every offloaded
    statement must come back from a worker, equal to the local run, with
    K1 launched in the worker bit-exact; a burst of four clients grows
    the pool to 2 and idle rounds reap one, its lease handed over."""
    import threading

    from spark_tpu_torch import types as T
    from spark_tpu_torch.parallel.blockserver import BlockStore
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.serving.pool import KERNEL_CHECK_ENV
    from spark_tpu_torch.testing import HASH_AGG_SQL, Q3_SCHEMAS, Q3_SQL

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_pool_")
    srv = None
    try:
        s = session.newSession()
        s.conf.set("spark.sql.warehouse.dir", os.path.join(root, "wh"))
        s.conf.set(SCAN_LIMIT_KEY, str(1 << 23))    # one batch per table
        t0 = time.perf_counter()
        s.createDataFrame(hash_table).write.saveAsTable("hash_t")
        for name, cols in Q3_SCHEMAS.items():
            st = T.StructType([T.StructField(c, T.type_for_name(t))
                               for c, t in cols])
            s.createDataFrame(tables[name], schema=st).write \
                .saveAsTable(name)
        write_ms = (time.perf_counter() - t0) * 1e3
        texts = {"hash-agg": HASH_AGG_SQL, "q3": Q3_SQL}
        unordered = {"hash-agg"}

        def rows_of(key, rows):
            return sorted(rows) if key in unordered else rows

        # the local runs: the server's own session, no pool
        srv = SQLServer(s, port=0).start()
        local = {}
        for key, sql in texts.items():
            walls = []
            for _ in range(2):
                st, out, ms = _http(srv.port, "/sql", "POST",
                                    {"query": sql})
                check(st == 200 and not out.get("pooled"),
                      f"[pool] local {key}: {st} {str(out)[:300]}")
                walls.append(ms)
            local[key] = (out["rows"], walls)
        srv.stop()
        srv = None

        s.conf.set("spark.tpu.blockserver.enabled", "true")
        s.enableHostShuffle(os.path.join(root, "shuffle"), 0, 1)
        for k, v in (("enabled", "true"), ("minWorkers", "1"),
                     ("maxWorkers", "2"), ("statementsPerWorker", "2"),
                     ("scaleDownRounds", "3"), ("cooldownSeconds", "1.0"),
                     ("pollSeconds", "0.25")):
            s.conf.set(f"spark.tpu.server.pool.{k}", v)
        os.environ[KERNEL_CHECK_ENV] = "1"
        t_start = time.perf_counter()
        srv = SQLServer(s, port=0).start()
        sup = srv._pool_supervisor
        _wait_for(lambda: sup.stats()["readyMs"].get("0") is not None,
                  "[pool] the first worker's session", timeout_s=120)
        first_ready_s = time.perf_counter() - t_start
        kernels = {}
        served = 0

        def offload(key):
            nonlocal served
            st, out, ms = _http(srv.port, "/sql", "POST",
                                {"query": texts[key]})
            check(st == 200, f"[pool] {key}: {st} {str(out)[:300]}")
            check(out.get("pooled") is True,
                  f"[pool] {key} was expected to be served by a pool "
                  f"worker and ran locally (the pool's reason: "
                  f"{srv._pool_supervisor.stats().get('lastFallback')}): "
                  f"{str(out)[:300]}")
            check(_rows_match(rows_of(key, out["rows"]),
                              rows_of(key, local[key][0])),
                  f"[pool] {key}: the worker's {len(out['rows'])} rows "
                  f"differ from the local run's")
            kernels[out["poolWorker"]] = out["kernels"]
            served += 1
            return ms

        pooled = {key: [offload(key) for _ in range(2)] for key in texts}
        k1 = kernels[0]
        check(k1["launches"]["grouped_accumulate_columns"] > 0
              and k1["checked"] > 0 and k1["equal"],
              f"[pool] K1 in the worker: {k1}")
        for key in texts:
            lw, pw = local[key][1], pooled[key]
            print(f"[pool] {key}: offloaded over HTTP {pw[0]:.2f} ms cold, "
                  f"{pw[1]:.2f} ms warm, beside the server's own session "
                  f"{lw[0]:.2f} ms cold, {lw[1]:.2f} ms warm; "
                  f"{len(local[key][0])} rows equal to the local run, "
                  f"served by worker 0", flush=True)
        print(f"[pool] K1 in worker 0 (its cuda_agg.ENTRY_LAUNCHES): "
              f"{k1['launches']} ({k1['captured']} while a graph was "
              f"captured); {k1['checked']} eager launch(es) held against "
              f"the plain version: bit-exact (max abs err "
              f"{k1['max_abs_err']})", flush=True)

        # the burst: four clients until the pool holds two workers
        stop = threading.Event()
        errors = []

        def client():
            n = 0
            while n < 3 or not stop.is_set():
                try:
                    offload("hash-agg")
                except BaseException as e:   # noqa: BLE001 — reported
                    errors.append(e)
                    return
                n += 1
        threads = [threading.Thread(target=client)
                   for _ in range(POOL_CLIENTS)]
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        try:
            _wait_for(lambda: sup.live == 2 or errors,
                      "[pool] the burst to grow the pool to 2", 120)
            _wait_for(lambda: sup.stats()["readyMs"].get("1") is not None
                      or errors, "[pool] the second worker", 120)
        finally:
            stop.set()
            for t in threads:
                t.join()
        check(not errors, f"[pool] burst: {errors[:1]}")
        grow_s = time.perf_counter() - t_burst
        t_idle = time.perf_counter()
        _wait_for(lambda: sup.live == 1 and sup.counters["workers_reaped"],
                  "[pool] idle rounds to reap a worker", 60)
        reap_s = time.perf_counter() - t_idle
        store = BlockStore(os.path.join(root, "shuffle"), s.conf_obj)
        check(store.lease_fresh("pool-1", time.time())
              and store._heir_of("pool-1") == sup.owner,
              "[pool] the reaped worker's lease was not handed over")
        stats = sup.stats()
        c = stats["counters"]
        check(c["pool_statements_served"] == served
              and c["offload_fallbacks"] == 0,
              f"[pool] statements the pool was sent: {served}, served by "
              f"a worker: {c['pool_statements_served']} ({c})")
        print(f"[pool] spawn to ready (session on the card): "
              f"{stats['readyMs']} ms by worker; the server's start to "
              f"worker 0 ready {first_ready_s * 1e3:.1f} ms; a burst of "
              f"{POOL_CLIENTS} clients grew the pool to 2 in "
              f"{grow_s * 1e3:.1f} ms and idle rounds reaped one "
              f"{reap_s * 1e3:.1f} ms after it ended, its lease handed to "
              f"{sup.owner}; counters {c}; last decision "
              f"{stats['lastDecision']}; reaps that waited for a claimed "
              f"statement {stats.get('reapClaimWaits', 0)}; tables written in "
              f"{write_ms:.0f} ms", flush=True)
        for entry in k1_entries:
            entry["pool_launches"] = sum(k["launches"][entry["name"]]
                                         for k in kernels.values())
        k2_entry["pool_launches"] = 0
        srv.stop()
        srv = None
        check(sup.live == 0, "[pool] workers left after the server stopped")
    finally:
        os.environ.pop(KERNEL_CHECK_ENV, None)
        if srv is not None:
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    print(f"[pool] phase {time.perf_counter() - t_phase:.2f} s", flush=True)


#: [stream]: the Yahoo Streaming Benchmark's shape at full width (100
#: campaigns of 10 ads, 2^20 events a file, one file a trigger), the
#: stream-stream join's and the session scenario's sizes, and the dedup
#: watermark that keeps about two triggers of keys in its state
STREAM_EVENTS = 1 << 20
STREAM_TRIGGERS = 8
STREAM_JOIN_EVENTS = 1 << 16
STREAM_JOIN_TRIGGERS = 4
STREAM_SESSION_EVENTS = 1 << 14
STREAM_SESSION_USERS = 1000
STREAM_SESSION_TRIGGERS = 4
STREAM_DEDUP_DELAY_S = 20
STREAM_JOIN_DELAY_S = 10
#: the device of (f)'s worker processes
STREAM_WORKER_DEVICE = "cuda"


def _k1_runs():
    """K1's runs on the card so far, counted on the host: the wrapper's
    eager launches (not those made while a graph was captured, which run
    nothing) and the launches that the stage cache's graph replays
    carry."""
    from spark_tpu_torch import cuda_agg
    return sum(cuda_agg.ENTRY_LAUNCHES[e] - cuda_agg.CAPTURED_LAUNCHES[e]
               + cuda_agg.REPLAYED_LAUNCHES[e]
               for e in cuda_agg.ENTRY_LAUNCHES)


def _stream_step(tag):
    """A trigger step for ``testing``'s scenario runners: each trigger
    under ``profile_query`` (the card's activity only), numbered, as the
    trigger's wall under the profiler, the card's busy share, K1's runs
    counted on the host (``_k1_runs``) and the launches of K1 that the
    profiler saw."""
    n = itertools.count(1)

    def step(fn):
        k0 = _k1_runs()
        p = profile_query(f"[stream] {tag} trigger {next(n)}", fn,
                          cpu=False)
        return {"wall_ms": p["wall_ms"], "busy_share": p["busy"],
                "k1_runs": _k1_runs() - k0, "k1_seen": p["own"]["K1"][0]}
    return step


def _trigger_line(tag, i, rec, events, extra=""):
    t = rec["timings"]
    wall = t["wall_ms"]
    print(f"[stream] {tag} trigger {i + 1}: decode {t['source_ms']:.2f} ms; "
          f"to the card {t['h2d_bytes'] / 2**20:.1f} MiB in "
          f"{t['h2d_ms']:.3f} ms; below the stateful operator "
          f"{t['below_ms']:.2f} ms; state merge {t['merge_ms']:.3f} ms "
          f"(device); sink {t.get('sink_ms', 0.0):.2f} ms; commit "
          f"{t.get('commit_ms', 0.0) + t.get('state_commit_ms', 0.0):.2f} "
          f"ms; trigger wall {wall:.2f} ms ({events / (wall / 1e3):,.0f} "
          f"events/s); card busy {rec.get('busy_share', 0.0):.1%} "
          f"(under the profiler, {rec.get('wall_ms', 0.0):.2f} ms); "
          f"rebuilds {rec['progress']['stageRebuilds']}{extra}", flush=True)


def _stage_links(staged, watch):
    os.makedirs(watch, exist_ok=True)
    return [os.path.join(staged, f"f{t}") for t in range(STREAM_TRIGGERS)]


def _stream_recovery(session, root, files, counts_want):
    """(f): scenario (a) with a checkpoint and a json file sink: a
    lifetime without a fault in this process (the oracle of the sink's
    bytes), then ``stream-worker`` processes on the card: one that
    ``die_after_state_commit`` kills at trigger 3, and a restart that
    resumes from the checkpoint, has its last commit entry torn
    (``torn_checkpoint``) and, in a second lifetime in the same process,
    replays that batch."""
    import glob
    from spark_tpu_torch.parallel.faults import FAULT_PLAN_ENV, FaultPlan
    from spark_tpu_torch.testing import stream_lifetime
    in_dir = os.path.join(root, "in")
    os.makedirs(in_dir, exist_ok=True)
    for f in files:
        os.symlink(f, os.path.join(in_dir, os.path.basename(f)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) \
        + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(FAULT_PLAN_ENV, None)

    def start(tag, plan=None, restart=False):
        e = dict(env)
        if plan is not None:
            e[FAULT_PLAN_ENV] = plan.to_env()
        out = os.path.join(root, f"out-{tag}")
        ckpt = os.path.join(root, f"ckpt-{tag}")
        if tag == "restart":
            out, ckpt = os.path.join(root, "out-fault"), \
                os.path.join(root, "ckpt-fault")
        argv = [sys.executable, "-m", "spark_tpu_torch.testing",
                "stream-worker", root, "yahoo", ckpt, out,
                STREAM_WORKER_DEVICE]
        if restart:
            argv.append("restart")
        log = open(os.path.join(root, f"log-{tag}.txt"), "w")
        return (subprocess.Popen(argv, env=e, stdout=log,
                                 stderr=subprocess.STDOUT),
                log, time.time(), out, tag)

    def finish(started):
        p, log, t0, out, tag = started
        try:
            rc = p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        text = open(os.path.join(root, f"log-{tag}.txt")).read()
        res = None
        if os.path.exists(out + ".result.json"):
            with open(out + ".result.json") as f:
                res = json.load(f)
        return rc, text, res, t0, out

    def sink(out):
        return {os.path.basename(p): open(p, "rb").read()
                for p in sorted(glob.glob(os.path.join(out, "part-*")))}

    t_f = time.perf_counter()
    # the victim starts first: its process comes up while the fault-free
    # lifetime runs here
    victim = start("fault",
                   FaultPlan().die_after_state_commit(after_entries=2))
    clean_out = os.path.join(root, "out-clean")
    stream_lifetime(session, "yahoo", in_dir,
                    os.path.join(root, "ckpt-clean"), clean_out)
    want_files = sink(clean_out)
    check(len(want_files) == STREAM_TRIGGERS,
          f"[stream] (f) {len(want_files)} sink files")
    # the fault-free sink holds (a)'s update rows, trigger by trigger
    for i in range(STREAM_TRIGGERS):
        rows = [json.loads(line) for line in
                want_files[f"part-{i:05d}.json"].decode().splitlines()
                if line.strip()]
        check(len(rows) == len(counts_want[i]["emit"]),
              f"[stream] (f) trigger {i + 1}: {len(rows)} sink rows, the "
              f"oracle {len(counts_want[i]['emit'])}")
    rc, log, _res, _t0, _ = finish(victim)
    check(rc == 43 and "dying after state commit at batch 2" in log,
          f"[stream] (f) the worker did not die after batch 2's state "
          f"commit (rc {rc}): {log[-2000:]}")
    # the restart replays batch 2, commits 2..7, tears the last commit
    # entry; its second lifetime replays that batch
    rc, log, res, t_restart, out = finish(start(
        "restart", FaultPlan().torn_checkpoint(
            keep_bytes=9, after_entries=STREAM_TRIGGERS - 3),
        restart=True))
    check(rc == 0 and res is not None,
          f"[stream] (f) the restarted worker failed: {log[-2000:]}")
    first, second = res["lifetimes"]
    check(first["metrics"]["replayed_batches"] == 1
          and res["injected"] == [f"torn_checkpoint:{STREAM_TRIGGERS - 1}"]
          and second["metrics"]["replayed_batches"] == 1
          and second["metrics"]["batches_committed"] == 1,
          f"[stream] (f) replays: {first['metrics']} / "
          f"{second['metrics']} / {res['injected']}")
    got = sink(out)
    check(got == want_files,
          f"[stream] (f) the sink after the kill differs from the "
          f"fault-free one: {sorted(got)} vs {sorted(want_files)}")
    recover_s = first["first_commit_unix"] - t_restart
    print(f"[stream] (f) recovery on the card (stream-worker processes): "
          f"killed after batch 2's state commit (exit 43), the restart's "
          f"first new commit {recover_s:.3f} s after the restart began "
          f"(process start, imports and session included; its own "
          f"first-commit wall from entering main "
          f"{first['first_commit_unix'] - res['start_unix']:.3f} s); "
          f"batch 2 replayed, the torn commit of batch "
          f"{STREAM_TRIGGERS - 1} read as uncommitted and replayed; "
          f"{len(got)} sink files equal to the fault-free run byte for "
          f"byte; phase part {time.perf_counter() - t_f:.1f} s", flush=True)
    return recover_s


def _stream_server(session, files, ads, counts_want, root):
    """(h): ``POST /stream`` of (a)'s query as a spec (watermark + SQL
    over the stream's view, the ads table a view of the server's
    session), ``GET /stream/<id>`` after each trigger, a second POST over
    ``maxStandingQueries`` = 1 refused naming the limit, ``DELETE``."""
    import datetime
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.testing import YAHOO_STREAM_SCHEMA
    s = session.newSession()
    s.conf.set("spark.tpu.server.maxStandingQueries", "1")
    s.createDataFrame(ads).createOrReplaceTempView("ads")
    watch = os.path.join(root, "h-in")
    os.makedirs(watch)
    text = ("SELECT window(event_time, '10 seconds') AS w, campaign_id, "
            "COUNT(*) AS n FROM events JOIN ads ON events.ad_id = "
            "ads.ad_id WHERE event_type = 'view' GROUP BY "
            "window(event_time, '10 seconds'), campaign_id")
    spec = {"source": {"format": "parquet", "path": watch,
                       "schema": YAHOO_STREAM_SCHEMA,
                       "options": {"maxFilesPerTrigger": "1"}},
            "watermark": {"column": "event_time", "delay": "10 seconds"},
            "view": "events", "sql": text, "mode": "update",
            "sink": {"format": "json", "path": os.path.join(root, "h-out")},
            "checkpoint": os.path.join(root, "h-ckpt"), "interval": 0.05}
    srv = SQLServer(s, port=0).start()
    try:
        st, out, _ms = _http(srv.port, "/stream", "POST", spec)
        check(st == 200, f"[stream] (h) POST /stream: {st} {out}")
        sid = out["streamId"]
        polls = []
        for i, f in enumerate(files):
            os.symlink(f, os.path.join(watch, os.path.basename(f)))
            t0 = time.perf_counter()
            while True:
                st, got, _ms = _http(srv.port, f"/stream/{sid}")
                check(st == 200 and "error" not in got,
                      f"[stream] (h) GET /stream: {st} {got}")
                if got["metrics"]["batches_committed"] >= i + 1:
                    break
                check(time.perf_counter() - t0 < 120,
                      f"[stream] (h) trigger {i + 1} never committed")
                time.sleep(0.02)
            polls.append((time.perf_counter() - t0) * 1e3)
            part = os.path.join(root, "h-out", f"part-{i:05d}.json")
            rows = {}
            for line in open(part):
                if line.strip():
                    r = json.loads(line)
                    w = datetime.datetime.fromisoformat(str(r["w"]))
                    us = int((w - datetime.datetime(1970, 1, 1))
                             .total_seconds() * 1e6)
                    rows[(us, int(r["campaign_id"]))] = int(r["n"])
            check(rows == counts_want[i]["emit"],
                  f"[stream] (h) trigger {i + 1}: the sink's "
                  f"{len(rows)} rows differ from the oracle's")
        st, out, _ms = _http(srv.port, "/stream", "POST", spec)
        check(st == 429 and out.get("limit") == "maxStandingQueries",
              f"[stream] (h) a second standing query over the cap: "
              f"{st} {out}")
        st, done, _ms = _http(srv.port, f"/stream/{sid}", "DELETE")
        check(st == 200 and done["batchesCommitted"] == len(files),
              f"[stream] (h) DELETE: {st} {done}")
        print(f"[stream] (h) the server: POST /stream of (a) as a spec, "
              f"{len(files)} triggers each equal to the oracle, GET after "
              f"each ({statistics.median(polls):.1f} ms median from the "
              f"file's arrival to the commit seen over HTTP), a second "
              f"POST refused 429 naming maxStandingQueries, DELETE after "
              f"{done['batchesCommitted']} commits", flush=True)
    finally:
        srv.stop()


def phase_stream(session, k1_entries, k2_entry):
    """[stream]: Structured Streaming on the card, scenarios (a)–(h) on
    the Yahoo Streaming Benchmark's shape (see the module docstring)."""
    import numpy as np
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch import testing as TT
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.stagecompile import stage_cache

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        s = session.newSession()
        s.conf.set("spark.sql.warehouse.dir", os.path.join(root, "wh"))
        t0 = time.perf_counter()
        staged = os.path.join(root, "staged")
        feeds = []
        files = TT.yahoo_write(s, staged, STREAM_EVENTS, STREAM_TRIGGERS,
                               feeds=feeds)
        ads = TT.yahoo_ads()
        # the ad table of (f)'s worker processes, beside their input
        s.createDataFrame(ads).write.parquet(os.path.join(root, "f", "ads"))
        ads_df = s.createDataFrame(ads)
        print(f"[stream] {STREAM_TRIGGERS} files of {STREAM_EVENTS:,} ad "
              f"events written by the port's parquet writer in "
              f"{time.perf_counter() - t0:.1f} s (user_id, page_id and "
              f"ip_address int64, not UUID strings)", flush=True)
        zero_counts()
        a2a0 = cuda_a2a.LAUNCHES + cuda_a2a.PULL_LAUNCHES

        # (a) update mode, (b) append mode
        results = {}
        for tag, mode in (("(a)", "update"), ("(b)", "append")):
            want = TT.yahoo_counts_oracle(feeds, ads, mode)
            got = TT.stream_counts(s, F, os.path.join(root, f"in-{mode}"),
                                   files, ads_df, mode,
                                   step=_stream_step(tag))
            for i, (g, w) in enumerate(zip(got, want)):
                check(g["emit"] == w["emit"],
                      f"[stream] {tag} trigger {i + 1}: {len(g['emit'])} "
                      f"rows, the oracle {len(w['emit'])}; equal "
                      f"{g['emit'] == w['emit']}")
                check(g["metrics"]["state_rows"] == w["state_groups"],
                      f"[stream] {tag} trigger {i + 1}: state groups "
                      f"{g['metrics']['state_rows']} vs "
                      f"{w['state_groups']}")
                _trigger_line(tag, i, g, STREAM_EVENTS,
                              f"; {len(g['emit'])} rows equal to the "
                              f"oracle; state groups "
                              f"{g['metrics']['state_rows']}")
            if mode == "update":
                check(all(g["progress"]["stageRebuilds"] == 0
                          for g in got[1:]),
                      f"[stream] (a) stage rebuilds from trigger 2 on: "
                      f"{[g['progress']['stageRebuilds'] for g in got]}")
            else:
                keys = [k for g in got for k in g["emit"]]
                check(len(keys) == len(set(keys)) and keys,
                      "[stream] (b) a window was emitted twice")
            results[mode] = (got, want)

        # (c) dedup under the watermark
        want = TT.yahoo_dedup_oracle(feeds, STREAM_DEDUP_DELAY_S)
        got = TT.stream_dedup(s, os.path.join(root, "in-dedup"), files,
                              STREAM_DEDUP_DELAY_S,
                              step=_stream_step("(c)"))
        evicted = 0
        for i, (g, w) in enumerate(zip(got, want)):
            evicted += w["evicted"]
            check(np.array_equal(g["emit"], w["emit"]),
                  f"[stream] (c) trigger {i + 1}: {len(g['emit'])} keys, "
                  f"the oracle {len(w['emit'])}")
            check(g["metrics"]["state_rows"] == w["state_rows"]
                  and g["evicted"] == evicted,
                  f"[stream] (c) trigger {i + 1}: state rows "
                  f"{g['metrics']['state_rows']} vs {w['state_rows']}, "
                  f"evicted {g['evicted']} vs {evicted}")
            _trigger_line("(c)", i, g, STREAM_EVENTS,
                          f"; {len(g['emit']):,} new keys equal to the "
                          f"oracle; state {g['metrics']['state_rows']:,} "
                          f"rows, {g['metrics']['state_bytes'] / 2**20:.1f} "
                          f"MiB; evicted so far {g['evicted']:,}")

        # the state holds its live keys at their own capacity: with the
        # live keys flat from trigger 2 on, so are its bytes
        state_mib = [g["metrics"]["state_bytes"] / 2**20 for g in got]
        check(all(b == state_mib[1] for b in state_mib[1:]),
              f"[stream] (c) state bytes grow with the triggers: "
              f"{state_mib} MiB")
        print(f"[stream] (c) state {state_mib} MiB by trigger: flat from "
              f"trigger 2 on", flush=True)

        # (d) stream-stream join
        vdirs, cdirs, sides = TT.write_join_sides(
            s, os.path.join(root, "join"), STREAM_JOIN_EVENTS,
            STREAM_JOIN_TRIGGERS)
        want = TT.stream_join_oracle(sides, STREAM_JOIN_DELAY_S)
        got = TT.stream_join(s, F, os.path.join(root, "join-watch"), vdirs,
                             cdirs, STREAM_JOIN_DELAY_S,
                             step=_stream_step("(d)"))
        for i, (g, w) in enumerate(zip(got, want)):
            check(np.array_equal(g["emit"], w["rows"])
                  and g["view_buffer"] == w["view_buffer"]
                  and g["click_buffer"] == w["click_buffer"],
                  f"[stream] (d) trigger {i + 1}: {len(g['emit'])} rows vs "
                  f"{len(w['rows'])}, buffers {g['view_buffer']}/"
                  f"{g['click_buffer']} vs {w['view_buffer']}/"
                  f"{w['click_buffer']}")
            _trigger_line("(d)", i, g, 2 * STREAM_JOIN_EVENTS,
                          f"; {len(g['emit']):,} joined rows equal to the "
                          f"oracle; buffers {g['view_buffer']:,} views, "
                          f"{g['click_buffer']:,} clicks")

        # (e) flatMapGroupsWithState: host-bound by design
        feeds_e = TT.session_events(STREAM_SESSION_EVENTS,
                                    STREAM_SESSION_TRIGGERS,
                                    STREAM_SESSION_USERS)
        got = TT.stream_sessions(s, feeds_e, step=_stream_step("(e)"))
        want = TT.session_oracle(feeds_e)
        for i, (g, w) in enumerate(zip(got, want)):
            check(g["emit"] == w, f"[stream] (e) trigger {i + 1}: "
                  f"{len(g['emit'])} rows vs {len(w)}")
            t = g["timings"]
            print(f"[stream] (e) trigger {i + 1}: {len(w)} session rows "
                  f"equal to the oracle ({sum(c for *_x, c in w)} closed); "
                  f"the user function's host time {t['fmgws_host_ms']:.2f} "
                  f"ms of a {t['wall_ms']:.2f} ms trigger; card busy "
                  f"{g['busy_share']:.1%}; {g['states']} open sessions",
                  flush=True)

        # (f) recovery in worker processes
        recover_s = _stream_recovery(s, os.path.join(root, "f"), files,
                                     results["update"][1])

        # (g) foreachBatch: hash-agg over each micro-batch, K1 in the
        # stage cache
        table_rows = []

        def hash_agg(bdf, _bid):
            out = bdf.groupBy("ad_id").agg(F.sum("page_id").alias("s"),
                                           F.count("*").alias("c"))
            table_rows.append(TT._host_columns(out._execute()))

        gin = os.path.join(root, "in-g")
        os.makedirs(gin)
        q = (TT.yahoo_stream(s, gin).writeStream.foreachBatch(hash_agg)
             .trigger(once=True).start())
        for entry in cuda_agg.ENTRY_LAUNCHES:
            cuda_agg.ENTRY_LAUNCHES[entry] = 0
            cuda_agg.CAPTURED_LAUNCHES[entry] = 0
            cuda_agg.REPLAYED_LAUNCHES[entry] = 0
        cache = stage_cache()
        # held, so that no new variant takes the id of a dropped one
        old_variants = [v for e in cache.entries() for v in e.variants]
        old_ids = {id(v) for v in old_variants}
        recs = []
        with TT._K1Compare() as k1:
            recs = TT._drive(q, files, gin, [], _stream_step("(g)"))
        q.stop()
        for i, (feed, rows) in enumerate(zip(feeds, table_rows)):
            cnt = np.bincount(feed["ad_id"], minlength=1000)
            tot = np.zeros(1000, np.int64)
            np.add.at(tot, feed["ad_id"], feed["page_id"])
            order = np.argsort(rows["ad_id"])
            check(np.array_equal(rows["ad_id"][order],
                                 np.nonzero(cnt)[0])
                  and np.array_equal(rows["c"][order], cnt[cnt > 0])
                  and np.array_equal(rows["s"][order], tot[cnt > 0]),
                  f"[stream] (g) trigger {i + 1}: hash-agg differs from "
                  f"numpy")
        ran = [r["k1_runs"] for r in recs]
        seen = [r["k1_seen"] for r in recs]
        wrapper = dict(cuda_agg.ENTRY_LAUNCHES)
        replayed = dict(cuda_agg.REPLAYED_LAUNCHES)
        check(k1.checked > 0 and k1.equal,
              f"[stream] (g) K1's eager launch vs its plain version: "
              f"checked {k1.checked}, equal {k1.equal}")
        check(ran == [1] * len(files),
              f"[stream] (g) K1 ran {ran} times per trigger (its eager "
              f"launches and the launches its stage graphs' replays "
              f"carry), not once per trigger; wrapper launches {wrapper}, "
              f"replayed {replayed}")
        check(wrapper["grouped_accumulate_columns"] > 0,
              f"[stream] (g) K1's wrapper never launched: {wrapper}")
        # the card's own record that (g)'s graph runs K1: one profile of
        # 8 replays of that graph alone.  A profile can miss device
        # records, those at its start most of all (PERF.md §7), so it
        # must see K1 at least once, and the per-trigger count is the
        # host's above
        graphs = [v for e in cache.entries() for v in e.variants
                  if id(v) not in old_ids and v.k1_launches]
        check(len(graphs) == 1 and sum(graphs[0].k1_launches.values())
              == 1, f"[stream] (g) built {len(graphs)} stage graphs that "
              f"hold K1 ({[g.k1_launches for g in graphs]}), expected one "
              f"with one launch")
        lone = profile_query(
            "[stream] (g) 8 replays of its stage graph alone",
            lambda: [graphs[0].graph.replay() for _ in range(8)],
            cpu=False)
        graph_k1_seen, graph_k1_ms = lone["own"]["K1"]
        check(graph_k1_seen >= 1,
              f"[stream] (g) a profile of 8 replays of its stage graph "
              f"saw no launch of K1")
        print(f"[stream] (g) foreachBatch hash-agg (groupBy(ad_id)."
              f"agg(sum(page_id), count(*))) over each of "
              f"{len(files)} micro-batches, equal to numpy: K1 ran "
              f"{ran} times per trigger on the card (the eager warm-up, "
              f"then one launch in each replay of the trigger's stage "
              f"graph: {replayed} replayed); the per-trigger profiles "
              f"saw {seen}; a profile of 8 replays of that graph alone "
              f"saw K1 {graph_k1_seen} times, "
              f"{graph_k1_ms / graph_k1_seen:.4f} ms each; its wrapper "
              f"launched {wrapper} (cuda_agg.ENTRY_LAUNCHES from 0 "
              f"before (g)); {k1.checked} eager launch(es) held against "
              f"the plain version: bit-exact (max abs err "
              f"{k1.max_abs_err}); trigger walls "
              f"{[round(r['timings']['wall_ms'], 1) for r in recs]} ms",
              flush=True)
        for entry in k1_entries:
            entry["stream_launches"] = wrapper[entry["name"]]
            entry["stream_replayed_launches"] = replayed[entry["name"]]
        a2a = cuda_a2a.LAUNCHES + cuda_a2a.PULL_LAUNCHES - a2a0
        check(a2a == 0, f"[stream] K2 launched {a2a} times")
        k2_entry["stream_launches"] = a2a

        # (h) the server
        _stream_server(s, files, ads, results["update"][1], root)
        upd = results["update"][0]
        walls = [g["timings"]["wall_ms"] for g in upd[1:]]
        print(f"[stream] (a) sustained: median trigger wall "
              f"{statistics.median(walls):.2f} ms over triggers 2..8, "
              f"{STREAM_EVENTS / (statistics.median(walls) / 1e3):,.0f} "
              f"events/s; K2 launched 0 times in [stream] (no exchange on "
              f"one card); time to recover {recover_s:.3f} s", flush=True)
        print(f"[stream] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[stream] phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)


# ---------------------------------------------------------------------------
# [analysis]: the plan verifier, the cross-process runtime checks and the
# decision-trace backstop on the card; the jdbc source and the CLI
# ---------------------------------------------------------------------------

ANALYSIS_WORKERS = 2
ANALYSIS_TIMEOUT_S = 60.0
ANALYSIS_WORKER_DEVICE = "cuda"
#: the q93 join's tables at [ooc]'s SF1 counts; the battery's other
#: tables, which the join does not read, at a token size
ANALYSIS_SPEC = {"hash_rows": 4096, "hash_groups": 64,
                 "q3": {"store_sales": 4096, "item": 400, "date_dim": 4000},
                 "ooc_seed": 19}
VERIFY_ON = {"spark.tpu.analysis.verifyPlans": "on"}


def _analysis_queries(s, hash_table, tables, k1_entries):
    """(a): hash-agg and q3 from SQL text on the graph lane of a session
    with ``verifyPlans=on``, each built anew (the stage contract verified
    at its build), every eager K1 launch held against its plain
    version; then the warm walls with the verifier on, in turns with the
    root session's (verifier off: ``auto`` outside pytest)."""
    from spark_tpu_torch import cuda_agg
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL, _K1Compare,
                                         hash_agg_oracle, q3_oracle)
    queries = [("hash-agg", HASH_AGG_SQL, hash_agg_oracle(hash_table),
                False), ("q3", Q3_SQL, q3_oracle(tables), True)]
    clear_stage_cache()
    zero_counts()
    with _K1Compare() as k1:
        for name, sql, want, ordered in queries:
            st0 = dict(s._analysis_stats)
            t0 = time.perf_counter()
            got = [tuple(r) for r in s.sql(sql).collect()]
            first_ms = (time.perf_counter() - t0) * 1e3
            n = s._analysis_stats["plans_verified"] - st0["plans_verified"]
            ms = s._analysis_stats["plan_verify_ms"] - st0["plan_verify_ms"]
            check((got if ordered else sorted(got))
                  == (want if ordered else sorted(want)),
                  f"[analysis] {name} with the verifier on differs from "
                  f"the SQL phase's answer (first rows {got[:2]})")
            check(n > 0, f"[analysis] {name}: no plan verified")
            print(f"[analysis] (a) {name}: {len(got)} rows equal to the SQL "
                  f"phase's answer; first run (stage built, graph "
                  f"captured) {first_ms:.2f} ms with {n} verifications "
                  f"(logical, physical, stage contract) taking "
                  f"{ms:.3f} ms", flush=True)
    launches = dict(cuda_agg.ENTRY_LAUNCHES)
    check(launches["grouped_accumulate_columns"] >= 2 and k1.checked >= 1
          and k1.equal, f"[analysis] (a) K1 launches {launches}, "
          f"{k1.checked} eager launch(es) checked, equal {k1.equal}")
    for entry in k1_entries:
        entry["analysis_launches"] = launches[entry["name"]]
    print(f"[analysis] (a) K1 wrapper launches {launches} "
          f"(cuda_agg.ENTRY_LAUNCHES from 0 before (a)); {k1.checked} eager "
          f"launch(es) held against the plain version: bit-exact (max abs "
          f"err {k1.max_abs_err})", flush=True)
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import register_sql_tables
    root = s.newSession()
    for k in VERIFY_ON:
        root.conf.set(k, "auto")
    register_sql_tables(root, hash_table, tables, T)
    for name, sql, _w, _o in queries:
        on, off = s.sql(sql), root.sql(sql)
        st0 = dict(s._analysis_stats)
        walls = [wall_ms(on.collect), wall_ms(off.collect),
                 wall_ms(off.collect), wall_ms(on.collect)]
        runs = 2 * 6                      # two wall_ms calls: 1 + 5 runs
        n = s._analysis_stats["plans_verified"] - st0["plans_verified"]
        ms = s._analysis_stats["plan_verify_ms"] - st0["plan_verify_ms"]
        print(f"[analysis] (a) {name}: warm wall, median of 5, in turns "
              f"verifier on, off, off, on: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms; plan_verify_ms "
              f"per run {ms / runs:.3f} ms ({n / runs:.1f} verifications "
              f"per run)", flush=True)
    root.stop()


def _analysis_workers(root, n):
    from spark_tpu_torch.parallel.faults import FAULT_PLAN_ENV, FaultPlan
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for pid in range(n):
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        env.pop(FAULT_PLAN_ENV, None)
        if pid == 1:
            env[FAULT_PLAN_ENV] = FaultPlan().skew_decision().to_env()
        log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "spark_tpu_torch.testing",
             "analysis-worker", str(pid), str(n), root, "card",
             str(ANALYSIS_TIMEOUT_S), ANALYSIS_WORKER_DEVICE],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here), log))
    return procs


def _analysis_crossproc(k2_entry, pull_entry):
    """(b) and (c): two ``cuda`` workers run q93's join on the hash lane
    over the device tier with the runtime checks on — cold (every K2
    pull held against its plain version), warm — then once more with
    ``skew_decision`` armed in worker 1, which must end BOTH workers in a
    ``PlanInvariantError`` naming the diverged component."""
    import torch
    from spark_tpu_torch.testing import OOC_SF1
    n = ANALYSIS_WORKERS
    root = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    procs = []
    try:
        free, _total = torch.cuda.mem_get_info()
        spec = dict(ANALYSIS_SPEC, ooc=OOC_SF1, conf={
            "spark.tpu.memory.hbmBudget": str(int(free * 0.8) // n)})
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        procs = _analysis_workers(root, n)
        deadline = time.monotonic() + 600
        for p, _log in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        workers_s = time.perf_counter() - t0
        results = []
        for pid, (p, log) in enumerate(procs):
            log.close()
            with open(os.path.join(root, f"log-p{pid}.txt")) as f:
                text = f.read()
            check(p.returncode == 0, f"[analysis] worker {pid} exited "
                  f"{p.returncode}:\n{text[-4000:]}")
            with open(os.path.join(root, f"result-p{pid}.json")) as f:
                results.append(json.load(f))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(root, ignore_errors=True)
    pulls = a2a = 0
    for pid, r in enumerate(results):
        runs = r["runs"]
        check(len(runs) == 3, f"[analysis] worker {pid}: {len(runs)} runs")
        for i, run in enumerate(runs[:2]):
            check(run["outcome"] == "ok" and run["rows"] == r["want"][0],
                  f"[analysis] (b) worker {pid} run {i}: {run['outcome']} "
                  f"({run.get('message', run.get('error', ''))[:400]}); "
                  f"rows equal {run.get('rows') == r['want'][0]}")
            check(run["pull_launches"] >= 1, f"[analysis] (b) worker {pid} "
                  f"run {i}: the join sides took no K2 pull")
        chk = r["check"]
        check(chk.get("checked", 0) >= 1 and chk.get("equal"),
              f"[analysis] (b) worker {pid}: pulls held against the plain "
              f"version {chk}")
        div = r["analysis"].get("decision_trace_divergence", 0)
        checks = runs[1]["checks"]
        check(checks > 0 and runs[1]["div"] == 0,
              f"[analysis] (b) worker {pid}: {checks} decision-trace "
              f"checks, {runs[1]['div']} divergences in the clean runs")
        pulls += runs[0]["pull_launches"] + runs[1]["pull_launches"]
        a2a += runs[0]["a2a_launches"] + runs[1]["a2a_launches"]
        print(f"[analysis] (b) worker {pid}: q93's join on the hash lane "
              f"over the device tier equal to the single-process answer "
              f"({len(runs[0]['rows'])} rows), cold {runs[0]['wall_ms']:.2f}"
              f" ms, warm {runs[1]['wall_ms']:.2f} ms; decision-trace "
              f"checks {checks} over both runs, divergences "
              f"{runs[1]['div']}; K2 pulls "
              f"{runs[0]['pull_launches']} + {runs[1]['pull_launches']}, "
              f"{chk['checked']} held against the plain version: bit-exact "
              f"(max abs err {chk.get('max_abs_err', 0)})", flush=True)
        bad = runs[2]
        check(bad["outcome"] == "diverged"
              and bad["property"] == "decision-trace-agreement"
              and "component(s) ['decision']" in bad["message"],
              f"[analysis] (c) worker {pid}: {bad['outcome']} "
              f"{bad.get('property')} {bad.get('message', bad.get('error'))}")
        print(f"[analysis] (c) skew_decision armed in worker 1: worker "
              f"{pid} ended in PlanInvariantError "
              f"({bad['property']}, at {bad['node']}) "
              f"{bad['elapsed_s']:.3f} s into the statement, naming "
              f"component(s) ['decision']; divergences counted {div}",
              flush=True)
    check(a2a == 0, f"[analysis] (b) K2's all-to-all launched {a2a} times "
          f"in the clean runs (the device tier pulls across processes)")
    pull_entry["analysis_launches"] = pulls
    k2_entry["analysis_launches"] = a2a
    print(f"[analysis] (b, c) {n} workers done in {workers_s:.2f} s",
          flush=True)


def _analysis_jdbc(s, tables, root):
    """(d): q3 with date_dim and item read through jdbc from a sqlite
    file the port's writer wrote, store_sales in memory."""
    from spark_tpu_torch import types as T
    from spark_tpu_torch.testing import Q3_SCHEMAS, Q3_SQL, q3_oracle
    url = f"jdbc:sqlite:{os.path.join(root, 'q3.db')}"
    j = s.newSession()
    t0 = time.perf_counter()
    for name in ("date_dim", "item", "store_sales"):
        st = T.StructType([T.StructField(c, T.type_for_name(t))
                           for c, t in Q3_SCHEMAS[name]])
        df = j.createDataFrame(tables[name], schema=st)
        if name == "store_sales":
            df.createOrReplaceTempView(name)
        else:
            df.write.jdbc(url, name, mode="overwrite")
    write_s = time.perf_counter() - t0
    for name in ("date_dim", "item"):
        j.read.jdbc(url, name).createOrReplaceTempView(name)
    t0 = time.perf_counter()
    got = [tuple(r) for r in j.sql(Q3_SQL).collect()]
    first_ms = (time.perf_counter() - t0) * 1e3
    check(got == q3_oracle(tables), f"[analysis] (d) q3 over jdbc differs "
          f"from the in-memory q3 (first rows {got[:2]})")
    warm = wall_ms(j.sql(Q3_SQL).collect, warmup=0, reps=3)
    print(f"[analysis] (d) q3 with date_dim "
          f"({len(tables['date_dim']['d_date_sk'])} rows) and item "
          f"({len(tables['item']['i_item_sk'])} rows) read through jdbc "
          f"from sqlite (written by the port in {write_s:.2f} s): "
          f"{len(got)} rows equal to the in-memory q3; first run "
          f"{first_ms:.2f} ms, warm wall (median of 3, each re-reading the "
          f"database) {warm:.2f} ms", flush=True)
    j.stop()


def _analysis_cli(s, hash_table, root):
    """(e): ``python -m spark_tpu_torch.cli sql -e`` with a hash-agg text
    over a parquet copy of hash_t, in a process of its own on the card:
    its table equals this process's ``show`` of the same text."""
    path = os.path.join(root, "hash_t")
    s.createDataFrame(hash_table).write.parquet(path)
    text = (f"SELECT k, SUM(v) AS s, COUNT(*) AS c FROM parquet.`{path}` "
            f"GROUP BY k ORDER BY k")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s.sql(text).show(100)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "spark_tpu_torch.cli", "sql",
                        "-e", text], capture_output=True, text=True,
                       env=env, cwd=here, timeout=300)
    cli_s = time.perf_counter() - t0

    def table(out):
        return [ln for ln in out.splitlines() if ln.startswith(("+", "|"))]
    check(r.returncode == 0, f"[analysis] (e) the CLI exited "
          f"{r.returncode}: {r.stderr[-3000:]}")
    check(table(r.stdout) and table(r.stdout) == table(buf.getvalue()),
          f"[analysis] (e) the CLI's table differs from the in-process "
          f"one:\n{r.stdout[-1500:]}")
    print(f"[analysis] (e) python -m spark_tpu_torch.cli sql -e "
          f"'<hash-agg over parquet>' on the card (its default device): "
          f"{len(table(r.stdout)) - 4} rows shown, equal to the in-process "
          f"show(); the process took {cli_s:.2f} s", flush=True)


def phase_analysis(session, hash_table, tables, k1_entries, k2_entry,
                   pull_entry):
    """The analysis slice on the card (see the module's docstring, 21):
    (a) the verifier on the main path's queries, (b) the runtime checks
    and the decision trace across two processes on the device tier, (c)
    ``skew_decision``, (d) q3 through jdbc, (e) the CLI."""
    t_phase = time.perf_counter()
    s = session.newSession()
    for k, v in VERIFY_ON.items():
        s.conf.set(k, v)
    root = tempfile.mkdtemp(prefix="chip_smoke_analysis_files_")
    try:
        from spark_tpu_torch import types as T
        from spark_tpu_torch.testing import register_sql_tables
        register_sql_tables(s, hash_table, tables, T)
        _analysis_queries(s, hash_table, tables, k1_entries)
        _analysis_crossproc(k2_entry, pull_entry)
        _analysis_jdbc(s, tables, root)
        _analysis_cli(s, hash_table, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        s.stop()
    print(f"[analysis] phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)


ML_SEED = 18
ML_RECORDS, ML_RECORD_WORDS, ML_VOCAB, ML_PARTS = 1 << 20, 8, 1 << 16, 8
ML_AGG_ROWS, ML_AGG_KEYS = 1 << 20, 1024
ML_LR_ROWS, ML_LR_COLS, ML_LR_ITERS = 1 << 22, 28, 25
ML_KM_ROWS, ML_KM_DIM, ML_KM_K, ML_KM_ITERS = 1 << 22, 20, 10, 20
ML_RMAT_SCALE, ML_RMAT_EDGE_FACTOR, ML_PR_ITERS = 22, 16, 20
#: Graph500's R-MAT quadrant probabilities A, B, C (D = 1 - A - B - C)
ML_RMAT_ABC = (0.57, 0.19, 0.19)
#: stated tolerances of [ml]: coefficients absolute, AUC absolute, KMeans
#: centres and PageRank relative; a KMeans point whose two nearest
#: squared distances differ by less than ML_TIE_RTOL (relative) may take
#: either centre
ML_COEF_ATOL, ML_AUC_ATOL, ML_CENTRE_RTOL, ML_PR_RTOL = 1e-8, 1e-9, 1e-9, 1e-9
ML_TIE_RTOL = 1e-9


def _ml_wall(fn, reps=3):
    """(median wall ms of ``reps`` synchronized runs after one warm-up,
    the last run's result)."""
    last = {}

    def run():
        last["out"] = fn()
    return wall_ms(run, reps=reps), last["out"]


def _ml_card(tag, fn, top=5):
    """One run of ``fn`` under ``torch.profiler`` (the card's activity):
    the device ms per op of its largest ops and the bytes it held (peak
    allocated, from 0 peak before it).  Returns ``fn``'s result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(us for us, _c, _k in rows) / 1e3
    tops = "; ".join(f"{k[:48]} x{c} {us / 1e3:.3f} ms"
                     for us, c, k in rows[:top])
    print(f"[ml] {tag}: one profiled run: device {total:.3f} ms over "
          f"{sum(c for _u, c, _k in rows)} kernels and copies; top: {tops}; "
          f"held on the card {base / 2**20:.1f} MiB before, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    return out


def _ml_session(session, root):
    """A session on the root session's device whose event log and CSV
    sink are set before its first query, with a listener counting the
    events it posts."""
    from spark_tpu_torch.sql.session import SparkSession
    conf = session.conf_obj.clone()
    conf.set("spark.eventLog.dir", os.path.join(root, "events"))
    conf.set("spark.tpu.metrics.csv.dir", os.path.join(root, "metrics"))
    s = SparkSession(conf)
    SparkSession._active = session          # the root stays the active one
    events = []
    s.listenerManager.register(events.append)
    return s, events


def _ml_k1_check(k1, k1_entries):
    """(a)'s K1 launches: 2 through the columns entry (the stage's eager
    warm-up and its capture), the eager one bit-exact."""
    from spark_tpu_torch import cuda_agg
    launches = dict(cuda_agg.ENTRY_LAUNCHES)
    check(launches["grouped_accumulate_columns"] == 2
          and launches["grouped_accumulate"] == 0 and k1.checked >= 1
          and k1.equal, f"[ml] (a) K1 launches {launches}, {k1.checked} "
          f"eager launch(es) checked, equal {k1.equal}")
    for entry in k1_entries:
        entry["ml_launches"] = launches[entry["name"]]
    print(f"[ml] (a) K1 wrapper launches {launches} (from 0 before the "
          f"first run); {k1.checked} eager launch held against the plain "
          f"version: bit-exact (max abs err {k1.max_abs_err})", flush=True)


def _ml_rdd(s, k1_entries):
    """(a): the word count through the RDD layer against a Counter
    oracle, then ``toDF`` onto the DataFrame path and hash-agg's shape,
    whose stage runs K1."""
    import operator
    import numpy as np
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.testing import _K1Compare
    rng = np.random.default_rng(ML_SEED)
    vocab = np.array([f"{v:08x}" for v in rng.choice(1 << 31, ML_VOCAB,
                                                     replace=False)])
    ids = rng.integers(0, ML_VOCAB, (ML_RECORDS, ML_RECORD_WORDS))
    lines = [" ".join(r) for r in vocab[ids].tolist()]
    sc = s.sparkContext
    t0 = time.perf_counter()
    counts = np.bincount(ids.ravel(), minlength=ML_VOCAB)
    want = {vocab[i]: int(c) for i, c in enumerate(counts.tolist()) if c}
    oracle_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got = dict(sc.parallelize(lines, ML_PARTS)
               .flatMap(lambda line: line.split(" "))
               .map(lambda w: (w, 1))
               .reduceByKey(operator.add).collect())
    wc_ms = (time.perf_counter() - t0) * 1e3
    check(got == want, f"[ml] (a) word count differs from the Counter "
          f"oracle ({len(got)} vs {len(want)} words)")
    print(f"[ml] (a) word count: {ML_RECORDS:,} records of "
          f"{ML_RECORD_WORDS} words, vocabulary {ML_VOCAB:,}, {ML_PARTS} "
          f"partitions, flatMap → map → reduceByKey → collect: {len(got):,} "
          f"words equal to the Counter oracle exactly; one run {wc_ms:.1f} "
          f"ms (host Python, as in the JAX package), oracle "
          f"{oracle_ms:.1f} ms", flush=True)
    keys = rng.integers(0, ML_AGG_KEYS, ML_AGG_ROWS).astype(np.int64)
    vals = rng.integers(0, 100, ML_AGG_ROWS).astype(np.int64)
    t0 = time.perf_counter()
    df = sc.parallelize(list(zip(keys.tolist(), vals.tolist())),
                        ML_PARTS).toDF(["k", "v"])
    todf_ms = (time.perf_counter() - t0) * 1e3
    q = df.groupBy("k").agg(F.sum("v").alias("s"), F.count("*").alias("c"))
    want_agg = _grouped_oracle({"k": keys, "v": vals})
    clear_stage_cache()
    zero_counts()
    with _K1Compare() as k1:
        t0 = time.perf_counter()
        first = sorted(tuple(r) for r in q.collect())
        first_ms = (time.perf_counter() - t0) * 1e3
    check(first == want_agg, f"[ml] (a) toDF hash-agg differs from its "
          f"oracle (first rows {first[:2]})")
    warm_ms, rows = _ml_wall(q.collect)
    check(sorted(tuple(r) for r in rows) == want_agg,
          "[ml] (a) toDF hash-agg's warm run differs from its oracle")
    _ml_k1_check(k1, k1_entries)
    _ml_card("(a) toDF hash-agg warm run", q.collect)
    print(f"[ml] (a) toDF of {ML_AGG_ROWS:,} (k, v) rows ({ML_AGG_KEYS} keys) "
          f"{todf_ms:.1f} ms → groupBy(k).agg(sum, count): {len(first)} "
          f"groups equal to the numpy oracle; first run (stage built, "
          f"graph captured) {first_ms:.2f} ms, warm median of 3 "
          f"{warm_ms:.2f} ms", flush=True)


def _np_irls(X, y, iters):
    """numpy float64 IRLS, LogisticRegression's steps (intercept last)."""
    import numpy as np
    Xb = np.hstack([X, np.ones((len(X), 1))])
    w = np.zeros(Xb.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(Xb @ w)))
        wgt = np.maximum(p * (1 - p), 1e-10)
        w = w - np.linalg.solve((Xb * wgt[:, None]).T @ Xb, Xb.T @ (p - y))
    return w


def _np_auc(y, s):
    """areaUnderROC with ties given their mean rank (numpy)."""
    import numpy as np
    order = np.argsort(s, kind="stable")
    ranks = np.empty(len(s))
    ranks[order] = np.arange(1, len(s) + 1)
    sv = s[order]
    starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
    ends = np.r_[starts[1:], len(s)]
    for a, b in zip(starts.tolist(), ends.tolist()):
        if b - a > 1:
            ranks[order[a:b]] = (a + 1 + b) / 2.0
    pos = y > 0
    npos, nneg = int(pos.sum()), int((~pos).sum())
    return (ranks[pos].sum() - npos * (npos + 1) / 2) / (npos * nneg)


def _ml_logistic(s):
    """(b): VectorAssembler over HIGGS-shaped columns → StandardScaler →
    binomial IRLS → transform → areaUnderROC, against numpy."""
    import numpy as np
    from spark_tpu_torch.ml.base import Pipeline
    from spark_tpu_torch.ml.classification import LogisticRegression
    from spark_tpu_torch.ml.evaluation import BinaryClassificationEvaluator
    from spark_tpu_torch.ml.feature import StandardScaler, VectorAssembler
    rng = np.random.default_rng(ML_SEED + 1)
    n, d = ML_LR_ROWS, ML_LR_COLS
    X = rng.normal(0, 1, (n, d)) * rng.uniform(0.5, 2.0, d) \
        + rng.uniform(-1.0, 2.0, d)
    beta = rng.normal(0, 0.6, d)
    z = ((X - X.mean(0)) / X.std(0)) @ beta - 0.2
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    names = [f"f{j}" for j in range(d)]
    table = {nm: X[:, j].copy() for j, nm in enumerate(names)}
    table["label"] = y
    df = s.createDataFrame(table)
    pipe = Pipeline(stages=[
        VectorAssembler(inputCols=names, outputCol="raw"),
        StandardScaler(inputCol="raw", outputCol="features", withMean=True),
        LogisticRegression(family="binomial", maxIter=ML_LR_ITERS)])
    fit_ms, model = _ml_wall(lambda: pipe.fit(df))
    lr = model.getOrDefault("stages")[-1]
    coef = lr.getOrDefault("coefficients").cpu().numpy()
    icpt = lr.getOrDefault("intercept")
    scored = model.transform(df).selectExpr("label",
                                            "probability[1] AS score")
    ev = BinaryClassificationEvaluator(rawPredictionCol="score")
    t0 = time.perf_counter()
    auc = ev.evaluate(scored)
    eval_ms = (time.perf_counter() - t0) * 1e3
    _ml_card("(b) pipeline fit", lambda: pipe.fit(df))
    t0 = time.perf_counter()
    Z = (X - X.mean(0)) / X.std(0, ddof=1)
    w = _np_irls(Z, y, ML_LR_ITERS)
    p = 1.0 / (1.0 + np.exp(-(np.hstack([Z, np.ones((n, 1))]) @ w)))
    want_auc = _np_auc(y, p)
    oracle_ms = (time.perf_counter() - t0) * 1e3
    err = max(float(np.abs(coef - w[:-1]).max()), abs(icpt - w[-1]))
    check(err <= ML_COEF_ATOL, f"[ml] (b) IRLS coefficients differ from "
          f"numpy's by {err:.3g} (> {ML_COEF_ATOL})")
    check(abs(auc - want_auc) <= ML_AUC_ATOL, f"[ml] (b) AUC {auc!r} vs "
          f"numpy {want_auc!r}")
    print(f"[ml] (b) logistic regression: {n:,} rows × {d} float64 "
          f"columns (HIGGS shape) → VectorAssembler → StandardScaler → "
          f"binomial IRLS ({ML_LR_ITERS} steps): pipeline fit median of 3 "
          f"{fit_ms:.1f} ms; transform + areaUnderROC {eval_ms:.1f} ms; "
          f"coefficients max abs err vs numpy IRLS {err:.3g} (tol "
          f"{ML_COEF_ATOL}); AUC {auc:.12f} vs {want_auc:.12f} (|diff| "
          f"{abs(auc - want_auc):.3g}, tol {ML_AUC_ATOL}); numpy oracle "
          f"{oracle_ms:.1f} ms", flush=True)


def _np_lloyd(X, C, iters):
    """numpy Lloyd steps: nearest centre (the first on a tie), then each
    centre to its rows' mean (a one-hot matmul), an empty one kept."""
    import numpy as np
    xx = (X * X).sum(1)
    k = len(C)
    for _ in range(iters):
        a = (xx[:, None] - 2.0 * (X @ C.T) + (C * C).sum(1)[None]).argmin(1)
        onehot = np.zeros((len(X), k))
        onehot[np.arange(len(X)), a] = 1.0
        counts = np.bincount(a, minlength=k)
        C = np.where(counts[:, None] > 0,
                     (onehot.T @ X) / np.maximum(counts, 1)[:, None], C)
    return C


def _ml_kmeans(s):
    """(c): KMeans over Gaussian blobs against numpy Lloyd steps from the
    same ``default_rng`` starts."""
    import numpy as np
    from spark_tpu_torch.ml.clustering import KMeans
    rng = np.random.default_rng(ML_SEED + 2)
    centres = rng.normal(0, 10, (ML_KM_K, ML_KM_DIM))
    X = centres[rng.integers(0, ML_KM_K, ML_KM_ROWS)] \
        + rng.normal(0, 1, (ML_KM_ROWS, ML_KM_DIM))
    df = s.createDataFrame({"features": X})
    km = KMeans(k=ML_KM_K, maxIter=ML_KM_ITERS, seed=ML_SEED)
    fit_ms, model = _ml_wall(lambda: km.fit(df))
    got_c = model.getOrDefault("clusterCenters").cpu().numpy()
    assign = np.array([r[0] for r in model.transform(df)
                       .select("prediction").collect()], np.int64)
    _ml_card("(c) KMeans fit", lambda: km.fit(df))
    t0 = time.perf_counter()
    start = X[np.random.default_rng(ML_SEED).choice(ML_KM_ROWS, ML_KM_K,
                                                   replace=False)]
    want_c = _np_lloyd(X, start, ML_KM_ITERS)
    d2 = (X * X).sum(1)[:, None] - 2.0 * (X @ want_c.T) \
        + (want_c * want_c).sum(1)[None]
    want_a = d2.argmin(1)
    two = np.partition(d2, 1, axis=1)[:, :2]
    ties = np.abs(two[:, 1] - two[:, 0]) < ML_TIE_RTOL * np.abs(two[:, 1])
    oracle_ms = (time.perf_counter() - t0) * 1e3
    rel = float(np.abs(got_c - want_c).max() / np.abs(want_c).max())
    check(np.allclose(got_c, want_c, rtol=ML_CENTRE_RTOL, atol=0),
          f"[ml] (c) centres differ from numpy's Lloyd by {rel:.3g}")
    differ = int((assign != want_a)[~ties].sum())
    check(differ == 0, f"[ml] (c) {differ} assignments differ outside "
          f"near-ties")
    print(f"[ml] (c) KMeans: {ML_KM_ROWS:,} × {ML_KM_DIM} float64 points, "
          f"k = {ML_KM_K}, {ML_KM_ITERS} Lloyd steps: fit median of 3 "
          f"{fit_ms:.1f} ms; centres within rtol {ML_CENTRE_RTOL} of numpy's "
          f"(max rel err {rel:.3g}); assignments equal but "
          f"{int((assign != want_a).sum())} of {int(ties.sum())} near-ties "
          f"(two nearest squared distances within {ML_TIE_RTOL} relative); "
          f"numpy oracle {oracle_ms:.1f} ms", flush=True)


def rmat_edges(scale, edge_factor, seed, device):
    """A Graph500 R-MAT edge list on ``device``: ``edge_factor << scale``
    (src, dst) pairs, each of ``scale`` bits chosen by quadrant with
    probabilities A, B, C, D from a seeded ``torch.Generator``, then the
    vertex labels permuted; self-loops and repeats kept (int32)."""
    import torch
    a, b, c = ML_RMAT_ABC
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    m = edge_factor << scale
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros_like(src)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        src |= (r >= a + b).to(torch.int64) << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)) \
            .to(torch.int64) << bit
    perm = torch.randperm(1 << scale, generator=gen, device=device)
    return perm[src].to(torch.int32), perm[dst].to(torch.int32)


def _ml_graphx(s):
    """(d): PageRank and connected components over a Graph500 R-MAT
    graph made on the card, against numpy/scipy."""
    import numpy as np
    import torch
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components as scc
    from spark_tpu_torch.graphx import Graph, connected_components, page_rank
    n = 1 << ML_RMAT_SCALE
    t0 = time.perf_counter()
    src, dst = rmat_edges(ML_RMAT_SCALE, ML_RMAT_EDGE_FACTOR, ML_SEED,
                          s.device)
    g = Graph(torch.arange(n, device=s.device), {}, src, dst)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    pr_ms, ranks = _ml_wall(lambda: page_rank(g, ML_PR_ITERS))
    cc_ms, labels = _ml_wall(lambda: connected_components(g))
    _ml_card("(d) page_rank", lambda: page_rank(g, ML_PR_ITERS))
    _ml_card("(d) connected_components",
             lambda: connected_components(g))
    ranks, labels = ranks.cpu().numpy(), labels.cpu().numpy()
    hs, hd = src.cpu().numpy(), dst.cpu().numpy()        # the one copy
    t0 = time.perf_counter()
    out_deg = np.maximum(np.bincount(hs, minlength=n), 1).astype(np.float64)
    A = csr_matrix((np.ones(len(hs)), (hd, hs)), shape=(n, n))
    want = np.ones(n)
    for _ in range(ML_PR_ITERS):
        want = 0.15 + 0.85 * (A @ (want / out_deg))
    k, lab = scc(A, directed=True, connection="weak")
    mins = np.full(k, n, np.int64)
    np.minimum.at(mins, lab, np.arange(n, dtype=np.int64))
    oracle_ms = (time.perf_counter() - t0) * 1e3
    rel = float(np.max(np.abs(ranks - want) / np.abs(want)))
    check(rel <= ML_PR_RTOL, f"[ml] (d) PageRank differs from the scipy "
          f"oracle by {rel:.3g} relative")
    check(np.array_equal(labels, mins[lab]), "[ml] (d) component labels "
          "differ from scipy's per-component minimum vertex id")
    isolated = int((np.bincount(hs, minlength=n)
                    + np.bincount(hd, minlength=n) == 0).sum())
    print(f"[ml] (d) GraphX on a Graph500 R-MAT graph, scale "
          f"{ML_RMAT_SCALE} ({n:,} vertices, {isolated:,} isolated, kept), "
          f"edge factor {ML_RMAT_EDGE_FACTOR} ({len(hs):,} edges), made on "
          f"the card in {gen_ms:.1f} ms: page_rank ({ML_PR_ITERS} "
          f"iterations) median of 3 {pr_ms:.2f} ms, max rel err vs scipy "
          f"{rel:.3g} (tol {ML_PR_RTOL}); connected_components median of 3 "
          f"{cc_ms:.2f} ms, {k:,} components, labels equal to scipy's "
          f"per-component minimum vertex id exactly; oracles "
          f"{oracle_ms:.1f} ms", flush=True)


def _ml_events(s, root, events):
    """(e): one Start / End pair per execution in the event log and on
    the listener, none failed; the history page lists them; the CSV sink
    holds one file per source."""
    from spark_tpu_torch import ui
    log_dir = os.path.join(root, "events")
    logged = ui.load_events(log_dir)
    pairs = ui._pair_queries(logged)
    starts = sum(e["event"] == "SQLExecutionStart" for e in events)
    ends = [e for e in events if e["event"] == "SQLExecutionEnd"]
    check(starts == len(ends) == len(pairs) > 0
          and [e["event"] for e in logged] == [e["event"] for e in events]
          and all(q["end"] is not None for q in pairs)
          and not any("error" in e for e in ends),
          f"[ml] (e) listener saw {starts} starts and {len(ends)} ends, "
          f"the log {len(pairs)} pairs")
    page = ui.write_history(log_dir)
    text = open(page, encoding="utf-8").read()
    check(f"{len(pairs)} queries ({len(pairs)} finished, 0 failed)"
          in text, "[ml] (e) the history page does not list every query")
    snaps = s.metricsSystem.report()
    csvs = sorted(os.listdir(os.path.join(root, "metrics")))
    check(csvs == sorted(f"{name}.csv" for name in snaps),
          f"[ml] (e) CSV sink files {csvs} vs sources {sorted(snaps)}")
    print(f"[ml] (e) event log: {len(pairs)} SQLExecutionStart / "
          f"SQLExecutionEnd pairs, one per execution of (a)–(d), equal to "
          f"the listener's, none failed; history page "
          f"{os.path.getsize(page):,} bytes lists them; CSV sink: "
          f"{len(csvs)} files, one per source ({', '.join(sorted(snaps))})",
          flush=True)


def phase_ml(session, k1_entries, k2_entry, pull_entry):
    """RDD, ML and GraphX on the card (see the module's docstring, 22):
    (a) an RDD word count, then ``toDF`` onto hash-agg's shape (K1),
    (b) a HIGGS-shaped logistic-regression pipeline, (c) KMeans, (d)
    PageRank and connected components on an R-MAT graph, (e) the event
    log, the history page and the CSV sink."""
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch.sql.session import SparkSession
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ml_")
    cuda_a2a.LAUNCHES = cuda_a2a.PULL_LAUNCHES = 0
    s, events = _ml_session(session, root)
    try:
        _ml_rdd(s, k1_entries)
        _ml_logistic(s)
        _ml_kmeans(s)
        _ml_graphx(s)
        _ml_events(s, root, events)
    finally:
        s.stop()
        SparkSession._active = session
        shutil.rmtree(root, ignore_errors=True)
    check(cuda_a2a.LAUNCHES == cuda_a2a.PULL_LAUNCHES == 0,
          f"[ml] K2 launched {cuda_a2a.LAUNCHES} / {cuda_a2a.PULL_LAUNCHES} "
          "times on one card")
    k2_entry["ml_launches"] = cuda_a2a.LAUNCHES
    pull_entry["ml_launches"] = cuda_a2a.PULL_LAUNCHES
    print(f"[ml] phase {time.perf_counter() - t_phase:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# [cards]: shards on several cards
# ---------------------------------------------------------------------------

#: NVLink's rate to the other cards of the host, each way (H100 SXM)
NVLINK_BYTES_PER_S = 450e9
#: [cards]: the mesh's shards (one per card on four cards)
CARDS_SHARDS = 4
#: the barriers timed back to back, and the limit of the one made to fail
CARDS_BARRIERS = 200
CARDS_TIMEOUT_TEST_S = 0.05
#: a shard that raises must end every shard in an error within this
CARDS_ABORT_LIMIT_S = 30.0
#: [cards] (6): the idle pull over NVLink, at [ici]'s largest pull
CARDS_PULL_BYTES = 85_467_840


def sync_cards():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _cards_wall_ms(fn, warmup=1, reps=5):
    """Median host wall of a call, every card synchronized around it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync_cards()
        t0 = time.perf_counter()
        fn()
        sync_cards()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _kernel_ms_by_card(fn, name, reps=10, attempts=3):
    """Mean device time per launch of the kernel ``name`` on each card
    (``torch.profiler``, the kernel alone), over ``reps`` calls that launch
    it once on each card that runs it: {device index: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # marker kernels on every card at both ends of the timed launches:
    # the profiler drops records at a window's edges (kernel_device_ms)
    markers = [torch.zeros(1, device=f"cuda:{d}")
               for d in range(torch.cuda.device_count())]

    def mark():
        for m in markers:
            m.fill_(1.0)

    fn()
    mark()
    sync_cards()
    for attempt in range(1, attempts + 1):
        pad = PROFILE_PAD_S * 4 ** (attempt - 1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(PROFILE_LEAD_MARKERS):
                mark()
            sync_cards()
            time.sleep(pad)
            for _ in range(reps):
                fn()
            mark()
            sync_cards()
            time.sleep(pad)
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and name in e.name:
                us, n = per.get(e.device_index, (0.0, 0))
                per[e.device_index] = (us + e.time_range.elapsed_us(),
                                       n + 1)
        if per and all(n == reps for _us, n in per.values()):
            return {d: us / n / 1e3 for d, (us, n) in sorted(per.items())}
        print(f"[profile] attempt {attempt}: launches of {name} by card "
              f"{ {d: n for d, (_u, n) in per.items()} }, expected {reps} "
              "each", flush=True)
    check(False, f"the profiler never saw {reps} launches of {name} on "
          "each card")


def _cards_rows(df, hash_df):
    if df is hash_df:
        return sorted((r["k"], r["s"], r["c"]) for r in df.collect())
    return [tuple(r) for r in df.collect()]


def one_card_rows_main(path):
    """``chip_smoke.py --one-card-rows PATH``: the mesh lane's three queries
    at 4 shards on ONE card (the caller sets ``CUDA_VISIBLE_DEVICES``),
    their rows written to PATH as ``repr`` strings (bit for bit)."""
    import torch
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.session import SparkSession
    from spark_tpu_torch.testing import (hash_agg_query, hash_agg_table,
                                         q3_query, q3_tables)
    check(torch.cuda.device_count() == 1, "one-card rows need one card")
    session = SparkSession.builder.appName("one_card").getOrCreate()
    hash_table = hash_agg_table(MAIN_N, MAIN_GROUPS)
    tables = q3_tables(Q3_ROWS["store_sales"], Q3_ROWS["item"],
                       Q3_ROWS["date_dim"])
    hash_df = hash_agg_query(session, F, hash_table)
    q3_df = q3_query(session, F, T, tables)
    out = {}
    for name, df, threshold in (("hash-agg", hash_df, None),
                                ("q3 broadcast joins", q3_df, None),
                                ("q3 shuffled joins", q3_df, 0)):
        _mesh(session, CARDS_SHARDS, threshold)
        out[name] = repr(_cards_rows(df, hash_df))
    session.stop()
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def _cards_one_card_child(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    path = os.path.join(root, "one_card.json")
    log = open(os.path.join(root, "one_card.txt"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--one-card-rows", path], env=env, cwd=here,
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log, path


#: [cards]: the flag ping-pong's round trips and the limit of its wait
CARDS_PINGPONG_ROUNDS = 2000
CARDS_PINGPONG_TIMEOUT_S = 1.0


def _cards_timed(cards, streams, fn, per):
    """Device time per unit of ``fn``'s work on the cards: CUDA events
    recorded on every card's stream around it, the slowest card, over
    ``per`` units."""
    import torch
    starts = [torch.cuda.Event(enable_timing=True) for _ in cards]
    ends = [torch.cuda.Event(enable_timing=True) for _ in cards]
    for c, st, e in zip(cards, streams, starts):
        with torch.cuda.device(c):
            e.record(st)
    fn()
    for c, st, e in zip(cards, streams, ends):
        with torch.cuda.device(c):
            e.record(st)
    sync_cards()
    return max(s.elapsed_time(e) for s, e in zip(starts, ends)) / per


def _cards_graphs(cards, body):
    """One graph per card, captured together from this thread (relaxed,
    instantiated after every capture ends, as the stage cache captures a
    multi-card entry): ``body(capture_streams)`` enqueues the work.
    Returns (graphs, their streams, replay)."""
    import torch
    graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in cards]
    cap = [torch.cuda.Stream(device=c) for c in cards]
    for c, g, st in zip(cards, graphs, cap):
        with torch.cuda.device(c), torch.cuda.stream(st):
            g.capture_begin(capture_error_mode="relaxed")
    body(cap)
    for c, g, st in zip(cards, graphs, cap):
        with torch.cuda.device(c), torch.cuda.stream(st):
            g.capture_end()
        with torch.cuda.device(c):
            g.instantiate()

    def replay():
        for c, g, st in zip(cards, graphs, cap):
            with torch.cuda.device(c), torch.cuda.stream(st):
                g.replay()
    return graphs, cap, replay


def _cards_pingpong(cards):
    """Half a flag round trip between cards 0 and 1 over NVLink: the
    latency floor of any order across cards (ms; the best of 3)."""
    import ctypes

    import torch
    from spark_tpu_torch import cuda_a2a
    lib = cuda_a2a._lib()
    a, b = cards[0], cards[1]
    words = [torch.zeros(1, dtype=torch.int64, device=a),
             torch.zeros(1, dtype=torch.int64, device=b)]
    ns = torch.zeros(1, dtype=torch.int64, device=a)
    devs = (ctypes.c_int * 2)(a.index, b.index)
    mine = (ctypes.c_void_p * 2)(words[0].data_ptr(), words[1].data_ptr())
    peer = (ctypes.c_void_p * 2)(words[1].data_ptr(), words[0].data_ptr())
    streams = (ctypes.c_void_p * 2)(
        torch.cuda.current_stream(a).cuda_stream,
        torch.cuda.current_stream(b).cuda_stream)
    best = None
    for _ in range(3):
        for w in words:
            w.zero_()
        sync_cards()
        rc = lib.spark_flag_pingpong(
            devs, mine, peer, streams, CARDS_PINGPONG_ROUNDS,
            int(CARDS_PINGPONG_TIMEOUT_S * 1e9),
            ctypes.c_void_p(ns.data_ptr()))
        check(rc == 0, f"[cards] flag ping-pong launch: CUDA error {rc}")
        sync_cards()
        got = int(ns.item())
        check(got > 0, f"[cards] the flag ping-pong timed out ({got})")
        ms = got / (2 * CARDS_PINGPONG_ROUNDS) / 1e6
        best = ms if best is None else min(best, ms)
    return best


def _cards_barrier(cards):
    """The order across cards alone.  (a) The fused exchange's
    arrive-and-wait as the path makes it, the guards' gather of one bool
    per card to card 0 (card 0 copies, the others arrive and wait): R
    back to back from the host, then every card's state read back (the
    epoch, each arrival slot and card 0's done slot advanced by R, no
    failure), its time per exchange from the host and in one graph per
    card replayed together (CUDA events, the slowest card), and each
    card's launch alone (profiler).  (b) The latency floor: half a flag
    round trip between cards 0 and 1.  (c) The separate barrier_kernel
    that the old order took twice per exchange: R back to back and R in
    one graph per card, its slots read back.  (d) The plain version: each
    card's stream waiting on an event recorded on every card's.  (e) A
    lone card: the fused launch on card 0 alone at a 50 ms limit times
    out naming a peer, and the next check raises and resets the set."""
    import ctypes

    import torch
    from spark_tpu_torch import cuda_a2a
    n = len(cards)
    streams = [torch.cuda.current_stream(c) for c in cards]
    card_of = list(range(n))
    guards = [[torch.ones((), dtype=torch.bool, device=c) for c in cards]]
    order = cuda_a2a.barrier_set(cards)

    def gather(sts=streams):
        return cuda_a2a.all_to_all_cards(guards, card_of, cards, sts, True,
                                         range(1))

    # (a) the arrive-and-wait, back to back from the host
    for _ in range(10):
        gather()
    sync_cards()
    base = [order.read_state(r) for r in range(n)]
    host_ms = _cards_timed(cards, streams,
                           lambda: [gather() for _ in range(CARDS_BARRIERS)],
                           CARDS_BARRIERS)
    after = [order.read_state(r) for r in range(n)]
    err = 0
    for r, (b0, b1) in enumerate(zip(base, after)):
        want = b0["epoch"] + CARDS_BARRIERS
        err = max([err, abs(b1["epoch"] - want), abs(b1["done"][0] - want),
                   b1["failed"], b1["blocks"], abs(b1["arrived"] - want)]
                  + [abs(f - want) for f in b1["flags"]]
                  + [abs(d - d0) for d, d0 in zip(b1["done"][1:],
                                                  b0["done"][1:])])
    check(err == 0 and not order.failed(), f"[cards] the fused exchange's "
          f"states after {CARDS_BARRIERS} gathers: {after} from {base}")
    got = gather()
    sync_cards()
    check(got[0] is not None and bool(got[0][0].all())
          and all(g is None for g in got[1:]), "[cards] the guards' "
          "gather differs from its plain version")
    # in one graph per card, replayed together
    prev = cuda_a2a.CAPTURE_SOURCES
    cuda_a2a.CAPTURE_SOURCES = lambda p: True     # every buffer stays alive
    try:
        graphs, cap, replay = _cards_graphs(
            cards, lambda sts: [gather(sts) for _ in range(CARDS_BARRIERS)])
    finally:
        cuda_a2a.CAPTURE_SOURCES = prev
    replay()
    sync_cards()
    graph_ms = min(_cards_timed(cards, cap, replay, CARDS_BARRIERS)
                   for _ in range(3))
    del graphs
    alone = _kernel_ms_by_card(gather, "exchange_kernel")
    # (b) the latency floor
    floor_ms = _cards_pingpong(cards)
    # (c) the old order's separate barrier
    b = cuda_a2a.BarrierSet([c.index for c in cards])

    def run(times, sts=streams):
        for _ in range(times):
            for rank, (c, st) in enumerate(zip(cards, sts)):
                with torch.cuda.device(c):
                    b.launch(rank, st, cuda_a2a.BARRIER_TIMEOUT_S)

    run(10)
    sync_cards()
    old_base = [b.read(r) for r in range(n)]
    old_host_ms = _cards_timed(cards, streams,
                               lambda: run(CARDS_BARRIERS), CARDS_BARRIERS)
    graphs, cap, replay = _cards_graphs(
        cards, lambda sts: run(CARDS_BARRIERS, sts))
    replay()
    sync_cards()
    old_ms = min(_cards_timed(cards, cap, replay, CARDS_BARRIERS)
                 for _ in range(3))
    old_after = [b.read(r) for r in range(n)]
    old_err = 0
    for (e0, _f0), (e1, f1) in zip(old_base, old_after):
        want = e0 + 5 * CARDS_BARRIERS
        old_err = max([old_err, abs(e1 - want)] + [abs(f - want) for f in f1])
    del graphs
    check(old_err == 0 and not b.failed(), f"[cards] barrier_kernel states "
          f"after {CARDS_BARRIERS} barriers: {old_after} from {old_base}")

    # (d) the plain version: the same cross-card order in PyTorch alone,
    # each card's stream waiting on an event recorded on every card's
    # stream, launched back to back from the host
    def plain(times):
        for _ in range(times):
            events = []
            for c, st in zip(cards, streams):
                with torch.cuda.device(c):
                    e = torch.cuda.Event()
                    e.record(st)
                    events.append(e)
            for c, st in zip(cards, streams):
                with torch.cuda.device(c):
                    for e in events:
                        st.wait_event(e)

    plain(10)
    sync_cards()
    plain_ms = _cards_timed(cards, streams, lambda: plain(CARDS_BARRIERS),
                            CARDS_BARRIERS)
    # (e) card 0 alone at a short limit: it times out, the wrapper raises
    outs = [torch.empty((1, n), dtype=torch.bool, device=cards[0])]
    plan = cuda_a2a.a2a_card_plan(
        [[x.data_ptr() for x in guards[0]]], [[outs[0].data_ptr()]]
        + [None] * (n - 1), [1], [0], card_of, range(1),
        cross=order.cross(CARDS_TIMEOUT_TEST_S))
    d0, n_dst, table, total = plan[0]
    buf = (ctypes.c_longlong * len(table))(*table)
    with torch.cuda.device(cards[0]):
        rc = cuda_a2a._lib().spark_exchange_part(
            buf, len(table), 1, n, d0, n_dst,
            cuda_a2a.first_sender(n, d0, n_dst), total,
            streams[0].cuda_stream)
    check(rc == 0, f"[cards] the lone launch: CUDA error {rc}")
    t0 = time.perf_counter()
    torch.cuda.synchronize(cards[0])
    lone_s = time.perf_counter() - t0
    failed = order.failed()
    check(len(failed) == 1 and failed[0][0] == 0
          and 0 < failed[0][1] < n, f"[cards] a lone card's exchange did "
          f"not time out naming a peer ({failed})")
    try:
        order.check()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and "timed out" in raised, "[cards] a timed-"
          "out exchange did not raise")
    check(not order.failed() and order.read(0)[0] == 0, "[cards] the "
          "timed-out set was not reset")
    moved = 2 * 8 * n * n
    bound = moved / NVLINK_BYTES_PER_S * 1e3
    print(f"[cards] the fused exchange's arrive-and-wait on {n} cards (the "
          f"guards' gather to card 0: card 0 copies {n} B, the others "
          f"arrive and wait): {graph_ms:.5f} ms per exchange in one graph "
          f"per card replayed together ({CARDS_BARRIERS} per graph; CUDA "
          f"events, the slowest card, the best of 3), {host_ms:.5f} ms "
          f"launched back to back from the host; each card's launch alone "
          f"{ {d: round(v, 5) for d, v in alone.items()} } ms; every epoch, "
          f"arrival slot and card 0's done slot advanced by "
          f"{CARDS_BARRIERS} (max abs err {err}); latency floor (half a "
          f"flag round trip, cuda:{cards[0].index} <-> "
          f"cuda:{cards[1].index}, {CARDS_PINGPONG_ROUNDS} round trips, "
          f"the best of 3) {floor_ms:.5f} ms; bound {bound:.7f} ms ({moved} "
          f"B of flags over NVLink)", flush=True)
    print(f"[cards] the old order's barrier_kernel: {old_ms:.5f} ms per "
          f"barrier in one graph per card, {old_host_ms:.5f} ms back to "
          f"back from the host (two per exchange); its epochs and slots "
          f"advanced by {5 * CARDS_BARRIERS} (max abs err {old_err}); the "
          f"plain version (each card's stream waiting on an event of every "
          f"card's, back to back from the host) {plain_ms:.5f} ms per "
          f"barrier; card 0's exchange alone at a {CARDS_TIMEOUT_TEST_S} s "
          f"limit ended after {lone_s * 1e3:.1f} ms of host wait, naming "
          f"rank {failed[0][1]}, and raised: {raised[:120]}...",
          flush=True)
    return {"name": "barrier", "route": "cuda",
            "source": "spark_tpu_torch/csrc/all_to_all.cu",
            "replaces": "spark_tpu/parallel/ici.py:368 (the barrier "
                        "semaphore of _pallas_a2a): exchange_kernel's "
                        "arrive-and-wait",
            "launches": 0, "max_abs_err": err, "ms": graph_ms,
            "host_launched_ms": host_ms, "alone_by_card_ms": alone,
            "latency_floor_ms": floor_ms,
            "old_barrier_kernel_ms": old_ms,
            "old_barrier_kernel_host_ms": old_host_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "lone_timeout_ms": lone_s * 1e3}


def _cards_bytes(planes, card_of, gather):
    """(bytes that leave each card, bytes that stay on it, bytes that
    arrive at it) of one exchange, per card."""
    n = len(card_of)
    leave = [0] * (max(card_of) + 1)
    stay = [0] * (max(card_of) + 1)
    arrive = [0] * (max(card_of) + 1)
    for shards in planes:
        bb = shards[0].numel() * shards[0].element_size() \
            // (1 if gather else n)
        for s in range(n):
            for d in range(n):
                if card_of[s] == card_of[d]:
                    stay[card_of[s]] += bb
                else:
                    leave[card_of[s]] += bb
                    arrive[card_of[d]] += bb
    return leave, stay, arrive


def cards_exchange_bound_ms(leave, stay, arrive):
    """The least time of one exchange across cards: on each card the
    larger of its NVLink time (the bytes leaving it, or those arriving,
    each way at 450 GB/s) and its memory time (the bytes staying, read
    and written, the bytes leaving, read, and those arriving, written, at
    the card's memory rate), and of the cards the slowest.  The two run
    in parallel, so the bound is their larger, not their sum."""
    return max(max(max(lv, ar) / NVLINK_BYTES_PER_S,
                   (2 * sy + lv + ar) / HBM_BYTES_PER_S) * 1e3
               for lv, sy, ar in zip(leave, stay, arrive))


def _cards_k2_alone(call, cards):
    """K2 across cards at the largest recorded all-to-all: per call (CUDA
    events on every card, the slowest) the fused exchange through the
    wrapper and launched directly (its tables built once), in turns with
    the old order (barrier, one copy launch per receiving card, each from
    the sender after its own receivers, barrier; the same copy kernel as
    before, ``all_to_all_kernel``), each alone
    per card (profiler: ``exchange_kernel``, and the old order's copy),
    the library call (``copy_`` per peer block into the same outputs), the
    bound, and the one-card K2 at the same bytes."""
    import ctypes

    import torch
    from spark_tpu_torch import cuda_a2a
    _q, planes, card_of, devices, gather, receivers, _outs = call
    streams = [torch.cuda.current_stream(d) for d in devices]

    def kernel():
        return cuda_a2a.all_to_all_cards(planes, card_of, devices, streams,
                                         gather, receivers)

    outs = kernel()

    def library():
        for c, per in enumerate(outs):
            d0, n_dst = cuda_a2a.card_receivers(card_of, c, receivers)
            for k, o in enumerate(per or []):
                for r in range(n_dst):
                    for s, x in enumerate(planes[k]):
                        o[r, s].copy_(x if gather else x[d0 + r])

    # the old order into the same outputs
    lib = cuda_a2a._lib()
    n = len(card_of)
    nbytes = [sh[0].numel() * sh[0].element_size() // (1 if gather else n)
              for sh in planes]
    plan = cuda_a2a.a2a_card_plan(
        [[x.data_ptr() for x in sh] for sh in planes],
        [[o.data_ptr() for o in per] if per is not None else None
         for per in outs], nbytes, [0 if gather else nb for nb in nbytes],
        card_of, receivers)
    tables = [(ctypes.c_longlong * len(t))(*t) for _d, _n, t, _t in plan]
    fused_tables = [
        (d0, n_dst, (ctypes.c_longlong * len(t))(*t), total)
        for d0, n_dst, t, total in cuda_a2a.a2a_card_plan(
            [[x.data_ptr() for x in sh] for sh in planes],
            [[o.data_ptr() for o in per] if per is not None else None
             for per in outs], nbytes,
            [0 if gather else nb for nb in nbytes], card_of, receivers,
            cross=cuda_a2a.barrier_set(devices).cross(
                cuda_a2a.BARRIER_TIMEOUT_S))]

    def direct():
        # the fused launches of the wrapper, into the same outputs, their
        # tables built once: the device's part of a call
        for (d0, n_dst, buf, total), dev, st in zip(fused_tables, devices,
                                                    streams):
            with torch.cuda.device(dev):
                rc = lib.spark_exchange_part(
                    buf, len(buf), len(planes), n, d0, n_dst,
                    cuda_a2a.first_sender(n, d0, n_dst) if n_dst else 0,
                    total, st.cuda_stream)
            check(rc == 0, f"[cards] exchange launch: CUDA error {rc}")

    def old_order():
        # each card from the sender after its own receivers, as before
        cuda_a2a.barrier(devices, streams)
        for (d0, n_dst, _t, total), buf, dev, st in zip(
                plan, tables, devices, streams):
            if total:
                with torch.cuda.device(dev):
                    rc = lib.spark_all_to_all_part(
                        buf, len(buf), len(planes), n, d0, n_dst,
                        (d0 + n_dst) % n, total, st.cuda_stream)
                check(rc == 0, f"[cards] copy launch: CUDA error {rc}")
        cuda_a2a.barrier(devices, streams)

    def per_call(fn, reps=10):
        fn()
        sync_cards()
        return statistics.median(_cards_timed(devices, streams, fn, 1)
                                 for _ in range(reps))

    turns = {"fused": [], "direct": [], "old": []}
    calls = {"fused": kernel, "direct": direct, "old": old_order}
    for turn in ("fused", "direct", "old", "old", "direct", "fused"):
        turns[turn].append(per_call(calls[turn]))
    alone_turns = {"fused": [], "old": []}
    for turn in ("fused", "old", "old", "fused"):
        if turn == "fused":
            alone_turns[turn].append(_kernel_ms_by_card(kernel,
                                                        "exchange_kernel"))
        else:
            alone_turns[turn].append(_kernel_ms_by_card(
                old_order, "all_to_all_kernel"))
    want = cuda_a2a.all_to_all_plain(planes, gather, card_of, devices,
                                     receivers)
    for fn, what in ((old_order, "the old order's"),
                     (direct, "the direct launches'")):
        for per in outs:
            for o in per or []:
                o.zero_()
        fn()
        sync_cards()
        check(all(torch.equal(g, w) for gs, ws in zip(outs, want)
                  for g, w in zip(gs or [], ws or [])),
              f"[cards] {what} exchange differs from its plain version")
    got = kernel()
    sync_cards()
    check(all(torch.equal(g, w) for gs, ws in zip(got, want)
              for g, w in zip(gs or [], ws or [])),
          "[cards] the timed exchange differs from its plain version")
    del got, want
    lib_ms = per_call(library)
    k_wall = _cards_wall_ms(kernel, reps=10)
    lib_wall = _cards_wall_ms(library, reps=10)
    plain_ms = _cards_wall_ms(lambda: cuda_a2a.all_to_all_plain(
        planes, gather, card_of, devices, receivers), reps=3)
    leave, stay, arrive = _cards_bytes(planes, card_of, gather)
    bound = cards_exchange_bound_ms(leave, stay, arrive)
    total = sum(leave) + sum(stay)
    # the one-card K2 at the same bytes: every sender's buffers on card 0
    one = [[x.to(devices[0]) for x in shards] for shards in planes]
    one_ms = cuda_ms(lambda: cuda_a2a.all_to_all(one, gather))
    one_alone = kernel_device_ms(lambda: cuda_a2a.all_to_all(one, gather),
                                 "all_to_all_kernel", reps=10)
    one_bound = 2 * total / HBM_BYTES_PER_S * 1e3
    del one
    k_ms = statistics.median(turns["fused"])
    alone = {d: min(t[d] for t in alone_turns["fused"])
             for d in alone_turns["fused"][0]}

    def slowest(t):
        return ", ".join(f"{max(x.values()):.4f}" for x in t)

    print(f"[cards] K2 across {len(devices)} cards at the largest recorded "
          f"exchange ({_a2a_desc(planes, gather)}, {total:,} B, leaving "
          f"each card {leave} B, staying {stay} B): per call in turns "
          f"fused through the wrapper, fused launched directly, old, old, "
          f"direct, wrapper: {turns['fused'][0]:.4f}, "
          f"{turns['direct'][0]:.4f}, {turns['old'][0]:.4f}, "
          f"{turns['old'][1]:.4f}, {turns['direct'][1]:.4f}, "
          f"{turns['fused'][1]:.4f} ms (the old order: barrier, copy, "
          f"barrier, launched directly; CUDA events, the slowest card; "
          f"fused wall {k_wall:.4f}); alone, the slowest card, in turns "
          f"fused "
          f"(exchange_kernel), old (its copy alone), old, fused: "
          f"{slowest(alone_turns['fused'][:1])}, "
          f"{slowest(alone_turns['old'])}, "
          f"{slowest(alone_turns['fused'][1:])} ms; the fused launch alone "
          f"per card {  {d: round(v, 4) for d, v in alone.items()} } ms; "
          f"bound {bound:.4f} ms (on the slowest card the larger of its "
          f"NVLink time, the bytes leaving or arriving at 450 GB/s, and its "
          f"memory time, every byte it reads or writes at 3.35 TB/s); the "
          f"library call (copy_ per peer block) {lib_ms:.4f} ms (wall "
          f"{lib_wall:.4f}); plain version {plain_ms:.2f} ms; the one-card "
          f"K2 at the same bytes {one_ms:.4f} ms per call, {one_alone:.4f} "
          f"alone (bound {one_bound:.4f})", flush=True)
    return {"ms": k_ms, "ms_turns": turns["fused"],
            "direct_ms_turns": turns["direct"],
            "old_order_ms_turns": turns["old"], "wall_ms": k_wall,
            "alone_by_card_ms": alone, "alone_ms": max(alone.values()),
            "alone_turns_ms": [max(x.values())
                               for x in alone_turns["fused"]],
            "old_copy_alone_turns_ms": [max(x.values())
                                        for x in alone_turns["old"]],
            "library_ms": lib_ms, "library_wall_ms": lib_wall,
            "plain_ms": plain_ms, "bound_ms": bound, "bytes": total,
            "leave": leave, "stay": stay, "arrive": arrive,
            "one_card_ms": one_ms, "one_card_alone_ms": one_alone,
            "one_card_bound_ms": one_bound}


def _cards_abort(session, df):
    """A spy raises in shard 2 before its second collective: every shard
    must end in an error, the query must raise within
    ``CARDS_ABORT_LIMIT_S``, and the next run must answer."""
    import threading
    from collections import Counter
    from spark_tpu_torch.parallel import spmd
    meet = spmd.Communicator._meet
    calls = Counter()

    def failing(self, shard, value, fn):
        calls[shard] += 1
        if shard == 2 and calls[shard] == 2:
            raise RuntimeError("spy: shard 2 fails before its second "
                               "collective")
        return meet(self, shard, value, fn)

    out = {}

    def go():
        try:
            _cards_rows(df, None)
            out["error"] = None
        except Exception as e:  # noqa: BLE001 — the expected failure
            out["error"] = e

    spmd.Communicator._meet = failing
    _lane(session, "eager")
    t0 = time.perf_counter()
    try:
        t = threading.Thread(target=go, daemon=True)
        t.start()
        t.join(CARDS_ABORT_LIMIT_S * 4)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        spmd.Communicator._meet = meet
        _lane(session, "graph")
    check(not t.is_alive(), "[cards] a failing shard left the program "
          "hanging")
    err = out.get("error")
    check(err is not None and "spy" in str(err), f"[cards] the failing "
          f"shard's error did not surface ({err!r})")
    check(ms < CARDS_ABORT_LIMIT_S * 1e3, f"[cards] the failing program "
          f"took {ms:.0f} ms to end")
    sync_cards()
    print(f"[cards] a shard raising before its second collective: every "
          f"shard ended, the query raised {type(err).__name__} "
          f"({str(err)[:60]}) after {ms:.1f} ms, no card left waiting",
          flush=True)
    return ms


def _cards_mesh(session, hash_df, hash_table, q3_df, tables, one_card):
    """[cards] (2): the mesh lane's three queries at 4 shards, one per
    card.  Returns the recorded K2 calls, the kernels line's numbers and
    K2's and the barrier's runs on the cards."""
    import torch
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch import types as T
    from spark_tpu_torch.parallel import executor as EX
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (hash_agg_oracle, hash_agg_query,
                                         hash_agg_table, q3_oracle,
                                         q3_query, q3_tables)
    want_hash = hash_agg_oracle(hash_table)
    want_q3 = q3_oracle(tables)
    runs = [("hash-agg", hash_df, None),
            ("q3 broadcast joins", q3_df, None),
            ("q3 shuffled joins", q3_df, 0)]
    clear_stage_cache()
    cache = stage_cache()
    reserves = []
    reserve_fn = EX.DistributedExecution._reserves

    def spy_reserves(self, pq):
        got = reserve_fn(self, pq)
        reserves.append([nb for _m, nb in got])
        return got

    calls, query = [], [None]
    launch = cuda_a2a.all_to_all_cards

    def spy(planes, card_of, devices, streams=None, gather=False,
            receivers=None):
        out = launch(planes, card_of, devices, streams, gather, receivers)
        if not torch.cuda.is_current_stream_capturing():
            calls.append((query[0], [list(p) for p in planes],
                          list(card_of), list(devices), gather, receivers,
                          out))
        return out

    first = {}
    zero_counts()
    cuda_a2a.all_to_all_cards = spy
    EX.DistributedExecution._reserves = spy_reserves
    try:
        for name, df, threshold in runs:
            _mesh(session, CARDS_SHARDS, threshold)
            query[0] = name
            keys = {e.key for e in cache.entries()}
            s0, r0 = cache.stats(), len(reserves)
            t0 = time.perf_counter()
            got = _cards_rows(df, hash_df)
            ms = (time.perf_counter() - t0) * 1e3
            s1 = cache.stats()
            first[name] = {"rows": got, "ms": ms,
                           "entry": _mesh_entry(cache, keys),
                           "builds": s1["builds"] - s0["builds"],
                           "build_ms": s1["compile_ms"] - s0["compile_ms"],
                           "reserve": reserves[-1] if len(reserves) > r0
                           else None}
    finally:
        cuda_a2a.all_to_all_cards = launch
        EX.DistributedExecution._reserves = reserve_fn
    numbers = {}
    for name, df, threshold in runs:
        _mesh(session, CARDS_SHARDS, threshold)
        f = first[name]
        e = f["entry"]
        v = e.variants[-1]
        check(f["rows"] == (want_hash if df is hash_df else want_q3),
              f"[cards] {name} differs from the oracle")
        check(repr(f["rows"]) == one_card[name], f"[cards] {name}: the rows "
              "differ from the one-card mesh lane's bit for bit")
        check(e.key.endswith(f"|cards{CARDS_SHARDS}")
              and len(e.cards or ()) == CARDS_SHARDS
              and len(v.graphs) == CARDS_SHARDS,
              f"[cards] {name}: its entry is not one of {CARDS_SHARDS} "
              f"graphs ({e.key[:40]}…, cards {e.cards}, "
              f"{len(v.graphs)} graphs)")
        check(f["reserve"] is not None and len(f["reserve"]) == CARDS_SHARDS
              and all(b <= r for b, r in zip(v.card_bytes, f["reserve"])),
              f"[cards] {name}: graph bytes per card {v.card_bytes} beside "
              f"the reserves {f['reserve']}")
        s0 = cache.stats()
        l0 = cuda_a2a.LAUNCHES
        c0, b0 = dict(cuda_a2a.CARD_REPLAYED), \
            dict(cuda_a2a.CARD_REPLAYED_BARRIERS)
        got = _cards_rows(df, hash_df)
        s1 = cache.stats()
        copies = {d: n - c0.get(d, 0)
                  for d, n in cuda_a2a.CARD_REPLAYED.items()}
        barriers = {d: n - b0.get(d, 0)
                    for d, n in cuda_a2a.CARD_REPLAYED_BARRIERS.items()}
        check(got == f["rows"], f"[cards] {name}: the replay differs")
        # the gathers to card 0: the other cards arrive and wait
        waiting = sorted(d for d, n in barriers.items() if n > 0)
        check(s1["dispatches"] == s0["dispatches"] + 1
              and s1["variants"] == s0["variants"]
              and s1["guard_misses"] == s0["guard_misses"]
              and cuda_a2a.LAUNCHES == l0
              and len([d for d, n in copies.items() if n > 0]) >= 1
              and waiting == list(range(1, CARDS_SHARDS)),
              f"[cards] {name}: the warm run was no replay of every card's "
              f"graph (stage cache {s0} -> {s1}, copies {copies}, barriers "
              f"{barriers})")
        _lane(session, "eager")
        try:
            eager = _cards_rows(df, hash_df)
        finally:
            _lane(session, "graph")
        check(eager == got, f"[cards] {name}: the eager lane's rows differ")
        walls = []
        for lane in ("graph", "eager", "eager", "graph"):
            _lane(session, lane)
            walls.append(_cards_wall_ms(df.collect))
        _lane(session, "graph")
        prof = profile_query(f"cards {name} x{CARDS_SHARDS} captured",
                             lambda: (df.collect(), sync_cards()),
                             own_kernels=OWN_KERNELS + (
                                 ("exchange", "exchange_kernel"),))
        # the exchanges' waits are device time inside exchange_kernel:
        # the busy share counts them, and the exchanges' time is printed
        busy = prof["device_ms"] / prof["wall_ms"] / CARDS_SHARDS
        numbers[name] = {
            "first_ms": f["ms"], "build_ms": f["build_ms"],
            "graph_walls_ms": [walls[0], walls[3]],
            "eager_walls_ms": [walls[1], walls[2]],
            "card_bytes": v.card_bytes, "reserve_bytes": f["reserve"],
            "copies_per_card": copies, "barriers_per_card": barriers,
            "busy_per_card": busy,
            "exchange_ms": prof["own"]["exchange"][1],
            "device_ms": prof["device_ms"]}
        print(f"[cards] {name} x{CARDS_SHARDS} shards on {CARDS_SHARDS} "
              f"cards: equal to the oracle and to the one-card mesh lane bit "
              f"for bit; one entry of {len(v.graphs)} graphs (first run "
              f"{f['ms']:.2f} ms, build {f['build_ms']:.2f} ms); a warm run "
              f"is a replay (K2 copy launches per card {copies}, "
              f"arrive-and-wait launches per card {barriers}, no wrapper "
              f"call); the eager lane equal; warm "
              f"wall, median of 5, in turns graph, eager, eager, graph: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms; graph bytes per "
              f"card {v.card_bytes} beside the reserves {f['reserve']}; "
              f"device busy {busy:.1%} per card (the exchanges' waits "
              f"included: exchange_kernel "
              f"{prof['own']['exchange'][1]:.3f} ms over the cards)",
              flush=True)
    # a second data set through the same entries
    hash2 = hash_agg_table(MAIN_N, MAIN_GROUPS, seed=MESH_SECOND_SEED)
    sales2 = q3_tables(Q3_ROWS["store_sales"], Q3_ROWS["item"],
                       Q3_ROWS["date_dim"],
                       seed=MESH_SECOND_SEED)["store_sales"]
    tables2 = dict(tables, store_sales=sales2)
    df2 = hash_agg_query(session, F, hash2)
    second = [("hash-agg", df2, None, hash_agg_oracle(hash2)),
              ("q3 broadcast joins", q3_query(session, F, T, tables2), None,
               q3_oracle(tables2)),
              ("q3 shuffled joins", q3_query(session, F, T, tables2), 0,
               q3_oracle(tables2))]
    for name, df, threshold, want in second:
        _mesh(session, CARDS_SHARDS, threshold)
        s0 = cache.stats()
        got = _cards_rows(df, df2)
        s1 = cache.stats()
        check(got == want, f"[cards] {name} on the second data set differs "
              "from its oracle")
        replay = s1["builds"] == s0["builds"] \
            and s1["variants"] == s0["variants"]
        if name == "hash-agg":
            check(replay, f"[cards] {name} on the second data set was no "
                  f"replay ({s0} -> {s1})")
        numbers[name]["second_replay"] = replay
        print(f"[cards] {name}, second data set (seed {MESH_SECOND_SEED}): "
              f"equal to its oracle; "
              f"{'a replay of the same graphs' if replay else 'built'}",
              flush=True)
    return calls, numbers


def _cards_streamed(session, root):
    """[cards] (4): [ooc]'s (a), hash-agg over an SF1-sized file at 4
    shards, one per card, in ``OOC_MESH_BATCH``-row batches."""
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (HASH_AGG_SQL, hash_agg_oracle,
                                         hash_agg_table)
    hash1 = hash_agg_table(MAIN_N, MAIN_GROUPS)
    s = session.newSession()
    path = os.path.join(root, "hash_t")
    s.createDataFrame(hash1).write.parquet(path)
    s.read.parquet(path).createOrReplaceTempView("hash_t")
    s.conf.set(SCAN_LIMIT_KEY, str(OOC_MESH_BATCH))
    _mesh(s, CARDS_SHARDS)
    c0 = dict(cuda_a2a.CARD_REPLAYED)
    got, m = _ooc_run(s, lambda: sorted(tuple(r) for r in
                                        s.sql(HASH_AGG_SQL).collect()))
    copies = {d: n - c0.get(d, 0) for d, n in cuda_a2a.CARD_REPLAYED.items()}
    check(got == [tuple(x) for x in hash_agg_oracle(hash1)],
          "[cards] the streamed mesh step differs from its oracle")
    steps = [e for e in stage_cache().entries()
             if e.key.startswith(f"mbdist{CARDS_SHARDS}|")
             or e.key.startswith(f"stream|mesh{CARDS_SHARDS}|")]
    check(m["batches"] > 1 and any(len(e.cards or ()) == CARDS_SHARDS
                                   for e in steps),
          f"[cards] the streamed step did not span the cards ({m['batches']}"
          f" batches, entries {[e.key[:30] for e in steps]})")
    s.stop()
    print(f"[cards] streamed mesh step: hash-agg over a {MAIN_N}-row file "
          f"at {CARDS_SHARDS} shards on {CARDS_SHARDS} cards, "
          f"{OOC_MESH_BATCH}-row batches: equal to its oracle; "
          f"{m['batches']} batches, wall {m['wall_ms']:.2f} ms, graph "
          f"builds {m['builds']}, K2 copies replayed per card {copies}",
          flush=True)


def _cards_tier(session, cards):
    """[cards] (6): two workers, on ``cuda:0`` and ``cuda:1``, run q93's
    hash lane on the device tier (``ici-cards``); the probe puts them in
    one domain and every pull is held bit-exact.  Then the pull alone over
    NVLink with the peer idle, in this process: a buffer on card 1 pulled
    into rows on card 0, its sentinel bytes past each block kept."""
    import numpy as np
    import torch
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch import types as T
    from spark_tpu_torch.parallel.ici import _padded_rows
    from spark_tpu_torch.testing import (CARD_TEXTS, OOC_SF1, jsonable_rows,
                                         register_card_tables)
    root = tempfile.mkdtemp(prefix="chip_smoke_cards_tier_")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    try:
        free, _total = torch.cuda.mem_get_info(cards[1])
        spec = {"hash_rows": MAIN_N, "hash_groups": MAIN_GROUPS,
                "q3": Q3_ROWS, "ooc": OOC_SF1, "ooc_seed": 19,
                "conf": {"spark.tpu.memory.hbmBudget":
                         str(int(free * 0.8))}}
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        for pid in range(2):
            log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "spark_tpu_torch.testing",
                 "crossproc-worker", str(pid), "2", root, "ici-cards",
                 str(ICI_TIMEOUT_S), f"cuda:{cards[pid].index}"],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here),
                log))
        sql = [t for t in CARD_TEXTS if t[0] == "c_hash"][0][2]
        one = session.newSession()
        register_card_tables(one, T, spec)
        want = jsonable_rows(tuple(r) for r in one.sql(sql).collect())
        one.stop()
        for p, _log in procs:
            p.wait(timeout=600)
        results = []
        for pid, (p, log) in enumerate(procs):
            log.close()
            text = open(os.path.join(root, f"log-p{pid}.txt")).read()
            check(p.returncode == 0, f"[cards] tier worker {pid} exited "
                  f"{p.returncode}:\n{text[-4000:]}")
            with open(os.path.join(root, f"result-p{pid}.json")) as f:
                results.append(json.load(f))
        workers_s = time.perf_counter() - t0
        walls, pulls = [], []
        for pid, r in enumerate(results):
            check(r["counters"]["tier_split_peers"] == 1, f"[cards] tier "
                  f"worker {pid} on cuda:{pid}: its domain has "
                  f"{r['counters']['tier_split_peers']} peers, not 1")
            q = r["queries"]["c_hash"]
            for i, run in enumerate([q["cold"]] + q["warm"]):
                check(_rows_match(run["rows"], want), f"[cards] tier worker "
                      f"{pid} run {i} differs from the single-process answer")
                if run["tier"]:
                    check(run["delta"].get("ici_exchanges", 0) >= 2
                          and run["pull_launches"] >= 1, f"[cards] tier "
                          f"worker {pid} run {i}: no device tier "
                          f"({run['delta']})")
                    pulls.append(run["split"]["pull_ms"])
            walls.append([w["wall_ms"] for w in q["warm"]])
        chk = [r["queries"]["_check"] for r in results]
        launches = sum(r["queries"]["_pull_launches"] for r in results)
        check(all(c["equal"] for c in chk) and sum(c["checked"] for c in chk)
              > 0 and not any(c.get("missing") for c in chk),
              f"[cards] cross-card pulls differ from their plain version "
              f"({chk})")
        print(f"[cards] device tier: workers on cuda:0 and cuda:1 in one "
              f"domain (tier_split_peers 1 each), q93's hash lane equal to "
              f"the single-process answer in every run; {launches} pulls, "
              f"{sum(c['checked'] for c in chk)} held bit-exact; warm walls "
              f"(device, host, host, device) by worker {walls} ms; workers "
              f"done in {workers_s:.2f} s", flush=True)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(root, ignore_errors=True)
    # the pull alone over NVLink, the peer idle: 6 int64 planes on card 1
    planes = ICI_IDLE_PLANES
    width = CARDS_PULL_BYTES // planes // 8
    g = torch.Generator(device=cards[1]).manual_seed(20)
    src = [torch.randint(-2**62, 2**62, (width,), generator=g,
                         device=cards[1], dtype=torch.int64)
           for _ in range(planes)]
    rows = _padded_rows(width, 8) + 2           # room past each block
    outs = [torch.full((1, rows), -1, dtype=torch.int64, device=cards[0])
            for _ in range(planes)]
    sources = [[x.data_ptr()] for x in src]
    nbytes = [width * 8] * planes

    def pull():
        with torch.cuda.device(cards[0]):
            cuda_a2a.pull(sources, outs, nbytes)

    def library():
        for o, x in zip(outs, src):
            o[0, :width].copy_(x)

    pull()
    sync_cards()
    for o, x in zip(outs, src):
        check(torch.equal(o[0, :width].cpu(), x.cpu())
              and bool((o[0, width:] == -1).all()),
              "[cards] the cross-card pull differs or overwrote the "
              "sentinel bytes past its block")
    with torch.cuda.device(cards[0]):
        ms = cuda_ms(pull)
        # back to back, the card never waits for the host: the kernel's
        # own time (the profiler drops this launch's first records)
        alone = cuda_ms_back_to_back(pull)
        lib_ms = cuda_ms(library)
        plain_ms = cuda_ms(lambda: cuda_a2a.pull_plain(
            [[x.to(cards[0])] for x in src]))
    moved = planes * width * 8
    bound = max(moved / NVLINK_BYTES_PER_S,
                moved / HBM_BYTES_PER_S) * 1e3
    print(f"[cards] the pull alone over NVLink ({moved:,} B, {planes} int64 "
          f"planes of {width:,} rows from cuda:1 into cuda:0, the peer "
          f"idle): {ms:.4f} ms per call (CUDA events), {alone:.4f} back to "
          f"back; the library call (copy_ per plane) {lib_ms:.4f} ms; "
          f"plain version {plain_ms:.4f} ms; bound {bound:.4f} ms (the bytes "
          f"at 450 GB/s); bit-exact, the sentinel past each block kept; "
          f"pull_ms in the workers' device runs {pulls}", flush=True)
    return {"name": "pull_cards", "route": "cuda",
            "source": "spark_tpu_torch/csrc/all_to_all.cu",
            "replaces": "spark_tpu/parallel/ici.py:352",
            "launches": launches, "max_abs_err": 0, "ms": ms,
            "ms_back_to_back": alone, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            "bytes": moved, "statement_walls_ms": walls}


def phase_cards(session, hash_df, hash_table, q3_df, tables):
    """[cards]: shards on several cards (see the module docstring).  Returns
    the kernels line's ``k2_cards``, ``barrier`` and ``pull_cards``."""
    import torch
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch import types as T
    from spark_tpu_torch.parallel import mesh as M
    from spark_tpu_torch.testing import Q3_SQL, q3_oracle, \
        register_sql_tables
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    root = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        child, child_log, child_path = _cards_one_card_child(root)
        # 1. the cards and their peer access
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        for i, line in enumerate(smi):
            print(f"[cards] cuda:{i} {line}", flush=True)
        matrix = [[a == b or torch.cuda.can_device_access_peer(a, b)
                   for b in range(n)] for a in range(n)]
        missing = [(a, b) for a in range(n) for b in range(n)
                   if not matrix[a][b]]
        print(f"[cards] peer access (row: from, column: to): "
              f"{[''.join('1' if x else '0' for x in row) for row in matrix]}"
              f"; {n * (n - 1) - len(missing)} of {n * (n - 1)} ordered "
              f"pairs", flush=True)
        check(not missing, f"[cards] pairs without peer access: {missing}")
        cuda_a2a.enable_peer_access(cards)
        barrier_entry = _cards_barrier(cards[:CARDS_SHARDS])
        # 2. the mesh queries, one shard per card
        proc_rc = child.wait(timeout=900)
        child_log.close()
        check(proc_rc == 0, "[cards] the one-card mesh lane's child failed:"
              f"\n{open(os.path.join(root, 'one_card.txt')).read()[-3000:]}")
        with open(child_path) as f:
            one_card = json.load(f)
        zero_counts()
        calls, numbers = _cards_mesh(session, hash_df, hash_table, q3_df,
                                     tables, one_card)
        copies = cuda_a2a.LAUNCHES - cuda_a2a.CAPTURED_LAUNCHES \
            + cuda_a2a.REPLAYED_LAUNCHES
        barriers = sum(cuda_a2a.CARD_BARRIERS.values()) \
            - sum(cuda_a2a.CARD_CAPTURED_BARRIERS.values()) \
            + sum(cuda_a2a.CARD_REPLAYED_BARRIERS.values())
        check(copies > 0 and barriers > 0, f"[cards] K2 ran {copies} copy "
              f"launches and {barriers} arrive-and-wait launches on the "
              "cards")
        by_card = {d: cuda_a2a.CARD_LAUNCHES[d] - cuda_a2a.CARD_CAPTURED[d]
                   + cuda_a2a.CARD_REPLAYED[d] for d in cuda_a2a.CARD_LAUNCHES}
        waits_by_card = {
            d: cuda_a2a.CARD_BARRIERS[d] - cuda_a2a.CARD_CAPTURED_BARRIERS[d]
            + cuda_a2a.CARD_REPLAYED_BARRIERS[d]
            for d in cuda_a2a.CARD_BARRIERS}
        print(f"[cards] K2 runs on the cards over the mesh queries (counted "
              f"on the host: wrapper launches outside a capture plus "
              f"replayed): exchange_kernel with copies {copies} {by_card}, "
              f"arrive-and-wait {barriers} {waits_by_card}; barrier_kernel "
              f"0 (off the path)", flush=True)
        # 3. shards = 0 is every visible card
        _mesh(session, 0)
        register_sql_tables(session, hash_table, tables, T)
        got = [tuple(r) for r in session.sql(Q3_SQL).collect()]
        mesh = M._current
        check(got == q3_oracle(tables) and mesh is not None
              and mesh.n_shards == n and mesh.n_cards == n,
              f"[cards] shards = 0: {mesh}, rows equal "
              f"{got == q3_oracle(tables)}")
        print(f"[cards] spark.tpu.mesh.shards = 0: q3's SQL text ran as "
              f"{mesh}, equal to the oracle", flush=True)
        _mesh(session, 1)
        # 4. one streamed mesh step across the cards
        _cards_streamed(session, root)
        # 5. K2 across cards alone
        t0 = time.perf_counter()
        for i, (qn, planes, card_of, devices, gather, receivers, out) in \
                enumerate(calls):
            want = cuda_a2a.all_to_all_plain(planes, gather, card_of,
                                             devices, receivers)
            check(all(g is None and w is None or all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(g, w)) for g, w in zip(out, want)),
                f"[cards] {qn}: K2 call {i} differs from its plain version "
                f"({_a2a_desc(planes, gather)})")
        print(f"[cards] all {len(calls)} cross-card K2 calls of the mesh "
              f"queries' warm-ups bit-exact against all_to_all_plain "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        big = max((c for c in calls if c[0] == "q3 shuffled joins"
                   and not c[4]), key=lambda c: _a2a_bytes(c[1], c[4]))
        del calls
        t = _cards_k2_alone(big, cards[:CARDS_SHARDS])
        del big
        _mesh(session, CARDS_SHARDS, 0)
        abort_ms = _cards_abort(session, session.sql(Q3_SQL))
        got = [tuple(r) for r in session.sql(Q3_SQL).collect()]
        check(got == q3_oracle(tables), "[cards] the query after the "
              "failing shard differs")
        _mesh(session, 1)
        # 6. the device tier across cards
        pull_entry = _cards_tier(session, cards)
        barrier_entry["launches"] = barriers
        barrier_entry["launches_by_card"] = waits_by_card
        k2_entry = {"name": "k2_cards", "route": "cuda",
                    "source": "spark_tpu_torch/csrc/all_to_all.cu",
                    "replaces": "spark_tpu/parallel/ici.py:352",
                    "launches": copies, "launches_by_card": by_card,
                    "max_abs_err": 0, "ms": t["ms"],
                    "ms_turns": t["ms_turns"],
                    "direct_ms_turns": t["direct_ms_turns"],
                    "old_order_ms_turns": t["old_order_ms_turns"],
                    "kernel_alone_by_card_ms": t["alone_by_card_ms"],
                    "alone_turns_ms": t["alone_turns_ms"],
                    "old_copy_alone_turns_ms": t["old_copy_alone_turns_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": "bytes", "library_ms": t["library_ms"],
                    "bytes": t["bytes"], "one_card_ms": t["one_card_ms"],
                    "one_card_alone_ms": t["one_card_alone_ms"],
                    "abort_ms": abort_ms, "mesh": numbers}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[cards] phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return [k2_entry, barrier_entry, pull_entry]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    want_cards = 0
    if argv[:1] == ["--one-card-rows"] and len(argv) == 2:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return one_card_rows_main(argv[1])
    if argv[:1] == ["--cards"] and len(argv) == 2 and argv[1].isdigit():
        want_cards = int(argv[1])
    elif argv:
        print("usage: python3 chip_smoke.py [--cards N]", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < want_cards:
        print(f"chip_smoke: --cards {want_cards}, but "
              f"{torch.cuda.device_count()} card(s) are visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import spark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.session import SparkSession
    from spark_tpu_torch.testing import hash_agg_query, hash_agg_table

    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    session = SparkSession.builder.appName("chip_smoke").getOrCreate()
    check(session.device.type == "cuda", "default session is not on the card")
    hash_table = hash_agg_table(MAIN_N, MAIN_GROUPS)
    hash_df = hash_agg_query(session, F, hash_table)
    k1_entries = phase_kernel_check(session, hash_df)
    tables, q3_df = phase_slice(session, hash_df, hash_table, k1_entries)
    k2_sql_launches = phase_sql(session, hash_df, hash_table, q3_df, tables,
                                k1_entries)
    k1_replays = phase_stage(session, hash_df, hash_table, q3_df, tables)
    for entry in k1_entries:
        # the profiler's count of K1 in one replay of each hash-agg query
        entry["replayed_launches"] = \
            k1_replays if entry["name"] == "grouped_accumulate_columns" \
            else {}
    k2_breadth_launches = phase_breadth(session, hash_table, tables,
                                        k1_entries)
    captured, k2_launches, mesh_numbers, lpt_inputs, lpt_launches = \
        phase_mesh(session, hash_df, hash_table, q3_df, tables)
    k2_entry = phase_k2_check(captured, k2_launches)
    k2_entry["sql_launches"] = k2_sql_launches
    k2_entry["breadth_launches"] = k2_breadth_launches
    k2_entry["mesh"] = mesh_numbers
    k2_entry["replayed_launches"] = {
        name: m["k2_replayed"] for name, m in mesh_numbers.items()}
    lpt_entry = phase_lpt_check(
        lpt_inputs, lpt_launches,
        {name: m["lpt_replayed"] for name, m in mesh_numbers.items()})
    del captured, lpt_inputs
    basket_tables, baskets_want = phase_complex(session, k1_entries,
                                                k2_entry)
    srv = phase_server(session, hash_table, tables, k1_entries, k2_entry,
                       card)
    try:
        tpcds = phase_tpcds(session, srv)
        phase_complex_http(session, srv, basket_tables, baskets_want)
    finally:
        srv.stop()
    phase_scan(session, hash_table, tables, k1_entries, k2_entry, tpcds)
    root = tempfile.mkdtemp(prefix="chip_smoke_ooc_")
    try:
        ooc = phase_ooc(session, k1_entries, k2_entry, root)
        phase_cache(session, hash_table, tables, k1_entries, k2_entry, ooc,
                    root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_crossproc(session, k1_entries, k2_entry)
    pull_entry = phase_ici(session, k2_entry)
    phase_recovery(session, k1_entries, k2_entry)
    phase_pool(session, hash_table, tables, k1_entries, k2_entry)
    phase_stream(session, k1_entries, k2_entry)
    phase_analysis(session, hash_table, tables, k1_entries, k2_entry,
                   pull_entry)
    phase_ml(session, k1_entries, k2_entry, pull_entry)
    cards_entries = []
    if torch.cuda.device_count() >= 2:
        cards_entries = phase_cards(session, hash_df, hash_table, q3_df,
                                    tables)
    else:
        print(f"[cards] not run: {torch.cuda.device_count()} card visible",
              flush=True)
    session.stop()
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": k1_entries + [k2_entry, pull_entry,
                                                lpt_entry]
                      + cards_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
