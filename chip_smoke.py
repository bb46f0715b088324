#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elasticsearch_tpu_torch) on one card.

    python3 chip_smoke.py [--docs 1000000] [--seed 0] [--phases ...]

Phases, each printing one line with its seconds; any failure raises and the
script exits non-zero with no result line:

  build    nvcc builds every kernel of the package from csrc/ (sm_90a), one
           process per source, all started together.
  kernels  each kernel against its plain PyTorch twin on the card, at the
           main paths' shapes and beyond: scan_topk streamed (B=1, N=1M,
           k in {10, 25, 128}, with ties, count_positive on and off; B=512,
           k=10 as msearch calls it; and 8 rows at N-3 docs with a row of
           fewer than k finite lanes, an all -inf row under count_positive
           and ties across span boundaries, k in {10, 128}) and matmul
           (B=64, D=384, N=1M, every transform; and the exact kNN arm's
           rerun, B=700, cosine, timed beside torch.topk(transform(q @
           mat))): values equal, ids equal on finite lanes, totals equal.
           tiered_candidates (B=512 and B=37,
           D=896, N=1M, kb=64, identity, count_positive; C4's exact arm,
           B=1024, D=384, N=1M, cosine; every transform at N=100k,
           count_positive off), whose tensor-core sums add in their own
           order: `check_tiered_selection` (totals equal, scores within the
           f32 summation bound of 2D terms doubled for the tensor cores'
           truncation, ids equal but for swaps at the kb-th score within it,
           rows ordered), the largest |err| / bound reported; split_bf16
           against its run on the host (uint16 views equal); impact_gather
           (Q=512, R=64, uint16 and int8 codes, padding rows);
           fused_tile_candidates (Qc=512, N=1M on the tiered check's
           [896, 1M] hi/lo tier, Td=4, C1-sized sparse windows with
           duplicate (query, doc) entries, dead lanes, the tail tile and a
           tile with fewer than t live lanes): equal as scan_topk, on the
           wrapper's route for t=7 and on its sort route (the previous
           design, timed beside it).
  index    the bench corpus (1M docs, 100k-term Zipf vocabulary, Poisson(40)
           lengths clipped at 4, one long field) through Engine.create_index,
           EsIndex.index_doc and refresh, uploaded to the card. The refresh
           takes the card's route (`index/device_build.py`: analysis, the
           flat CSR, blocked postings, positions, impact codes, the dense
           tier): its RefreshProfile (seconds per stage and their sum
           against the wall). Then the same docs packed through the host
           route (device="cpu", its stage split) and every array of the two
           packs compared byte for byte (postings, block metadata, term
           dictionary and df, impact tier, dense tier, positions, norms,
           docvalues).
  traffic  300 queries (200 `or` matches, 50 `and`, 50 bool with a range
           filter and a must_not term) through EsIndex.search, first with
           size=10, then with from=5, size=20; sparse terms score from the
           impact tier. The launch counts are reset just before and read
           just after: one scan_topk launch per request.
  rest     the REST server (rest.server.serve on 127.0.0.1, a free port) over
           the Engine of phase index, through HTTP/1.1 keep-alive connections: PUT
           /rest_bm25, `_bulk` of the corpus's first 50,000 docs in NDJSON
           chunks of 5,000, `_refresh` (docs/s, refresh s) and 200 `_search`es
           equal to EsIndex.search's answers; a warm-up `_msearch` of 512
           bodies at size 10 and 25 with serving on; the traffic phase's 600
           requests on the 1M-doc index, one client (p50/p99, the REST overhead over
           the traffic phase's p50 and over EsIndex.search's p50 on the same
           requests just after, each answer equal to its EsIndex.search
           answer but for took and _shards); 1,024 C1 term-disjunction
           `_search`es (size 10) from 32 client threads with serving off,
           then on (QPS, p50/p99, waves, mean wave size, term_packed,
           fallback_solo), the serving-on answers held to the serving-off
           ones (totals equal below 10,000, scores within 1e-5 relative, ids
           up to ties); `_msearch` of 4,096 C1 bodies at size 10 and at size
           25 with serving on (wall, QPS, waves; rows against EsIndex.msearch
           on the same bodies: scores within 1e-6 relative, ids up to ties)
           and of 512 bodies with serving off (wall); 32 C1 rows of a padded
           wave against their 1-query waves at k=10 and k=25 (totals equal,
           scores within 1e-6 relative, ids up to ties; byte-equal rows
           counted); the error envelopes
           (unknown index 404, bad query 400, in_flight_requests limit 1 ->
           429 circuit_breaking_exception with Retry-After >= 1). Launch
           counts are reset before and read after each path.
  cpu      20 of the traffic phase's requests again on the same pack with device="cpu":
           totals equal, scores within 1e-6 relative, ids equal up to fp-ties
           (scores within 1e-5 relative).
  msearch  the headline `_msearch` traffic (bench.py config C1): warm-up
           batches, then 4 timed batches of 4,096 queries of up to 4 terms
           through ShardSearcher.msearch("body", queries, 10), which take
           the fused arm, and 2 timed batches of the same queries at k=25
           (the from=5, size=20 page), which take the impact and tiered
           arms; per batch wall, QPS, queries per arm, first-pass exact
           share, escalation rounds and kernel launches (counts reset just
           before the timed batches and read just after:
           fused_tile_candidates >= 1 launch per fused chunk,
           impact_gather >= 1 per chunk of every sparse group,
           tiered_candidates >= 1 per chunk of every dense-only group).
           Then one EsIndex.msearch call of 512 match bodies (half with
           from=5, size=20) and 32 bool bodies with a range filter, which
           must take the per-query route; all four kernels must launch.
  msearch_check  64 queries of one batch again as bool.should of terms:
           the fused k=10 rows against EsIndex.search's on exact BM25 plans
           (`mark_exact`) with totals equal, scores within 1e-5 relative and
           ids equal up to fp-ties; the k=25 rows against EsIndex.search
           (the impact tier) within 1e-5 relative and fp-ties, and against
           the exact plans with totals equal below 10,000 (else msearch's in
           [10,000, exact]), scores and ids within the impact tier's
           quantization tie class (2 * sum of boost*idf*ubf/QMAX over the
           impact-served terms + 1e-7, rtol 1e-6).
  msearch_cpu  32 of those queries (at least 4 dense-only) through
           device="cpu" on the same pack, at k=10 (the fused arm, its
           kernel's twin on the host) and at k=25, held by repricing to the
           arm the card's batch took (its last_stats): totals equal, scores
           within 1e-5 relative, ids equal up to ties within 1e-5.
  profile  100 of the requests again, then one 4,096-query msearch batch at
           k=10 and one at k=25, under torch.profiler: the device's busy
           share of the wall time, each kernel's share of device time and
           the top device ops.
  impact_search  the traffic phase's 600 answers (the impact tier) against
           the same requests on exact BM25 plans: totals equal, scores and
           ids within each request's tie class (2 * the sum over its terms
           of boost*idf*ubf/QMAX + 1e-7), p50/p99 of both; 20 answers
           against the same pack with device="cpu" (scores within 1e-6).
  bf16     C1 k=25 msearch(bf16=True): on the impact arm (the planner's
           cold choice; it ignores bf16, rows equal f32's), then the fast
           arm held by repricing, f32 and bf16 in turns on 2 batches (wall,
           QPS, first-pass exact share, rounds); the fast arm's dense
           product alone over the batch's chunks, f32 GEMM against bf16
           operands with f32 output (CUDA events); 64 bf16 rows against the
           uncut bf16 fast arm (the bf16 score function's exact top k).
  planner  the execution planner on the C1 batches: cold, a batch at k=10
           and k=25 byte-equal to phase msearch's rows (decisions static);
           each arm forced in turn by repricing the others on 2 batches
           (the warm-up); 4 batches at k=10 and 2 at k=25 routed by the
           model (arms, walls, QPS, predicted ms per arm, decision us
           p50/p99, decisions and modes, |residual| EMA per kernel; 64 rows
           of each k against exact BM25: 1e-5 on the exact arms, the tie
           class on the impact arm); fused and impact repriced route to the
           exact arm, every arm repriced to exact.
  dsl      the text DSL on the 1M-doc BM25 index (one shard), queries
           drawn from real docs with the phase's own stream: 200
           match_phrase of 2-3 consecutive tokens, 100 each of
           match_phrase_prefix and match_bool_prefix (2 tokens, then 4
           characters of a third), prefix (4 characters), wildcard
           (`t12?4`-style), dis_max of two matches, ids of 10 ids and
           query_string (fields, AND/OR/NOT, a quoted phrase, a `t12*`
           wildcard), 50 each of regexp and simple_query_string, 5 fuzzy
           (AUTO on 5-character terms): p50/p99 and scan_topk launches per
           kind (one per request), the busy share of one profiled request
           per kind, the first 10 of each kind (fuzzy: 3, each walks the
           100,000-term dictionary on the host) against the device="cpu"
           run of the same pack (totals equal, scores within 1e-6
           relative, ids up to fp-ties). The first 20 of each kind (fuzzy:
           1) are kept for phases writes and dsl_shards.
  collapse_rescore  on the same index: 100 C1 matches collapsed on the
           long field `n` and 100 C1 matches rescored (window 100) by a
           match_phrase of two consecutive terms: p50/p99, one scan_topk
           launch each, the first 50 answers of each (collapse keys, hits,
           rescored scores) against the device="cpu" run.
  aggs_index  bench.py C3's http_logs-like corpus (`corpus.c3_corpus`: status
           keyword, clientip keyword over 60,000 values, 30 days of
           @timestamp, size long) at 1,000,000 docs through EsIndex.index_doc
           and refresh on one shard, its first 50,000 docs on 4 murmur3
           shards (4 x 12,500, cut from 1M: the full run took 940 s with
           it on an NVIDIA H100 80GB HBM3 at 700 W, then from 4 x 100,000:
           1,117 s of 1,200 on a slow host, and from 4 x 25,000 for slice
           19's phases) and on one shard: index_doc s, refresh s,
           docvalues bytes and bytes on the card.
  aggs     on the 1-shard C3 index: C3's request at size 0 (terms(status) >
           {date_histogram(day), sum(size)}), the same request from 32
           search_wave entries (service time per request over 25 waves, the
           first under the profiler) and a mix of every
           ported agg type (cardinality(clientip), percentiles(size), a
           composite resumed after a key, the two-pass terms(size) with a
           sum, pipeline aggs): p50/p99 over 25 runs, M docs/s, scan_topk
           launches (one per request), and the first request under
           torch.profiler (device busy share, kernel launches); two runs
           byte-equal, wave rows byte-equal to solo, both requests equal to
           the device="cpu" run of the same pack (counts, keys, int sums,
           cardinalities byte-equal; floats within 1e-6 relative), every
           status's exact sum(size) equal to numpy's int64 sum, REST
           `_search` / `_msearch` equal to EsIndex.search; one round of
           1,000 updates on a 100,000-doc C3 index, whose next agg request
           merges the tiers and equals a full refresh's answer; then 100 of
           the traffic phase's C1 requests on the 1M-doc BM25 index with
           stats(n) and histogram(n) beside (p50/p99, one scan_topk launch
           each, busy share, 4 against the device="cpu" run).
  multi_index  (after aggs) C3's corpus (120,000 docs, 30 days of
           @timestamp) split by date into 6 indices of 5 days (`logs-0` ..
           `logs-5`, the layout of Rally's http_logs track) and as one
           index; over REST on `logs-*`: 50 "last 5 days" match + range
           requests (can_match skips 5 indices), 50 "last 15 days" (3), 50
           with no range, 25 sorted by @timestamp desc at size 100: per
           request `_shards.skipped` and one scan_topk launch per searched
           index, p50/p99, answers `==` the device="cpu" run's, sorted pages
           equal to the one index's up to full-key ties; `_field_caps` over
           `logs-*` and 5 `_mget`s of 100 ids `==` the cpu run's.
  esql     bench.py C10's ES|QL mix on the C3 indices of phase aggs_index
           (1M docs on one shard; 4 x 12,500 and the same docs on one
           shard): WHERE | STATS BY | SORT, SORT | LIMIT | KEEP, WHERE | SORT
           | LIMIT, EVAL | STATS, and the top-clients panel (STATS BY
           clientip, ~60,000 groups, | SORT | LIMIT), 1 profiled run each
           (p50/p99, input rows/s, the per-operator split and the collect's
           share of the wall, peak_live_bytes; operator walls summing
           exactly to each wall; the exchanges named where the reference
           runs them; the five kernels' launch counts, 0 expected); every
           answer equal to the device="cpu" engine's on the same packs
           (keywords, longs, counts exact, doubles within 1e-12 relative,
           bit-equal ones counted), the 4-shard answers to one shard's (up
           to equal sizes in SORT | LIMIT); topn_exchange and
           stats_exchange on the card against the host sort and _run_stats
           on the collected tables, SUM(size) BY status against numpy's;
           `POST /_sql`, `/_query` and `/c3/_eql/search` over REST against
           the cpu run, `GET /_esql/profile`; an EQL sequence by clientip
           with maxspan=1d on the 4 x 12,500-doc index; the device busy
           share of one profiled query per exchange and of each exchange
           call alone.
  sort     field-sorted search on C3 (1M docs, 1 shard; 4 x 12,500 beside
           a 1-shard index of the same docs): Discover's request (a range
           on @timestamp over one day, newest first, size 100) and 10
           pages by search_after, joined equal to one page as search_after
           reads it; status asc / size desc with missing; `_score` with a
           size tiebreak on a term filter; terms(status) beside a sort,
           its aggs equal the unsorted request's. p50/p99, no scan_topk
           launch on the sorted path, the busy share of one request; sort
           values and ids equal the device="cpu" run byte for byte; 4
           shards equal 1 shard up to full-key ties.
  rest_dsl  over REST: 100 sorted `_search`es paged by search_after on C3
           and 100 phrase `_search`es on the BM25 index, each body equal to
           EsIndex.search's.
  writes   on the 1M-doc index, after every phase that reads it unmodified
           (the 1-shard answers phase shards needs are kept first): 4
           rounds of 1,000 updates (25 of ids an earlier round wrote), 500
           deletes and 1,000 new docs from the corpus generator, each
           followed by refresh (seconds, kind, refresh lag, tier_stats,
           beside phase index's full refresh); the traffic phase's 600
           requests on the tiered index (p50/p99 beside phase traffic's,
           scan_topk launches = 600 x (1 + segments)), each held to its
           answer on exact BM25 plans over the tiers within the tie class
           of the tiers' largest per-term bounds; no deleted id in any
           hit, updated ids with their newest source, count equal to the
           tiered total, 20 requests (one with a dense-tier term) against a
           device="cpu" run of the same tiers (totals equal, scores within
           1e-6 relative, ids up to fp-ties); the kept DSL requests of each
           tier-safe kind (not match_phrase_prefix, which merges the
           tiers) on base + 4 segments, one scan_topk per tier, against
           the device="cpu" tiers; a fifth round past
           indexing.tiers.max_segments (the fold's seconds, merge_failures
           0, the CPU check again); a refresh of 500 deletes that seals no
           segment; over REST with serving on a `_bulk` of 100 delete and
           100 update items, `_update` and `DELETE _doc` with
           ?refresh=true, and 512 C1 `_search`es from 32 clients on the
           wave's tiered lane, each equal to the solo tiered search byte
           for byte (waves, mean size, QPS, p50/p99, launches).
  shards_index  the 1-shard index's answers to 64 traffic requests and to
           64 queries of one C1 batch at k=10 and k=25 (its exact arm) are
           kept, the index is released, and the same 1M docs go through
           EsIndex(..., settings={"number_of_shards": 8}) index_doc and
           refresh (murmur3 routing, global statistics, one StackedSearcher).
  shards   on the 8-shard index: the traffic phase's 600 requests (p50, p99,
           one scan_topk launch per request over the S·n_max lanes) and 544
           EsIndex.msearch bodies (their term disjunctions through
           msearch_sharded; scan_topk, impact_gather and
           fused_tile_candidates must launch); the kept requests and rows
           against the 1-shard answers (totals equal, scores within 1e-5
           relative, ids equal up to fp-ties; the k=25 impact rows within
           the impact tier's quantization tie class, 2 * sum of
           boost*idf*ubf/QMAX with each term's largest per-shard ubf +
           1e-7; the requests, each index scoring from its own impact tier,
           in the tie class of the larger of the two bounds); 16 requests
           and 32 msearch rows at k=10 and k=25 against the same pack with
           device="cpu", held to the card's arm.
  dsl_shards  the kept DSL requests on the 8-shard index: p50/p99, one
           scan_topk per request, each answer equal to the 1-shard
           index's (totals equal, scores within 1e-5 relative plus the
           impact tie class, ids up to ties).
  impact_search_shards  phase impact_search on the 8-shard index.
  rest_shards  over REST on the 8-shard index: its 300 size=10 traffic
           requests (each equal to EsIndex.search's answer) and one
           4,096-body `_msearch` with serving on (rows against
           EsIndex.msearch). Then the index is released.
  c5_index  bench.py config C5 cut in depth: 8 x 50,000 docs (--c5-docs; C5
           has 8 x 1M, which kept the full run above half its time limit;
           8 x 250,000 until the text DSL phases came)
           of C1's generator on the stream default_rng(4242), shard s =
           docs [s·n, (s+1)·n), built through
           build_stacked_pack_routed on the card's route and
           uploaded through StackedSearcher; shard 0's impact codes on the
           card equal the host derivation.
  c5       4 timed C1 batches of 4,096 queries at k=10 (fused partials:
           >= 8 shards x 8 chunks fused_tile_candidates launches) and 2 at
           k=25 (impact partials: >= 1 impact_gather launch per shard)
           through msearch_sharded, each with wall, QPS, host planning ms,
           queries per arm, escalated queries and launches; 300 `_search`
           requests (one scan_topk launch each); one batch at each k under
           torch.profiler; 64 rows of a batch against per-query `_search`
           of the same terms on exact BM25 plans (k=10: scores within 1e-5
           relative; k=25: the impact tie class); the execution planner at
           its sharded site, each arm forced in turn (k=10: fused, impact,
           exact; k=25: impact, exact), then 2 batches at each k routed by
           the model. Then C5 is released.
  knn_index  bench.py C4's ANN corpus (1M x 384, 750 clusters, nlist 750)
           through build_ann on the card twice (the builds byte-equal) and
           AnnSearcher(..., "cosine"); then 50k documents with an
           int8_hnsw vector field, a long field and a C1 text (`body`,
           corpus.doc_texts) through EsIndex.index_doc and refresh. The
           text index of the phases above is released first.
  knn_kernels  ann_gather_scan against its twin: the C4 batch (B=1024, P=2,
           D=384, kb=100, on the knn_index tiles, or synthetic L=1536 tiles
           when run alone), both tiers, every transform, kb 1 and 128; the
           `_search` shape on the knn_index EsIndex's tiles (B=1, the
           probes and kcand of KnnNode.prepare), and (B=1, P=2, L=512) and
           an L above 4,096 on synthetic tiles with pad slots, dead docs and
           exact ties. Values equal, ids equal on finite lanes, totals
           equal; times of the kernel, its twin, the gather + bmm + topk
           composition and the bound (counted on the probed tiles: each
           distinct tile once, a pad slot by its order entry alone), with
           the reference cost model's count beside it, at the C4 batch and
           at the `_search` shapes; the previous design's times from
           PERF.md beside them.
  knn      C4 ANN batches (1 warm-up, 4 timed int8 and 2 bf16 batches of
           1,024 queries, k=10, num_candidates=100: one ann_gather_scan
           launch each), one int8 batch under torch.profiler, recall@10 of
           64 near-data queries against the exact scan_topk matmul scan
           (>= 0.9); the same queries at nprobe = nlist on both tiers held
           to the exact scan by `ann.search.check_ann_rows` (a neighbour may
           be missing only where the tier's stated selection error,
           `AnnSearcher.selection_bound`, lets it lose to the kb-th
           candidate; every other lane equal, scores within 1e-6); C4's
           exact arm (TieredKnnScanner over 1M x 384 standard
           normal, 2 timed batches, flag rate, and one batch under
           torch.profiler: tiered_candidates against the scan_topk reruns);
           200 kNN `_search` requests
           (50 with a range filter, which take the kb > 128 route) at size=10
           and at from=5, size=5: p50/p99, one ann_gather_scan launch per
           unfiltered request, at least one scan_topk launch per request.
  knn_check  32 of those requests at nprobe = nlist, and 16 of their
           answers at the default nprobe, against the same pack searched
           with device="cpu" (the kernels' twins): totals equal, ids equal
           up to fp-ties, scores within 1e-6 relative (the f32 rescore's
           matrix-vector product sums in the BLAS's order).
  planner_knn  advise_nprobe on the kNN EsIndex: planner.knn.target_ms set
           through the cluster settings to the predicted ann.gather_scan
           time at 4x the default nprobe, then at nprobe 1 (the efficiency
           EMA warm from phase knn's C4 batches); the advised nprobe, p50
           and recall@10 of 64 near-data `_search`es against the exact scan,
           beside the default's (target 0). The target is cleared after.
  rest_knn  100 kNN `_search`es over REST on the kNN EsIndex, each equal to
           EsIndex.search(knn=...)'s answer, one ann_gather_scan launch per
           unfiltered request; then, with serving off and on, 50 hybrid
           `_search`es (a match of 2-4 C1 terms + a kNN section) and one
           `_msearch` of 512 bodies mixing kNN-only, hybrid and text bodies,
           each answer equal to EsIndex.search's.
  knn_shards_index  the C4 ANN corpus is released; 50,000 docs like the
           kNN index's (a keyword `tag` on every doc whose n is a multiple
           of 3) through an EsIndex of 4 shards (4 x 12,500: cut from 4 x
           50,000 to keep the full run within ~800 s, then from 4 x 25,000
           when it took 1,194 s of 1,200 on a slow H100 host):
           index_doc and refresh s, each shard's nlist and L, the padded
           (C, L), pack bytes and bytes on the card.
  knn_shards  200 kNN `_search`es on the 4-shard index: p50/p99 beside the
           1-shard index's, 4 ann_gather_scan and 5 scan_topk launches per
           request, recall@10 against the exact scan_topk matmul scan of
           every vector (>= 0.9); 64 rows at nprobe = nlist held by
           `ann.search.check_ann_rows` against each shard's own selection
           bound; 32 rows (8 at nprobe = nlist) against the device="cpu"
           run of the same pack; 50
           `exists` requests (each field, alone and under a range filter)
           whose totals equal the generator's counts.
  aggs_shards  the 4-shard C3 index answers the aggs phase's requests:
           counts, keys, int sums and cardinalities byte-equal to the
           1-shard index of the same docs (global ordinals, the OR of the
           cardinality bitmaps, the Python-int sum_exact merge), floats
           within 1e-6 relative, the device="cpu" run, the wave and the
           exact sums as on one shard; p50 beside that index's. Then 50 kNN `_search`es
           with terms(tag) beside on the 4-shard kNN index (p50/p99 beside
           kNN alone, launches, busy share).
  hybrid   60 hybrid `_search`es (the kNN section boosted 5x) on the
           1-shard and on the 4-shard kNN
           index: p50/p99 beside the same requests kNN-only and text-only,
           launches per request, 64 kNN sections equal to the device="cpu"
           run up to fp-ties, every answer equal to the query and the
           card's section evaluated with device="cpu", each hit's score
           minus its text-only score 0 or its kNN score (1e-5 relative).
  rrf      50 `_search`es with an `rrf` retriever (a `standard` match and a
           `knn` section, window 50) over REST on the 1-shard kNN index:
           p50/p99, one ann_gather_scan launch and >= 1 scan_topk per
           request, 10 against the device="cpu" run (the fused list `==`,
           or the sub-retrievers' searches equal up to fp-ties).
  knn_writes  on the 1-shard kNN index, 4 rounds of 500 updates (new
           vectors), 250 deletes and 500 new docs, each refreshed
           incrementally (s beside the full build's refresh); 200 kNN
           `_search`es on base + 4 segments (each segment probes its own
           IVF index): p50/p99, one ann_gather_scan launch per tier, the
           first 64 answers equal to the device="cpu" run of the same tiers
           (all 200 until the full run took 1,117 s on a slow host), new docs
           first at their own vectors, no deleted doc, the tiers
           unchanged. Then one round and 100 tiered kNN requests on the
           4-shard index (32 of them against the device="cpu" run).
  (build)  after each phase that refreshes (index, rest, writes,
           shards_index, c5_index, aggs_index, knn_index, knn_shards_index,
           knn_writes) a `build <phase>` line: its refreshes by kind, their
           wall and the sum of their stages (which must agree), per stage,
           with the route (basis) of each (also geo_index, field_types,
           matchers, analysis).
  scripts  (after rest_dsl, before writes) scripted search on the 1M-doc
           index: 100 each of script_score, function_score
           (field_value_factor, gauss, a filtered weight), random_score and
           a bool with a script filter (p50/p99, one scan_topk per
           request), 20 of each against the device="cpu" twin; script_fields
           at size 10 and a runtime long field in a range, a terms agg and
           a sort, each equal to the twin.
  scripts_update  (after writes) 1,000 scripted `_update`s over REST on
           the 1M-doc index, then a refresh: every source equal to a
           device="cpu" engine's after the same calls.
  scripts_shards  (after dsl_shards) 10 each of script_score and
           function_score on the 8-shard index held to the one-shard
           answers; random_score and the script filter to its cpu twin.
  tenancy  bench.py C8 on its own engine: 500 tenants of 24 docs (C8 has
           1,000; cut for slice 19's phases) folded
           into size-class superpacks, every 20th tenant's rows bit for bit
           against its per-index exact arm and a device="cpu" superpack,
           256 clients x 4 requests with superpacks on (each equal to the
           exact arm) and off (within the term lane's contract), the
           `_merge` lane under refreshes, every wave's tenant shares `==`
           its device segment, and fair share's clamp and its undo.
  extra    (after scripts, before writes adds tiers) the long-tail kinds on
           phase index's 1M-doc BM25 index: 100 more_like_this with real
           docs' texts as `like`, 50 combined_fields, 50 pinned, 20 wrapper,
           50 intervals (ordered and unordered, max_gaps 0-3, any_of,
           all_of over terms of ranks 50-500): p50/p99, one scan_topk
           launch per request, busy share, 10 of each against the
           device="cpu" run, the host seconds of the intervals walk.
  extra_shards  20 more_like_this by two `_id`s on the 8-shard index (the
           like docs' sources from their shards), each `==` the bool of the
           term queries it should select (worked out from the stored
           sources and the global df); then the corpus's first 24,000 docs
           on 8 shards, built by the card's engine and by a device="cpu"
           engine: every shard's card-built pack byte for byte against the
           host route's, and 20 more_like_this by `_id` on the card against
           the cpu engine's answers.
  fetch_highlight  (after extra) the fetch sub-phases on phase index's
           1M-doc index, what a results page sends: 100 `_search`es with
           highlight on the text field (fragment_size 100, 3 fragments; 20
           with a highlight_query, 20 with require_field_match off), 50
           with docvalue_fields on the long field (25 with the format
           "#.0"), 50 with stored_fields (`_none_` and a list): p50/p99 of
           the search with its fetch and of the fetch alone, one scan_topk
           launch per request, the busy share of 20 highlighted requests,
           10 of each kind against the device="cpu" run (hits, fragments,
           fields and sources equal); 50 of them over REST with serving
           off and on (the wave's answers equal serving off's).
  suggest  a search-as-you-type box: 100,000 geonames place names
           (`corpus.geonames_corpus`, Rally geonames' `name` weighted by
           `population`) in a `completion` field on 1 shard and on 4 x
           25,000, built on the card and, on 1 shard, with device="cpu"
           (the completion lists equal; the 4-shard list the 1-shard one's
           by id); 200 prefixes of 1-4 characters at size 5, 50 with
           skip_duplicates, on both (4 shards held to 1: texts and weights
           in order, ids up to ties), 20 over REST in `_search` with size
           0; `term` suggestions of 10 real terms with one edit and
           `phrase` suggestions of 3 two-token texts on the 1M-doc index;
           20 completion, 3 term and 3 phrase answers against the
           device="cpu" runs; p50/p99, the busy share of a size-0 search
           with a completion beside.
  search_profile  50 `profile: true` bools of 4 match clauses (the
           traffic's `or` shape, terms of a real doc) over REST on the
           1M-doc index: per request the tree's node count, its scan_topk
           launches (the search's own + 2 per profiled node) and the
           scan_topk events of the `device` section, which must agree;
           p50/p99 beside the same requests unprofiled, the busy share of
           5 profiled requests, 5 trees (types, descriptions, children)
           against the device="cpu" run.
  search_profile_shards  (after extra_shards) 10 of them on the 8-shard
           index: every shard's `device` section holds the request's
           scan_topk launches.
  templates  (after search_profile) on the 1M-doc index over REST: 200 of
           the traffic's `or` matches through one stored template (PUT
           /_scripts/c1-match), 50 inline templates with a range section
           and 10 `_msearch/template` bodies of 32 of them: p50/p99, one
           scan_topk launch per rendered search, each answer `==` its
           rendered body's plain `_search`, 20 against the device="cpu"
           run, the busy share of a window.
  search_apis  on the 1M-doc index over REST: 40 `_explain`s of a bool of 3
           match clauses on a doc's terms (1 + 3 scan_topk launches each)
           and 10 of a doc the query misses (1 launch); 20
           `_validate/query` (5 invalid), 20 `_analyze`, 50 `_termvectors`
           with term_statistics (no launch): p50/p99; 10 explanations of
           each kind and every other answer `==` the device="cpu" run's.
  rank_eval  20 `_rank_eval`s of 10 `or` matches each on the 1M-doc index,
           one metric in turn (precision, recall, MRR, dcg, normalized dcg,
           ERR), each query's exact-BM25 top 10 rated 3/2/1 by rank band
           and 5 seeded docs rated 0: p50/p99, 10 scan_topk launches each,
           5 against the device="cpu" run (ranked lists equal, metric
           scores within 1e-12, or the searches equal up to fp-ties).
  geo_index  a geonames-shaped corpus (`corpus.geonames_corpus`, the fields
           of Rally's geonames track, cut from its 11.4M docs) of 125,000
           docs on one shard, and its first 25,000 on 4 shards (4 x
           6,250) and on one shard.
  geo      on the 125,000-doc index: 100 geo_distance at 1, 10 and 100 km around
           real doc points, 100 geo_bounding_box (10 across the dateline),
           100 distance_feature on the location in a bool with a match on
           the name, 50 rank_feature of each function, 20 terms_set, 25
           runs each of geotile_grid (precision 6) with a geo_centroid
           sub-agg and of geo_bounds under a filter: p50/p99, scan_topk per
           request (one; k=1 at size 0), busy share, 10 of each against the
           device="cpu" run (geo_distance: the whole match sets, equal but
           for counted boundary docs within 1e-5 relative of the radius);
           10 of each on the 4-shard index, held to one shard of its docs
           (geo_distance, geo_bounding_box: the whole match sets) or to its
           cpu run (the text-scored kinds).
  field_types  bench.py C3's corpus (250,000 docs) under the mapping of
           Rally's http_logs track (clientip ip, @timestamp date_nanos, one
           doc in ten with sub-millisecond digits): 100 ip terms, 50 each of
           CIDR /16 and /24 terms, ip ranges, terms on clientip and
           date_nanos ranges with sub-millisecond bounds (p50/p99, scan_topk
           per request, busy share, 10 against the cpu run); Discover's page
           sorted by clientip and by @timestamp, 10 search_after pages of
           100 each, equal to the cpu run's (the sort path: no scan_topk).
  matchers nested: 12,500 StackOverflow-shaped questions (Rally's nested
           track, cut from 11.2M) with 1-5 nested answers and 20 nested
           queries with a range and a bool inside; percolate: 1,000 stored
           match, term and bool queries (Rally's percolator track, cut from
           100,000) and 10 requests of 1-4 documents: p50/p99, scan_topk
           per request, busy share, the host seconds of each request's walk,
           3 nested and 3 percolates against the cpu run.
  analysis 30,000 docs of the BM25 corpus's texts under `english` and a
           custom analyzer with synonym_graph and edge_ngram filters (the
           refresh's host route by analyzer type: `build.analyze` basis
           host_analyzer): 50 match and 50 match_phrase per field (p50/p99,
           scan_topk, busy share, 10 against the cpu run); over REST a `PUT
           /_synonyms/{set}`, an index whose search analyzer names it, and a
           search that sees the set's new rules after a second PUT.
  report   the card's name and power limit, then one line per kernel at
           its main path's shape and one JSON line with every measured
           kernel's launches on its main path (scan_topk, impact_gather and
           fused_tile_candidates also on each sharded path, under
           "launches_sharded"; every kernel on each REST path, under
           "launches_rest", where each must have launched; every kernel on
           each path of phase writes, under "launches_writes"; the exact
           plans of the impact_search phases, msearch(bf16=True) and the
           planner's batches, under "launches_planner"; every kernel on the
           4-shard kNN, exists, hybrid and tiered kNN paths, under
           "launches_knn"; every kernel on each path of the aggs phases,
           under "launches_aggs"; every kernel on each DSL kind on 1 and 8
           shards and on tiers, on collapse, rescore and each sorted
           request, under "launches_dsl"; every kernel on the ES|QL
           queries, under "launches_esql"; on C8's superpack and per-index
           loops and solo rows, under "launches_tenancy"; on each scripted
           path, under "launches_scripts"; on slice 18's kinds, under
           "launches_geo", "launches_types", "launches_extra",
           "launches_matchers" and "launches_analysis"; on slice 19's
           paths, under "launches_fetch", "launches_suggest" and
           "launches_search_profile"; on slice 20's, under
           "launches_templates", "launches_search_apis",
           "launches_rank_eval", "launches_multi_index" and
           "launches_rrf"), time, bound, plain twin's time and
           the library call's time; before it, one `build` JSON line:
           phase index's stage seconds on the card and on the host, and
           each build phase's stage seconds.

The last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the package beside the script, it exits non-zero first.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # f32 on the CUDA cores, H100 SXM data sheet
PHASES = ("build", "kernels", "index", "traffic", "rest", "cpu", "msearch", "msearch_check",
          "msearch_cpu", "profile", "impact_search", "bf16", "planner", "dsl", "collapse_rescore",
          "aggs_index", "aggs", "multi_index", "esql", "sort", "rest_dsl", "scripts", "extra",
          "fetch_highlight", "suggest", "search_profile", "templates", "search_apis",
          "rank_eval", "writes",
          "scripts_update", "shards_index", "shards", "dsl_shards", "scripts_shards",
          "extra_shards", "search_profile_shards", "impact_search_shards", "rest_shards", "c5_index", "c5", "knn_index",
          "knn_kernels", "knn", "knn_check", "planner_knn", "rest_knn", "knn_shards_index",
          "knn_shards", "aggs_shards", "hybrid", "rrf", "knn_writes", "tenancy", "geo_index", "geo",
          "field_types", "matchers", "analysis", "report")
C1_BATCH = 4096  # queries per msearch batch (bench.py config C1)
# phase index's host-route byte check runs on this prefix of its docs
INDEX_CHECK_DOCS = 75_000  # cut from 150,000 for slice 18's phases
# the times of the previous designs of the redesigned kernels, from PERF.md's
# kernel table (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
PREVIOUS_MS = {"fused_tile_candidates": 27.856, "ann_gather_scan": 18.788,
            "ann_gather_scan bf16": 38.419, "ann_gather_scan search": 0.2761,
            "ann_gather_scan synthetic search": 0.1786}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, device, warm: bool = True) -> float:
    """Mean device ms per call of fn over `iters` calls, after one warm-up
    call unless `warm` is False. On a card: CUDA events around the calls,
    queued behind a ~0.1 s spin kernel so that the host's time to issue them
    is hidden and the events time the device work back to back. Otherwise
    the host clock."""
    import torch

    if warm:
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1000 / iters


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def compare(got, want, what: str) -> float:
    """Kernel vs twin: values equal, ids equal on finite lanes, totals
    equal. -> max |value difference| over finite lanes (0.0)."""
    gv, gi, gt = [x.cpu().numpy() for x in got]
    wv, wi, wt = [x.cpu().numpy() for x in want]
    finite = np.isfinite(wv)
    if not np.array_equal(np.isfinite(gv), finite):
        raise AssertionError(f"{what}: finite lanes differ")
    err = float(np.max(np.abs(gv[finite] - wv[finite]), initial=0.0))
    if not np.array_equal(gv, wv):
        raise AssertionError(f"{what}: values differ (max abs {err})")
    if not np.array_equal(gi[finite], wi[finite]):
        raise AssertionError(f"{what}: ids differ")
    if not np.array_equal(gt, wt):
        raise AssertionError(f"{what}: totals differ {gt[:4]} vs {wt[:4]}")
    return err


def phase_kernels(device, rng, n_docs: int, state: dict) -> None:
    import torch

    from elasticsearch_tpu_torch.ops.kernels import TRANSFORMS, scan_topk, scan_topk_reference

    N = n_docs
    live = torch.from_numpy(rng.random(N) > 0.05).to(device)
    scores = torch.from_numpy(rng.normal(size=(1, N)).astype(np.float32)).to(device)
    ties = torch.from_numpy(np.round(rng.normal(size=(1, N)), 2).astype(np.float32)).to(device)
    err = 0.0
    checks = 0
    for k in (10, 25, 128):
        for cp in (False, True):
            for name, s in (("normal", scores), ("ties", ties)):
                err = max(err, compare(
                    scan_topk(None, s, live, k, count_positive=cp),
                    scan_topk_reference(None, s, live, k, aux_doc=torch.zeros(N, device=device),
                                        aux_q=torch.zeros(1, device=device), count_positive=cp),
                    f"streamed {name} k={k} count_positive={cp}"))
                checks += 1
    B, D = 64, 384
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(device)
    mat = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32)).to(device)
    sq = (mat * mat).sum(0)
    qsq = (q * q).sum(1)
    aux = {"cosine": (1.0 / torch.sqrt(sq), 1.0 / torch.sqrt(qsq)),
           "l2_norm": (sq, qsq)}
    for i, transform in enumerate(TRANSFORMS):
        aux_doc, aux_q = aux.get(transform, (torch.zeros(N, device=device),
                                             torch.zeros(B, device=device)))
        for cp in ((False, True) if transform == "identity" else (bool(i % 2),)):
            err = max(err, compare(
                scan_topk(q, mat, live, 10, transform=transform, aux_doc=aux_doc,
                          aux_q=aux_q, count_positive=cp),
                scan_topk_reference(q, mat, live, 10, transform=transform, aux_doc=aux_doc,
                                    aux_q=aux_q, count_positive=cp),
                f"matmul {transform} count_positive={cp}"))
            checks += 1
    state["max_abs_err"] = err

    # times at the main path's shape: streamed, B=1, N docs, k=10, the
    # per-query `ok` mask, count_positive off (top_k_with_total's call)
    z1, zn = torch.zeros(1, device=device), torch.zeros(N, device=device)
    t_kernel = time_ms(lambda: scan_topk(None, scores, live, 10, count_positive=False), 200, device)
    t_plain = time_ms(lambda: scan_topk_reference(None, scores, live, 10, aux_doc=zn, aux_q=z1,
                                                  count_positive=False), 20, device)
    t_lib = time_ms(lambda: torch.topk(scores, 10, dim=1), 200, device)
    out_bytes = 10 * 8 + 4
    state["streamed"] = {
        "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
        "bound_ms": (N * 4 + N * 1 + out_bytes) / HBM_BYTES_PER_S * 1e3,
    }
    t25 = time_ms(lambda: scan_topk(None, scores, live, 25, count_positive=False), 200, device)
    tm = time_ms(lambda: scan_topk(q, mat, live, 10), 5, device)
    tm_plain = time_ms(lambda: scan_topk_reference(q, mat, live, 10, aux_doc=zn,
                                                   aux_q=torch.zeros(B, device=device)), 1,
                       device, warm=False)
    tm_lib = time_ms(lambda: torch.topk(q @ mat, 10, dim=1), 5, device)
    state["shapes"] = {
        "streamed_k25_ms": t25,
        "matmul_B64_D384": {"ms": tm, "plain_ms": tm_plain, "library_ms": tm_lib,
                            "bound_ms": 2 * B * D * N / F32_FLOPS * 1e3,
                            "bound_by": "operations"},
    }
    log(f"kernels: {checks} checks equal, streamed k=10 {t_kernel:.4f} ms "
        f"(twin {t_plain:.3f} ms, torch.topk {t_lib:.4f} ms), k=25 {t25:.4f} ms, "
        f"matmul B={B} D={D} {tm:.3f} ms (twin {tm_plain:.1f} ms, torch.topk(q @ mat) "
        f"{tm_lib:.3f} ms)")
    del q, scores, ties
    scan_topk_c4_rerun(device, rng, mat, live, state)
    del mat
    scan_topk_msearch_shape(device, n_docs, state)
    sm = state["scan_msearch"]
    log(f"kernels: scan_topk streamed B=512 k=10 equal; {sm['ms']:.3f} ms (twin "
        f"{sm['plain_ms']:.1f} ms, torch.topk {sm['library_ms']:.3f} ms, bound {sm['bound_ms']:.3f} ms)")
    phase_kernels_tiered(device, rng, n_docs, state)
    phase_kernels_fused(device, rng, state)
    phase_kernels_impact(device, rng, n_docs, state)


C4_RERUN_ROWS = 700  # the exact kNN arm's flagged rows of a 1,024 batch (0.68-0.69)


def scan_topk_c4_rerun(device, rng, mat, live, state: dict) -> None:
    """scan_topk's matmul route at the shape of the exact kNN arm's rerun
    (ops/vector.py TieredKnnScanner: the flagged rows of a C4 batch against
    the f32 [384, N] corpus, cosine, k=10, count_positive off): equal to
    its twin (timed by the same call), beside the library call
    torch.topk(transform(q @ mat)) of the live lanes."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import _apply_transform, scan_topk, scan_topk_reference

    D, N = mat.shape
    B = C4_RERUN_ROWS
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(device)
    aux_doc = 1.0 / torch.sqrt((mat * mat).sum(0))
    aux_q = 1.0 / torch.sqrt((q * q).sum(1))
    kw = {"transform": "cosine", "aux_doc": aux_doc, "aux_q": aux_q, "count_positive": False}
    got = scan_topk(q, mat, live, 10, **kw)
    box = []
    plain = time_ms(lambda: box.append(scan_topk_reference(q, mat, live, 10, **kw)), 1, device,
                    warm=False)
    err = compare(got, box[0], f"matmul C4 rerun B={B} D={D} cosine")
    state["max_abs_err"] = max(state["max_abs_err"], err)
    del box, got

    def library():
        s = _apply_transform(q @ mat, "cosine", aux_doc, aux_q[:, None])
        return torch.topk(torch.where(live, s, float("-inf")), 10, dim=1)

    state["shapes"]["matmul_c4_rerun"] = {
        "shape": f"B={B} D={D} N={N} k=10 cosine",
        "ms": time_ms(lambda: scan_topk(q, mat, live, 10, **kw), 5, device),
        "plain_ms": plain, "library_ms": time_ms(library, 5, device),
        "bound_ms": 2 * B * D * N / F32_FLOPS * 1e3, "bound_by": "operations"}
    m = state["shapes"]["matmul_c4_rerun"]
    log(f"kernels: scan_topk matmul at the C4 rerun (B={B}, D={D}, cosine) equal; "
        f"{m['ms']:.3f} ms (twin {plain:.1f} ms, torch.topk(transform(q @ mat)) "
        f"{m['library_ms']:.3f} ms, bound {m['bound_ms']:.3f} ms)")


def scan_topk_msearch_shape(device, n_docs: int, state: dict) -> None:
    """scan_topk streamed as the batched arms call it: B=512 rows of dense
    scores, N docs, k=10, count_positive."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import scan_topk, scan_topk_reference

    B, N = 512, n_docs
    gen = torch.Generator(device=device).manual_seed(1)
    scores = torch.rand((B, N), generator=gen, device=device)
    scores.mul_(torch.rand((B, N), generator=gen, device=device) < 0.3)
    live = torch.rand(N, generator=gen, device=device) > 0.05
    zn, zb = torch.zeros(N, device=device), torch.zeros(B, device=device)
    compare(scan_topk(None, scores, live, 10),
            scan_topk_reference(None, scores, live, 10, aux_doc=zn, aux_q=zb),
            "streamed B=512 k=10 count_positive")
    # the selection's edges, 8 rows at N - 3 docs (ragged past a span
    # boundary; spans are multiples of 2,048 lanes): row 0 with 5 positive
    # lanes (fewer than k finite), row 1 with none (all -inf under
    # count_positive), row 2 with equal scores on both sides of every
    # 2,048-lane boundary
    Ne = N - 3
    edge = scores[:8, :Ne].clone()
    edge[0] = 0.0
    edge[0, torch.randint(0, Ne, (5,), generator=gen, device=device)] = 0.5
    edge[1] = 0.0
    b = torch.arange(2048, Ne, 2048, device=device)
    edge[2].clamp_(max=0.9)
    edge[2, torch.cat([b - 1, b])] = 1.0
    for k in (10, 128):
        for cp in (False, True):
            compare(scan_topk(None, edge, live[:Ne], k, count_positive=cp),
                    scan_topk_reference(None, edge, live[:Ne], k, aux_doc=zn[:Ne],
                                        aux_q=zb[:8], count_positive=cp),
                    f"streamed edges B=8 N={Ne} k={k} count_positive={cp}")
    del edge
    state["scan_msearch"] = {
        "ms": time_ms(lambda: scan_topk(None, scores, live, 10), 5, device),
        "plain_ms": time_ms(lambda: scan_topk_reference(None, scores, live, 10, aux_doc=zn,
                                                        aux_q=zb), 2, device),
        "library_ms": time_ms(lambda: torch.topk(torch.where(live & (scores > 0), scores,
                                                             float("-inf")), 10, dim=1),
                              5, device),
        "bound_ms": (B * N * 4 + N + B * (10 * 8 + 4)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


C1_TIER_ROWS = 896  # dense tier rows of the kernel checks' BM25 tier


def c1_dense_tier(device, N: int, gen):
    """A BM25-shaped split-bf16 dense tier [896, N] on the card (~5% of
    lanes hold a tf/(tf+K) in (0, 1)) and a live mask (~95% live)."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import split_bf16

    mat = torch.rand((C1_TIER_ROWS, N), generator=gen, device=device)
    mat.mul_(torch.rand((C1_TIER_ROWS, N), generator=gen, device=device) < 0.05)
    hi, lo = split_bf16(mat)
    del mat
    return hi, lo, torch.rand(N, generator=gen, device=device) > 0.05


def phase_kernels_tiered(device, rng, n_docs: int, state: dict) -> None:
    """tiered_candidates against its twin within the tensor cores' bound
    (`check_tiered_selection`), and split_bf16 against its twin."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import (
        TRANSFORMS, _mask_hi, check_tiered_selection, split_bf16, tiered_candidates,
        tiered_candidates_reference)

    D, N, kb = C1_TIER_ROWS, n_docs, 64
    gen = torch.Generator(device=device).manual_seed(2)
    hi, lo, live = c1_dense_tier(device, N, gen)
    zn = torch.zeros(N, device=device)
    checks = 0
    ratio, err = 0.0, 0.0

    def check(got, want, *args, **kw):
        nonlocal checks, ratio, err
        r, e = check_tiered_selection(got, want, *args, **kw)
        checks += 1
        ratio, err = max(ratio, r), max(err, e)

    timing = {}
    for B in (512, 37):
        # BM25 weights: up to 4 dense terms per query, idf-sized
        q = np.zeros((B, D), np.float32)
        for r in range(B):
            q[r, rng.choice(D, int(rng.integers(1, 5)), replace=False)] = rng.uniform(0.5, 8, 1)
        q = torch.from_numpy(q).to(device)
        zb = torch.zeros(B, device=device)
        got = tiered_candidates(q, hi, lo, live, kb)
        sync(device)
        t0 = time.perf_counter()
        want = tiered_candidates_reference(q, hi, lo, live, kb, aux_doc=zn, aux_q=zb)
        sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(got, want, q, hi, lo, live)
        if B == 512:
            qh = _mask_hi(q).to(torch.bfloat16)
            timing = {
                "ms": time_ms(lambda: tiered_candidates(q, hi, lo, live, kb), 5, device),
                "plain_ms": plain_ms,
                "library_ms": time_ms(lambda: torch.topk(
                    (qh @ hi).float() + (qh @ lo).float(), kb, dim=1), 3, device),
                "bound_ms": max(4 * B * D * N / 989e12, 2 * D * N * 2 / HBM_BYTES_PER_S) * 1e3,
                "bound_by": "operations",
            }
        del want, got
    state["tier_hilo"] = (hi, lo, live)  # the fused check's tier
    del hi, lo
    torch.cuda.empty_cache()

    # C4's exact arm: B=1024 standard-normal queries against 1M x 384
    # standard-normal vectors, cosine, kb=64, count_positive off
    B, D = 1024, 384
    vec_t = torch.randn((D, N), generator=gen, device=device)
    hi, lo = split_bf16(vec_t)
    aux_doc = 1.0 / torch.clamp(torch.sqrt((vec_t * vec_t).sum(0)), min=1e-30)
    del vec_t
    q = torch.randn((B, D), generator=gen, device=device)
    aux_q = 1.0 / torch.clamp(torch.sqrt((q * q).sum(1)), min=1e-30)
    live_c4 = torch.ones(N, dtype=torch.bool, device=device)
    kw = {"transform": "cosine", "aux_doc": aux_doc, "aux_q": aux_q, "count_positive": False}
    got = tiered_candidates(q, hi, lo, live_c4, kb, **kw)
    sync(device)
    t0 = time.perf_counter()
    want = tiered_candidates_reference(q, hi, lo, live_c4, kb, **kw)
    sync(device)
    c4_plain = (time.perf_counter() - t0) * 1e3
    check(got, want, q, hi, lo, live_c4, **kw)
    del got, want
    qh = _mask_hi(q).to(torch.bfloat16)

    def c4_library():
        dots = (qh @ hi).float() + (qh @ lo).float()
        return torch.topk((1.0 + dots * aux_doc * aux_q[:, None]) / 2.0, kb, dim=1)

    c4 = {"ms": time_ms(lambda: tiered_candidates(q, hi, lo, live_c4, kb, **kw), 5, device),
          "plain_ms": c4_plain, "library_ms": time_ms(c4_library, 3, device),
          "bound_ms": max(4 * B * D * N / 989e12, 2 * D * N * 2 / HBM_BYTES_PER_S) * 1e3,
          "bound_by": "operations"}
    del hi, lo, qh
    torch.cuda.empty_cache()

    # every transform, count_positive off, on a signed matrix
    B, D, N = 16, 128, 100_000
    qn = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(device)
    matn = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32)).to(device)
    hi, lo = split_bf16(matn)
    hc, lc = split_bf16(matn.cpu())
    for name, a, b in (("hi", hi, hc), ("lo", lo, lc)):
        if not torch.equal(a.cpu().view(torch.int16), b.view(torch.int16)):
            raise AssertionError(f"split_bf16 {name} differs between the card and the host")
    livn = torch.from_numpy(rng.random(N) > 0.1).to(device)
    sq = (matn * matn).sum(0)
    qsq = (qn * qn).sum(1)
    aux = {"cosine": (1.0 / torch.sqrt(sq), 1.0 / torch.sqrt(qsq)), "l2_norm": (sq, qsq)}
    for transform in TRANSFORMS:
        aux_doc, aux_q = aux.get(transform, (torch.zeros(N, device=device),
                                             torch.zeros(B, device=device)))
        kw = {"transform": transform, "aux_doc": aux_doc, "aux_q": aux_q,
              "count_positive": False}
        check(tiered_candidates(qn, hi, lo, livn, kb, **kw),
              tiered_candidates_reference(qn, hi, lo, livn, kb, **kw), qn, hi, lo, livn, **kw)
    if ratio > 1.0:
        raise AssertionError(f"tiered_candidates: |err| / bound {ratio} above 1")
    state["tiered"] = {**timing, "max_abs_err": err, "max_err_over_bound": ratio,
                       "checks": checks}
    state.setdefault("shapes", {})["tiered_c4_B1024_D384_cosine"] = c4
    log(f"kernels: tiered_candidates {checks} checks within the tensor-core bound (largest "
        f"|err| / bound {ratio:.4g}, |err| {err:.3g}), split_bf16 equal to the host's; "
        f"B=512 D=896 N={n_docs} kb={kb}: {timing['ms']:.3f} ms (twin {timing['plain_ms']:.1f} ms, "
        f"topk over bf16 cuBLAS {timing['library_ms']:.3f} ms, bound {timing['bound_ms']:.3f} ms); "
        f"C4 B=1024 D=384 cosine: {c4['ms']:.3f} ms (twin {c4['plain_ms']:.1f} ms, library "
        f"{c4['library_ms']:.3f} ms, bound {c4['bound_ms']:.3f} ms)")


def fused_c1_inputs(device, rng, hi, lo, live) -> dict:
    """The C1 chunk's fused_tile_candidates inputs on the tier (hi, lo,
    live): Qc=512, up to Td=4 dense rows per query, 0-3 sparse terms of
    100-3,900 postings per query (a dense tier holds the terms of df >=
    N/256), 5% duplicate (query, doc) entries, the tail tile, and tile 3
    with 3 live lanes (fewer than t). -> {"args", "t", "db", "Qc", "Td",
    "njc"}."""
    import torch

    from elasticsearch_tpu_torch.ops.fused import SENTINEL, TILE_N, _key_bits, tile_t_for

    V, N = hi.shape
    Qc, Td = 512, 4
    njc = -(-N // TILE_N)
    t = tile_t_for(njc)
    _, db, _ = _key_bits(njc * TILE_N, 1, Qc)
    live = live.clone()
    live[3 * TILE_N: 4 * TILE_N] = False
    live[3 * TILE_N + torch.tensor([1, 700, 4095], device=device)] = True
    drows = np.zeros((Qc, Td), np.int32)
    dwh = np.zeros((Qc, Td), np.float32)
    qs, docs = [], []
    for q in range(Qc):
        nd = int(rng.integers(0, Td + 1))
        drows[q, :nd] = np.sort(rng.choice(V, nd, replace=False))
        dwh[q, :nd] = rng.uniform(0.5, 8, nd)
        for _ in range(int(rng.integers(0, 4))):
            df = int(rng.integers(100, 3900))
            docs.append(rng.integers(0, N, df))
            qs.append(np.full(df, q))
    dwh = (dwh.view(np.int32) & -65536).view(np.float32)  # bf16-cut, as the pipeline's
    q_all, d_all = np.concatenate(qs), np.concatenate(docs)
    dup = rng.random(q_all.shape[0]) < 0.05  # a doc in two of a query's terms
    q_all = np.concatenate([q_all, q_all[dup]])
    d_all = np.concatenate([d_all, d_all[dup]])
    keys = ((q_all << db) | d_all).astype(np.int32)
    keys = np.concatenate([keys[np.argsort(keys, kind="stable")],
                           np.full(-keys.shape[0] % 128, SENTINEL, np.int32)])
    vals = rng.uniform(0.01, 6, keys.shape[0]).astype(np.float32)
    bounds = (np.arange(Qc)[:, None] << db) | (np.arange(njc + 1) * TILE_N)[None, :]
    ptr = np.searchsorted(keys, bounds.reshape(-1)).astype(np.int32).reshape(Qc, njc + 1)
    args = (hi, lo, live, *(torch.from_numpy(a).to(device) for a in (drows, dwh, keys, vals, ptr)))
    return {"args": args, "t": t, "db": db, "Qc": Qc, "Td": Td, "njc": njc}


def phase_kernels_fused(device, rng, state: dict) -> None:
    """fused_tile_candidates against its twin at the C1 chunk
    (`fused_c1_inputs`) on the [896, N] split-bf16 tier of the tiered
    check."""
    import torch

    from elasticsearch_tpu_torch.ops.fused import (
        TILE_N, _fused_tile_candidates_cuda, fused_route, fused_tile_candidates,
        fused_tile_candidates_reference)

    hi, lo, live = state.pop("tier_hilo")
    V, N = hi.shape
    c1 = fused_c1_inputs(device, rng, hi, lo, live)
    args, t, db, Qc, Td, njc = (c1[k] for k in ("args", "t", "db", "Qc", "Td", "njc"))
    live, ptr = args[2], args[7]
    got = fused_tile_candidates(*args, t=t, db=db)
    t0 = time.perf_counter()
    want = fused_tile_candidates_reference(*args, t=t, db=db)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare(got[:3], want[:3], f"fused_tile_candidates Qc={Qc} N={N} t={t}")
    if not torch.equal(got[1], want[1]) or got[3].any():
        raise AssertionError("fused_tile_candidates: ids or window flags differ")
    if int(torch.isfinite(got[0].view(Qc, njc, t)[:, 3]).sum(1).max()) > 3:
        raise AssertionError("fused_tile_candidates: dead lanes among the candidates")
    del want

    # the composition the JAX package's out-of-kernel mode stands for:
    # the bf16 cuBLAS product [Wh | Wh] @ [hi; lo], the sparse entries
    # accumulated in, masks, and torch.topk of every tile row
    W = torch.zeros((Qc, V), dtype=torch.float32, device=device)
    W.scatter_add_(1, args[3].long(), args[4])
    W2 = torch.cat([W, W], dim=1).to(torch.bfloat16)
    tstack = torch.cat([hi, lo], dim=0)
    ent = int(ptr[-1, -1])
    d_keys, d_vals = args[5][:ent].long(), args[6][:ent]
    flat = (d_keys >> db) * N + (d_keys & ((1 << db) - 1))
    pad = njc * TILE_N - N

    def library():
        sc = (W2 @ tstack).float()
        sc.view(-1).index_put_((flat,), d_vals, accumulate=True)
        sc = torch.where(live & (sc > 0), sc, float("-inf"))
        sc = torch.nn.functional.pad(sc, (0, pad), value=float("-inf"))
        return torch.topk(sc.view(Qc * njc, TILE_N), t, dim=1)

    nnz = int((args[4] != 0).sum())
    rows_touched = int(torch.unique(args[3][args[4] != 0]).numel())
    out_bytes = Qc * njc * (t * 8 + 4)
    bytes_ = rows_touched * N * 4 + ent * 8 + N + out_bytes
    # the previous design (one block per (row, tile), a bitonic sort of the
    # tile) is the wrapper's route for t > 128: held to the twin and timed
    # at this t too
    sort_err = compare(_fused_tile_candidates_cuda(*args, t, db, route="sort")[:3], got[:3],
                       "fused_tile_candidates sort route")
    state["fused"] = {
        "ms": time_ms(lambda: fused_tile_candidates(*args, t=t, db=db), 3, device),
        "route": fused_route(t),
        "sort_route_ms": time_ms(
            lambda: _fused_tile_candidates_cuda(*args, t, db, route="sort"), 3, device),
        "previous_ms": PREVIOUS_MS["fused_tile_candidates"],
        "plain_ms": plain_ms,
        "library_ms": time_ms(library, 3, device),
        "bound_ms": max(bytes_ / HBM_BYTES_PER_S, 4 * N * nnz / 67e12) * 1e3,
        "bound_by": "bytes" if bytes_ / HBM_BYTES_PER_S >= 4 * N * nnz / 67e12 else "operations",
        "max_abs_err": max(err, sort_err),
        "shape": f"Qc={Qc} N={N} Td={Td} ({nnz} weights, {rows_touched} rows) "
                 f"{ent} entries t={t}",
    }
    del W2, tstack, got, args, hi, lo
    torch.cuda.empty_cache()
    f = state["fused"]
    log(f"kernels: fused_tile_candidates equal to its twin at {f['shape']}: {f['ms']:.3f} ms "
        f"on the {f['route']} route (twin {f['plain_ms']:.1f} ms, bf16 cuBLAS + index_put_ + "
        f"topk {f['library_ms']:.3f} ms, bound {f['bound_ms']:.3f} ms, {f['bound_by']}); the "
        f"previous design (sort route, equal too) {f['sort_route_ms']:.3f} ms here, "
        f"{f['previous_ms']} ms in PERF.md's table")


def phase_kernels_impact(device, rng, n_docs: int, state: dict) -> None:
    """impact_gather against its twin, uint16 and int8 codes."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import impact_gather, impact_gather_reference

    nb, Q, R = 200_000, 512, 64
    docids = rng.integers(0, n_docs, (nb, 128)).astype(np.int32)
    docids[0] = n_docs  # row 0: the all-padding block
    rows = rng.integers(1, nb, (Q, R)).astype(np.int32)
    pad = rng.random((Q, R)) < 0.1
    rows[pad] = 0
    w = rng.uniform(0, 1e-3, (Q, R)).astype(np.float32)
    w[pad] = 0.0
    d_docids, d_rows, d_w = (torch.from_numpy(a).to(device) for a in (docids, rows, w))
    timing = {}
    for dtype, high in ((np.uint16, 65536), (np.int8, 128)):
        codes = rng.integers(1, high, (nb, 128)).astype(dtype)
        codes[0] = 0
        d_codes = torch.from_numpy(codes).to(device)
        got = impact_gather(d_codes, d_docids, d_rows, d_w)
        want = impact_gather_reference(d_codes, d_docids, d_rows, d_w)
        for g, x, what in zip(got, want, ("ids", "scores")):
            if not torch.equal(g, x):
                raise AssertionError(f"impact_gather {np.dtype(dtype).name}: {what} differ")
        if dtype == np.uint16:
            lanes = Q * R * 128
            timing = {
                "ms": time_ms(lambda: impact_gather(d_codes, d_docids, d_rows, d_w), 200, device),
                "plain_ms": time_ms(lambda: impact_gather_reference(d_codes, d_docids, d_rows,
                                                                    d_w), 20, device),
                "library_ms": None,  # no single PyTorch call gathers and scales
                "bound_ms": (lanes * (2 + 4 + 8) + Q * R * 8) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
            }
    state["impact"] = {**timing, "max_abs_err": 0.0}
    log(f"kernels: impact_gather uint16 and int8 equal; Q={Q} R={R} uint16: "
        f"{timing['ms']:.4f} ms (twin {timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms)")


# phases whose refreshes get a `build <phase>` line
BUILD_PHASES = ("index", "rest", "writes", "shards_index", "c5_index", "aggs_index",
                "knn_index", "knn_shards_index", "knn_writes", "geo_index", "field_types",
                "matchers", "analysis")
# how far a RefreshProfile's wall may read below the caller's clock around
# idx.refresh(): 5% + 0.1 s (relative, absolute s) for the refresh's last
# bookkeeping after its profile closes (0.5 ms at most in
# scripts/refresh_probe.py's 60 full refreshes on an H100)
REFRESH_WALL_MARGIN = (0.05, 0.1)
PACK_ARRAYS = ("post_docids", "post_tfs", "post_dls", "term_block_start", "term_df",
               "block_max_tf", "block_min_len", "live", "dense_tfn", "impact_codes",
               "impact_ubf", "pos_keys", "term_pos_start", "term_pos_count")
DV_ARRAYS = ("values", "has_value", "uniq_values", "uniq_ords", "mv_pair_docs", "mv_pair_ords")


def _profile_mark(state: dict) -> int:
    eng = state.get("engine")
    return eng.refresh_recorder.profiles(0)["recorded_total"] if eng is not None else 0


def _new_profiles(state: dict, mark: int) -> list:
    """The engine's RefreshProfiles recorded after `mark`."""
    eng = state.get("engine")
    if eng is None:
        return []
    return [p for p in eng.refresh_recorder.profiles()["profiles"] if p["refresh"] > mark]


def _log_profile(what: str, wall: float, stages: dict, basis: dict, n: int = 1) -> None:
    """One stage split (of `n` refreshes): seconds per stage (largest first,
    with its route), and their sum against the wall, which must agree up to
    the profiles' rounding (1e-4 ms per stage)."""
    total = sum(stages.values())
    if abs(total - wall) > 1e-7 * n * len(stages) + 1e-9 * wall:
        raise AssertionError(f"{what}: stages sum to {total} s, the wall is {wall} s")
    parts = ", ".join(f"{k} {v:.4f}" + (f" ({basis[k]})" if k in basis else "")
                      for k, v in sorted(stages.items(), key=lambda kv: -kv[1]))
    log(f"{what}: {wall:.4f} s; stages (s): {parts}; sum {total:.4f} s")


def _check_profile_wall(what: str, profile_s: float, clock_s: float) -> None:
    """A refresh's RefreshProfile wall against this script's own clock
    around `idx.refresh()` (the card synchronised): the profile may miss
    only the refresh's last bookkeeping, within REFRESH_WALL_MARGIN
    (relative, absolute s)."""
    rel, absolute = REFRESH_WALL_MARGIN
    if not clock_s - (rel * clock_s + absolute) <= profile_s <= clock_s:
        raise AssertionError(f"{what}: the profile's wall {profile_s:.4f} s is not within "
                             f"{REFRESH_WALL_MARGIN} of the caller's clock {clock_s:.4f} s")
    log(f"{what}: profile wall {profile_s:.4f} s, the caller's clock {clock_s:.4f} s")


def _log_build(state: dict, phase: str, profiles: list) -> None:
    """The refreshes one phase ran, summed per stage."""
    if not profiles:
        return
    stages: dict = {}
    basis: dict = {}
    kinds: dict = {}
    for p in profiles:
        for k, v in p["stages_ms"].items():
            stages[k] = stages.get(k, 0.0) + v / 1e3
        for k, b in p["basis"].items():
            basis[k] = b if basis.get(k) in (None, b) else "mixed"
        kinds[p["kind"]] = kinds.get(p["kind"], 0) + 1
    wall = sum(p["wall_ms"] for p in profiles) / 1e3
    _log_profile(f"build {phase}: {len(profiles)} refreshes {kinds}", wall, stages, basis,
                 len(profiles))
    state.setdefault("build", {}).setdefault("phases", {})[phase] = {
        "refreshes": kinds, "docs": sum(p["docs"] for p in profiles), "wall_s": round(wall, 4),
        "stages_s": {k: round(v, 4) for k, v in stages.items()}, "basis": basis}


def _host_pack(parsed_docs: list, mappings, dense_min_df=None, device="cpu"):
    """(id, parsed) docs packed through the host route (or with `device` a
    card, through the card's route above the device-build floors).
    -> (pack, wall s, {stage: s}, {stage: basis})."""
    from elasticsearch_tpu_torch.index.pack import PackBuilder
    from elasticsearch_tpu_torch.monitoring.refresh_profile import (collect_build_stages,
                                                                    refresh_stage)

    with collect_build_stages() as c:
        b = PackBuilder(mappings, device=device)
        with refresh_stage("analyze"):
            b.add_documents_batch([p for _i, p in parsed_docs],
                                  doc_ids=[i for i, _p in parsed_docs])
        pack = b.build(dense_min_df=dense_min_df)
    wall, stages = c.finish()
    return pack, wall, stages, dict(c.bases)


def _compare_packs(got, want, what: str) -> tuple[int, int]:
    """Every array of two ShardPacks byte for byte (a card-resident array
    copied back), and their dictionaries and statistics equal.
    -> (arrays, bytes) compared."""
    import torch

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    pairs = [(n, getattr(got, n), getattr(want, n)) for n in PACK_ARRAYS]
    pairs += [(f"norms.{f}", got.norms.get(f), a) for f, a in want.norms.items()]
    pairs += [(f"text_present.{f}", got.text_present.get(f), a)
              for f, a in want.text_present.items()]
    for f, col in want.docvalues.items():
        gcol = got.docvalues.get(f)
        if gcol is None or (gcol.kind, gcol.ord_terms, gcol.vmin, gcol.vmax) != \
                (col.kind, col.ord_terms, col.vmin, col.vmax):
            raise AssertionError(f"{what}: docvalues [{f}] differ")
        pairs += [(f"docvalues.{f}.{k}", getattr(gcol, k), getattr(col, k)) for k in DV_ARRAYS]
    n_arrays = n_bytes = 0
    for name, g, w in pairs:
        if w is None and g is None:
            continue
        g, w = host(g), host(w)
        if g is None or w is None or g.dtype != w.dtype or g.shape != w.shape \
                or g.tobytes() != w.tobytes():
            raise AssertionError(f"{what}: [{name}] differs from the host route's")
        n_arrays += 1
        n_bytes += w.nbytes
    for name in ("term_dict", "dense_dict", "field_stats", "impact_meta"):
        if getattr(got, name) != getattr(want, name):
            raise AssertionError(f"{what}: [{name}] differs from the host route's")
    if list(got.term_dict) != list(want.term_dict) or got.num_docs != want.num_docs:
        raise AssertionError(f"{what}: the term order or doc count differs")
    return n_arrays, n_bytes


def phase_index(device, rng, n_docs: int, state: dict):
    import torch

    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus

    t0 = time.perf_counter()
    lens, tok, nums = make_corpus(rng, n_docs)
    docs = corpus_docs(lens, tok, nums)
    t_gen = time.perf_counter() - t0
    idx = _engine(state, device).create_index("corpus", MAPPINGS)
    t1 = time.perf_counter()
    for i, d in enumerate(docs):
        idx.index_doc(str(i), d)
    del docs
    t2 = time.perf_counter()
    mark = _profile_mark(state)
    idx.refresh()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    pack = idx.searcher.pack
    dense_rows = len(pack.dense_dict)
    on_card = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    state.update(corpus=(lens, tok), nums=nums, index=idx, index_refresh_s=t3 - t2)
    log(f"index: {pack.num_docs} docs, {pack.num_terms} terms, {dense_rows} dense rows "
        f"(tier {pack.dense_tfn.shape[0]} x {pack.num_docs}), {pack.nbytes()} pack bytes, "
        f"{on_card} bytes allocated on the card; generate {t_gen:.1f} s, "
        f"index_doc {t2 - t1:.1f} s, refresh {t3 - t2:.1f} s")
    (card,) = _new_profiles(state, mark)
    if card["kind"] != "full" or card["basis"].get("flat_csr") != "device":
        raise AssertionError(f"the 1M-doc refresh did not take the card's route: {card['basis']}")
    _check_profile_wall("index card refresh", card["wall_ms"] / 1e3, t3 - t2)
    _log_profile("index card refresh", card["wall_ms"] / 1e3,
                 {k: v / 1e3 for k, v in card["stages_ms"].items()}, card["basis"])
    # the card's route against the host route, every array compared, on a
    # prefix of the docs that crosses every device-build floor (the whole
    # 1M-doc host build took ~67 s of the run's time limit)
    prefix = [(i, e.parsed) for i, e in itertools.islice(idx._docs.items(), INDEX_CHECK_DOCS)]
    card_pack, _cw, _cs, bases = _host_pack(prefix, idx.mappings, device=device)
    if bases.get("flat_csr") != "device":
        raise AssertionError(f"the {len(prefix)}-doc card build took the host route: {bases}")
    host, wall, stages, _hb = _host_pack(prefix, idx.mappings)
    _log_profile(f"index host build ({len(prefix)} docs)", wall, stages, {})
    n_arrays, n_bytes = _compare_packs(card_pack, host, "index prefix")
    del host, card_pack
    log(f"index: a card-built pack of the first {len(prefix)} docs equals the host route's, "
        f"{n_arrays} arrays, {n_bytes} bytes compared")
    state.setdefault("build", {})["index"] = {
        "docs": pack.num_docs, "card_wall_s": card["wall_ms"] / 1e3, "caller_clock_s": t3 - t2,
        "card": {k: round(v / 1e3, 4) for k, v in card["stages_ms"].items()},
        "basis": card["basis"], "host_docs": len(prefix), "host_wall_s": round(wall, 4),
        "host": {k: round(v, 4) for k, v in stages.items()}}


def phase_traffic(device, rng, state: dict) -> None:
    from elasticsearch_tpu_torch.corpus import traffic
    from elasticsearch_tpu_torch.ops import kernels

    idx = state["index"]
    lens, tok = state["corpus"]
    queries = traffic(rng, lens, tok, 200, 50, 50)
    requests = [(q, 10, 0) for q in queries] + [(q, 20, 5) for q in queries]
    for q, size, from_ in requests[:5]:  # warm-up: first loads and allocations
        idx.search(q, size=size, from_=from_)
    kernels.reset_launch_counts()
    lat = {(10, 0): [], (20, 5): []}
    results = []
    for q, size, from_ in requests:
        t0 = time.perf_counter()
        out = idx.search(q, size=size, from_=from_)  # ends in a device-to-host copy
        lat[(size, from_)].append((time.perf_counter() - t0) * 1000)
        results.append(out)
    launches = dict(kernels.launch_counts)
    if launches["scan_topk"] != len(requests):
        raise AssertionError(f"scan_topk launched {launches['scan_topk']} times for "
                             f"{len(requests)} requests")
    for (q, size, from_), out in zip(requests, results):
        hits = out["hits"]["hits"]
        scores = [h["_score"] for h in hits]
        if len(hits) > size or not all(np.isfinite(scores)) or scores != sorted(scores, reverse=True):
            raise AssertionError(f"malformed hits for {q}")
    n_hits = sum(len(o["hits"]["hits"]) for o in results)
    if n_hits == 0:
        raise AssertionError("the traffic returned no hits")
    state.update(requests=requests, results=results, launches=launches,
                 traffic_p50={key: float(np.percentile(ms, 50)) for key, ms in lat.items()})
    parts = []
    for (size, from_), ms in lat.items():
        parts.append(f"size={size} from={from_}: p50 {np.percentile(ms, 50):.3f} ms "
                     f"p99 {np.percentile(ms, 99):.3f} ms")
    log(f"traffic: {len(requests)} requests, {n_hits} hits, scan_topk launches "
        f"{launches['scan_topk']}; " + "; ".join(parts))


def phase_cpu(state: dict) -> None:
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    idx = state["index"]
    cpu = ShardSearcher(idx.searcher.pack, device="cpu", mappings=idx.mappings)
    requests, results = state["requests"], state["results"]
    picks = list(range(0, len(requests), len(requests) // 20))[:20]
    worst = 0.0
    for i in picks:
        q, size, from_ = requests[i]
        want = cpu.search(q, size=size, from_=from_)
        got = results[i]["hits"]
        if got["total"]["value"] != want.total:
            raise AssertionError(f"total {got['total']['value']} vs cpu {want.total} for {q}")
        gs = np.array([h["_score"] for h in got["hits"]], np.float64)
        ws = want.scores.astype(np.float64)
        if gs.shape != ws.shape:
            raise AssertionError(f"hit count differs for {q}")
        rel = np.abs(gs - ws) / np.maximum(np.abs(ws), 1e-30) if len(ws) else np.zeros(0)
        worst = max(worst, float(rel.max(initial=0.0)))
        if worst > 1e-6:
            raise AssertionError(f"scores differ by {worst} relative for {q}")
        for h, d, w in zip(got["hits"], want.doc_ids, ws):
            if int(h["_id"]) != int(d) and abs(h["_score"] - w) > 1e-5 * max(abs(w), 1.0):
                raise AssertionError(f"ids differ beyond fp-ties for {q}")
    log(f"cpu: {len(picks)} requests match the device=cpu run "
        f"(max relative score difference {worst:.3g})")


def _msearch_batches(searcher, batches, k: int, need: dict) -> tuple[list, list]:
    """Time each batch through ShardSearcher.msearch at k and check its rows
    and its launches: need maps a kernel to the arm whose chunks it must
    cover. -> (per-batch outputs, per-batch rows of numbers)."""
    from elasticsearch_tpu_torch.ops import kernels

    bs = searcher.batched()
    results, rows = [], []
    for qs in batches:
        before = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        out = searcher.msearch("body", qs, k)  # ends in the host copy of every row
        wall = time.perf_counter() - t0
        st = bs.last_stats
        launched = {n: kernels.launch_counts[n] - before[n] for n in before}
        for name, arm in need.items():
            n = st["chunks"].get(arm, 0)
            if n == 0 or launched[name] < n:
                raise AssertionError(f"{name} launched {launched[name]} times for {n} {arm} chunks")
        v, i, t, ex = out
        if v.shape != (len(qs), k) or np.isnan(v).any():
            raise AssertionError("malformed msearch rows")
        fin = np.isfinite(v)
        if (v[:, 1:] > v[:, :-1]).any() or (t < fin.sum(1)).any():
            raise AssertionError("msearch rows out of order or totals below the hit count")
        results.append(out)
        rows.append({"k": k, "wall_ms": wall * 1e3, "qps": len(qs) / wall, "arms": st["queries"],
                     "chunks": st["chunks"], "first_pass_exact": float(ex.mean()),
                     "rounds": st["rounds"], "escalated": st["escalated"], "launches": launched})
        log(f"msearch batch k={k}: {wall * 1e3:.1f} ms, {len(qs) / wall:.0f} QPS, arms "
            f"{st['queries']}, chunks {st['chunks']}, first-pass exact {ex.mean():.4f}, "
            f"{st['rounds']} rounds ({st['escalated']} reruns), launches {launched}")
    if sum(int(np.isfinite(r[0]).sum()) for r in results) == 0:
        raise AssertionError("msearch returned no hits")
    return results, rows


def phase_msearch(device, rng, state: dict) -> None:
    from elasticsearch_tpu_torch.corpus import sample_queries, traffic
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.planner import execution_planner

    idx = state["index"]
    lens, tok = state["corpus"]
    searcher = idx.searcher
    # warm-up batches: the split-bf16 tier copies, pinned buffers, allocations
    warm = sample_queries(rng, lens, tok, C1_BATCH)
    searcher.msearch("body", warm, 10)
    searcher.msearch("body", warm, 25)
    sync(device)
    batches = [sample_queries(rng, lens, tok, C1_BATCH) for _ in range(4)]
    kernels.reset_launch_counts()
    results, rows = _msearch_batches(searcher, batches, 10,
                                     {"fused_tile_candidates": "fused"})
    results25, rows25 = _msearch_batches(
        searcher, batches[:2], 25, {"impact_gather": "impact", "tiered_candidates": "tiered"})
    launches = dict(kernels.launch_counts)
    modes = execution_planner().stats()["decision_modes"]
    if modes["model"]:
        raise AssertionError(f"the planner routed phase msearch's batches by its model: {modes}")

    # EsIndex.msearch: match bodies ride the term lane, bool bodies the
    # per-query route (spied on, so the route is shown, not assumed)
    bodies = []
    for j, qs in enumerate(sample_queries(rng, lens, tok, 512)):
        body = {"query": {"match": {"body": " ".join(t for t, _ in qs)}}}
        bodies.append({**body, "from": 5, "size": 20} if j % 2 else body)
    bools = [{"query": q} for q in traffic(rng, lens, tok, 0, 0, 32)]
    per_query, batched = [0], [0]
    search, msearch = idx.search, searcher.msearch

    def spy_search(*a, **kw):
        per_query[0] += 1
        return search(*a, **kw)

    def spy_msearch(fld, queries, k=10, **kw):
        batched[0] += len(queries)
        return msearch(fld, queries, k, **kw)

    idx.search, searcher.msearch = spy_search, spy_msearch
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resp = idx.msearch(bodies + bools)
        wall = time.perf_counter() - t0
        es_launches = dict(kernels.launch_counts)
    finally:
        del idx.search, searcher.msearch
    statuses = {r["status"] for r in resp["responses"]}
    if statuses != {200} or len(resp["responses"]) != len(bodies) + len(bools):
        raise AssertionError(f"EsIndex.msearch statuses {statuses}")
    if per_query[0] != len(bools) or batched[0] != len(bodies):
        raise AssertionError(f"routes: {per_query[0]} per-query, {batched[0]} batched")
    for name in ("fused_tile_candidates", "impact_gather", "tiered_candidates", "scan_topk"):
        if es_launches[name] == 0:
            raise AssertionError(f"EsIndex.msearch launched no {name}")
    for r, body in zip(resp["responses"], bodies):
        if len(r["hits"]["hits"]) > body.get("size", 10):
            raise AssertionError("EsIndex.msearch returned too many hits")
    state.update(msearch_batches=batches, msearch_results=results,
                 msearch_results25=results25, msearch_rows=rows + rows25,
                 msearch_launches=launches)
    parts = []
    for k, rr in ((10, rows), (25, rows25)):
        walls = [r["wall_ms"] for r in rr]
        parts.append(f"k={k}: {len(rr)} x {C1_BATCH} queries, wall p50 "
                     f"{np.percentile(walls, 50):.1f} ms, "
                     f"{len(rr) * C1_BATCH / (sum(walls) / 1e3):.0f} QPS")
    log(f"msearch: {'; '.join(parts)}; launches {launches}; planner decisions {modes}; "
        f"EsIndex.msearch {len(bodies)} match + {len(bools)} bool bodies in {wall * 1e3:.1f} ms: "
        f"{batched[0]} batched, {per_query[0]} per-query, launches {es_launches}")


def _disjunction(terms) -> dict:
    return {"bool": {"should": [{"term": {"body": {"value": t, "boost": b}}} for t, b in terms]}}


def phase_msearch_check(state: dict) -> None:
    """64 msearch rows against per-query `_search`: the fused k=10 rows
    exactly (up to fp-ties) against exact BM25 plans, the impact k=25 rows
    in the impact tier's quantization tie class of them, and within 1e-5
    relative of `_search` itself (the impact tier too)."""
    from elasticsearch_tpu_torch.ops.batched import impact_tie_class

    idx = state["index"]
    pack = idx.searcher.pack
    queries = state["msearch_batches"][0][:64]

    v, ids, tt, _ = state["msearch_results"][0]
    worst, ties = 0.0, 0
    for row, terms in enumerate(queries):
        want = _exact_hits(idx, _disjunction(terms), 10)
        if tt[row] != want["total"]["value"]:
            raise AssertionError(f"fused total {tt[row]} vs {want['total']['value']} for {terms}")
        ws = np.array([h["_score"] for h in want["hits"]])
        gs = v[row][np.isfinite(v[row])]
        if gs.shape != ws.shape:
            raise AssertionError(f"{len(gs)} fused hits vs {len(ws)} for {terms}")
        rel = np.abs(gs - ws) / np.maximum(np.abs(ws), 1e-30)
        worst = max(worst, float(rel.max(initial=0.0)))
        if worst > 1e-5:
            raise AssertionError(f"fused scores differ by {worst} relative for {terms}")
        for j, h in enumerate(want["hits"]):
            if int(h["_id"]) != int(ids[row][j]):
                ties += 1
                if abs(gs[j] - ws[j]) > 1e-5 * max(abs(ws[j]), 1.0):
                    raise AssertionError(f"fused ids differ beyond fp-ties for {terms}")
    fused_line = (f"{len(queries)} fused k=10 rows equal per-query _search (max relative "
                  f"score difference {worst:.3g}, {ties} positions swapped among fp-ties)")

    v, ids, tt, _ = state["msearch_results25"][0]
    worst_gap, ties, iworst = 0.0, 0, 0.0
    for row, terms in enumerate(queries):
        solo = idx.search(_disjunction(terms), size=25)
        ws, wi, _wt = _hits_arrays(solo)
        fin = np.isfinite(v[row])
        ties += _rows_match(v[row][fin].astype(np.float64), ids[row][fin], ws, wi,
                            f"impact k=25 vs impact _search {terms}", rtol=1e-5)
        if len(ws):
            iworst = max(iworst, float((np.abs(v[row][fin] - ws) / np.abs(ws)).max()))
        want = _exact_hits(idx, _disjunction(terms), 25)
        exact_total = want["total"]["value"]
        if exact_total < 10_000:
            if tt[row] != exact_total:
                raise AssertionError(f"total {tt[row]} vs {exact_total} for {terms}")
        elif not 10_000 <= tt[row] <= exact_total:
            raise AssertionError(f"total {tt[row]} outside [10000, {exact_total}] for {terms}")
        tol = impact_tie_class(pack, "body", terms)
        ws = np.array([h["_score"] for h in want["hits"]])
        gs = v[row][np.isfinite(v[row])]
        if gs.shape != ws.shape:
            raise AssertionError(f"{len(gs)} hits vs {len(ws)} for {terms}")
        gap = np.abs(gs - ws)
        if (gap > tol + 1e-6 * np.abs(ws)).any():
            raise AssertionError(f"scores differ by {gap.max()} (bound {tol}) for {terms}")
        worst_gap = max(worst_gap, float(gap.max(initial=0.0)))
        for j, h in enumerate(want["hits"]):
            if int(h["_id"]) != int(ids[row][j]):
                ties += 1
                if gap[j] > tol:
                    raise AssertionError(f"ids differ beyond the tie class for {terms}")
    log(f"msearch_check: {fused_line}; {len(queries)} impact k=25 rows match the impact "
        f"_search (max relative {iworst:.3g}) and exact BM25 within the tie class (max score gap "
        f"{worst_gap:.3g}, {ties} positions swapped within the classes)")


def phase_msearch_cpu(state: dict) -> None:
    """msearch rows of the card against the same queries on the host, at
    k=10 (fused arm) and k=25 (impact and tiered arms)."""
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    idx = state["index"]
    pack = idx.searcher.pack
    queries = state["msearch_batches"][0]
    dense_only = [i for i, q in enumerate(queries)
                  if q and all(pack.dense_row_of("body", t) is not None for t, _ in q)]
    picks = dense_only[:4] + [i for i in range(len(queries)) if i not in dense_only[:4]][:28]
    if len(dense_only) < 4:
        raise AssertionError(f"only {len(dense_only)} dense-only queries in the batch")
    t0 = time.perf_counter()
    cpu = ShardSearcher(pack, device="cpu", mappings=idx.mappings)
    worst = 0.0
    arms = {}
    for k, results in ((10, state["msearch_results"]), (25, state["msearch_results25"])):
        v, ids, tt, _ = results[0]
        card_arm = _batch_arm(state["msearch_rows"][0 if k == 10 else 4]["arms"])
        with _held_to(card_arm):
            cv, ci, ct, _ = cpu.msearch("body", [queries[i] for i in picks], k)
        arms[k] = sorted(cpu.batched().last_stats["queries"])
        if _batch_arm(cpu.batched().last_stats["queries"]) != card_arm:
            raise AssertionError(f"k={k}: the host run took {arms[k]}, the card {card_arm}")
        for j, i in enumerate(picks):
            if ct[j] != tt[i]:
                raise AssertionError(f"k={k}: total {tt[i]} vs cpu {ct[j]} for {queries[i]}")
            fin = np.isfinite(cv[j])
            if not np.array_equal(fin, np.isfinite(v[i])):
                raise AssertionError(f"k={k}: hit count differs for {queries[i]}")
            rel = np.abs(v[i][fin] - cv[j][fin]) / np.maximum(np.abs(cv[j][fin]), 1e-30)
            worst = max(worst, float(rel.max(initial=0.0)))
            if worst > 1e-5:
                raise AssertionError(f"k={k}: scores differ by {worst} relative for {queries[i]}")
            for a, b, sa, sb in zip(ids[i][fin], ci[j][fin], v[i][fin], cv[j][fin]):
                if a != b and abs(sa - sb) > 1e-5 * max(abs(sb), 1.0):
                    raise AssertionError(f"k={k}: ids differ beyond fp-ties for {queries[i]}")
    if arms[10] != ["fused"]:
        raise AssertionError(f"the host run took arms {arms[10]} at k=10")
    log(f"msearch_cpu: {len(picks)} rows ({len(dense_only[:4])} dense-only) at k=10 (arms "
        f"{arms[10]}) and k=25 (arms {arms[25]}) match the device=cpu run (max relative score "
        f"difference {worst:.3g}) in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the impact `_search`, msearch(bf16=True) and the execution planner
# ---------------------------------------------------------------------------

PLANNER_ARMS = ("fused", "impact", "exact")


def _batch_arm(arm_counts: dict) -> str:
    """The execution planner's arm of a batch from its `last_stats`
    queries per arm: fused; impact when an impact group ran; else exact (the
    fast arm's groups: fast, tiered, dense; on shards the exact partials)."""
    if "fused" in arm_counts:
        return "fused"
    return "impact" if "impact" in arm_counts else "exact"


def _held_to(arm: str):
    """A scope in which the execution planner routes every batch to `arm`
    (the others repriced): a device="cpu" run held to the arm the card
    took."""
    from elasticsearch_tpu_torch.planner import execution_planner

    return execution_planner().reprice([a for a in PLANNER_ARMS if a != arm],
                                       reason="held to the card's arm")


def _term_nodes(node) -> list:
    from elasticsearch_tpu_torch.query.nodes import (BoolNode, ConstantScoreNode, DisMaxNode,
                                                     TermNode)

    if isinstance(node, TermNode):
        return [node]
    if isinstance(node, DisMaxNode):
        return [t for c in node.children for t in _term_nodes(c)]
    if isinstance(node, BoolNode):
        return [t for grp in (node.must, node.filter, node.should, node.must_not)
                for c in grp for t in _term_nodes(c)]
    if isinstance(node, ConstantScoreNode):
        return _term_nodes(node.child)
    return []


def _impact_bound(query, mappings, views) -> float:
    """Σ over a query's terms of the largest boost·idf·ubf/QMAX among the
    (view, pack) pairs of `views` (tiers or shards) that score the term from
    the impact tier: how far any doc's impact score lies from exact BM25."""
    from elasticsearch_tpu_torch.query.dsl import parse_query

    bound = 0.0
    for t in _term_nodes(parse_query(query, mappings)):
        key = (t.fld, t.term)
        best = 0.0
        for view, pack in views:
            params = t.prepare(view)
            if params[0] == "impact" and key in pack.term_dict:
                best = max(best, params[2] * float(pack.impact_ubf[pack.term_dict[key]])
                           / pack.impact_meta["qmax"])
        bound += best
    return bound


def _tier_views(idx) -> list:
    """(view, pack) of every shard of every tier of an EsIndex."""
    out = []
    for tr in idx.tier_searchers():
        if hasattr(tr, "_views"):
            out += list(zip(tr._views, tr.sp.shards))
        else:
            out.append((tr.view, tr.pack))
    return out


def _exact_hits(idx, query, size: int, from_: int = 0) -> dict:
    """EsIndex.search's hits on exact BM25 plans (`mark_exact`), over the
    tiers when it has tail segments: the oracle of the impact tier."""
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.query.nodes import mark_exact

    node = mark_exact(parse_query(query, idx.mappings))
    if idx._tails:
        return idx._search_tiered(node, size, from_)["hits"]
    return idx._format_generic_hits(idx._searcher.search(node, size=size, from_=from_))["hits"]


def _hit_rows(hits: dict):
    """A hits object -> (scores f64, _id strings, total)."""
    return (np.array([h["_score"] for h in hits["hits"]], np.float64),
            np.array([h["_id"] for h in hits["hits"]], object), hits["total"]["value"])


def _impact_against_exact(idx, requests, results, what: str) -> dict:
    """The requests again on exact BM25 plans, timed; each impact answer of
    `results` held to its exact answer within the impact tie class (totals
    equal; scores within 2·bound + 1e-7 + 1e-6 relative; ids swapped only
    within it). -> numbers for the report."""
    from elasticsearch_tpu_torch.ops import kernels

    views = _tier_views(idx)
    for q, size, from_ in requests[:5]:
        _exact_hits(idx, q, size, from_)
    kernels.reset_launch_counts()
    lat = {}
    exact = []
    for q, size, from_ in requests:
        t0 = time.perf_counter()
        exact.append(_exact_hits(idx, q, size, from_))
        lat.setdefault((size, from_), []).append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launch_counts)
    worst_gap, swapped, with_impact, moved = 0.0, 0, 0, 0
    for (q, size, from_), got, want in zip(requests, results, exact):
        bound = _impact_bound(q, idx.mappings, views)
        with_impact += bound > 0
        tie = 2 * bound + 1e-7
        gs, gi, gt = _hit_rows(got["hits"])
        ws, wi, wt = _hit_rows(want)
        if gt != wt:
            raise AssertionError(f"{what}: impact total {gt} vs exact {wt} for {q}")
        swapped += _rows_match(gs, gi, ws, wi, f"{what} impact vs exact {q}", tie=tie)
        if len(ws):
            worst_gap = max(worst_gap, float(np.abs(gs - ws).max()))
            moved += int((gs != ws).any())
    if with_impact < len(requests) // 2 or moved == 0:
        raise AssertionError(f"{what}: {with_impact} requests scored impact terms, "
                             f"{moved} answers differ from exact BM25")
    return {"requests": len(requests), "with_impact_terms": with_impact,
            "answers_not_exact": moved, "max_gap": worst_gap, "swapped": swapped,
            "exact_p50_ms": {f"{s},{f}": float(np.percentile(ms, 50)) for (s, f), ms in lat.items()},
            "exact_p99_ms": {f"{s},{f}": float(np.percentile(ms, 99)) for (s, f), ms in lat.items()},
            "exact_launches": launches}


def _impact_cpu_parity(idx, cpu_searcher, requests, results, what: str) -> float:
    """20 of the impact answers against the same pack searched with
    device="cpu" (the same impact plans on the host): totals equal, scores
    within 1e-6 relative, ids up to fp-ties. -> the largest relative gap."""
    worst = 0.0
    for i in range(0, len(requests), len(requests) // 20)[:20]:
        q, size, from_ = requests[i]
        want = idx._format_generic_hits(cpu_searcher.search(q, size=size, from_=from_))
        gs, gi, gt = _hit_rows(results[i]["hits"])
        ws, wi, wt = _hit_rows(want["hits"])
        if gt != wt:
            raise AssertionError(f"{what}: total {gt} vs cpu {wt} for {q}")
        _rows_match(gs, gi, ws, wi, f"{what} card vs cpu {q}", rtol=1e-6)
        if len(ws):
            worst = max(worst, float((np.abs(gs - ws) / np.abs(ws)).max()))
    return worst


def phase_impact_search(device, state: dict) -> None:
    """The traffic phase's 600 answers (the impact tier) against the same
    requests on exact BM25 plans (p50/p99 of both, the tie class), and 20
    of them against the device="cpu" run of the same pack."""
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    idx = state["index"]
    requests, results = state["requests"], state["results"]
    out = _impact_against_exact(idx, requests, results, "impact_search")
    t0 = time.perf_counter()
    cpu = ShardSearcher(idx.searcher.pack, device="cpu", mappings=idx.mappings)
    out["cpu_max_rel"] = _impact_cpu_parity(idx, cpu, requests, results, "impact_search")
    out["cpu_s"] = time.perf_counter() - t0
    del cpu
    out["impact_p50_ms"] = {f"{s},{f}": v for (s, f), v in state["traffic_p50"].items()}
    state.setdefault("impact_search", {})["1_shard"] = out
    state.setdefault("planner_launches", {})["impact_search_exact"] = out["exact_launches"]
    log(f"impact_search: {len(requests)} requests ({out['with_impact_terms']} with impact terms, "
        f"{out['answers_not_exact']} answers off exact BM25, max gap {out['max_gap']:.3g}, "
        f"{out['swapped']} positions swapped within the tie class); impact p50 "
        f"{out['impact_p50_ms']} ms against exact p50 {out['exact_p50_ms']} p99 "
        f"{out['exact_p99_ms']} ms; 20 answers equal the device=cpu run (max relative "
        f"{out['cpu_max_rel']:.3g}) in {out['cpu_s']:.1f} s")


def phase_impact_search_shards(device, state: dict) -> None:
    """Phase impact_search on the 8-shard index: the traffic requests'
    impact answers against exact plans, and 20 against the device="cpu"
    run of the same stacked pack."""
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.parallel import StackedSearcher

    idx = state["shards_index"]
    requests = state["requests"]
    kernels.reset_launch_counts()
    lat = []
    results = []
    for q, size, from_ in requests:
        t0 = time.perf_counter()
        results.append(idx.search(q, size=size, from_=from_))
        lat.append((time.perf_counter() - t0) * 1e3)
    impact_launches = dict(kernels.launch_counts)
    out = _impact_against_exact(idx, requests, results, "impact_search 8 shards")
    t0 = time.perf_counter()
    cpu = StackedSearcher(idx.searcher.sp, device="cpu")
    out["cpu_max_rel"] = _impact_cpu_parity(idx, cpu, requests, results,
                                            "impact_search 8 shards")
    out["cpu_s"] = time.perf_counter() - t0
    del cpu
    out["impact_p50_ms"] = float(np.percentile(lat, 50))
    out["impact_p99_ms"] = float(np.percentile(lat, 99))
    state.setdefault("impact_search", {})["8_shards"] = out
    state.setdefault("planner_launches", {}).update(
        impact_search_shards=impact_launches, impact_search_shards_exact=out["exact_launches"])
    log(f"impact_search 8 shards: {len(requests)} requests, impact p50 "
        f"{out['impact_p50_ms']:.3f} ms p99 {out['impact_p99_ms']:.3f} ms against exact p50 "
        f"{out['exact_p50_ms']} ({out['answers_not_exact']} answers off exact BM25, max gap "
        f"{out['max_gap']:.3g}, {out['swapped']} swapped within the tie class); 20 answers equal "
        f"the device=cpu run (max relative {out['cpu_max_rel']:.3g}) in {out['cpu_s']:.1f} s")


def phase_bf16(device, state: dict) -> None:
    """C1 k=25 msearch(bf16=True): with the impact tier resident the planner
    routes the batch to the impact arm, which ignores bf16; so also the fast
    arm (impact repriced) on the same batches, f32 and bf16 in turns (wall,
    QPS, first-pass exact share, rounds), its dense product alone (f32 GEMM
    against bf16 operands with f32 output, CUDA events over every chunk of
    the batch's sparse groups), and the proof check: 64 rows against the
    uncut bf16 fast arm (the bf16 score function's exact top k)."""
    import torch

    from elasticsearch_tpu_torch.index.pack import BLOCK
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.ops.batched import bf16_product, fetch

    idx = state["index"]
    searcher = idx.searcher
    bs = searcher.batched()
    batches = state["msearch_batches"][:2]
    k = 25
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    imp = searcher.msearch("body", batches[0], k, bf16=True)
    imp_wall = time.perf_counter() - t0
    imp_arms = dict(bs.last_stats["queries"])
    ref_rows = state["msearch_results25"][0]
    if imp_arms.get("impact", 0) == 0 or not all(np.array_equal(a, b)
                                                  for a, b in zip(imp, ref_rows)):
        raise AssertionError(f"bf16 on the impact arm: arms {imp_arms}, rows differ from f32's")
    runs = {"f32": [], "bf16": []}
    rows = {}
    with _held_to("exact"):
        for qs in batches:
            for mode in ("f32", "bf16", "bf16", "f32"):
                t0 = time.perf_counter()
                out = searcher.msearch("body", qs, k, bf16=mode == "bf16")
                wall = time.perf_counter() - t0
                st = bs.last_stats
                runs[mode].append({"wall_ms": wall * 1e3, "qps": len(qs) / wall,
                                   "first_pass_exact": float(out[3].mean()),
                                   "rounds": st["rounds"], "arms": dict(st["queries"])})
                if "impact" in st["queries"]:
                    raise AssertionError(f"the fast arm was held, arms {st['queries']}")
                rows.setdefault((mode, id(qs)), out)
    launches = dict(kernels.launch_counts)
    # the dense product alone: f32 against bf16 operands, over the chunks
    extras = bs._fast_extras(True)
    dense = searcher.dev["dense_tfn"]
    prod = {"f32": 0.0, "bf16": 0.0}
    for _, plan in bs.plan_bucketed("body", batches[0], k):
        if plan.dense_only:
            continue
        for (W,) in bs._chunks(plan.W):
            out16 = bf16_product(W, extras["dense_bf16"])
            if out16.dtype != torch.float32:
                raise AssertionError(f"the bf16 product returned {out16.dtype}")
            prod["f32"] += time_ms(lambda W=W: torch.matmul(W, dense), 3, device)
            prod["bf16"] += time_ms(lambda W=W: bf16_product(W, extras["dense_bf16"]), 3, device)
    # the proof: 64 rows of the bf16 batch against the uncut bf16 fast arm
    qs64 = batches[0][:64]
    got = rows[("bf16", id(batches[0]))]
    swapped = 0
    for idxs, plan in bs.plan_bucketed("body", qs64, k):
        if plan.dense_only:
            continue
        C = plan.sparse_rows.shape[1] * plan.sparse_rows.shape[2] * BLOCK
        uv, ui, ut, uok, udrop = fetch([bs.run_fast("body", plan, M=C, bf16=True)])[0]
        if not uok.all() or (udrop != 0).any():
            raise AssertionError("the uncut bf16 run flagged a query")
        for j, row in enumerate(idxs):
            if ut[j] < 10_000 and got[2][row] != ut[j]:
                raise AssertionError(f"bf16 total {got[2][row]} vs uncut {ut[j]}")
            swapped += _rows_match(got[0][row].astype(np.float64), got[1][row],
                                   uv[j].astype(np.float64), ui[j], f"bf16 proof row {row}",
                                   rtol=1e-5)
    summary = {m: {"wall_ms": [r["wall_ms"] for r in rr],
                   "qps": len(rr) * C1_BATCH / (sum(r["wall_ms"] for r in rr) / 1e3),
                   "first_pass_exact": float(np.mean([r["first_pass_exact"] for r in rr])),
                   "rounds": [r["rounds"] for r in rr], "arms": rr[0]["arms"]}
               for m, rr in runs.items()}
    state["bf16"] = {"impact_arm_wall_ms": imp_wall * 1e3, "impact_arm_arms": imp_arms,
                     "fast_arm": summary, "dense_product_ms": prod, "proof_rows": 64,
                     "proof_swapped": swapped, "launches": launches}
    state.setdefault("planner_launches", {})["bf16"] = launches
    log(f"bf16: k=25 C1 msearch(bf16=True) on the impact arm {imp_wall * 1e3:.1f} ms (arms "
        f"{imp_arms}, rows equal f32's); the fast arm held: " + "; ".join(
            f"{m} walls " + ", ".join(f"{w:.1f}" for w in s["wall_ms"])
            + f" ms ({s['qps']:.0f} QPS, first-pass exact {s['first_pass_exact']:.4f}, rounds "
            f"{s['rounds']})" for m, s in summary.items())
        + f"; dense product per batch f32 {prod['f32']:.3f} ms, bf16 operands with f32 output "
        f"{prod['bf16']:.3f} ms; 64 bf16 rows equal the uncut bf16 arm ({swapped} swapped among "
        f"fp-ties); launches {launches}")


def _planner_rows_check(idx, queries, out, arm: str, k: int, what: str) -> None:
    """64 rows of a batch the planner routed to `arm` against exact BM25
    per-query answers: 1e-5 relative on the exact arms, the tie class on the
    impact arm."""
    from elasticsearch_tpu_torch.ops.batched import impact_tie_class

    pack = idx.searcher.pack
    for row, terms in enumerate(queries[:64]):
        want = _exact_hits(idx, _disjunction(terms), k)
        tie = impact_tie_class(pack, "body", terms) if arm == "impact" else 0.0
        fin = np.isfinite(out[0][row])
        ws, wi, wt = _hits_arrays({"hits": want})  # 1-shard corpus ids are integers
        if wt < 10_000 and out[2][row] != wt:
            raise AssertionError(f"{what}: total {out[2][row]} vs {wt} for {terms}")
        _rows_match(out[0][row][fin].astype(np.float64), out[1][row][fin], ws, wi,
                    f"{what} {terms}", rtol=1e-5, tie=tie)


def _planner_summary(pl, decision_us: list) -> dict:
    st = pl.stats()
    return {"decisions": st["decisions"], "modes": st["decision_modes"],
            "decision_us_p50": float(np.percentile(decision_us, 50)) if decision_us else None,
            "decision_us_p99": float(np.percentile(decision_us, 99)) if decision_us else None,
            "kernels": st["kernels"], "worst_kernel": st["worst_kernel"],
            "worst_abs_residual_ema": st["worst_abs_residual_ema"], "knobs": st["knobs"]}


def _planner_events(events) -> tuple[list, dict]:
    """-> (decision µs of each choice, predicted ms per arm of the last)."""
    dec = [e for e in events if e["kind"] == "planner"]
    return [e["decision_us"] for e in dec], (dec[-1]["predicted_ms"] if dec else {})


def phase_planner(device, state: dict) -> None:
    """The execution planner on the 1-shard C1 batches: (1) cold, a batch at
    k=10 and at k=25 byte-equal to phase msearch's rows of the same batch
    (the static route), decisions static; (2) warm-up, each arm forced in
    turn by repricing the others (k=10: fused, impact, exact; k=25: impact,
    exact) on two batches; (3) warm, 4 batches at k=10 and 2 at k=25 routed
    by the model (decisions, modes, decision µs, predictions, |residual|
    EMA per kernel, wall and QPS); (4) reprice: fused and impact repriced
    routes to exact, every arm repriced to exact. The launch counts are
    read there; then 64 rows of the first warm batch of each k and of the
    repriced batch are held to exact BM25 (the oracle's own launches are
    not counted)."""
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.planner import execution_planner, reset_for_tests
    from elasticsearch_tpu_torch.telemetry import collect_profile_events

    idx = state["index"]
    searcher = idx.searcher
    bs = searcher.batched()
    batches = state["msearch_batches"]
    pl = execution_planner()
    kernels.reset_launch_counts()
    out: dict = {"before": pl.stats()["decision_modes"]}
    # (1) cold
    reset_for_tests()
    for k, ref in ((10, state["msearch_results"][0]), (25, state["msearch_results25"][0])):
        got = searcher.msearch("body", batches[0], k)
        if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"k={k}: the cold planner's rows differ from phase msearch's")
    cold = pl.stats()
    if cold["decision_modes"] != {"model": 0, "static": 2, "repriced": 0}:
        raise AssertionError(f"cold decisions {cold['decision_modes']}")
    out["cold"] = {"decisions": cold["decisions"], "modes": cold["decision_modes"]}
    # (2) warm-up
    forced = []
    for qs in batches[1:3]:
        for k, arms in ((10, PLANNER_ARMS), (25, ("impact", "exact"))):
            for arm in arms:
                with _held_to(arm):
                    t0 = time.perf_counter()
                    searcher.msearch("body", qs, k)
                    wall = time.perf_counter() - t0
                took = _batch_arm(bs.last_stats["queries"])
                if took != arm:
                    raise AssertionError(f"held to {arm}, the batch took {took}")
                forced.append({"k": k, "arm": arm, "wall_ms": wall * 1e3})
    out["warm_up"] = forced
    # (3) warm
    warm_rows = []
    decision_us = []
    predicted = {}
    checks = []  # rows held to exact BM25 after the launch counts are read
    for k, qs_list in ((10, batches[:4]), (25, batches[:2])):
        for j, qs in enumerate(qs_list):
            with collect_profile_events() as events:
                t0 = time.perf_counter()
                res = searcher.msearch("body", qs, k)
                wall = time.perf_counter() - t0
            us, pred = _planner_events(events)
            decision_us += us
            predicted[k] = pred
            arm = _batch_arm(bs.last_stats["queries"])
            warm_rows.append({"k": k, "arm": arm, "wall_ms": wall * 1e3, "qps": len(qs) / wall,
                              "predicted_ms": pred})
            if j == 0:
                checks.append((qs, res, arm, k, f"planner warm k={k} ({arm})"))
    st = pl.stats()
    if st["decision_modes"]["model"] < 6:
        raise AssertionError(f"the warm planner decided {st['decision_modes']}")
    out["warm"] = warm_rows
    # (4) reprice
    with pl.reprice(["fused", "impact"]):
        res = searcher.msearch("body", batches[0], 10)
        arms = dict(bs.last_stats["queries"])
    if _batch_arm(arms) != "exact":
        raise AssertionError(f"fused and impact repriced, arms {arms}")
    checks.append((batches[0], res, "exact", 10, "planner repriced"))
    with pl.reprice(PLANNER_ARMS):
        searcher.msearch("body", batches[0][:512], 10)
        if _batch_arm(bs.last_stats["queries"]) != "exact":
            raise AssertionError("every arm repriced: not the exact arm")
    out["launches"] = dict(kernels.launch_counts)
    out["repriced_arms"] = arms
    out["stats"] = _planner_summary(pl, decision_us)
    for check in checks:
        _planner_rows_check(idx, *check)
    state["planner"] = out
    state.setdefault("planner_launches", {})["planner"] = out["launches"]
    walls = {k: [r["wall_ms"] for r in warm_rows if r["k"] == k] for k in (10, 25)}
    log(f"planner: cold {out['cold']}, rows equal phase msearch's; warm-up "
        + ", ".join(f"k={r['k']} {r['arm']} {r['wall_ms']:.1f} ms" for r in forced)
        + "; warm " + "; ".join(
            f"k={k}: arms {[r['arm'] for r in warm_rows if r['k'] == k]}, walls "
            + ", ".join(f"{w:.1f}" for w in walls[k])
            + f" ms ({len(walls[k]) * C1_BATCH / (sum(walls[k]) / 1e3):.0f} QPS), predicted "
            f"{predicted[k]} ms" for k in (10, 25))
        + f"; decisions {out['stats']['decisions']}, modes {out['stats']['modes']}, decision "
        f"p50 {out['stats']['decision_us_p50']:.1f} us p99 {out['stats']['decision_us_p99']:.1f} "
        f"us; kernels {out['stats']['kernels']}; fused and impact repriced -> arms {arms}; "
        f"launches {out['launches']}")


def _c5_planner(device, state: dict, ss, batches) -> dict:
    """The execution planner at site sharded.msearch_partials on C5: each
    arm forced in turn (k=10: fused, impact, exact; k=25: impact, exact),
    then 2 batches at each k routed by the model."""
    from elasticsearch_tpu_torch.parallel import msearch_sharded
    from elasticsearch_tpu_torch.planner import execution_planner
    from elasticsearch_tpu_torch.telemetry import collect_profile_events

    pl = execution_planner()
    before = {k: v for k, v in pl.stats()["kernels"].items() if k.startswith("sharded.")}
    forced = []
    for k, arms in ((10, PLANNER_ARMS), (25, ("impact", "exact"))):
        for arm in arms:
            with _held_to(arm):
                t0 = time.perf_counter()
                msearch_sharded(ss, "body", batches[0], k)
                wall = time.perf_counter() - t0
            took = _batch_arm(ss.last_stats["queries"])
            if took != arm:
                raise AssertionError(f"C5 held to {arm}, the batch took {took}")
            forced.append({"k": k, "arm": arm, "wall_ms": wall * 1e3})
    warm, decision_us = [], []
    for k in (10, 25):
        for qs in batches[:2]:
            with collect_profile_events() as events:
                t0 = time.perf_counter()
                v, sh, dc, tt = msearch_sharded(ss, "body", qs, k)
                wall = time.perf_counter() - t0
            us, pred = _planner_events(events)
            decision_us += us
            _check_msearch_rows(v, dc, tt, k, f"C5 warm k={k}")
            warm.append({"k": k, "arm": _batch_arm(ss.last_stats["queries"]),
                         "wall_ms": wall * 1e3, "qps": len(qs) / wall, "predicted_ms": pred})
    st = _planner_summary(pl, decision_us)
    st["kernels"] = {k: v for k, v in st["kernels"].items() if k.startswith("sharded.")}
    out = {"kernels_before": before, "warm_up": forced, "warm": warm, "stats": st}
    log("planner c5: warm-up " + ", ".join(f"k={r['k']} {r['arm']} {r['wall_ms']:.1f} ms"
                                           for r in forced)
        + "; warm " + ", ".join(f"k={r['k']} {r['arm']} {r['wall_ms']:.1f} ms (predicted "
                                f"{r['predicted_ms']})" for r in warm)
        + f"; sharded kernels {st['kernels']}; decision p50 {st['decision_us_p50']:.1f} us")
    return out


def phase_planner_knn(device, state: dict) -> None:
    """advise_nprobe on the kNN EsIndex: with planner.knn.target_ms set (the
    cluster setting) and ann.gather_scan's efficiency EMA warm from the C4
    batches, KnnNode.prepare takes the largest nprobe whose predicted scan
    meets the target. Two targets (the predictions at 4x the default
    nprobe and at nprobe 1): the advised nprobe, the p50 of 64 near-data
    `_search`es and their recall@10 against the exact scan, beside the
    default nprobe's."""
    import torch

    from elasticsearch_tpu_torch.ann.search import default_nprobe
    from elasticsearch_tpu_torch.planner import execution_planner
    from elasticsearch_tpu_torch.telemetry import collect_profile_events

    idx = state["knn_index"]
    eng = _engine(state, device)
    pl = execution_planner()
    if "ann.gather_scan" not in pl.stats()["kernels"]:
        raise AssertionError("no ann.gather_scan observation: run phase knn first")
    vc = idx.searcher.pack.vectors["vec"]
    C, L = int(vc.ann["nlist"]), int(vc.ann["tile"])
    default = max(1, min(default_nprobe(C, L, KNN_NC), C))
    fields = {"queries": 1, "dims": int(vc.dims), "tile": L, "scan_tier": vc.ann_quant}
    qs = state["knn_index_near"][:64]
    dev = idx.searcher.dev
    vecs = dev["vec"]["vec"]
    unit = vecs / vecs.norm(dim=1, keepdim=True).clamp_min(1e-30)
    exact_ids = []
    for q in qs:
        qt = torch.from_numpy(np.asarray(q, np.float32)).to(vecs.device)
        s = unit @ (qt / qt.norm())
        exact_ids.append({idx.shard_docs[0][d][0] for d in torch.topk(s, 10).indices.tolist()})

    def run(target_ms: float) -> dict:
        eng.settings.update({"transient": {"planner.knn.target_ms": target_ms}})
        lat, recall, nprobes = [], [], set()
        for q, want in zip(qs, exact_ids):
            with collect_profile_events() as events:
                t0 = time.perf_counter()
                res = idx.search(knn=_knn_body(q), size=10)
                lat.append((time.perf_counter() - t0) * 1e3)
            nprobes |= {e["nprobe"] for e in events if e["kind"] == "tier" and "nprobe" in e}
            got = {h["_id"] for h in res["hits"]["hits"]}
            recall.append(len(got & want) / 10)
        return {"target_ms": target_ms, "nprobe": sorted(nprobes),
                "p50_ms": float(np.percentile(lat, 50)), "recall_at_10": float(np.mean(recall))}

    from elasticsearch_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    try:
        rows = [run(0.0)]
        wide = min(C, 4 * default)
        for n in (wide, 1):
            rows.append(run(pl.predict_ms("ann.gather_scan", {**fields, "nprobe": n})))
    finally:
        eng.settings.update({"transient": {"planner.knn.target_ms": None}})
    launches = dict(kernels.launch_counts)
    if rows[0]["nprobe"] != [default] or rows[1]["nprobe"] != [wide] or rows[2]["nprobe"] != [1]:
        raise AssertionError(f"advised nprobes {[r['nprobe'] for r in rows]}, default {default}")
    if launches["ann_gather_scan"] != 3 * len(qs):
        raise AssertionError(f"ann_gather_scan launched {launches['ann_gather_scan']} times for "
                             f"{3 * len(qs)} searches")
    state.setdefault("planner_launches", {})["planner_knn"] = launches
    state["planner_knn"] = {"nlist": C, "tile": L, "default_nprobe": default, "runs": rows,
                            "efficiency_ema": pl.stats()["kernels"]["ann.gather_scan"]}
    log(f"planner knn: nlist {C}, L {L}, default nprobe {default}; " + "; ".join(
        f"target {r['target_ms']:.4g} ms -> nprobe {r['nprobe']}, p50 {r['p50_ms']:.3f} ms, "
        f"recall@10 {r['recall_at_10']:.4f}" for r in rows)
        + f"; ann.gather_scan {state['planner_knn']['efficiency_ema']}")


KNN_BATCH = 1024  # queries per C4 batch (bench.py config C4)
KNN_K, KNN_NC = 10, 100  # C4's k and num_candidates
KNN_VECTORS = 1_000_000  # C4's ANN corpus
KNN_DOCS = 50_000  # documents of the kNN EsIndex


def _synthetic_ann(gen, device, C: int, L: int, D: int, n_docs: int):
    """ANN tiles of random content on the card: about 1/8 pad slots at the
    tile ends, and in every tile the rows of slots 1-4 copied onto slots
    5-8 (the same codes, halves, norms and scale/offset: exactly tied
    scores under distinct docids)."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import split_bf16

    vals = torch.randn((C, L, D), generator=gen, device=device)
    vals[:, 5:9] = vals[:, 1:5]
    hi, lo = split_bf16(vals)
    codes = torch.randint(-127, 128, (C, L, D), generator=gen, device=device).to(torch.int8)
    codes[:, 5:9] = codes[:, 1:5]
    scale = torch.rand((C, L), generator=gen, device=device) * 0.05
    offset = torch.randn((C, L), generator=gen, device=device) * 0.1
    sq = (vals * vals).sum(-1)
    for t in (scale, offset, sq):
        t[:, 5:9] = t[:, 1:5]
    order = torch.randperm(C * L, generator=gen, device=device).remainder(n_docs).to(torch.int32)
    order = order.view(C, L)
    fill = torch.randint(L - L // 4, L + 1, (C, 1), generator=gen, device=device)
    order = torch.where(torch.arange(L, device=device)[None, :] < fill, order,
                        torch.full_like(order, -1))
    cents = torch.randn((C, D), generator=gen, device=device)
    return {"centroids": cents, "order": order.contiguous(), "codes": codes, "scale": scale,
            "offset": offset, "hi": hi, "lo": lo, "sq": sq}


def _ann_library(q, probes, dev, live_slots, kb: int, similarity: str):
    """The PyTorch composition of the scan (no single call computes it), in
    query steps that keep the gathered f32 tiles under 2 GB: the tiles
    indexed by probes, a batched f32 product, the transform and masks,
    torch.topk."""
    import torch

    from elasticsearch_tpu_torch.ann.kernels import query_aux, slot_aux
    from elasticsearch_tpu_torch.ops.kernels import _apply_transform

    B, P = probes.shape
    C, L, D = dev["codes"].shape
    auxd, auxq = slot_aux(dev["sq"], similarity), query_aux(q, similarity)
    step = max(1, (2 << 30) // (P * L * D * 4))
    out = []
    for s in range(0, B, step):
        pl, qc = probes[s: s + step].long(), q[s: s + step]
        b = pl.shape[0]
        dots = torch.bmm(dev["codes"][pl].flatten(1, 2).float(), qc[:, :, None])[:, :, 0]
        dots = (dev["scale"][pl].reshape(b, -1) * dots
                + dev["offset"][pl].reshape(b, -1) * qc.sum(1, keepdim=True))
        sc = _apply_transform(dots, similarity, auxd[pl].reshape(b, -1), auxq[s: s + step, None])
        ok = (dev["order"][pl] >= 0).reshape(b, -1) & (live_slots[pl].reshape(b, -1) != 0)
        out.append(torch.topk(torch.where(ok, sc, float("-inf")), kb, dim=1))
    return out


def _ann_bounds(dev, probes, kb: int) -> dict:
    """The least work of one ann_gather_scan over `probes`, counted on this
    run's tiles: each distinct probed tile read once, a pad slot (order < 0)
    by its 4-byte order entry alone, a real slot by its codes (int8: D
    bytes; bf16: hi and lo, 4D), its order, norm (and int8: scale, offset)
    at 4 bytes each and its live byte; the queries (4D + 8 bytes each) and
    probes read, the outputs written. Operations: 2D per real slot of each
    (query, probe) for int8, 4D for bf16 (two products), at the card's f32
    rate. -> {"int8"|"bf16": (bound_ms, bound_by)}, the reference cost
    model's bound ("costmodel": slots (D+8) + 12 slots + 4BD bytes with
    slots = B P L, pads and repeated tiles included) and the real share of
    the probed slots."""
    import torch

    B, P = probes.shape
    C, L, D = dev["codes"].shape
    real = (dev["order"] >= 0).sum(1)
    tiles = torch.unique(probes.long())
    n_real = int(real[tiles].sum())
    n_pad = tiles.numel() * L - n_real
    pair_real = int(real[probes.long()].sum())
    io = B * (4 * D + 8) + 4 * B * P + B * (8 * kb + 4)
    out = {}
    for tier, per_slot, ops_per_dim in (("int8", D + 17, 2), ("bf16", 4 * D + 9, 4)):
        bytes_ms = (n_real * per_slot + 4 * n_pad + io) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_per_dim * D * pair_real / 67e12 * 1e3
        out[tier] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")
    slots = B * P * L
    out["costmodel"] = {"int8": (slots * (D + 8) + 12 * slots + 4 * B * D) / HBM_BYTES_PER_S * 1e3,
                        "bf16": (4 * D * slots + 12 * slots + 4 * B * D) / HBM_BYTES_PER_S * 1e3}
    out["real_share"] = pair_real / slots
    out["distinct_tiles"] = tiles.numel()
    return out


def phase_knn_kernels(device, rng, state: dict) -> None:
    """ann_gather_scan against its twin: the C4 batch (B=1024, P=2, D=384,
    kb=100, on the knn_index build's tiles, or synthetic tiles of L=1536
    when run alone) for both tiers and every transform, with kb = 1 and 128
    too; the `_search` shape on the knn_index EsIndex's own tiles (B=1, the
    probes and kcand of KnnNode.prepare, 8 requests); the `_search` shape
    on synthetic tiles (B=1, P=2, L=512, kb=100) and an L above 4,096, with
    pad slots, dead docs and exactly tied scores."""
    import torch

    from elasticsearch_tpu_torch.ann.kernels import (
        ann_gather_scan, ann_gather_scan_reference, centroid_topk, slot_live)
    from elasticsearch_tpu_torch.ops.kernels import TRANSFORMS
    from elasticsearch_tpu_torch.query.dsl import parse_knn

    gen = torch.Generator(device=device).manual_seed(4)
    B, P, D, kb = KNN_BATCH, 2, 384, KNN_NC
    searcher = state.get("ann_searcher")
    if searcher is not None:
        dev, live_slots = searcher.dev, searcher._slot_live()
        q = torch.randn((B, D), generator=gen, device=device)
        probes = centroid_topk(dev["centroids"], q, nprobe=P)
        c4_src = f"the knn_index build, C={dev['order'].shape[0]}"
    else:
        dev = _synthetic_ann(gen, device, 750, 1536, D, 1_000_000)
        live_slots = (torch.rand(dev["order"].shape, generator=gen, device=device) > 0.05
                      ).to(torch.uint8)
        q = torch.randn((B, D), generator=gen, device=device)
        probes = torch.randint(0, 750, (B, P), generator=gen, device=device).to(torch.int32)
        c4_src = "synthetic tiles, C=750"
    L = dev["order"].shape[1]
    err, checks = 0.0, 0

    def check(qq, pp, d, ls, k, tier, sim, what):
        nonlocal err, checks
        err = max(err, compare(ann_gather_scan(qq, pp, d, ls, k, tier=tier, similarity=sim),
                               ann_gather_scan_reference(qq, pp, d, ls, k, tier=tier,
                                                         similarity=sim), what))
        checks += 1

    for tier in ("int8", "bf16"):
        for sim in TRANSFORMS:
            check(q, probes, dev, live_slots, kb, tier, sim, f"C4 {tier} {sim}")
        for k in (1, 128):
            check(q, probes, dev, live_slots, k, tier, "cosine", f"C4 {tier} kb={k}")
    for C_, L_, B_, P_, what in ((316, 512, 1, 2, "_search"), (6, 4096 + 640, 16, 3, "L>4096")):
        d = _synthetic_ann(gen, device, C_, L_, D, 100_000)
        ls = (torch.rand((C_, L_), generator=gen, device=device) > 0.1).to(torch.uint8)
        qq = torch.randn((B_, D), generator=gen, device=device)
        pp = torch.stack([torch.randperm(C_, generator=gen, device=device)[:P_]
                          for _ in range(B_)]).to(torch.int32)
        for tier in ("int8", "bf16"):
            for sim in TRANSFORMS:
                for k in (1, 100, 128):
                    check(qq, pp, d, ls, k, tier, sim, f"{what} {tier} {sim} kb={k}")
        if what == "_search":
            search_ms = time_ms(lambda: ann_gather_scan(qq, pp, d, ls, kb), 200, device)
            search_bound = _ann_bounds(d, pp, kb)["int8"]
            search_shape = f"B=1 P=2 L=512 kb={kb} int8 cosine (synthetic tiles)"
            synthetic = {
                "shape": search_shape, "ms": search_ms, "bound_ms": search_bound[0],
                "bound_by": search_bound[1],
                "plain_ms": time_ms(lambda: ann_gather_scan_reference(qq, pp, d, ls, kb), 20,
                                    device),
                "library_ms": time_ms(lambda: _ann_library(qq, pp, d, ls, kb, "cosine"), 200,
                                      device),
                "previous_ms": PREVIOUS_MS["ann_gather_scan synthetic search"]}
            search_plain, search_lib = synthetic["plain_ms"], synthetic["library_ms"]
        del d
    idx = state.get("knn_index")
    if idx is not None:  # the tiles and probes that `_search` scans
        ann_dev = idx.searcher.dev["vec_ann"]["vec"]
        ls = slot_live(ann_dev["order"], idx.searcher.dev["live"])
        for qv in state["knn_index_near"][:8]:
            node = parse_knn(_knn_body(qv), idx.mappings)
            qv32 = node.prepare(idx.searcher.pack)[0]
            nprobe, kcand, itier = node._ann
            qq = torch.from_numpy(qv32)[None].to(device)
            pp = centroid_topk(ann_dev["centroids"], qq, nprobe=nprobe)
            for tier in ("int8", "bf16"):
                for sim in TRANSFORMS:
                    check(qq, pp, ann_dev, ls, kcand, tier, sim, f"knn_index {tier} {sim}")
        search_ms = time_ms(lambda: ann_gather_scan(qq, pp, ann_dev, ls, kcand, tier=itier), 200,
                            device)
        search_plain = time_ms(lambda: ann_gather_scan_reference(qq, pp, ann_dev, ls, kcand,
                                                                 tier=itier), 20, device)
        search_lib = (time_ms(lambda: _ann_library(qq, pp, ann_dev, ls, kcand, "cosine"), 200,
                              device) if itier == "int8" else None)
        search_bound = _ann_bounds(ann_dev, pp, kcand)[itier]
        search_shape = (f"B=1 P={nprobe} L={ann_dev['order'].shape[1]} kb={kcand} {itier} "
                        f"cosine (the knn_index EsIndex's tiles)")
    t_int8 = time_ms(lambda: ann_gather_scan(q, probes, dev, live_slots, kb), 20, device)
    t_bf16 = time_ms(lambda: ann_gather_scan(q, probes, dev, live_slots, kb, tier="bf16"), 10,
                     device)
    t_plain = time_ms(lambda: ann_gather_scan_reference(q, probes, dev, live_slots, kb), 2, device)
    t_lib = time_ms(lambda: _ann_library(q, probes, dev, live_slots, kb, "cosine"), 5, device)
    bounds = _ann_bounds(dev, probes, kb)
    state["ann"] = {
        "ms": t_int8, "plain_ms": t_plain, "library_ms": t_lib,
        "bound_ms": bounds["int8"][0], "bound_by": bounds["int8"][1],
        "costmodel_bound_ms": bounds["costmodel"]["int8"],
        "max_abs_err": err,
        "shape": f"B={B} P={P} L={L} D={D} kb={kb} int8 cosine ({c4_src})",
        "real_slot_share": bounds["real_share"], "distinct_tiles": bounds["distinct_tiles"],
        "bf16_ms": t_bf16, "bf16_bound_ms": bounds["bf16"][0],
        "bf16_costmodel_bound_ms": bounds["costmodel"]["bf16"],
        "search_shape": search_shape, "search_shape_ms": search_ms,
        "search_shape_bound_ms": search_bound[0], "search_shape_bound_by": search_bound[1],
        "search_shape_plain_ms": search_plain, "search_shape_library_ms": search_lib,
        "synthetic_search": synthetic,
        "previous_ms": PREVIOUS_MS["ann_gather_scan"],
        "previous_bf16_ms": PREVIOUS_MS["ann_gather_scan bf16"],
        "previous_search_shape_ms": PREVIOUS_MS["ann_gather_scan search"],
    }
    if searcher is None:
        del dev
    sync(device)
    a = state["ann"]
    log(f"knn_kernels: ann_gather_scan {checks} checks equal to its twin; {a['shape']}: "
        f"{a['ms']:.4f} ms (twin {a['plain_ms']:.1f} ms, gather + bmm + topk {a['library_ms']:.3f} ms, "
        f"bound {a['bound_ms']:.4f} ms, {a['bound_by']}, over {a['distinct_tiles']} distinct tiles "
        f"with {100 * a['real_slot_share']:.1f}% of the probed slots real; the cost model's count "
        f"{a['costmodel_bound_ms']:.4f} ms); bf16 {t_bf16:.4f} ms (bound {a['bf16_bound_ms']:.4f} ms, "
        f"cost model {a['bf16_costmodel_bound_ms']:.4f} ms); {search_shape}: {search_ms:.4f} ms "
        f"(bound {search_bound[0]:.5f} ms, {search_bound[1]}; twin {search_plain:.4f} ms, "
        f"library {'none' if search_lib is None else f'{search_lib:.4f} ms'}); "
        f"{synthetic['shape']}: {synthetic['ms']:.4f} ms (bound {synthetic['bound_ms']:.5f} ms, "
        f"{synthetic['bound_by']}; twin {synthetic['plain_ms']:.4f} ms, library "
        f"{synthetic['library_ms']:.4f} ms)")
    log(f"knn_kernels: ann_gather_scan's previous design (per (query, probe, chunk) blocks), "
        f"PERF.md's table: C4 int8 {a['previous_ms']} ms, bf16 {a['previous_bf16_ms']} ms, the "
        f"`_search` shape {a['previous_search_shape_ms']} ms, synthetic "
        f"{synthetic['previous_ms']} ms; "
        f"this run: {a['ms']:.4f}, {a['bf16_ms']:.4f}, {search_ms:.4f}, {synthetic['ms']:.4f} ms")
    log("ann: " + json.dumps(a))


def _on_card(device) -> int:
    import torch

    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def phase_knn_index(device, rng, n_vec: int, n_docs: int, state: dict) -> None:
    """(a) bench.py C4's ANN corpus (n_vec x 384 clustered, nlist =
    0.75 sqrt(n)) through build_ann (k-means and tile packing on the card)
    twice, the builds byte-equal, and AnnSearcher(..., "cosine"); (b) n_docs
    documents through EsIndex.index_doc / refresh with an int8_hnsw vector
    field and a long field. The 1M-vector corpus does not go through
    index_doc: each document keeps a JSON snapshot and a parsed copy of 384
    Python floats (~25 KB), so 1M documents would need ~25 GB of host RAM."""
    from elasticsearch_tpu_torch.ann import AnnSearcher, build_ann
    from elasticsearch_tpu_torch.corpus import N_MAX, doc_texts, make_corpus, vector_corpus

    _drop_index(state, "corpus", "index", device)  # the text phases are done
    D = 384
    nlist = max(16, int(n_vec ** 0.5 * 0.75))
    t0 = time.perf_counter()
    vecs, near = vector_corpus(rng, n_vec, D, nlist, 64)
    t_gen = time.perf_counter() - t0
    times = [{}, {}]
    ann = build_ann(vecs, np.ones(n_vec, bool), nlist, device=device, timings=times[0])
    again = build_ann(vecs, np.ones(n_vec, bool), nlist, device=device, timings=times[1])
    for key in ("centroids", "order", "codes", "scale", "offset", "tile", "nlist"):
        a, b = ann[key], again[key]
        if not (np.array_equal(a, b) and np.asarray(a).tobytes() == np.asarray(b).tobytes()):
            raise AssertionError(f"two builds of the same corpus differ in [{key}]")
    del again
    before = _on_card(device)
    t1 = time.perf_counter()
    searcher = AnnSearcher(ann, vecs, (vecs * vecs).sum(1), "cosine", device=device)
    sync(device)
    t_up = time.perf_counter() - t1
    state.update(ann_searcher=searcher, ann_host=ann, knn_vecs=vecs, knn_near=near)
    state["knn_build"] = {"kmeans_s": [t["kmeans_s"] for t in times],
                          "tiles_s": [t["tiles_s"] for t in times], "upload_s": t_up,
                          "L": ann["tile"], "nlist": ann["nlist"],
                          "bytes_on_card": _on_card(device) - before}
    kb_ = state["knn_build"]
    log(f"knn_index: {n_vec} x {D} clustered, nlist {ann['nlist']}, L {ann['tile']}; generate "
        f"{t_gen:.1f} s; k-means {kb_['kmeans_s'][0]:.2f} / {kb_['kmeans_s'][1]:.2f} s, tiles "
        f"{kb_['tiles_s'][0]:.2f} / {kb_['tiles_s'][1]:.2f} s (two builds, byte-equal); upload "
        f"{t_up:.2f} s, {kb_['bytes_on_card']} bytes on the card")

    ncl = max(16, int(n_docs ** 0.5 * 0.75))
    dvecs, dnear = vector_corpus(rng, n_docs, D, ncl, 200)
    nums = rng.integers(0, N_MAX, size=n_docs)
    lens, tok, _ = make_corpus(rng, n_docs)  # a C1 text per doc, for the hybrid
    texts = doc_texts(lens, tok)
    mapping = _knn_mapping(D)
    idx = _engine(state, device).create_index("vectors", mapping)
    t2 = time.perf_counter()
    rows = dvecs.tolist()
    for i in range(n_docs):
        idx.index_doc(str(i), {"vec": rows[i], "n": int(nums[i]), "body": texts[i]})
    del rows, texts
    t3 = time.perf_counter()
    idx.refresh()
    sync(device)
    t4 = time.perf_counter()
    vc = idx.searcher.pack.vectors["vec"]
    if vc.ann is None:
        raise AssertionError("the int8_hnsw field built no ANN index")
    state.update(knn_index=idx, knn_index_near=dnear, knn_index_vecs=dvecs,
                 knn_index_text=(lens, tok))
    state["knn_build"].update(index_doc_s=t3 - t2, refresh_s=t4 - t3,
                              index_nlist=vc.ann["nlist"], index_L=vc.ann["tile"])
    log(f"knn_index: {n_docs} docs through EsIndex ({ncl} generator clusters): index_doc "
        f"{t3 - t2:.1f} s, refresh {t4 - t3:.1f} s (nlist {vc.ann['nlist']}, L {vc.ann['tile']}), "
        f"{idx.searcher.pack.nbytes()} pack bytes")


def _knn_mapping(D: int) -> dict:
    """The kNN indices' mapping: C4's vectors on the int8 ANN tier, a long,
    a C1 text and a keyword that only some docs hold."""
    return {"properties": {
        "vec": {"type": "dense_vector", "dims": D, "similarity": "cosine",
                "index_options": {"type": "int8_hnsw"}},
        "n": {"type": "long"}, "body": {"type": "text"}, "tag": {"type": "keyword"}}}


def _knn_body(q, filt=None, **extra) -> dict:
    body = {"field": "vec", "query_vector": [float(x) for x in q], "k": KNN_K,
            "num_candidates": KNN_NC, **extra}
    if filt is not None:
        body["filter"] = filt
    return body


def phase_knn(device, rng, state: dict) -> None:
    """C4 ANN batches (int8 and bf16) with recall@10 and the full-probe
    exactness check, C4's exact arm (TieredKnnScanner), and 200 kNN
    `_search` requests on the EsIndex, each path between resets of the
    launch counts."""
    import gc

    import torch

    from elasticsearch_tpu_torch.ann.search import check_ann_rows
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.ops.vector import TieredKnnScanner

    searcher = state["ann_searcher"]
    vecs = state["knn_vecs"]
    n, D = vecs.shape
    searcher.search(rng.standard_normal((KNN_BATCH, D)).astype(np.float32), KNN_K,
                    num_candidates=KNN_NC)  # warm-up
    sync(device)
    rows = {}
    kernels.reset_launch_counts()
    for tier, nb in (("int8", 4), ("bf16", 2)):
        walls = []
        for _ in range(nb):
            q = rng.standard_normal((KNN_BATCH, D)).astype(np.float32)
            before = kernels.launch_counts["ann_gather_scan"]
            t0 = time.perf_counter()
            v, i, t = searcher.search(q, KNN_K, num_candidates=KNN_NC, tier=tier)
            walls.append((time.perf_counter() - t0) * 1e3)
            if kernels.launch_counts["ann_gather_scan"] - before != 1:
                raise AssertionError("ann_gather_scan did not launch once per C4 batch")
            if v.shape != (KNN_BATCH, KNN_K) or not np.isfinite(v).all():
                raise AssertionError("malformed C4 ANN rows")
        rows[tier] = walls
    batch_launches = dict(kernels.launch_counts)

    def profiled_batch():
        searcher.search(q, KNN_K, num_candidates=KNN_NC)
        sync(device)

    prof = None
    if device.type == "cuda":
        wall_us, ops = _profiled(profiled_batch)
        busy_us = sum(us for _, us in ops)
        prof = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                "ann_gather_scan_ms": _kernel_us(ops)["ann_gather_scan"] / 1e3,
                "top_ops": [(k[:80], us / 1e3) for k, us in ops[:6]]}

    # recall@10 of near-data queries against the exact scan_topk matmul scan
    near = state["knn_near"]
    qn = torch.from_numpy(near).to(device)
    mat_t = searcher.vectors.T.contiguous()
    aux_doc = 1.0 / torch.clamp(torch.sqrt(searcher.sq_norms), min=1e-30)
    aux_q = 1.0 / torch.clamp(torch.sqrt((qn * qn).sum(1)), min=1e-30)
    ev, ei, _ = kernels.scan_topk(qn, mat_t, searcher.live, KNN_K, transform="cosine",
                                  aux_doc=aux_doc, aux_q=aux_q, count_positive=False)
    ev, ei = ev.cpu().numpy(), ei.cpu().numpy()
    del mat_t
    recall = {}
    for tier in ("int8", "bf16"):
        _, ai, _ = searcher.search(near, KNN_K, num_candidates=KNN_NC, tier=tier)
        recall[tier] = float(np.mean([len(set(ai[b]) & set(ei[b])) / KNN_K
                                      for b in range(len(near))]))
    if recall["int8"] < 0.9:
        raise AssertionError(f"recall@10 {recall['int8']} below 0.9")
    # nprobe = nlist on both tiers, held to the exact scan by each tier's
    # stated selection error (the int8 tier's quantisation, the bf16 tier's
    # query cut to bf16): a true neighbour may be missing only where its
    # exact score minus that bound does not clear the kb-th selection score
    full_probe = {}
    for tier in ("int8", "bf16"):
        fv, fi, _ = searcher.search(near, KNN_K, num_candidates=KNN_NC, nprobe=searcher.nlist,
                                    tier=tier)
        sel_v, _, _ = searcher.selection(qn, KNN_K, nprobe=searcher.nlist,
                                         num_candidates=KNN_NC, tier=tier)
        bound = searcher.selection_bound(qn, torch.from_numpy(ei).to(device), tier=tier)
        dropped, swapped = check_ann_rows((fv, fi), (ev, ei), sel_v[:, -1].cpu().numpy(), bound,
                                          f"nprobe = nlist {tier} vs the exact scan")
        full_probe[tier] = {"dropped": dropped, "swapped": swapped,
                            "bound_max": float(bound.max())}
    del qn

    # C4's default exact arm: TieredKnnScanner on a standard-normal corpus
    corpus = rng.standard_normal((n, D)).astype(np.float32)
    scanner = TieredKnnScanner(corpus, (corpus * corpus).sum(1), "cosine", device=device)
    del corpus
    scanner.search(rng.standard_normal((KNN_BATCH, D)).astype(np.float32), KNN_K)
    sync(device)
    kernels.reset_launch_counts()
    exact_walls, flags = [], []
    for _ in range(2):
        q = rng.standard_normal((KNN_BATCH, D)).astype(np.float32)
        t0 = time.perf_counter()
        v, i, t, first = scanner.search(q, KNN_K)
        exact_walls.append((time.perf_counter() - t0) * 1e3)
        flags.append(float(1.0 - first.mean()))
        if not np.isfinite(v).all():
            raise AssertionError("malformed exact-arm rows")
    exact_launches = dict(kernels.launch_counts)
    if exact_launches["tiered_candidates"] != 2:
        raise AssertionError(f"tiered_candidates launched {exact_launches['tiered_candidates']} times")
    exact_prof = None
    if device.type == "cuda":
        # one more exact-arm batch under the profiler: the split between the
        # selection (tiered_candidates) and the flagged queries' reruns
        qp = rng.standard_normal((KNN_BATCH, D)).astype(np.float32)

        def exact_batch():
            scanner.search(qp, KNN_K)
            sync(device)

        wall_us, ops = _profiled(exact_batch)
        busy_us = sum(us for _, us in ops)
        per_kernel = _kernel_us(ops)
        exact_prof = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                      "tiered_candidates_ms": per_kernel["tiered_candidates"] / 1e3,
                      "scan_topk_ms": per_kernel["scan_topk"] / 1e3,
                      "top_ops": [(k[:80], us / 1e3) for k, us in ops[:6]]}
    del scanner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 200 kNN `_search` requests, 50 with a range filter (kcand 400: kb > 128)
    idx = state["knn_index"]
    qs = state["knn_index_near"]
    bodies = []
    for j, q in enumerate(qs[:200]):
        lo = int(rng.integers(0, 600_000))
        filt = {"range": {"n": {"gte": lo, "lt": lo + 400_000}}} if j % 4 == 3 else None
        bodies.append(_knn_body(q, filt))
    requests = [(b, 10, 0) for b in bodies] + [(b, 5, 5) for b in bodies]
    for b, size, from_ in requests[:5]:
        idx.search(knn=b, size=size, from_=from_)
    kernels.reset_launch_counts()
    lat = {(10, 0): [], (5, 5): []}
    results = []
    for b, size, from_ in requests:
        t0 = time.perf_counter()
        out = idx.search(knn=b, size=size, from_=from_)
        lat[(size, from_)].append((time.perf_counter() - t0) * 1e3)
        results.append(out)
    search_launches = dict(kernels.launch_counts)
    unfiltered = sum(1 for b, _, _ in requests if "filter" not in b)
    if search_launches["ann_gather_scan"] != unfiltered:
        raise AssertionError(f"ann_gather_scan launched {search_launches['ann_gather_scan']} "
                             f"times for {unfiltered} unfiltered requests")
    if search_launches["scan_topk"] < len(requests):
        raise AssertionError(f"scan_topk launched {search_launches['scan_topk']} times for "
                             f"{len(requests)} requests")
    for (b, size, from_), out in zip(requests, results):
        hits = out["hits"]["hits"]
        sc = [h["_score"] for h in hits]
        if (len(hits) != min(size, KNN_K - from_) or sc != sorted(sc, reverse=True)
                or out["hits"]["total"]["value"] != KNN_K):
            raise AssertionError(f"malformed kNN hits for request {b.get('filter')}")
    state.update(knn_requests=requests, knn_results=results)
    state["knn"] = {
        "c4_ann_walls_ms": rows, "c4_ann_qps": {t: len(w) * KNN_BATCH / (sum(w) / 1e3)
                                                for t, w in rows.items()},
        "c4_launches": batch_launches, "recall_at_10": recall, "profile": prof,
        "nprobe_all": full_probe,
        "exact_walls_ms": exact_walls, "exact_qps": 2 * KNN_BATCH / (sum(exact_walls) / 1e3),
        "exact_flag_rate": flags, "exact_launches": exact_launches,
        "exact_profile": exact_prof,
        "search_p50_ms": {f"size={s} from={f}": float(np.percentile(v, 50))
                          for (s, f), v in lat.items()},
        "search_p99_ms": {f"size={s} from={f}": float(np.percentile(v, 99))
                          for (s, f), v in lat.items()},
        "search_launches": search_launches,
    }
    k = state["knn"]
    log(f"knn: C4 ANN batches of {KNN_BATCH}: int8 " + ", ".join(f"{w:.1f}" for w in rows["int8"])
        + f" ms ({k['c4_ann_qps']['int8']:.0f} QPS), bf16 "
        + ", ".join(f"{w:.1f}" for w in rows["bf16"]) + f" ms ({k['c4_ann_qps']['bf16']:.0f} QPS); "
        f"launches {batch_launches['ann_gather_scan']} for 6 batches; recall@10 int8 "
        f"{recall['int8']:.4f} bf16 {recall['bf16']:.4f}; nprobe = nlist rows hold the exact "
        f"scan's within each tier's selection bound: " + ", ".join(
            f"{t} {v['dropped']} neighbours dropped within the bound (largest bound "
            f"{v['bound_max']:.3g}), {v['swapped']} swapped among fp-ties"
            for t, v in full_probe.items()))
    if prof is not None:
        log(f"knn: one profiled int8 C4 batch: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms ({100 * prof['device_busy_ms'] / prof['wall_ms']:.1f}%), "
            f"ann_gather_scan {prof['ann_gather_scan_ms']:.3f} ms; top ops {prof['top_ops']}")
    log(f"knn: C4 exact arm (TieredKnnScanner, {n} x {D} standard normal): "
        + ", ".join(f"{w:.1f}" for w in exact_walls) + f" ms ({k['exact_qps']:.0f} QPS), flag rate "
        f"{flags}, launches {exact_launches}")
    if exact_prof is not None:
        log(f"knn: one profiled exact-arm batch: wall {exact_prof['wall_ms']:.2f} ms, device busy "
            f"{exact_prof['device_busy_ms']:.2f} ms, tiered_candidates "
            f"{exact_prof['tiered_candidates_ms']:.3f} ms, scan_topk (reruns) "
            f"{exact_prof['scan_topk_ms']:.3f} ms; top ops {exact_prof['top_ops']}")
    log(f"knn: {len(requests)} _search requests ({unfiltered} unfiltered): "
        + "; ".join(f"{key}: p50 {k['search_p50_ms'][key]:.3f} ms p99 {k['search_p99_ms'][key]:.3f} ms"
                    for key in k["search_p50_ms"]) + f"; launches {search_launches}")


def _rows_match(gv, gi, wv, wi, what: str, rtol: float = 1e-6, tie: float = 0.0) -> int:
    """Scores within rtol relative (plus `tie` absolute); where ids differ,
    the two scores agree within 1e-5 relative (the repo's fp-tie contract)
    or `tie`. -> positions swapped."""
    fin = np.isfinite(wv)
    if not np.array_equal(np.isfinite(gv), fin):
        raise AssertionError(f"{what}: hit counts differ")
    gap = np.abs(gv[fin] - wv[fin])
    if (gap > rtol * np.abs(wv[fin]) + tie).any():
        rel = gap / np.maximum(np.abs(wv[fin]), 1e-30)
        raise AssertionError(f"{what}: scores differ by {rel.max()} relative (tie class {tie})")
    swapped = 0
    for a, b, sa, sb in zip(gi[fin], wi[fin], gv[fin], wv[fin]):
        if a != b:
            swapped += 1
            if abs(sa - sb) > max(1e-5 * max(abs(sb), 1.0), tie):
                raise AssertionError(f"{what}: ids differ beyond fp-ties")
    return swapped


def _hits_arrays(out: dict):
    hits = out["hits"]["hits"]
    return (np.array([h["_score"] for h in hits], np.float64),
            np.array([int(h["_id"]) for h in hits]), out["hits"]["total"]["value"])


def phase_knn_check(device, state: dict) -> None:
    """32 kNN requests at nprobe = nlist, run on the card, and 16 of phase
    knn's answers, against the same pack searched with device="cpu" (the
    kernels' twins on the host): the same algorithm on both, so totals are
    equal, ids equal up to fp-ties and scores within 1e-6 relative. Not
    byte for byte: the f32 rescore of the candidates (`knn_scores`, `vectors
    @ q`) sums in the BLAS's order, which differs between the card and the
    host by an ulp (1.2e-7 relative in an earlier run)."""
    idx = state["knn_index"]
    nlist = idx.searcher.pack.vectors["vec"].ann["nlist"]
    t0 = time.perf_counter()
    cpu = _cpu_twin_index(idx)
    requests = state["knn_requests"]
    picks = [(dict(b, nprobe=nlist), size, from_)
             for b, size, from_ in requests[:: max(1, len(requests) // 32)][:32]]
    answers = [(req, idx.search(knn=req[0], size=req[1], from_=req[2])) for req in picks]
    results = state["knn_results"]
    answers += [(requests[j], results[j]) for j in range(0, len(requests), len(requests) // 16)[:16]]
    worst, swapped, equal = 0.0, 0, 0
    for (b, size, from_), got in answers:
        gs, gi, gt = _hits_arrays(got)
        ws, wi, wt = _hits_arrays(cpu.search(knn=b, size=size, from_=from_))
        if gt != wt:
            raise AssertionError(f"total {gt} vs the cpu run's {wt} (nprobe {b.get('nprobe')})")
        swapped += _rows_match(gs[None], gi[None], ws[None], wi[None],
                               f"device=cpu _search (nprobe {b.get('nprobe')})")
        equal += int(np.array_equal(gs, ws) and np.array_equal(gi, wi))
        if len(ws):
            worst = max(worst, float((np.abs(gs - ws) / np.abs(ws)).max()))
    log(f"knn_check: 32 requests at nprobe = nlist and 16 at the default nprobe match the "
        f"device=cpu run ({equal} of {len(answers)} byte-equal, max relative score difference "
        f"{worst:.3g}, {swapped} positions swapped among fp-ties) in "
        f"{time.perf_counter() - t0:.1f} s")


KERNEL_OPS = {  # the __global__ functions each kernel's launches run
    "scan_topk": ("scan_streamed_kernel", "scan_matmul_kernel", "scan_merge_kernel"),
    "tiered_candidates": ("tiered_tc_kernel", "tiered_merge_kernel"),
    "impact_gather": ("impact_gather_kernel",),
    "fused_tile_candidates": ("fused_select_kernel", "fused_tile_kernel"),
    "ann_gather_scan": ("ann_group_kernel", "ann_tile_scan_kernel", "ann_merge_kernel"),
}


PROFILE_TRIES = 3


def _device_trace(fn) -> tuple[float, list]:
    """Run fn under torch.profiler, the card synchronised before the trace
    stops -> (wall us, [(device op, self device us, launches)]). CUPTI can
    hand a short trace back with no kernel record at all; the run is then
    traced again, up to PROFILE_TRIES times, and a work that never shows
    device time fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops = _device_ops(prof)
        if ops:
            return wall_us, ops
        log(f"profiler: trace {attempt} of {PROFILE_TRIES} holds no device time")
    raise EmptyTraceError(f"the profiler recorded no device time in {PROFILE_TRIES} traces")


def _device_ops(prof) -> list:
    """[(device op, self device us, launches)] of a finished trace, summed
    from its raw kineto events under the names `key_averages` gives them:
    the tree of host events that `key_averages` builds first took seconds
    per 100,000 of them (a window of 20 requests on 8 shards holds some
    200,000), and the device ops need none of it (`_check_device_ops` holds
    the two readings equal). A torch without the raw events goes through
    `key_averages`."""
    from torch.autograd import DeviceType
    from torch.autograd import profiler_util

    results = getattr(prof.profiler, "kineto_results", None)
    rewrite = getattr(profiler_util, "_rewrite_name", None)
    if results is None or rewrite is None:
        return _key_averages_ops(prof)
    raw: dict = {}
    for e in results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        us_n = raw.setdefault(e.name(), [0.0, 0])
        us_n[0] += e.duration_ns() / 1e3
        us_n[1] += 1
    ops: dict = {}
    for name, (us, n) in raw.items():
        key = rewrite(name=name, with_wildcard=True)
        t = ops.setdefault(key, [0.0, 0])
        t[0] += us
        t[1] += n
    return [(key, us, n) for key, (us, n) in ops.items() if us > 0]


def _key_averages_ops(prof) -> list:
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]


def _check_device_ops(fn) -> int:
    """One trace of fn read both ways: `_device_ops` and `key_averages` name
    the same device ops with the same launches, and their µs agree within
    0.01 µs a launch. -> ops compared."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    raw = {k: (us, n) for k, us, n in _device_ops(prof)}
    avg = {k: (us, n) for k, us, n in _key_averages_ops(prof)}
    if raw.keys() != avg.keys() or any(
            raw[k][1] != n or abs(raw[k][0] - us) > 0.01 * n for k, (us, n) in avg.items()):
        raise AssertionError(f"the raw events' device ops {sorted(raw.items())[:5]} differ from "
                             f"key_averages' {sorted(avg.items())[:5]}")
    return len(avg)


class EmptyTraceError(AssertionError):
    """The profiler handed back no kernel record in PROFILE_TRIES traces."""


def _profiled(fn) -> tuple[float, list]:
    """Run fn under torch.profiler -> (wall us, [(device op, self device us)])."""
    wall_us, ops = _device_trace(fn)
    return wall_us, sorted(((key, us) for key, us, _ in ops), key=lambda o: -o[1])


def _kernel_us(ops) -> dict:
    return {name: sum(us for key, us in ops if any(f"::{f}(" in key or f"::{f}<" in key
                                                  for f in fns))
            for name, fns in KERNEL_OPS.items()}


def phase_profile(state: dict) -> None:
    import torch

    idx = state["index"]
    sample = state["requests"][:: max(1, len(state["requests"]) // 100)][:100]

    def searches():
        for q, size, from_ in sample:
            idx.search(q, size=size, from_=from_)

    n_ops = _check_device_ops(searches)
    log(f"profile: {n_ops} device ops of one trace read from the raw events equal key_averages'")
    wall_us, ops = _profiled(searches)
    busy_us = sum(us for _, us in ops)
    scan_us = _kernel_us(ops)["scan_topk"]
    state["profile"] = {"requests": len(sample), "wall_ms": wall_us / 1e3,
                        "device_busy_ms": busy_us / 1e3,
                        "scan_topk_ms": scan_us / 1e3}
    log(f"profile: {len(sample)} requests, wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), scan_topk kernels "
        f"{scan_us / 1e3:.2f} ms ({100 * scan_us / busy_us:.1f}% of device time)")
    if "msearch_batches" not in state:
        return
    queries = state["msearch_batches"][-1]
    for k in (10, 25):
        def batch():
            idx.searcher.msearch("body", queries, k)
            torch.cuda.synchronize()

        wall_us, ops = _profiled(batch)
        busy_us = sum(us for _, us in ops)
        per_kernel = _kernel_us(ops)
        state[f"profile_msearch_k{k}"] = {
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            **{f"{n}_ms": us / 1e3 for n, us in per_kernel.items()}}
        log(f"profile: one {len(queries)}-query msearch batch at k={k}, wall "
            f"{wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
            f"({100 * busy_us / wall_us:.1f}%); "
            + ", ".join(f"{n} {us / 1e3:.2f} ms ({100 * us / busy_us:.1f}%)"
                        for n, us in per_kernel.items()))
        for key, us in ops[:10]:
            log(f"  device op {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {key[:100]}")


# ---------------------------------------------------------------------------
# the write path: deletes, updates and the tail-segment refresh
# ---------------------------------------------------------------------------

WRITE_ROUNDS = 4  # rounds before the fold
WRITE_UPDATES, WRITE_DELETES, WRITE_NEW = 1_000, 500, 1_000  # writes per round
WRITE_OLDER = 25  # of a round's updates and deletes, on ids an earlier round wrote
WRITE_CPU_PICKS = 20  # tiered requests held to the device="cpu" run
WRITE_CONCURRENT = 512  # C1 `_search`es over REST on the tiered lane


class _WriteLog:
    """What the writes phase wrote: the newest source of every id it
    updated or created, the ids it deleted, and the ids it created."""

    def __init__(self, n_base: int, gen):
        self.n_base, self.gen = n_base, gen
        self.latest: dict[str, dict] = {}
        self.deleted: set[str] = set()
        self.created: list[str] = []

    def live_written(self, rng, n: int) -> list[str]:
        ids = [i for i in self.latest if i not in self.deleted]
        return [ids[j] for j in rng.choice(len(ids), size=min(n, len(ids)), replace=False)]

    def base_ids(self, rng, n: int, avoid: set) -> list[str]:
        out: list[str] = []
        while len(out) < n:
            i = str(int(rng.integers(0, self.n_base)))
            if i not in self.deleted and i not in avoid and i not in out:
                out.append(i)
        return out

    def round(self, idx, rng, r: int, updates: int, deletes: int, new: int) -> None:
        """One round of writes through EsIndex: updates of base ids and of
        ids earlier rounds wrote, deletes likewise, and new docs."""
        older = self.live_written(rng, WRITE_OLDER) if self.latest else []
        upd = older + self.base_ids(rng, updates - len(older), set(older))
        older_del = [i for i in self.live_written(rng, 2 * WRITE_OLDER) if i not in upd]
        older_del = older_del[:WRITE_OLDER]
        dels = older_del + self.base_ids(rng, deletes - len(older_del), set(upd) | set(older_del))
        for i in upd:
            self.latest[i] = next(self.gen)
            idx.index_doc(i, self.latest[i])
        for i in dels:
            idx.delete_doc(i)
            self.deleted.add(i)
        for j in range(new):
            i = f"n{r}_{j}"
            self.latest[i] = next(self.gen)
            self.created.append(i)
            idx.index_doc(i, self.latest[i])


def _timed_refresh(idx, device) -> dict:
    """One refresh, its seconds on the host clock after a synchronize, its
    kind, the fold's seconds when it folded, and the refresh lag it ended
    (the oldest write's wait, ms)."""
    lag_ms = idx.refresh_lag_ms()
    folds = []
    fold = idx._merge_tail_segments

    def timed_fold():
        t0 = time.perf_counter()
        out = fold()
        sync(device)
        folds.append(time.perf_counter() - t0)
        return out

    idx._merge_tail_segments = timed_fold
    try:
        t0 = time.perf_counter()
        idx.refresh()
        sync(device)
        secs = time.perf_counter() - t0
    finally:
        del idx._merge_tail_segments
    return {"s": secs, "kind": idx.last_refresh_kind, "fold_s": folds[0] if folds else None,
            "lag_ms": lag_ms, **idx.tier_stats()}


def _cpu_twin_index(idx):
    """The index's tiers searched with device="cpu" on the same packs (the
    base under its statistics override, each segment as it is), behind the
    same EsIndex logic, so a search on it runs the card's algorithm on the
    kernels' twins."""
    import copy
    import dataclasses

    import torch

    from elasticsearch_tpu_torch.parallel.sharded import StackedSearcher
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    cpu = copy.copy(idx)
    cpu.device = torch.device("cpu")
    cpu._breaker_account = None  # the card's index holds the breaker's charge
    if isinstance(idx._searcher, StackedSearcher):
        cpu._searcher = StackedSearcher(idx._searcher.sp, device="cpu")
    else:
        cpu._searcher = ShardSearcher(idx._searcher.pack, device="cpu", mappings=idx.mappings)
        if idx._searcher.stats_override is not None:  # else the host-built tiers, as the card's
            cpu._searcher.set_stats_override(idx._searcher.stats_override)
    cpu._tails = [dataclasses.replace(seg, searcher=StackedSearcher(seg.searcher.sp,
                                                                    device="cpu"))
                  for seg in idx._tails]
    return cpu


def _tiered_cpu_check(idx, picks, results, what: str, cpu=None) -> float:
    """`picks` ((query, size, from_), answer on the card) against the same
    tiers searched on the host (`cpu`, else a fresh `_cpu_twin_index`) and
    merged by EsIndex._tiered_merge: totals equal, scores within 1e-6
    relative, ids equal up to fp-ties. -> the largest relative score
    difference."""
    cpu = _cpu_twin_index(idx) if cpu is None else cpu
    worst = 0.0
    for (q, size, from_), got in zip(picks, results):
        want = cpu._search_tiered(q, size, from_)["hits"]
        g = got["hits"]
        if g["total"] != want["total"]:
            raise AssertionError(f"{what}: total {g['total']} vs cpu {want['total']} for {q}")
        gs = np.array([h["_score"] for h in g["hits"]], np.float64)
        ws = np.array([h["_score"] for h in want["hits"]], np.float64)
        gi = np.array([h["_id"] for h in g["hits"]], object)
        wi = np.array([h["_id"] for h in want["hits"]], object)
        if gs.shape != ws.shape:
            raise AssertionError(f"{what}: hit count differs for {q}")
        _rows_match(gs[None], gi[None], ws[None], wi[None], f"{what} {q}")
        if len(ws):
            worst = max(worst, float((np.abs(gs - ws) / np.abs(ws)).max()))
    return worst


def _check_written(wl: _WriteLog, results, what: str) -> None:
    """No deleted id in any hit; every hit of an id the phase wrote carries
    its newest source."""
    for out in results:
        for h in out["hits"]["hits"]:
            if h["_id"] in wl.deleted:
                raise AssertionError(f"{what}: deleted id {h['_id']} in a hit")
            if h["_id"] in wl.latest and h["_source"] != wl.latest[h["_id"]]:
                raise AssertionError(f"{what}: {h['_id']} carries an older source")


def phase_writes(device, rng, state: dict) -> None:
    """Deletes, updates and the tail-segment refresh on the 1M-doc index of
    phase index, after every phase that reads it unmodified: 4 rounds of
    1,000 updates, 500 deletes and 1,000 new docs, each followed by a
    refresh (seconds and kind beside phase index's full refresh); the
    traffic phase's 600 requests on the tiered index (p50/p99 beside phase
    traffic's, one scan_topk launch per tier per request); the checks
    (no deleted id in a hit, updated ids with their newest source, count
    equal to the tiered total, 20 requests with a dense-tier term among
    them against a device="cpu" run of the same tiers); a fifth round past
    indexing.tiers.max_segments (the fold's seconds, the CPU check again);
    a refresh that only deletes; then over REST with serving on a `_bulk`
    of delete and update items, `_update` and `DELETE _doc` with
    ?refresh=true, and 512 concurrent C1 `_search`es on the tiered lane,
    each equal to the solo tiered `search` byte for byte."""
    from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus, sample_queries
    from elasticsearch_tpu_torch.ops import kernels

    if "msearch_batches" in state:
        _keep_one_shard_answers(state)
    # a child stream of the run's seed: the phases after this one draw the
    # inputs they drew before it existed, so their numbers stay comparable
    rng = rng.spawn(1)[0]
    idx = state["index"]
    n_base = idx._searcher.pack.num_docs
    lens, tok, nums = make_corpus(rng, (WRITE_ROUNDS + 2) * (WRITE_UPDATES + WRITE_NEW))
    wl = _WriteLog(n_base, iter(corpus_docs(lens, tok, nums)))
    launches: dict = {}
    out: dict = {"full_refresh_s": state.get("index_refresh_s"), "rounds": []}

    # 1. the write rounds
    kernels.reset_launch_counts()
    for r in range(WRITE_ROUNDS):
        t0 = time.perf_counter()
        wl.round(idx, rng, r, WRITE_UPDATES, WRITE_DELETES, WRITE_NEW)
        write_s = time.perf_counter() - t0
        ref = _timed_refresh(idx, device)
        if ref["kind"] != "incremental" or ref["segments"] != r + 1:
            raise AssertionError(f"round {r}: refresh {ref}")
        out["rounds"].append({"write_s": write_s, **ref})
        log(f"writes round {r}: {WRITE_UPDATES + WRITE_DELETES + WRITE_NEW} writes in "
            f"{write_s:.2f} s; refresh {ref['s']:.3f} s ({ref['kind']}, lag "
            f"{ref['lag_ms']:.1f} ms), tier_stats "
            f"{ {k: ref[k] for k in ('base_docs', 'tail_docs', 'tail_fraction', 'segments')} } "
            f"(phase index's full refresh {out['full_refresh_s']:.1f} s)")
    launches["refresh"] = dict(kernels.launch_counts)

    # 2. the traffic phase's requests on the tiered index
    requests = state["requests"]
    segments = len(idx._tails)
    for q, size, from_ in requests[:5]:
        idx.search(q, size=size, from_=from_)
    kernels.reset_launch_counts()
    lat = {(10, 0): [], (20, 5): []}
    results = []
    for q, size, from_ in requests:
        t0 = time.perf_counter()
        results.append(idx.search(q, size=size, from_=from_))
        lat[(size, from_)].append((time.perf_counter() - t0) * 1e3)
    launches["search"] = dict(kernels.launch_counts)
    if launches["search"]["scan_topk"] != len(requests) * (1 + segments):
        raise AssertionError(f"scan_topk launched {launches['search']['scan_topk']} times for "
                             f"{len(requests)} requests on {1 + segments} tiers")
    base_p50 = state.get("traffic_p50", {})
    out["search"] = {f"{s},{f}": {"segments": segments, "p50_ms": float(np.percentile(ms, 50)),
                                  "p99_ms": float(np.percentile(ms, 99)),
                                  "traffic_p50_ms": base_p50.get((s, f))}
                     for (s, f), ms in lat.items()}
    log(f"writes search: {len(requests)} requests on 1 + {segments} tiers, scan_topk launches "
        f"{launches['search']['scan_topk']}; " + "; ".join(
            f"size={s} from={f}: {_percentiles(ms)} (phase traffic p50 "
            f"{base_p50.get((s, f), float('nan')):.3f} ms)" for (s, f), ms in lat.items()))

    # the impact tier on every tier against exact BM25 plans over the tiers
    imp = _impact_against_exact(idx, requests, results, "impact_search tiers")
    imp["impact_p50_ms"] = {key: v["p50_ms"] for key, v in out["search"].items()}
    state.setdefault("impact_search", {})["tiers"] = imp
    state.setdefault("planner_launches", {})["impact_search_tiers_exact"] = imp["exact_launches"]
    log(f"impact_search tiers: {len(requests)} requests on 1 + {segments} tiers "
        f"({imp['answers_not_exact']} answers off exact BM25, max gap {imp['max_gap']:.3g}, "
        f"{imp['swapped']} swapped within the tie class); exact plans p50 {imp['exact_p50_ms']} "
        f"p99 {imp['exact_p99_ms']} ms")

    # 3. the checks
    _check_written(wl, results, "tiered search")
    for (q, _size, _from), res in list(zip(requests, results))[:: len(requests) // 50]:
        if idx.count(q) != res["hits"]["total"]["value"]:
            raise AssertionError(f"count({q}) differs from the tiered total")
    pack = idx._searcher.pack
    dense_term = next(t for (f, t) in pack.dense_dict if f == "body")
    dense_req = ({"match": {"body": dense_term}}, 10, 0)
    pick_ix = list(range(0, len(requests), len(requests) // (WRITE_CPU_PICKS - 1)))
    pick_ix = pick_ix[: WRITE_CPU_PICKS - 1]
    picks = [requests[i] for i in pick_ix] + [dense_req]
    picked = [results[i] for i in pick_ix] + [idx.search(dense_req[0], size=10)]
    t0 = time.perf_counter()
    cpu = _cpu_twin_index(idx)  # this tier state's host twin, for the DSL check too
    worst = _tiered_cpu_check(idx, picks, picked, "tiered cpu", cpu=cpu)
    out["cpu_check"] = {"requests": len(picks), "max_rel": worst,
                        "s": time.perf_counter() - t0}
    log(f"writes checks: no deleted id in {len(results)} answers, updated ids carry their "
        f"newest source, count equals the tiered total; {len(picks)} requests (dense-tier "
        f"term {dense_term!r}) equal the device=cpu tiers (max relative {worst:.3g})")

    if "dsl_kept" in state:  # the text DSL on base + segments
        out["dsl_tiers"] = _dsl_tiers(idx, state, segments, cpu)
    del cpu

    # 4. a fifth round: past indexing.tiers.max_segments, the fold
    bound = idx.max_tail_segments()
    kernels.reset_launch_counts()
    for r in range(WRITE_ROUNDS, bound + 1):
        wl.round(idx, rng, r, WRITE_UPDATES, WRITE_DELETES, WRITE_NEW)
        fold = _timed_refresh(idx, device)
    launches["fold"] = dict(kernels.launch_counts)
    if fold["fold_s"] is None or idx.counters.get("merge_failures", 0) or \
            fold["segments"] > bound:
        raise AssertionError(f"the fold: {fold}, counters {idx.counters}")
    out["fold"] = fold
    after = [idx.search(q, size=s, from_=f) for q, s, f in picks]
    _check_written(wl, after, "after the fold")
    worst = _tiered_cpu_check(idx, picks, after, "folded cpu")
    log(f"writes fold: refresh {fold['s']:.3f} s with the fold {fold['fold_s']:.3f} s, "
        f"{fold['segments']} segment(s) (bound {bound}), merge_failures 0; {len(picks)} "
        f"requests equal the device=cpu tiers (max relative {worst:.3g})")

    # 5. a refresh that only deletes
    dels = wl.base_ids(rng, WRITE_DELETES, set())
    for i in dels:
        idx.delete_doc(i)
        wl.deleted.add(i)
    segs = [seg.searcher for seg in idx._tails]
    dref = _timed_refresh(idx, device)
    if [seg.searcher for seg in idx._tails] != segs or dref["kind"] != "incremental":
        raise AssertionError(f"a delete-only refresh sealed a segment: {dref}")
    out["delete_only"] = dref
    log(f"writes delete-only: {len(dels)} deletes, refresh {dref['s']:.3f} s, no segment "
        f"sealed ({dref['segments']} segment(s))")

    # 6. over REST with serving on
    server, c = _serve(state, device)
    try:
        lines, touched = [], wl.base_ids(rng, 200, set())
        for i in touched[:100]:
            lines.append({"delete": {"_index": "corpus", "_id": i}})
            wl.deleted.add(i)
        for i in touched[100:]:
            n = int(rng.integers(0, 1000))
            lines += [{"update": {"_index": "corpus", "_id": i}}, {"doc": {"n": n}}]
            wl.latest[i] = {**idx.get_doc(i)["_source"], "n": n}
        status, _, resp = c("POST", "/_bulk?refresh=true", raw=_ndjson(lines))
        if status != 200 or resp["errors"] or {next(iter(x)) for x in resp["items"]} != {
                "delete", "update"}:
            raise AssertionError(f"_bulk delete/update: {status}")
        up, gone = [i for i in wl.created if i not in wl.deleted][:2]
        wl.latest[up] = {**wl.latest[up], "n": -1}
        status, _, resp = c("POST", f"/corpus/_update/{up}?refresh=true", {"doc": {"n": -1}})
        if status != 200 or resp["result"] != "updated" or not resp.get("forced_refresh"):
            raise AssertionError(f"_update: {status} {resp}")
        status, _, resp = c("DELETE", f"/corpus/_doc/{gone}?refresh=true")
        if status != 200 or resp["result"] != "deleted":
            raise AssertionError(f"DELETE _doc: {status} {resp}")
        wl.deleted.add(gone)
        if c("GET", f"/corpus/_doc/{gone}")[0] != 404:
            raise AssertionError("a deleted doc is still found")
        lens0, tok0 = state["corpus"]
        bodies = [{"query": {"match": {"body": " ".join(t for t, _ in q)}}, "size": 10}
                  for q in sample_queries(rng, lens0, tok0, WRITE_CONCURRENT)]
        solo = [idx.search(b["query"], size=10) for b in bodies]
        _check_written(wl, solo, "solo")
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": True}})
        before = c("GET", "/_serving/stats")[2]["serving"]
        segments = len(idx._tails)
        kernels.reset_launch_counts()
        resp, lat, wall = _concurrent(server.port, [("POST", "/corpus/_search", b)
                                                    for b in bodies], REST_CLIENTS)
        launches["rest"] = dict(kernels.launch_counts)
        after = c("GET", "/_serving/stats")[2]["serving"]
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})
        for j, (g, w) in enumerate(zip(resp, solo)):
            _same_hits(g, w, f"tiered wave [{j}]")
        waves = after["waves"] - before["waves"]
        tiered = after["tiered_packed"] - before["tiered_packed"]
        if tiered != len(bodies) or launches["rest"]["scan_topk"] != len(bodies) * (1 + segments):
            raise AssertionError(f"tiered lane: {tiered} entries, scan_topk "
                                 f"{launches['rest']['scan_topk']}")
        out["rest"] = {"requests": len(bodies), "waves": waves, "mean_wave": len(bodies) / waves,
                       "qps": len(bodies) / wall, "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99)), "segments": segments}
        log(f"writes rest: _bulk of 100 delete and 100 update items, _update and DELETE _doc "
            f"with ?refresh=true; {len(bodies)} C1 _search with serving on over {1 + segments} "
            f"tiers: {waves} waves (mean {len(bodies) / waves:.1f}), {len(bodies) / wall:.0f} "
            f"QPS, {_percentiles(lat)}, each equal to the solo tiered search byte for byte")
    finally:
        c.close()
        server.stop()
    state["writes"] = out
    state["writes_launches"] = launches


# ---------------------------------------------------------------------------
# multi-shard indices: the 8-shard 1M-doc EsIndex and bench.py config C5
# ---------------------------------------------------------------------------

N_SHARDS = 8  # bench.py C5's shard count
SHARD_KEEP = 64  # requests and msearch queries kept from the 1-shard index
SHARDED_KERNELS = ("scan_topk", "impact_gather", "fused_tile_candidates")


def _release(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _check_msearch_rows(v, keys, tt, k: int, what: str) -> None:
    if v.shape[1] != k or np.isnan(v).any():
        raise AssertionError(f"{what}: malformed rows")
    fin = np.isfinite(v)
    if (v[:, 1:] > v[:, :-1]).any() or (tt < fin.sum(1)).any():
        raise AssertionError(f"{what}: rows out of order or totals below the hit count")


def _keep_one_shard_answers(state: dict) -> None:
    """The 1-shard index's answers that phase shards holds the 8-shard
    index to, taken once, before phase writes changes the index."""
    if "shards_kept" in state:
        return
    idx = state["index"]
    reqs = state["requests"]
    pick = list(range(0, len(reqs), len(reqs) // SHARD_KEEP))[:SHARD_KEEP]
    queries = state["msearch_batches"][0][:SHARD_KEEP]
    bs = idx.searcher.batched()
    views = _tier_views(idx)
    state["shards_kept"] = {
        # each answer with its impact bound on this index (its own ubf)
        "search": [(reqs[i], state["results"][i], _impact_bound(reqs[i][0], idx.mappings, views))
                   for i in pick],
        "queries": queries,
        "msearch": {k: bs.search("body", queries, k) for k in (10, 25)},
    }


def phase_shards_index(device, state: dict) -> None:
    """Keep the 1-shard index's answers to 64 traffic requests and to 64
    queries of one C1 batch at k=10 and k=25 (its exact arm), release it,
    then index the same 1M docs into an 8-shard EsIndex."""
    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs

    _keep_one_shard_answers(state)
    _drop_index(state, "corpus", "index", device)
    lens, tok = state["corpus"]
    t0 = time.perf_counter()
    docs = corpus_docs(lens, tok, state["nums"])
    t1 = time.perf_counter()
    idx8 = _engine(state, device).create_index("shards", MAPPINGS,
                                               {"number_of_shards": N_SHARDS})
    for i, d in enumerate(docs):
        idx8.index_doc(str(i), d)
    del docs
    t2 = time.perf_counter()
    mark = _profile_mark(state)
    idx8.refresh()
    sync(device)
    t3 = time.perf_counter()
    (profile,) = _new_profiles(state, mark)
    _check_profile_wall("shards_index refresh", profile["wall_ms"] / 1e3, t3 - t2)
    sp = idx8.searcher.sp
    state["shards_index"] = idx8
    # (the card route's byte check against the host route is phase index's,
    # on its prefix: the 8 shards' host build of shard 0 was cut for time)
    state["shards_build"] = {"docs_per_shard": [p.num_docs for p in sp.shards], "n_max": sp.n_max,
                             "dense_rows": sp.dense_v, "pack_bytes": sp.nbytes(),
                             "bytes_on_card": _on_card(device), "generate_s": t1 - t0,
                             "index_doc_s": t2 - t1, "refresh_s": t3 - t2}
    log(f"shards_index: {sp.num_docs} docs on {sp.S} shards {state['shards_build']['docs_per_shard']}"
        f" (n_max {sp.n_max}), {sp.dense_v} dense rows, {sp.nbytes()} pack bytes (tier copies "
        f"included), {_on_card(device)} bytes allocated on the card; generate {t1 - t0:.1f} s, "
        f"index_doc {t2 - t1:.1f} s, refresh {t3 - t2:.1f} s")


def phase_shards(device, rng, state: dict) -> None:
    """The traffic and msearch bodies on the 8-shard index, its rows against
    the kept 1-shard answers and against the same pack on the host."""
    import torch

    from elasticsearch_tpu_torch.corpus import sample_queries, traffic
    from elasticsearch_tpu_torch.engine import engine
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.ops.batched import impact_tie_class
    from elasticsearch_tpu_torch.parallel import StackedSearcher, msearch_sharded

    idx = state["shards_index"]
    ss = idx.searcher
    lens, tok = state["corpus"]
    requests = state["requests"]
    for q, size, from_ in requests[:5]:
        idx.search(q, size=size, from_=from_)
    kernels.reset_launch_counts()
    lat = {(10, 0): [], (20, 5): []}
    n_hits = 0
    for q, size, from_ in requests:
        t0 = time.perf_counter()
        out = idx.search(q, size=size, from_=from_)
        lat[(size, from_)].append((time.perf_counter() - t0) * 1000)
        n_hits += len(out["hits"]["hits"])
    search_launches = dict(kernels.launch_counts)
    if search_launches["scan_topk"] != len(requests) or n_hits == 0:
        raise AssertionError(f"scan_topk launched {search_launches['scan_topk']} times for "
                             f"{len(requests)} requests ({n_hits} hits)")

    bodies = []
    for j, qs in enumerate(sample_queries(rng, lens, tok, 512)):
        body = {"query": {"match": {"body": " ".join(t for t, _ in qs)}}}
        bodies.append({**body, "from": 5, "size": 20} if j % 2 else body)
    bools = [{"query": q} for q in traffic(rng, lens, tok, 0, 0, 32)]
    idx.msearch(bodies[:16])  # warm-up: the split-bf16 tier copies
    sync(device)
    routed = [0]
    real = engine.msearch_sharded

    def spy(searcher, fld, queries, k=10):
        routed[0] += len(queries)
        return real(searcher, fld, queries, k)

    engine.msearch_sharded = spy
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resp = idx.msearch(bodies + bools)
        ms_wall = time.perf_counter() - t0
        ms_launches = dict(kernels.launch_counts)
    finally:
        engine.msearch_sharded = real
    if {r["status"] for r in resp["responses"]} != {200} or routed[0] != len(bodies):
        raise AssertionError(f"EsIndex.msearch: {routed[0]} bodies took msearch_sharded")
    for name in SHARDED_KERNELS:
        if ms_launches[name] == 0:
            raise AssertionError(f"the sharded EsIndex.msearch launched no {name}")
    state.setdefault("sharded_launches", {}).update(shards_search=search_launches,
                                                    shards_msearch=ms_launches)

    # the kept 1-shard answers: _search rows (the impact tier on both, each
    # index quantizing with its own per-term bounds: the tie class of the
    # larger bound), and msearch rows against the 1-shard exact arm (in the
    # impact tie class where the 8-shard batch took the impact arm, read
    # from `last_stats`)
    kept = state.pop("shards_kept")
    worst, swapped = 0.0, 0
    views8 = _tier_views(idx)
    for (q, size, from_), want, bound1 in kept["search"]:
        got = idx.search(q, size=size, from_=from_)
        gs, gi, gt = _hits_arrays(got)
        ws, wi, wt = _hits_arrays(want)
        if gt != wt:
            raise AssertionError(f"8 shards: total {gt} vs 1 shard {wt} for {q}")
        tie = 2 * max(bound1, _impact_bound(q, idx.mappings, views8)) + 1e-7
        swapped += _rows_match(gs, gi, ws, wi, f"8 shards vs 1 for {q}", rtol=1e-5, tie=tie)
    queries = kept["queries"]
    for k in (10, 25):
        v, sh, dc, tt = msearch_sharded(ss, "body", queries, k)
        arm = _batch_arm(ss.last_stats["queries"])
        ids = np.array([[int(idx.shard_docs[s][d][0]) if np.isfinite(x) else -1
                         for s, d, x in zip(rs, rd, rv)] for rs, rd, rv in zip(sh, dc, v)])
        wv, wi, wt = kept["msearch"][k]
        if not np.array_equal(tt, wt):
            raise AssertionError(f"k={k}: 8-shard totals differ from the 1-shard exact arm's")
        for row, terms in enumerate(queries):
            tie = impact_tie_class(ss.sp, "body", terms) if arm == "impact" else 0.0
            swapped += _rows_match(v[row].astype(np.float64), ids[row], wv[row].astype(np.float64),
                                   wi[row], f"k={k} msearch ({arm}) {terms}", rtol=1e-5, tie=tie)
            fin = np.isfinite(wv[row])
            if fin.any() and k == 10:
                worst = max(worst, float((np.abs(v[row][fin] - wv[row][fin])
                                          / np.abs(wv[row][fin])).max()))
    one_line = (f"{len(kept['search'])} requests (impact tie class) and {len(queries)} x 2 "
                f"msearch rows match the 1-shard index (max relative score difference "
                f"{worst:.3g} of the k=10 rows, {swapped} positions swapped among ties)")

    # the same pack on the host
    t0 = time.perf_counter()
    cpu = StackedSearcher(ss.sp, device="cpu")
    cworst = 0.0
    for (q, size, from_), _, _ in kept["search"][::4][:16]:
        a, b = ss.search(q, size=size, from_=from_), cpu.search(q, size=size, from_=from_)
        if a.total != b.total:
            raise AssertionError(f"card total {a.total} vs cpu {b.total} for {q}")
        _rows_match(a.scores.astype(np.float64), a.doc_shards * ss.sp.n_max + a.doc_ids,
                    b.scores.astype(np.float64), b.doc_shards * ss.sp.n_max + b.doc_ids,
                    f"card vs cpu {q}", rtol=1e-5)
        if len(b.scores):
            cworst = max(cworst, float((np.abs(a.scores - b.scores) / np.abs(b.scores)).max()))
    arms = {}
    for k in (10, 25):
        a = msearch_sharded(ss, "body", queries[:32], k)
        with _held_to(_batch_arm(ss.last_stats["queries"])):
            b = msearch_sharded(cpu, "body", queries[:32], k)
        arms[k] = sorted(cpu.last_stats["queries"])
        if arms[k] != sorted(ss.last_stats["queries"]):
            raise AssertionError(f"k={k}: the host run took {arms[k]}, the card "
                                 f"{sorted(ss.last_stats['queries'])}")
        if not np.array_equal(a[3], b[3]):
            raise AssertionError(f"k={k}: card totals differ from the cpu run's")
        for row in range(32):
            _rows_match(a[0][row].astype(np.float64), a[1][row] * ss.sp.n_max + a[2][row],
                        b[0][row].astype(np.float64), b[1][row] * ss.sp.n_max + b[2][row],
                        f"k={k} card vs cpu", rtol=1e-5)
    if arms != {10: ["fused"], 25: ["impact"]}:
        raise AssertionError(f"the host run took arms {arms}")
    del cpu
    t_cpu = time.perf_counter() - t0
    del idx, ss
    parts = [f"size={s} from={f}: p50 {np.percentile(ms, 50):.3f} ms p99 "
             f"{np.percentile(ms, 99):.3f} ms" for (s, f), ms in lat.items()]
    state["shards"] = {"search_p50_ms": {f"{s},{f}": float(np.percentile(ms, 50))
                                         for (s, f), ms in lat.items()},
                       "search_p99_ms": {f"{s},{f}": float(np.percentile(ms, 99))
                                         for (s, f), ms in lat.items()},
                       "msearch_wall_ms": ms_wall * 1e3, "msearch_bodies": len(bodies) + len(bools)}
    log(f"shards: {len(requests)} requests, {n_hits} hits, scan_topk launches "
        f"{search_launches['scan_topk']} ({search_launches['scan_topk'] / len(requests):.2f} per "
        f"request); " + "; ".join(parts)
        + f"; EsIndex.msearch {len(bodies)} match + {len(bools)} bool bodies in "
        f"{ms_wall * 1e3:.1f} ms, launches {ms_launches} ("
        + ", ".join(f"{ms_launches[n] / (len(bodies) + len(bools)):.3f} {n}" for n in SHARDED_KERNELS)
        + f" per body); {one_line}; 16 requests and 32 msearch rows at k=10 and k=25 (arms "
        f"{arms}) match the device=cpu run (max relative score difference {cworst:.3g}) in "
        f"{t_cpu:.1f} s")


def phase_c5_index(device, state: dict, n_per_shard: int) -> None:
    """bench.py C5: 8 x n_per_shard docs of C1's generator on their own
    stream, split by doc range, built through build_stacked_pack_routed on
    the card's route (the shards one after another, shard k+1 analyzed while
    shard k builds) and uploaded through StackedSearcher; the card's impact
    codes of shard 0 against the host derivation."""
    import torch

    from elasticsearch_tpu_torch.corpus import C5_MAPPINGS, C5_SHARDS, c5_corpus, c5_shard_docs
    from elasticsearch_tpu_torch.index.mappings import Mappings
    from elasticsearch_tpu_torch.index.pack import impact_codes_host
    from elasticsearch_tpu_torch.parallel import StackedSearcher, build_stacked_pack_routed

    _drop_index(state, "shards", "shards_index", device)  # when rest_shards did not run
    t0 = time.perf_counter()
    lens, tok, crng = c5_corpus(n_per_shard, C5_SHARDS)
    t1 = time.perf_counter()
    routed = [c5_shard_docs(lens, tok, s, n_per_shard) for s in range(C5_SHARDS)]
    from elasticsearch_tpu_torch.monitoring.refresh_profile import collect_build_stages

    t2 = time.perf_counter()
    with collect_build_stages() as coll:
        sp = build_stacked_pack_routed(routed, Mappings(C5_MAPPINGS), device=device)
    del routed
    t3 = time.perf_counter()
    wall, stages = coll.finish()
    _log_build(state, "c5_index", [{
        "kind": "full", "docs": C5_SHARDS * n_per_shard, "wall_ms": wall * 1e3,
        "stages_ms": {k: v * 1e3 for k, v in stages.items()}, "basis": dict(coll.bases)}])
    before = _on_card(device)
    ss = StackedSearcher(sp, device=device)
    sync(device)
    t4 = time.perf_counter()
    on_card = _on_card(device) - before
    meta = sp.impact_meta
    k_base, k_slope = ss.impact_row_params()
    want = impact_codes_host(sp.post_tfs[0], sp.post_dls[0], k_base[0], k_slope[0],
                             sp.impact_row_scale_inv[0], meta["qmax"], meta["dtype"])
    got = ss.dev["impact_codes"][0].view(torch.int16).cpu().numpy().view(want.dtype)
    if got.tobytes() != want.tobytes():
        raise AssertionError("the card's impact codes of shard 0 differ from the host's")
    state.update(c5_searcher=ss, c5_corpus=(lens, tok, crng))
    state["c5_build"] = {"shards": sp.S, "docs_per_shard": n_per_shard, "n_max": sp.n_max,
                         "dense_rows": sp.dense_v, "postings_blocks": sp.nb_max,
                         "tokens": int(lens.sum()), "pack_bytes": sp.nbytes(),
                         "bytes_on_card": on_card, "generate_s": t1 - t0, "texts_s": t2 - t1,
                         "analyse_build_s": t3 - t2, "upload_derive_s": t4 - t3}
    log(f"c5_index: {sp.S} x {n_per_shard} docs ({int(lens.sum())} tokens), n_max {sp.n_max}, "
        f"{sp.dense_v} dense rows, {sp.nb_max} postings blocks per shard, {sp.nbytes()} pack "
        f"bytes (tier copies included), {on_card} bytes on the card after upload; generate "
        f"{t1 - t0:.1f} s, doc texts {t2 - t1:.1f} s, analyse + build (the card's route) + "
        f"stack {t3 - t2:.1f} s, upload + device derivation {t4 - t3:.1f} s; shard "
        f"0's impact codes equal the host derivation")


def phase_c5(device, state: dict) -> None:
    """C5 `_msearch` batches through msearch_sharded (fused at k=10, impact
    at k=25), 300 `_search` requests through StackedSearcher.search, one
    profiled batch at each k, and 64 rows against per-query `_search`."""
    import torch

    from elasticsearch_tpu_torch.corpus import sample_queries, traffic
    from elasticsearch_tpu_torch.ops import fused, kernels
    from elasticsearch_tpu_torch.ops.batched import impact_tie_class
    from elasticsearch_tpu_torch.parallel import msearch_sharded
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.query.nodes import mark_exact

    ss = state["c5_searcher"]
    sp = ss.sp
    lens, tok, crng = state["c5_corpus"]
    # bench.py's two timed batches, its warm-up batch, then two more
    b1, b2, warm, b3, b4 = (sample_queries(crng, lens, tok, C1_BATCH) for _ in range(5))
    for k in (10, 25):
        msearch_sharded(ss, "body", warm, k)
    sync(device)
    rows, results, result_arms = [], {}, {}
    totals = {10: dict.fromkeys(SHARDED_KERNELS, 0), 25: dict.fromkeys(SHARDED_KERNELS, 0)}
    chunks = -(-C1_BATCH // fused.QC)
    for k, batches in ((10, (b1, b2, b3, b4)), (25, (b1, b2))):
        for qs in batches:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = msearch_sharded(ss, "body", qs, k)
            wall = time.perf_counter() - t0
            launched = dict(kernels.launch_counts)
            st = ss.last_stats
            v, sh, dc, tt = out
            _check_msearch_rows(v, dc, tt, k, f"C5 k={k}")
            need = ("fused_tile_candidates", sp.S * chunks) if k == 10 else ("impact_gather", sp.S)
            if launched[need[0]] < need[1]:
                raise AssertionError(f"C5 k={k}: {need[0]} launched {launched[need[0]]} times, "
                                     f"expected >= {need[1]}")
            for n in SHARDED_KERNELS:
                totals[k][n] += launched[n]
            results.setdefault(k, out)
            result_arms.setdefault(k, _batch_arm(st["queries"]))
            rows.append({"k": k, "wall_ms": wall * 1e3, "qps": len(qs) / wall,
                         "plan_ms": st["plan_ms"], "arms": st["queries"],
                         "escalated": st.get("escalated", 0), "launches": launched})
            log(f"c5 batch k={k}: {wall * 1e3:.1f} ms, {len(qs) / wall:.0f} QPS, host planning "
                f"{st['plan_ms']:.1f} ms, arms {st['queries']}, escalated "
                f"{st.get('escalated', 0)}, launches {launched}")
    if sum(int(np.isfinite(r[0]).sum()) for r in results.values()) == 0:
        raise AssertionError("C5 msearch returned no hits")

    reqs = traffic(crng, lens, tok, 200, 100, 0)
    for q in reqs[:5]:
        ss.search(q)
    kernels.reset_launch_counts()
    lat = []
    for q in reqs:
        t0 = time.perf_counter()
        res = ss.search(q, size=10)
        lat.append((time.perf_counter() - t0) * 1e3)
        if len(res.scores) > 10 or not np.isfinite(res.scores).all():
            raise AssertionError(f"malformed C5 hits for {q}")
    search_launches = dict(kernels.launch_counts)
    if search_launches["scan_topk"] != len(reqs):
        raise AssertionError(f"C5 _search: scan_topk launched {search_launches['scan_topk']} "
                             f"times for {len(reqs)} requests")
    state.setdefault("sharded_launches", {}).update(c5_k10=totals[10], c5_k25=totals[25],
                                                    c5_search=search_launches)

    prof = {}
    for k in (10, 25):
        def batch():
            msearch_sharded(ss, "body", b4, k)
            sync(device)

        wall_us, ops = _profiled(batch)
        busy_us = sum(us for _, us in ops)
        per_kernel = _kernel_us(ops)
        prof[k] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                   **{f"{n}_ms": us / 1e3 for n, us in per_kernel.items()}}
        log(f"c5 profile k={k}: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
            f"({100 * busy_us / wall_us:.1f}%); "
            + ", ".join(f"{n} {us / 1e3:.2f} ms ({100 * us / busy_us:.1f}%)"
                        for n, us in per_kernel.items() if us))
        for key, us in ops[:8]:
            log(f"  device op {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {key[:100]}")

    # 64 rows of the first batch against per-query _search of bool.should
    worst, swapped = 0.0, 0
    for k in (10, 25):
        v, sh, dc, tt = results[k]
        for row, terms in enumerate(b1[:64]):
            want = ss.search(mark_exact(parse_query(_disjunction(terms), sp.mappings)), size=k)
            if tt[row] != want.total:
                raise AssertionError(f"C5 k={k}: total {tt[row]} vs _search {want.total}")
            fin = np.isfinite(v[row])
            tie = impact_tie_class(sp, "body", terms) if result_arms[k] == "impact" else 0.0
            swapped += _rows_match(v[row][fin].astype(np.float64),
                                   sh[row][fin] * sp.n_max + dc[row][fin],
                                   want.scores.astype(np.float64),
                                   want.doc_shards * sp.n_max + want.doc_ids,
                                   f"C5 k={k} {terms}", rtol=1e-5, tie=tie)
            if k == 10 and len(want.scores):
                worst = max(worst, float((np.abs(v[row][fin] - want.scores)
                                          / np.abs(want.scores)).max()))
    planner = _c5_planner(device, state, ss, [b1, b2])
    state.pop("c5_searcher")
    del ss
    _release(device)
    state["c5"] = {"rows": rows, "search_p50_ms": float(np.percentile(lat, 50)),
                   "search_p99_ms": float(np.percentile(lat, 99)), "profile": prof,
                   "planner": planner}
    parts = []
    for k in (10, 25):
        walls = [r["wall_ms"] for r in rows if r["k"] == k]
        parts.append(f"k={k}: {len(walls)} x {C1_BATCH} queries, wall p50 "
                     f"{np.percentile(walls, 50):.1f} ms, "
                     f"{len(walls) * C1_BATCH / (sum(walls) / 1e3):.0f} QPS")
    log(f"c5: {'; '.join(parts)}; _search {len(reqs)} requests p50 {np.percentile(lat, 50):.3f} ms "
        f"p99 {np.percentile(lat, 99):.3f} ms, scan_topk launches {search_launches['scan_topk']}; "
        f"64 rows at k=10 equal per-query _search on exact plans (max relative score difference "
        f"{worst:.3g}) and 64 at k=25 within the impact tie class ({swapped} positions swapped "
        f"among ties)")


# ---------------------------------------------------------------------------
# the REST server (rest/app.py, rest/server.py) and the serving wave
# ---------------------------------------------------------------------------

# docs of the write path's index and requests of the concurrency check:
# 50,000 and 1,024, cut from 100,000 and 2,048 when the full run took
# 1,194 s of its 1,200 s limit on a slow H100 host
REST_BULK_DOCS = 50_000
REST_BULK_CHUNK = 5_000  # docs per _bulk request
REST_CLIENTS = 32  # client threads of the concurrency check
REST_CONCURRENT = 1_024
# (kernel, a REST path that must launch it)
REST_KERNEL_PATHS = (("scan_topk", "search"), ("fused_tile_candidates", "msearch_10"),
                     ("impact_gather", "msearch_25"), ("tiered_candidates", "msearch_25"),
                     ("ann_gather_scan", "knn_search"), ("scan_topk", "phrase"))


def _engine(state: dict, device):
    """The Engine every index of the script lives in (made at first use)."""
    if "engine" not in state:
        from elasticsearch_tpu_torch.engine import Engine

        state["engine"] = Engine(device=device)
        # every refresh of the run stays in the RefreshProfile ring
        state["engine"].settings.update({"transient": {"indexing.profile.size": 4096}})
    return state["engine"]


def _drop_index(state: dict, name: str, key: str, device) -> None:
    """Delete an index from the engine and the script's state, and free its
    device memory."""
    engine = state.get("engine")
    if engine is not None and name in engine.indices:
        engine.delete_index(name)
    state.pop(key, None)
    _release(device)


class _Client:
    """One keep-alive HTTP/1.1 connection to the server, with TCP_NODELAY as
    Elasticsearch's Python client (urllib3) sets it: http.client sends a
    request's headers and body in two writes, and under Nagle the body
    waits for the server's delayed ACK."""

    def __init__(self, port: int):
        import http.client
        import socket

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        self.conn.connect()
        self.conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def __call__(self, method: str, path: str, body=None, raw: bytes | None = None):
        if raw is None:
            raw = b"" if body is None else json.dumps(body).encode()
        self.conn.request(method, path, body=raw, headers={"Content-Type": "application/json"})
        r = self.conn.getresponse()
        out = r.read()
        t0 = time.perf_counter()
        resp = json.loads(out) if out else None
        self.last_bytes, self.last_decode_ms = len(out), (time.perf_counter() - t0) * 1e3
        return r.status, dict(r.getheaders()), resp

    def close(self):
        self.conn.close()


def _serve(state: dict, device):
    """A RestApp over the script's engine on 127.0.0.1:<free port>, and a
    first client."""
    from elasticsearch_tpu_torch.rest import make_app
    from elasticsearch_tpu_torch.rest.server import serve

    server = serve(make_app(_engine(state, device)), "127.0.0.1", 0)
    return server, _Client(server.port)


def _ndjson(lines) -> bytes:
    return ("\n".join(json.dumps(x) for x in lines) + "\n").encode()


def _rest_path(state: dict, path: str, fn):
    """Run one REST path between a reset and a read of the launch counts,
    kept under state["rest_launches"][path]. -> fn()'s result."""
    from elasticsearch_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    out = fn()
    state.setdefault("rest_launches", {})[path] = dict(kernels.launch_counts)
    return out


def _strip(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in ("took", "_shards", "timed_out")}


def _same_hits(got: dict, want: dict, what: str) -> None:
    """The REST answer carries EsIndex.search's answer byte for byte."""
    if json.dumps(_strip(got), sort_keys=True) != json.dumps(want, sort_keys=True):
        raise AssertionError(f"{what}: the REST answer differs from EsIndex.search's")


class _WaveArms:
    """Records the execution planner's arm of every term-lane wave: a scope
    in which the engine's `msearch_wave_begin` reads its searcher's
    `last_stats` just after each batch (on the engine thread, which runs
    the batches one by one) and files each query, as (field, terms, k),
    under the batch's arm."""

    def __init__(self):
        self.arms: dict = {}

    def __enter__(self):
        from elasticsearch_tpu_torch.engine import engine as engine_mod
        from elasticsearch_tpu_torch.parallel import StackedSearcher

        self._mod, begin = engine_mod, engine_mod.msearch_wave_begin

        def recorded(ss, fld, queries, k=10):
            st = begin(ss, fld, queries, k)
            stats = ss.last_stats if isinstance(ss, StackedSearcher) else ss.batched().last_stats
            arm = _batch_arm(stats["queries"])
            for terms in queries:
                self.arms.setdefault(_term_key(fld, terms, k), set()).add(arm)
            return st

        self._begin = begin
        engine_mod.msearch_wave_begin = recorded
        return self

    def __exit__(self, *exc):
        self._mod.msearch_wave_begin = self._begin

    def of(self, idx, query: dict, k: int) -> set:
        """The arms the waves took for `query` at k (raises when no wave
        carried it)."""
        spec = _term_spec(idx, query)
        arms = self.arms.get(_term_key(*spec, k)) if spec else None
        if not arms:
            raise AssertionError(f"no term-lane wave carried {query} at k={k}")
        return arms


def _term_key(fld: str, terms, k: int) -> tuple:
    return fld, tuple((t, float(b)) for t, b in terms), k


def _term_spec(idx, query: dict):
    """(field, terms) of a query on the term lane, else None."""
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.serving.coalesce import term_disjunction_of

    return term_disjunction_of(parse_query(query, idx.mappings))


def _arm_tie(idx, query: dict, arms: set) -> float:
    """The tie class two answers of one term disjunction are held to, from
    the arms that gave them (read from `last_stats`): 0 where every arm
    scores exact BM25 (fused, exact) or every arm is the impact arm (the
    same codes); the impact tier's quantization class where they mix."""
    if "impact" not in arms or arms == {"impact"}:
        return 0.0
    return _impact_class(idx, query)


def _impact_class(idx, query: dict) -> float:
    """The impact tier's quantization tie class of a term-lane query."""
    from elasticsearch_tpu_torch.ops.batched import impact_tie_class

    pack = idx.searcher.pack if idx.num_shards == 1 else idx.searcher.sp
    return impact_tie_class(pack, *_term_spec(idx, query))


def _wave_rows_match(got: dict, want: dict, tie: float, what: str, rtol: float = 1e-5) -> int:
    """Under the wave contract: totals equal below 10,000 (at or above it a
    batched arm's total may be a lower bound: at least 10,000 and at most an
    exact `want`), scores within `tie` + rtol relative, ids equal up to ties
    within that. -> positions swapped."""
    g, w = got["hits"], want["hits"]
    gt, wt = g["total"]["value"], w["total"]["value"]
    if (gt != wt) if wt < 10_000 else gt < 10_000:
        raise AssertionError(f"{what}: total {gt} vs {wt}")
    gs = np.array([h["_score"] for h in g["hits"]], np.float64)
    ws = np.array([h["_score"] for h in w["hits"]], np.float64)
    gi = np.array([h["_id"] for h in g["hits"]], object)
    wi = np.array([h["_id"] for h in w["hits"]], object)
    return _rows_match(gs[None], gi[None], ws[None], wi[None], what, rtol=rtol, tie=tie)


def _percentiles(ms: list) -> str:
    return f"p50 {np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} ms"


def _concurrent(port: int, requests: list, n_clients: int) -> tuple[list, list, float]:
    """`requests` ((method, path, body)) from n_clients threads, each on its
    own keep-alive connection. -> (responses in order, latencies ms, wall s)."""
    import threading

    out, lat = [None] * len(requests), [0.0] * len(requests)
    it = iter(range(len(requests)))
    lock = threading.Lock()
    errors = []

    def client():
        c = _Client(port)
        try:
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                t0 = time.perf_counter()
                status, _, resp = c(*requests[i])
                lat[i] = (time.perf_counter() - t0) * 1e3
                if status != 200:
                    raise AssertionError(f"status {status}: {resp}")
                out[i] = resp
        except Exception as ex:  # noqa: BLE001 - re-raised below
            errors.append(ex)
        finally:
            c.close()

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return out, lat, wall


def _serving_delta(after: dict, before: dict) -> dict:
    """The serving counters of one path: waves, mean wave size, the summed
    ms of the wave stages (begin and finish on the engine thread, fetch on
    the completer, each wave from claim to finish)."""
    d = {k: after[k] - before.get(k, 0) for k in
         ("waves", "completed", "term_packed", "fallback_solo", "coalesced", "shed", "expired")}
    d["mean_wave"] = d["completed"] / max(d["waves"], 1)
    d["avg_term_occupancy"] = after["wave"]["avg_term_occupancy"]
    d["stage_ms"] = {k: v - before["wave"]["stage_ms_total"][k]
                     for k, v in after["wave"]["stage_ms_total"].items()}
    return d


def _direct_p50(idx, requests) -> float:
    """EsIndex.search's p50 ms on (query, size, from_) requests, as REST
    would run them (the REST overhead's baseline, measured beside it)."""
    lat = []
    for q, size, from_ in requests:
        t0 = time.perf_counter()
        idx.search(q, size=size, from_=from_)
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50))


def _msearch_body(bodies, index: str) -> bytes:
    return _ndjson([x for b in bodies for x in ({"index": index}, b)])


def phase_rest(device, rng, state: dict) -> None:
    """The REST path on the 1M-doc index of phase index, over HTTP/1.1
    keep-alive to `rest.server.serve` on 127.0.0.1: the write path
    (`_bulk` of 50,000 docs into a new index, `_refresh`, 200 `_search`es
    against EsIndex.search), the traffic phase's 600 `_search`es (one
    client, against their EsIndex.search answers), 1,024 C1 `_search`es from
    32 clients with serving off and on, 4,096-body `_msearch`es at size 10
    and 25 with serving on (against EsIndex.msearch) and 512 with serving
    off, and the error envelopes."""
    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, sample_queries, traffic

    engine = _engine(state, device)
    idx = state["index"]
    lens, tok = state["corpus"]
    server, c = _serve(state, device)
    out = {}
    try:
        # 1. the write path
        n = REST_BULK_DOCS
        docs = corpus_docs(lens[:n], tok[: int(lens[:n].sum())], state["nums"][:n])
        if c("PUT", "/rest_bm25", {"mappings": MAPPINGS})[0] != 200:
            raise AssertionError("PUT /rest_bm25 failed")

        def write():
            t0 = time.perf_counter()
            for a in range(0, n, REST_BULK_CHUNK):
                raw = _ndjson([x for i in range(a, min(a + REST_BULK_CHUNK, n))
                               for x in ({"index": {"_id": str(i)}}, docs[i])])
                status, _, resp = c("POST", "/rest_bm25/_bulk", raw=raw)
                if status != 200 or resp["errors"]:
                    raise AssertionError(f"_bulk failed: {status}")
            t1 = time.perf_counter()
            if c("POST", "/rest_bm25/_refresh")[2]["_shards"]["failed"]:
                raise AssertionError("_refresh failed")
            sync(device)
            return t1 - t0, time.perf_counter() - t1

        bulk_s, refresh_s = _rest_path(state, "write", write)
        del docs
        small = engine.get_index("rest_bm25")
        if small.searcher.pack.num_docs != n:
            raise AssertionError(f"rest_bm25 holds {small.searcher.pack.num_docs} docs")
        for q in traffic(rng, lens[:n], tok[: int(lens[:n].sum())], 120, 40, 40):
            status, _, resp = c("POST", "/rest_bm25/_search", {"query": q, "size": 10})
            if status != 200:
                raise AssertionError(f"_search on rest_bm25: {status}")
            _same_hits(resp, small.search(q, size=10), f"rest_bm25 {q}")
        out["write"] = {"docs": n, "bulk_s": bulk_s, "docs_per_s": n / bulk_s,
                        "refresh_s": refresh_s}
        log(f"rest write: _bulk of {n} docs in {n // REST_BULK_CHUNK} requests {bulk_s:.2f} s "
            f"({n / bulk_s:.0f} docs/s), _refresh {refresh_s:.2f} s; 200 _search answers equal "
            f"EsIndex.search's")

        # warm-up: the batched arms' first use on the 1M-doc index (tier
        # copies, pinned buffers) through waves of both sizes
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": True}})
        for size in (10, 25):
            warm = [{"query": {"match": {"body": " ".join(t for t, _ in q)}}, "size": size}
                    for q in sample_queries(rng, lens, tok, 512)]
            if c("POST", "/_msearch", raw=_msearch_body(warm, "corpus"))[0] != 200:
                raise AssertionError("warm-up _msearch failed")
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})

        # 2. the traffic phase's requests on the 1M-doc index, one client
        requests, results = state["requests"], state["results"]
        for q, size, from_ in requests[:5]:
            c("POST", "/corpus/_search", {"query": q, "size": size, "from": from_})

        def search():
            lat = {(10, 0): [], (20, 5): []}
            for (q, size, from_), want in zip(requests, results):
                t0 = time.perf_counter()
                status, _, resp = c("POST", "/corpus/_search",
                                    {"query": q, "size": size, "from": from_})
                lat[(size, from_)].append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"_search {status}: {resp}")
                _same_hits(resp, want, f"corpus {q}")
            return lat

        lat = _rest_path(state, "search", search)
        if state["rest_launches"]["search"]["scan_topk"] != len(requests):
            raise AssertionError("REST _search: not one scan_topk launch per request")
        base = state.get("traffic_p50", {})  # phase traffic's EsIndex.search p50
        beside = {key: _direct_p50(idx, [r for r in requests if r[1:] == key]) for key in lat}
        out["search"] = {f"{s},{f}": {
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "esindex_p50_ms_traffic": base.get((s, f)), "esindex_p50_ms_beside": beside[(s, f)]}
            for (s, f), ms in lat.items()}
        log("rest search: 600 requests equal EsIndex.search's answers; " + "; ".join(
            f"size={s} from={f}: {_percentiles(ms)} (EsIndex.search p50 "
            f"{base.get((s, f), float('nan')):.3f} ms in phase traffic, "
            f"{beside[(s, f)]:.3f} ms just after; REST overhead "
            f"{np.percentile(ms, 50) - base.get((s, f), float('nan')):.3f} / "
            f"{np.percentile(ms, 50) - beside[(s, f)]:.3f} ms)"
            for (s, f), ms in lat.items()))

        # 3. concurrency: C1 term disjunctions, serving off, then on
        qs = sample_queries(rng, lens, tok, REST_CONCURRENT)
        bodies = [{"query": {"match": {"body": " ".join(t for t, _ in q)}}, "size": 10}
                  for q in qs]
        reqs = [("POST", "/corpus/_search", b) for b in bodies]
        _concurrent(server.port, reqs[:64], REST_CLIENTS)  # warm-up
        conc = {}
        waves = _WaveArms()
        for mode in ("off", "on"):
            st = c("PUT", "/_cluster/settings",
                   {"transient": {"serving.enabled": mode == "on"}})
            if st[0] != 200:
                raise AssertionError("PUT /_cluster/settings failed")
            before = c("GET", "/_serving/stats")[2]["serving"]
            with waves:
                resp, lat, wall = _rest_path(
                    state, f"concurrent_{mode}",
                    lambda: _concurrent(server.port, reqs, REST_CLIENTS))
            after = c("GET", "/_serving/stats")[2]["serving"]
            conc[mode] = {"responses": resp, "qps": len(reqs) / wall, "wall_s": wall,
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p99_ms": float(np.percentile(lat, 99)),
                          "serving": _serving_delta(after, before)}
        # each answer against exact BM25 plans: serving off, the solo
        # `_search` on the impact tier, in its tie class; serving on, in the
        # tie class only where the wave took the impact arm, else exact
        swapped = 0
        for j, b in enumerate(bodies):
            on, off = conc["on"]["responses"][j], conc["off"]["responses"][j]
            want = {"hits": _exact_hits(idx, b["query"], 10)}
            tie = _impact_class(idx, b["query"])
            swapped += _wave_rows_match(off, want, tie, f"concurrent off {b}")
            arms = waves.of(idx, b["query"], 10)
            swapped += _wave_rows_match(on, want, tie if "impact" in arms else 0.0,
                                        f"concurrent on {b} (arms {sorted(arms)})")
            if on["hits"]["total"]["value"] > off["hits"]["total"]["value"]:
                raise AssertionError(f"concurrent {b}: a total above the exact one")
        if conc["on"]["serving"]["waves"] == 0 or conc["off"]["serving"]["waves"] != 0:
            raise AssertionError(f"serving counters {conc['on']['serving']}")
        out["concurrent"] = {m: {k: v for k, v in d.items() if k != "responses"}
                             for m, d in conc.items()}
        log(f"rest concurrent: {len(reqs)} C1 _search from {REST_CLIENTS} clients; " + "; ".join(
            f"serving {m}: {d['qps']:.0f} QPS, p50 {d['p50_ms']:.3f} ms p99 {d['p99_ms']:.3f} ms"
            f", serving {d['serving']}" for m, d in out["concurrent"].items())
            + f"; answers held to exact BM25 plans: serving off in the impact tie class, serving "
            f"on exactly except where the wave took the impact arm (wave arms "
            f"{sorted(set().union(*waves.arms.values()))}; {swapped} positions swapped in ties)")

        # 4. _msearch: 4,096 C1 bodies with serving on, against EsIndex.msearch
        ms = {}
        mbodies = bodies + [{"query": {"match": {"body": " ".join(t for t, _ in q)}}, "size": 10}
                            for q in sample_queries(rng, lens, tok, C1_BATCH - len(bodies))]
        for size in (10, 25):
            sb = [{**b, "size": size} for b in mbodies]
            raw = _msearch_body(sb, "corpus")
            before = c("GET", "/_serving/stats")[2]["serving"]

            def run():
                t0 = time.perf_counter()
                status, _, resp = c("POST", "/_msearch", raw=raw)
                return status, resp, time.perf_counter() - t0

            with waves:
                status, resp, wall = _rest_path(state, f"msearch_{size}", run)
            resp_mb, decode_ms = c.last_bytes / 1e6, c.last_decode_ms
            after = c("GET", "/_serving/stats")[2]["serving"]
            t0 = time.perf_counter()
            want = idx.msearch([{"query": b["query"], "size": size} for b in sb])
            es_wall = time.perf_counter() - t0
            direct = _batch_arm(idx.searcher.batched().last_stats["queries"])
            bad = [r for r in resp["responses"] if r["status"] != 200]
            if status != 200 or bad:
                raise AssertionError(f"_msearch size={size}: {status}, {len(bad)} failed: "
                                     f"{bad[:1]}")
            swapped = 0
            for j, (g, w) in enumerate(zip(resp["responses"], want["responses"])):
                arms = waves.of(idx, sb[j]["query"], size) | {direct}
                swapped += _wave_rows_match(g, w, _arm_tie(idx, sb[j]["query"], arms),
                                            f"_msearch size={size} [{j}] (arms {sorted(arms)})",
                                            rtol=1e-6)
            ms[size] = {"wall_ms": wall * 1e3, "qps": len(sb) / wall,
                        "esindex_msearch_wall_ms": es_wall * 1e3,
                        "response_mb": resp_mb, "client_decode_ms": decode_ms,
                        "serving": _serving_delta(after, before), "swapped": swapped}
        # the card's busy share: one _msearch at size 10 (serving on) and
        # 100 `_search`es (serving off) under torch.profiler
        sample = requests[:: len(requests) // 100][:100]
        if device.type == "cuda":
            raw10 = _msearch_body([{**b, "size": 10} for b in mbodies], "corpus")
            ms_us, ops = _profiled(lambda: c("POST", "/_msearch", raw=raw10))
            ms["profile_10"] = {"wall_ms": ms_us / 1e3,
                                "device_busy_ms": sum(us for _, us in ops) / 1e3,
                                **{f"{n}_ms": us / 1e3 for n, us in _kernel_us(ops).items()}}
            c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})
            s_us, ops = _profiled(lambda: [c("POST", "/corpus/_search",
                                             {"query": q, "size": sz, "from": f})
                                           for q, sz, f in sample])
            out["search"]["profile"] = {"requests": len(sample), "wall_ms": s_us / 1e3,
                                        "device_busy_ms": sum(us for _, us in ops) / 1e3}
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})
        solo = [{**b, "size": 10} for b in mbodies[:512]]
        t0 = time.perf_counter()
        status, _, resp = c("POST", "/_msearch", raw=_msearch_body(solo, "corpus"))
        solo_wall = time.perf_counter() - t0
        if status != 200 or {r["status"] for r in resp["responses"]} != {200}:
            raise AssertionError("_msearch with serving off failed")
        ms["solo_512_wall_ms"] = solo_wall * 1e3
        out["msearch"] = ms
        log("rest msearch: " + "; ".join(
            f"size={s}: {C1_BATCH} bodies {d['wall_ms']:.1f} ms ({d['qps']:.0f} QPS; "
            f"EsIndex.msearch {d['esindex_msearch_wall_ms']:.1f} ms), serving {d['serving']}, "
            f"rows match EsIndex.msearch ({d['swapped']} positions swapped in ties)"
            for s, d in ms.items() if s in (10, 25))
            + f"; 512 bodies with serving off (sequential solo) {solo_wall * 1e3:.1f} ms; "
            f"profiled: _msearch size=10 {ms.get('profile_10')}, 100 _search "
            f"{out['search'].get('profile')}")

        # the wave contract on the card: each of 32 C1 rows in a padded wave
        # against its 1-query wave (totals equal, scores within 1e-6
        # relative, ids up to ties), and how many are byte-equal
        from elasticsearch_tpu_torch.parallel.sharded import msearch_wave

        wq = sample_queries(rng, lens, tok, 32)
        same = {}
        for k in (10, 25):
            (v, sh, dc, tt), tier = msearch_wave(idx.searcher, "body", wq, k)
            same[k] = 0
            for j, q in enumerate(wq):
                (v1, sh1, dc1, tt1), _ = msearch_wave(idx.searcher, "body", [q], k)
                if tt1[0] != tt[j]:
                    raise AssertionError(f"wave k={k}: total {tt[j]} vs 1-query {tt1[0]}")
                _rows_match(v[j:j + 1].astype(np.float64), dc[j:j + 1],
                            v1[:1].astype(np.float64), dc1[:1], f"wave row k={k} {q}")
                same[k] += v[j].tobytes() == v1[0].tobytes() and np.array_equal(dc[j], dc1[0])
        ms["wave_rows_byte_equal"] = {k: f"{n}/{len(wq)}" for k, n in same.items()}
        log(f"rest wave contract: rows of a padded wave of {len(wq)} against their 1-query "
            f"waves byte-equal {ms['wave_rows_byte_equal']}, the rest within 1e-6 relative")

        # 7. error envelopes
        status, _, resp = c("POST", "/no_such_index/_search", {"query": {"match_all": {}}})
        if status != 404 or resp["error"]["type"] != "index_not_found_exception":
            raise AssertionError(f"unknown index: {status} {resp}")
        status, _, resp = c("POST", "/corpus/_search", {"query": {"no_such_query": {}}})
        if status != 400:
            raise AssertionError(f"bad query: {status} {resp}")
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": True}})
        breaker = engine.breakers.children["in_flight_requests"]
        breaker.limit = 1
        try:
            status, headers, resp = c("POST", "/corpus/_search", bodies[0])
        finally:
            breaker.limit = engine.breakers.total
        if (status != 429 or resp["error"]["type"] != "circuit_breaking_exception"
                or int(headers.get("Retry-After", 0)) < 1):
            raise AssertionError(f"breaker trip: {status} {headers} {resp}")
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})
        if engine.serving._reserved_bytes:
            raise AssertionError("in_flight_requests reservations leaked")
        log("rest errors: unknown index 404 index_not_found_exception, bad query 400, "
            "in_flight_requests limit 1 -> 429 circuit_breaking_exception with Retry-After "
            f"{headers['Retry-After']}")
    finally:
        c.close()
        server.stop()
    engine.delete_index("rest_bm25")
    state["rest"] = out


def phase_rest_shards(device, rng, state: dict) -> None:
    """The REST path on the 8-shard 1M-doc index of phase shards: the
    traffic phase's 300 size=10 requests (against EsIndex.search) and one
    4,096-body `_msearch` with serving on (against EsIndex.msearch). Then
    the index is released."""
    from elasticsearch_tpu_torch.corpus import sample_queries

    idx = state["shards_index"]
    lens, tok = state["corpus"]
    server, c = _serve(state, device)
    try:
        requests = [(q, s, f) for q, s, f in state["requests"] if (s, f) == (10, 0)]
        base = _direct_p50(idx, requests)

        def search():
            lat, got = [], []
            for q, size, from_ in requests:
                t0 = time.perf_counter()
                status, _, resp = c("POST", "/shards/_search", {"query": q, "size": size})
                lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"8-shard _search {status}")
                got.append(resp)
            return lat, got

        lat, got = _rest_path(state, "shards_search", search)
        if state["rest_launches"]["shards_search"]["scan_topk"] != len(requests):
            raise AssertionError("8-shard REST _search: not one scan_topk launch per request")
        for (q, size, _), resp in zip(requests, got):
            _same_hits(resp, idx.search(q, size=size), f"8 shards {q}")
        bodies = [{"query": {"match": {"body": " ".join(t for t, _ in q)}}, "size": 10}
                  for q in sample_queries(rng, lens, tok, C1_BATCH)]
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": True}})
        before = c("GET", "/_serving/stats")[2]["serving"]

        def run():
            t0 = time.perf_counter()
            status, _, resp = c("POST", "/_msearch", raw=_msearch_body(bodies, "shards"))
            return status, resp, time.perf_counter() - t0

        with _WaveArms() as waves:
            status, resp, wall = _rest_path(state, "shards_msearch", run)
        after = c("GET", "/_serving/stats")[2]["serving"]
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})
        t0 = time.perf_counter()
        want = idx.msearch(bodies)
        es_wall = time.perf_counter() - t0
        direct = _batch_arm(idx.searcher.last_stats["queries"])
        if status != 200 or {r["status"] for r in resp["responses"]} != {200}:
            raise AssertionError(f"8-shard _msearch {status}")
        swapped = 0
        for j, (g, w) in enumerate(zip(resp["responses"], want["responses"])):
            arms = waves.of(idx, bodies[j]["query"], 10) | {direct}
            swapped += _wave_rows_match(g, w, _arm_tie(idx, bodies[j]["query"], arms),
                                        f"8-shard _msearch [{j}] (arms {sorted(arms)})",
                                        rtol=1e-6)
    finally:
        c.close()
        server.stop()
    state.setdefault("rest", {})["shards"] = {
        "search_p50_ms": float(np.percentile(lat, 50)), "esindex_search_p50_ms": base,
        "search_p99_ms": float(np.percentile(lat, 99)),
        "msearch_wall_ms": wall * 1e3, "esindex_msearch_wall_ms": es_wall * 1e3,
        "serving": _serving_delta(after, before)}
    log(f"rest_shards: {len(requests)} _search equal EsIndex.search's, {_percentiles(lat)} "
        f"(EsIndex.search p50 {base:.3f} ms beside it); "
        f"_msearch of {len(bodies)} bodies (serving on) {wall * 1e3:.1f} ms (EsIndex.msearch "
        f"{es_wall * 1e3:.1f} ms), serving {_serving_delta(after, before)}, rows match "
        f"EsIndex.msearch ({swapped} positions swapped in ties)")
    _drop_index(state, "shards", "shards_index", device)


def phase_rest_knn(device, state: dict) -> None:
    """100 kNN `_search` bodies over REST on the kNN index of phase
    knn_index, each equal to EsIndex.search(knn=...)'s answer."""
    idx = state["knn_index"]
    server, c = _serve(state, device)
    try:
        requests = state["knn_requests"][:100]
        lat0 = []
        for b, size, from_ in requests:
            t0 = time.perf_counter()
            idx.search(knn=b, size=size, from_=from_)
            lat0.append((time.perf_counter() - t0) * 1e3)
        base = float(np.percentile(lat0, 50))

        def search():
            lat, got = [], []
            for b, size, from_ in requests:
                t0 = time.perf_counter()
                status, _, resp = c("POST", f"/{idx.name}/_search",
                                    {"knn": b, "size": size, "from": from_})
                lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"kNN _search {status}: {resp}")
                got.append(resp)
            return lat, got

        lat, got = _rest_path(state, "knn_search", search)
        lat_nosrc = []  # the same requests without the 384-float sources in the hits
        for b, size, from_ in requests:
            t0 = time.perf_counter()
            status, _, resp = c("POST", f"/{idx.name}/_search",
                                {"knn": b, "size": size, "from": from_, "_source": False})
            lat_nosrc.append((time.perf_counter() - t0) * 1e3)
            if status != 200 or any("_source" in h for h in resp["hits"]["hits"]):
                raise AssertionError(f"kNN _search with _source false: {status}")
    finally:
        c.close()
        server.stop()
    for (b, size, from_), resp in zip(requests, got):
        _same_hits(resp, idx.search(knn=b, size=size, from_=from_), "kNN _search")
    unfiltered = sum(1 for b, _, _ in requests if "filter" not in b)
    if state["rest_launches"]["knn_search"]["ann_gather_scan"] != unfiltered:
        raise AssertionError("REST kNN: not one ann_gather_scan launch per unfiltered request")
    state.setdefault("rest", {})["knn"] = {
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "esindex_search_p50_ms": base, "no_source_p50_ms": float(np.percentile(lat_nosrc, 50))}
    log(f"rest_knn: {len(requests)} kNN _search ({unfiltered} unfiltered) equal "
        f"EsIndex.search(knn=...)'s, {_percentiles(lat)} (EsIndex.search p50 {base:.3f} ms "
        f"beside it; with _source false p50 {np.percentile(lat_nosrc, 50):.3f} ms)")
    _rest_hybrid(device, state)


REST_HYBRID = 50  # hybrid `_search`es over REST, each serving mode
REST_MSEARCH_KNN = 512  # bodies of the mixed kNN `_msearch`


def _rest_hybrid(device, state: dict) -> None:
    """Over REST on the kNN index, with serving off and then on: hybrid
    `_search`es and one `_msearch` of 512 bodies mixing kNN-only, hybrid
    and text bodies (`and` matches and bool filters: the generic lane);
    each answer equal to EsIndex.search's on the same body."""
    idx = state["knn_index"]
    lens, tok = state["knn_index_text"]
    near = state["knn_index_near"]
    rng = np.random.default_rng(7)
    hybrid = _hybrid_requests(rng, lens, tok, near, REST_HYBRID)
    bodies = []
    for j, (q, kb) in enumerate(_hybrid_requests(rng, lens, tok, near, REST_MSEARCH_KNN)):
        kind = j % 3
        if kind == 0:
            bodies.append({"knn": kb, "size": 10})
        elif kind == 1:
            bodies.append({"query": q, "knn": kb, "size": 10})
        elif j % 2:
            bodies.append({"query": {"match": {"body": {"query": q["match"]["body"],
                                                        "operator": "and"}}}, "size": 10})
        else:
            lo = int(rng.integers(0, 600_000))
            bodies.append({"query": {"bool": {"must": [q], "filter": [
                {"range": {"n": {"gte": lo, "lt": lo + 400_000}}}]}}, "size": 10})
    want_h = [idx.search(q, knn=kb, size=10) for q, kb in hybrid]
    want_m = [idx.search(b.get("query"), knn=b.get("knn"), size=10) for b in bodies]
    server, c = _serve(state, device)
    out = {}
    try:
        for mode in ("off", "on"):
            c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": mode == "on"}})

            def run():
                lat = []
                for (q, kb), want in zip(hybrid, want_h):
                    t0 = time.perf_counter()
                    status, _, resp = c("POST", f"/{idx.name}/_search",
                                        {"query": q, "knn": kb, "size": 10})
                    lat.append((time.perf_counter() - t0) * 1e3)
                    if status != 200:
                        raise AssertionError(f"hybrid _search {status}: {resp}")
                    _same_hits(resp, want, f"REST hybrid, serving {mode}")
                t0 = time.perf_counter()
                status, _, resp = c("POST", f"/{idx.name}/_msearch",
                                    raw=_msearch_body(bodies, idx.name))
                wall = (time.perf_counter() - t0) * 1e3
                if status != 200:
                    raise AssertionError(f"kNN _msearch {status}")
                for b, r, want in zip(bodies, resp["responses"], want_m):
                    if r.pop("status") != 200:
                        raise AssertionError(f"kNN _msearch body {b}: {r}")
                    _same_hits(r, want, f"REST kNN _msearch, serving {mode}")
                return lat, wall

            lat, wall = _rest_path(state, f"knn_mixed_{mode}", run)
            out[mode] = {"hybrid": _p(lat), "msearch_ms": wall}
    finally:
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})
        c.close()
        server.stop()
    state["rest"]["knn_mixed"] = out
    log("rest_knn: " + "; ".join(
        f"serving {m}: {REST_HYBRID} hybrid _search equal EsIndex.search's, p50 "
        f"{o['hybrid']['p50_ms']:.3f} ms p99 {o['hybrid']['p99_ms']:.3f} ms; a {len(bodies)}-body "
        f"_msearch (kNN-only, hybrid, text) {o['msearch_ms']:.1f} ms, every response equal "
        f"EsIndex.search's" for m, o in out.items()))


KNN_SHARDS = 4
# 4 x 12,500, cut in depth from 4 x 50,000 (each shard the size of the
# one-shard kNN index): that took 195 s to index and 67 + 89 s in phases
# knn_shards and hybrid on an H100 host, which put the full run above
# ~800 s of its 1,200 s limit; then from 4 x 25,000 when the full run took
# 1,194 s on a slow H100 host
KNN_SHARD_DOCS = 50_000
KNN_SHARD_REQUESTS = 200
KNN_WRITE_ROUNDS = 4
KNN_WRITE_UPDATES, KNN_WRITE_DELETES, KNN_WRITE_NEW = 500, 250, 500
HYBRID_REQUESTS = 60  # cut from 200 with KNN_SHARD_DOCS, from 100 for slice 18's phases
HYBRID_KNN_BOOST = 5.0
HYBRID_CPU_SECTIONS = 64


def _hit_rows_of(out: dict):
    """A response's hits -> (scores f64, ids object) arrays and its total."""
    hits = out["hits"]["hits"]
    return (np.array([h["_score"] for h in hits], np.float64),
            np.array([h["_id"] for h in hits], object), out["hits"].get("total", {}).get("value"))


def _against_cpu(cpu, calls, answers, what: str, wants=None) -> tuple[float, int, int]:
    """Each (kwargs of EsIndex.search, card answer) against the cpu twin's
    answer (or `wants`, answers computed on the host otherwise): totals
    equal, scores within 1e-6 relative, ids up to fp-ties. -> (largest
    relative score difference, positions swapped, answers byte-equal)."""
    worst, swapped, equal = 0.0, 0, 0
    for j, (kw, got) in enumerate(zip(calls, answers)):
        gs, gi, gt = _hit_rows_of(got)
        ws, wi, wt = _hit_rows_of(cpu.search(**kw) if wants is None else wants[j])
        if gt != wt or gs.shape != ws.shape:
            raise AssertionError(f"{what}: total {gt} vs the cpu run's {wt}")
        swapped += _rows_match(gs[None], gi[None], ws[None], wi[None], what)
        equal += int(np.array_equal(gs, ws) and np.array_equal(gi, wi))
        if len(ws):
            worst = max(worst, float((np.abs(gs - ws) / np.abs(ws)).max()))
    return worst, swapped, equal


def _timed_searches(idx, calls, warm: int = 5) -> tuple[list, list, dict]:
    """Run EsIndex.search on each kwargs between a reset and a read of the
    launch counts, after `warm` of them. -> (latencies ms, answers,
    launches)."""
    from elasticsearch_tpu_torch.ops import kernels

    for kw in calls[:warm]:  # warm-up
        idx.search(**kw)
    kernels.reset_launch_counts()
    lat, out = [], []
    for kw in calls:
        t0 = time.perf_counter()
        out.append(idx.search(**kw))
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat, out, dict(kernels.launch_counts)


def _p(lat) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def _knn_hits_ok(out: dict, k: int, what: str) -> None:
    hits = out["hits"]["hits"]
    sc = [h["_score"] for h in hits]
    if (len(hits) != k or sc != sorted(sc, reverse=True) or not np.isfinite(sc).all()
            or out["hits"]["total"]["value"] != k):
        raise AssertionError(f"{what}: malformed kNN hits")


def phase_knn_shards_index(device, rng, n_docs: int, state: dict) -> None:
    """50,000 docs like the kNN index's (C4 vectors, 384 dims, cosine,
    int8_hnsw; a C1 text; a long; a keyword `tag` on the docs whose n is a
    multiple of 3) through an EsIndex of 4 shards: index_doc, refresh
    (murmur3 routing, each shard's k-means on the card, the tiles stacked
    to the widest (C, L)). The C4 ANN corpus of phase knn_index is released
    first."""
    from elasticsearch_tpu_torch.corpus import N_MAX, doc_texts, make_corpus, vector_corpus

    for key in ("ann_searcher", "ann_host", "knn_vecs", "knn_near"):
        state.pop(key, None)
    _release(device)
    D = 384
    ncl = max(16, int(n_docs ** 0.5 * 0.75))
    vecs, near = vector_corpus(rng, n_docs, D, ncl, KNN_SHARD_REQUESTS)
    nums = rng.integers(0, N_MAX, size=n_docs)
    lens, tok, _ = make_corpus(rng, n_docs)
    texts = doc_texts(lens, tok)
    idx = _engine(state, device).create_index(
        "vectors4", _knn_mapping(D), {"number_of_shards": KNN_SHARDS})
    t0 = time.perf_counter()
    rows = vecs.tolist()
    for i in range(n_docs):
        src = {"vec": rows[i], "n": int(nums[i]), "body": texts[i]}
        if nums[i] % 3 == 0:
            src["tag"] = f"g{nums[i] % 5}"
        idx.index_doc(str(i), src)
    del rows, texts
    t1 = time.perf_counter()
    before = _on_card(device)
    idx.refresh()
    sync(device)
    t2 = time.perf_counter()
    sp = idx.searcher.sp
    vc = sp.vectors["vec"]
    if vc.ann is None:
        raise AssertionError("the 4-shard int8_hnsw field built no stacked ANN index")
    per_shard = [(int(p.vectors["vec"].ann["nlist"]), int(p.vectors["vec"].ann["tile"]))
                 for p in sp.shards]
    state.update(knn_shards_index=idx, knn_shards_vecs=vecs, knn_shards_near=near,
                 knn_shards_nums=nums, knn_shards_text=(lens, tok))
    state["knn_shards_build"] = {
        "docs": n_docs, "shards": KNN_SHARDS, "index_doc_s": t1 - t0, "refresh_s": t2 - t1,
        "shard_docs": [p.num_docs for p in sp.shards], "shard_nlist_L": per_shard,
        "padded_C_L": [int(vc.ann["nlist"]), int(vc.ann["tile"])],
        "pack_bytes": sp.nbytes(), "bytes_on_card": _on_card(device) - before}
    b = state["knn_shards_build"]
    log(f"knn_shards_index: {n_docs} docs on {KNN_SHARDS} shards {b['shard_docs']}: index_doc "
        f"{b['index_doc_s']:.1f} s, refresh {b['refresh_s']:.1f} s; per shard (nlist, L) "
        f"{per_shard}, padded (C, L) {tuple(b['padded_C_L'])}; {b['pack_bytes']} pack bytes, "
        f"{b['bytes_on_card']} bytes on the card")


def _shard_ann_check(device, idx, near, vecs, ev, ei) -> dict:
    """nprobe = nlist on every shard, held to the exact scan by
    `ann.search.check_ann_rows`: each shard's selection (an AnnSearcher
    over the shard's own tiles) states its kb-th selection score and its
    error bound at the exact neighbours it holds; a neighbour may be
    missing only where that bound lets it lose its own shard's selection."""
    import torch

    from elasticsearch_tpu_torch.ann import AnnSearcher
    from elasticsearch_tpu_torch.ann.search import check_ann_rows

    sp = idx.searcher.sp
    nlist = int(sp.vectors["vec"].ann["nlist"])
    qn = torch.from_numpy(near).to(device)
    B = len(near)
    got = [idx.search(knn=_knn_body(q, nprobe=nlist), size=KNN_K) for q in near]
    gv = np.full((B, KNN_K), -np.inf)
    gi = np.full((B, KNN_K), -1, np.int64)
    for r, out in enumerate(got):
        hits = sorted(((-h["_score"], int(h["_id"])) for h in out["hits"]["hits"]))
        gv[r, : len(hits)] = [-s for s, _ in hits]
        gi[r, : len(hits)] = [i for _, i in hits]
    pos = idx._base_pos
    shard_of = np.array([[pos[str(i)][0] for i in row] for row in ei])
    local = np.array([[pos[str(i)][1] for i in row] for row in ei])
    sel = np.zeros((B, KNN_SHARDS))
    bound = np.zeros(ei.shape)
    for s, p in enumerate(sp.shards):
        pv = p.vectors["vec"]
        searcher = AnnSearcher(pv.ann, pv.values, (pv.values * pv.values).sum(1), "cosine",
                               live=p.live, device=device)
        sv, _, _ = searcher.selection(qn, KNN_K, nprobe=searcher.nlist, num_candidates=KNN_NC)
        sel[:, s] = sv[:, -1].cpu().numpy()
        ids = torch.from_numpy(np.where(shard_of == s, local, 0)).to(device)
        b = searcher.selection_bound(qn, ids)
        bound = np.where(shard_of == s, b, bound)
        del searcher
    # one kb-th score per row: the largest shard's, each neighbour's bound
    # moved by its own shard's distance to it (-inf: that shard kept every
    # live candidate, so no neighbour of it may be missing)
    top = sel.max(axis=1)
    own = np.take_along_axis(sel, shard_of, axis=1)
    eff = np.where(np.isfinite(own), bound + (top[:, None] - own), -np.inf)
    eff = np.where(np.isfinite(top)[:, None], eff, -np.inf)
    dropped, swapped = check_ann_rows((gv, gi), (ev, ei), top, eff,
                                      "4-shard nprobe = nlist vs the exact scan")
    return {"rows": B, "dropped": dropped, "swapped": swapped, "nprobe": nlist}


def phase_knn_shards(device, rng, state: dict) -> None:
    """200 kNN `_search`es (k=10, num_candidates=100) on the 4-shard index:
    p50/p99 beside the 1-shard index's, launches per request (4
    ann_gather_scan, 5 scan_topk), recall@10 against the exact scan of all
    100,000 vectors (scan_topk's matmul route), 64 rows at nprobe = nlist
    held by check_ann_rows, 32 rows against the device="cpu" run of the
    same pack; 50 `exists` requests whose totals equal the generator's
    counts."""
    import torch

    from elasticsearch_tpu_torch.ops import kernels

    idx = state["knn_shards_index"]
    near, vecs, nums = state["knn_shards_near"], state["knn_shards_vecs"], state["knn_shards_nums"]
    calls = [dict(knn=_knn_body(q), size=KNN_K) for q in near[:KNN_SHARD_REQUESTS]]
    lat, results, launches = _timed_searches(idx, calls)
    n = len(calls)
    if launches["ann_gather_scan"] != KNN_SHARDS * n or launches["scan_topk"] != (KNN_SHARDS + 1) * n:
        raise AssertionError(f"4-shard kNN launches {launches} for {n} requests")
    for out in results:
        _knn_hits_ok(out, KNN_K, "4-shard kNN")
    one = {}
    if "knn_index" in state:  # the 1-shard index on the same request shape
        one_calls = [dict(knn=_knn_body(q), size=KNN_K) for q in state["knn_index_near"][:n]]
        one = _p(_timed_searches(state["knn_index"], one_calls)[0])
    # recall@10 against the exact scan of every vector
    qn = torch.from_numpy(near).to(device)
    mat_t = torch.from_numpy(vecs).to(device).T.contiguous()
    sq = (mat_t * mat_t).sum(0)
    live = torch.ones(mat_t.shape[1], dtype=torch.bool, device=device)
    aux_doc = 1.0 / torch.clamp(torch.sqrt(sq), min=1e-30)
    aux_q = 1.0 / torch.clamp(torch.sqrt((qn * qn).sum(1)), min=1e-30)
    ev, ei, _ = kernels.scan_topk(qn, mat_t, live, KNN_K, transform="cosine", aux_doc=aux_doc,
                                  aux_q=aux_q, count_positive=False)
    ev, ei = ev.cpu().numpy().astype(np.float64), ei.cpu().numpy().astype(np.int64)
    del mat_t, sq, live, aux_doc
    _release(device)
    recall = float(np.mean([len({int(h["_id"]) for h in out["hits"]["hits"]} & set(ei[r])) / KNN_K
                            for r, out in enumerate(results)]))
    if recall < 0.9:
        raise AssertionError(f"4-shard recall@10 {recall} below 0.9")
    full = _shard_ann_check(device, idx, near[:64], vecs, ev[:64], ei[:64])
    # 32 rows against the same pack searched on the host
    t0 = time.perf_counter()
    cpu = state["knn_shards_cpu"] = _cpu_twin_index(idx)  # phase hybrid reads it too
    nlist = full["nprobe"]
    picks = [dict(knn=_knn_body(q, nprobe=nlist), size=KNN_K) for q in near[:8]]
    picks += calls[8:32]  # a full probe costs the host's scan twin ~1.5 s a request
    answers = [idx.search(**kw) for kw in picks[:8]] + results[8:32]
    worst, swapped, equal = _against_cpu(cpu, picks, answers, "4-shard kNN vs device=cpu")
    cpu_s = time.perf_counter() - t0
    # exists: totals equal the generator's counts
    has_tag = nums % 3 == 0
    fields = {"vec": np.ones(len(nums), bool), "body": np.ones(len(nums), bool),
              "n": np.ones(len(nums), bool), "tag": has_tag, "nope": np.zeros(len(nums), bool)}
    ex_calls, ex_want = [], []
    for j in range(50):
        fld = list(fields)[j % 5]
        if j < 25:
            ex_calls.append(dict(query={"exists": {"field": fld}}, size=10))
            ex_want.append(int(fields[fld].sum()))
        else:
            lo = int(rng.integers(0, 600_000))
            ex_calls.append(dict(query={"bool": {"must": [{"exists": {"field": fld}}],
                                                 "filter": [{"range": {"n": {"gte": lo,
                                                                             "lt": lo + 400_000}}}]}},
                                 size=10))
            ex_want.append(int((fields[fld] & (nums >= lo) & (nums < lo + 400_000)).sum()))
    ex_lat, ex_out, ex_launch = _timed_searches(idx, ex_calls)
    for kw, out, want in zip(ex_calls, ex_out, ex_want):
        if out["hits"]["total"]["value"] != want:
            raise AssertionError(f"exists {kw['query']}: total {out['hits']['total']} vs the "
                                 f"generator's {want}")
        if any(s != 1.0 for s in (h["_score"] for h in out["hits"]["hits"])):
            raise AssertionError("exists scores are not the boost")
    state.setdefault("knn_launches", {})["knn_shards"] = launches
    state["knn_launches"]["exists_shards"] = ex_launch
    state["knn_shards"] = {
        "requests": n, **_p(lat), "one_shard": one,
        "launches_per_request": {k: v / n for k, v in launches.items() if v},
        "recall_at_10": recall, "nprobe_all": full,
        "cpu": {"rows": len(picks), "max_rel": worst, "swapped": swapped, "byte_equal": equal,
                "s": cpu_s},
        "exists": {"requests": len(ex_calls), **_p(ex_lat)}}
    k = state["knn_shards"]
    log(f"knn_shards: {n} kNN _search on {KNN_SHARDS} shards: p50 {k['p50_ms']:.3f} ms p99 "
        f"{k['p99_ms']:.3f} ms (1 shard: {one}); launches per request "
        f"{k['launches_per_request']}; recall@10 {recall:.4f} against the exact scan of "
        f"{len(vecs)} vectors; nprobe = nlist ({nlist}) on 64 rows: {full['dropped']} neighbours "
        f"dropped within the bound, {full['swapped']} swapped among fp-ties; {len(picks)} rows "
        f"equal the device=cpu run ({equal} byte-equal, max relative {worst:.3g}, {swapped} "
        f"swapped) in {cpu_s:.1f} s; 50 exists totals equal the generator's, p50 "
        f"{k['exists']['p50_ms']:.3f} ms")


def _hybrid_requests(rng, lens, tok, near, n: int) -> list:
    """n hybrid bodies: a `match` of 2-4 C1 terms drawn from a doc's text,
    plus a kNN section at a near-data query, boosted 5x so that its scores
    (<= 1 for cosine) compete with the text's BM25 scores."""
    from elasticsearch_tpu_torch.corpus import sample_queries

    out, j = [], 0
    while len(out) < n:
        for terms in sample_queries(rng, lens, tok, 2 * n):
            if len(terms) >= 2 and len(out) < n:
                out.append(({"match": {"body": " ".join(t for t, _ in terms)}},
                            _knn_body(near[j % len(near)], boost=HYBRID_KNN_BOOST)))
                j += 1
    return out


def _hybrid_decomposition(idx, calls, answers, what: str) -> int:
    """Each hybrid hit's score minus its text-only score is 0, or its score
    in the kNN section's own answer (within 1e-5 relative). -> hits with
    a kNN part."""
    with_knn = 0
    for kw, out in zip(calls, answers):
        ids = [h["_id"] for h in out["hits"]["hits"]]
        text = idx.search({"bool": {"must": [kw["query"]], "filter": [{"terms": {"_id": ids}}]}},
                          size=len(ids))
        text_s = {h["_id"]: h["_score"] for h in text["hits"]["hits"]}
        knn_s = {h["_id"]: h["_score"] for h in idx.search(knn=kw["knn"])["hits"]["hits"]}
        for h in out["hits"]["hits"]:
            extra = h["_score"] - text_s.get(h["_id"], 0.0)
            want = knn_s.get(h["_id"], 0.0)
            if abs(extra - want) > 1e-5 * abs(h["_score"]):
                raise AssertionError(f"{what}: {h['_id']} scores {h['_score']}, text "
                                     f"{text_s.get(h['_id'])}, knn {knn_s.get(h['_id'])}")
            with_knn += int(h["_id"] in knn_s)
    return with_knn


def _hybrid_against_cpu(idx, cpu, calls, answers, what: str) -> tuple[float, int, int]:
    """Hybrid answers against the device="cpu" run, in two holds, each
    with totals equal, scores within 1e-6 relative and ids up to fp-ties:
      - the kNN section's own answer, for the first HYBRID_CPU_SECTIONS
        requests (the host's ANN scan twin costs ~0.2-0.3 s a request on an
        H100's host; phases knn_check and knn_shards hold kNN answers too).
        The card's f32 rescore sums in another order than the host's, so a
        doc tied with the section's k-th score within 1e-5 may swap with
        the next;
      - every card answer against the query plus the card's section result
        (the PinnedScoresNode clauses) evaluated on the host. A swap at the
        section's k-th score changes which doc carries a kNN part, and so a
        hybrid total (seen once on an H100 against its host, 21,738 against
        21,739): this hold keeps it apart from the text evaluation.
    -> (largest relative score difference, positions swapped, answers
    byte-equal)."""
    sections = [dict(knn=kw["knn"], size=KNN_K) for kw in calls[:HYBRID_CPU_SECTIONS]]
    w1, s1, _ = _against_cpu(cpu, sections, [idx.search(**c) for c in sections],
                             f"{what}: the kNN section vs device=cpu")
    wants = []
    for kw in calls:
        node = idx._hybrid_node(kw["query"], idx._knn_nodes([kw["knn"]]))
        wants.append(cpu._format_generic_hits(
            cpu._searcher.search(node, size=kw.get("size", 10), from_=kw.get("from_", 0))))
    w2, s2, equal = _against_cpu(cpu, calls, answers, f"{what} vs device=cpu", wants)
    return max(w1, w2), s1 + s2, equal


def phase_hybrid(device, rng, state: dict) -> None:
    """HYBRID_REQUESTS hybrid `_search`es (a match of 2-4 C1 terms + a kNN section) on
    the 1-shard and on the 4-shard kNN index: p50/p99 beside the same
    requests' kNN-only and text-only p50, launches per request, every
    answer against the device="cpu" run of the same pack
    (`_hybrid_against_cpu`), and each hit's score decomposed into its text
    and kNN parts."""
    out = {}
    for key, name in (("1", "knn_index"), ("4", "knn_shards_index")):
        if name not in state:
            continue
        idx = state[name]
        near = state["knn_index_near" if key == "1" else "knn_shards_near"]
        lens, tok = state["knn_index_text" if key == "1" else "knn_shards_text"]
        reqs = _hybrid_requests(rng, lens, tok, near, HYBRID_REQUESTS)
        calls = [dict(query=q, knn=kb, size=10) for q, kb in reqs]
        lat, answers, launches = _timed_searches(idx, calls)
        knn_lat = _timed_searches(idx, [dict(knn=kb, size=10) for _, kb in reqs])[0]
        text_lat = _timed_searches(idx, [dict(query=q, size=10) for q, _ in reqs])[0]
        n_knn = _hybrid_decomposition(idx, calls, answers, f"hybrid on {key} shard(s)")
        t0 = time.perf_counter()
        cpu = state.pop("knn_shards_cpu", None) if key == "4" else None
        worst, swapped, equal = _hybrid_against_cpu(idx, cpu or _cpu_twin_index(idx), calls,
                                                    answers, f"hybrid on {key} shard(s)")
        cpu_s = time.perf_counter() - t0
        del cpu
        S = idx.num_shards
        if launches["ann_gather_scan"] != S * len(calls):
            raise AssertionError(f"hybrid on {key} shard(s): launches {launches}")
        state.setdefault("knn_launches", {})[f"hybrid_{key}"] = launches
        out[key] = {**_p(lat), "knn_only_p50_ms": float(np.percentile(knn_lat, 50)),
                    "text_only_p50_ms": float(np.percentile(text_lat, 50)),
                    "launches_per_request": {k: v / len(calls) for k, v in launches.items() if v},
                    "hits_with_knn_part": n_knn,
                    "hits": sum(len(a["hits"]["hits"]) for a in answers),
                    "cpu": {"max_rel": worst, "swapped": swapped, "byte_equal": equal,
                            "s": cpu_s}}
        o = out[key]
        log(f"hybrid: {len(calls)} on {key} shard(s): p50 {o['p50_ms']:.3f} ms p99 "
            f"{o['p99_ms']:.3f} ms (kNN only p50 {o['knn_only_p50_ms']:.3f}, text only p50 "
            f"{o['text_only_p50_ms']:.3f}); launches per request {o['launches_per_request']}; "
            f"{n_knn} of {o['hits']} hits carry a kNN part, each score = text + kNN within "
            f"1e-5; the kNN sections and all answers over them equal the device=cpu run "
            f"({equal} byte-equal, max relative {worst:.3g}, {swapped} swapped) in "
            f"{cpu_s:.1f} s")
    state["hybrid"] = out


def _knn_write_round(rng, idx, vecs, texts_of, log_: dict, n_upd: int, n_del: int, n_new: int):
    """One round of writes on a kNN index: n_upd updates with new vectors
    (near an existing doc's), n_del deletes and n_new new docs."""
    D = vecs.shape[1]
    alive = log_["alive"]
    pick = rng.choice(len(alive), n_upd + n_del, replace=False)
    ids = [alive[i] for i in pick]
    for doc_id in ids[:n_upd]:
        v = vecs[int(rng.integers(0, len(vecs)))] + rng.standard_normal(D).astype(np.float32) * 0.3
        idx.index_doc(doc_id, {"vec": v.tolist(), "n": int(rng.integers(0, 1_000_000)),
                               "body": texts_of(doc_id)})
        log_["new"].pop(doc_id, None)  # a new doc's vector changed
    for doc_id in ids[n_upd:]:
        idx.delete_doc(doc_id)
        log_["deleted"].add(doc_id)
        log_["new"].pop(doc_id, None)
    dead = set(ids[n_upd:])
    log_["alive"] = [a for a in alive if a not in dead]
    for _ in range(n_new):
        doc_id = f"w{log_['next']}"
        log_["next"] += 1
        v = vecs[int(rng.integers(0, len(vecs)))] + rng.standard_normal(D).astype(np.float32) * 0.3
        idx.index_doc(doc_id, {"vec": v.tolist(), "n": int(rng.integers(0, 1_000_000)),
                               "body": texts_of(None)})
        log_["alive"].append(doc_id)
        log_["new"][doc_id] = v


def _tiered_knn_check(device, idx, calls, wl: dict, what: str, tiers: int) -> dict:
    """kNN `_search`es on base + segments: one ann_gather_scan launch per
    shard of each tier with an ANN index, the tiers unchanged, no deleted
    id, the first 64 answers (32 on shards) against the device="cpu" run
    of the same tiers, and a query at a new doc's own vector returning
    that doc first."""
    tails = list(idx._tails)
    lat, answers, launches = _timed_searches(idx, calls)
    if list(idx._tails) != tails or len(tails) != tiers:
        raise AssertionError(f"{what}: the searches changed the tiers")
    S = idx.num_shards
    with_ann = (1 + sum(seg.searcher.sp.vectors["vec"].ann is not None for seg in tails))
    if launches["ann_gather_scan"] != S * with_ann * len(calls):
        raise AssertionError(f"{what}: ann_gather_scan launched {launches['ann_gather_scan']} "
                             f"times for {len(calls)} requests on {S} x {with_ann} ANN tiers")
    for out in answers:
        _knn_hits_ok(out, KNN_K, what)
        if {h["_id"] for h in out["hits"]["hits"]} & wl["deleted"]:
            raise AssertionError(f"{what}: a deleted doc came back")
    firsts = 0
    new = list(wl["new"].items())
    for doc_id, v in new[:: max(1, len(new) // 20)][:20]:
        hit = idx.search(knn=_knn_body(v), size=1)["hits"]["hits"]
        if not hit or hit[0]["_id"] != doc_id:
            raise AssertionError(f"{what}: a query at {doc_id}'s vector returned "
                                 f"{hit[0]['_id'] if hit else None} first")
        firsts += 1
    t0 = time.perf_counter()
    # of the host runs (~0.15 s each on 1 shard, ~0.35 s on 4), 64 and 32
    n_cpu = 64 if idx.num_shards == 1 else 32
    worst, swapped, equal = _against_cpu(_cpu_twin_index(idx), calls[:n_cpu], answers[:n_cpu],
                                         f"{what} vs device=cpu")
    return {"requests": len(calls), **_p(lat), "tiers": 1 + len(tails),
            "ann_tiers": with_ann, "launches_per_request": {
                k: v / len(calls) for k, v in launches.items() if v},
            "own_vector_first": firsts, "cpu": {"rows": n_cpu, "max_rel": worst,
                                                "swapped": swapped, "byte_equal": equal,
                                                "s": time.perf_counter() - t0},
            "launches": launches}


def phase_knn_writes(device, rng, state: dict) -> None:
    """Writes to the 1-shard kNN index: 4 rounds of 500 updates (new
    vectors), 250 deletes and 500 new docs, each refreshed incrementally
    (seconds beside the full build's); then 200 kNN `_search`es on base + 4
    segments (p50/p99 beside the untiered p50, launches, the first 64
    answers against the device="cpu" run of the same tiers, new docs found at their
    own vectors, no deleted doc, the tiers unchanged). Then one round and
    100 tiered kNN requests on the 4-shard index."""
    out = {}
    for key, name, rounds, n_calls in (("1", "knn_index", KNN_WRITE_ROUNDS, 200),
                                       ("4", "knn_shards_index", 1, 100)):
        if name not in state:
            continue
        idx = state[name]
        vecs = state["knn_index_vecs" if key == "1" else "knn_shards_vecs"]
        near = state["knn_index_near" if key == "1" else "knn_shards_near"]
        docs = idx._docs
        wl = {"alive": [d for d, e in docs.items() if e.alive], "deleted": set(), "new": {},
              "next": 0}
        alive = wl["alive"]

        def text_of(doc_id):  # an update keeps its text; a new doc takes a random doc's
            if doc_id is None:
                doc_id = alive[int(rng.integers(0, len(alive)))]
            return docs[doc_id].source.get("body", "")

        refreshes = []
        for _ in range(rounds):
            _knn_write_round(rng, idx, vecs, text_of, wl, KNN_WRITE_UPDATES, KNN_WRITE_DELETES,
                             KNN_WRITE_NEW)
            refreshes.append(_timed_refresh(idx, device))
            if refreshes[-1]["kind"] != "incremental":
                raise AssertionError(f"knn_writes on {key} shard(s): a {refreshes[-1]['kind']} "
                                     "refresh")
        calls = [dict(knn=_knn_body(q), size=KNN_K) for q in near[:n_calls]]
        chk = _tiered_knn_check(device, idx, calls, wl, f"tiered kNN on {key} shard(s)", rounds)
        state.setdefault("knn_launches", {})[f"knn_writes_{key}"] = chk.pop("launches")
        full_s = (state.get("knn_build", {}).get("refresh_s") if key == "1"
                  else state.get("knn_shards_build", {}).get("refresh_s"))
        out[key] = {"refreshes": refreshes, "full_refresh_s": full_s, **chk}
        o = out[key]
        log(f"knn_writes on {key} shard(s): {rounds} rounds of {KNN_WRITE_UPDATES} updates, "
            f"{KNN_WRITE_DELETES} deletes, {KNN_WRITE_NEW} new docs: incremental refresh "
            + ", ".join(f"{r['s']:.3f}" for r in refreshes) + f" s (the full build's refresh "
            f"{full_s} s); {n_calls} kNN _search on {o['tiers']} tiers ({o['ann_tiers']} with "
            f"an ANN index): p50 {o['p50_ms']:.3f} ms p99 {o['p99_ms']:.3f} ms; launches per "
            f"request {o['launches_per_request']}; {o['own_vector_first']} new docs first at "
            f"their own vectors; {o['cpu']['rows']} equal the device=cpu run "
            f"({o['cpu']['byte_equal']} byte-equal, max relative {o['cpu']['max_rel']:.3g}, "
            f"{o['cpu']['swapped']} swapped) in {o['cpu']['s']:.1f} s")
    state["knn_writes"] = out


# ---------------------------------------------------------------------------
# aggregations: bench.py C3 on 1 and 4 shards, C1 traffic and kNN beside aggs
# ---------------------------------------------------------------------------

AGGS_DOCS = 1_000_000  # bench.py C3's 1M point (its 4M point waits for a benchmark)
# docs of the 4-shard C3 index: 4 x 12,500, cut from C3's 1M (with it the
# full run took 940 s of 1,200 on an NVIDIA H100 80GB HBM3 at 700 W; from
# 4 x 100,000 when it took 1,117 s on a slow host); a
# 1-shard index of the same docs is what its answers are held to
AGGS_SHARD_DOCS = 50_000  # 4 x 12,500 (4 x 25,000 before slice 19's phases, 4 x 50,000 before 18's)
AGGS_SHARDS = 4
AGGS_TIER_DOCS = 100_000  # the tiers check's C3 index (a merge of 1M is a full rebuild)
AGGS_TIER_UPDATES = 1_000
AGGS_RUNS = 25  # timed runs per request (and waves); cut from 50 for phase esql
AGGS_WAVE = 32  # concurrent search_wave entries (bench.py `_c3_measure`'s depth)
AGGS_C1 = 100  # C1 `_search`es with stats(n) and histogram(n) beside
AGGS_C1_CPU = 4
AGGS_KNN = 50  # kNN `_search`es with terms(tag) beside, on the 4-shard kNN index
AGGS_BESIDE_C1 = {"n_stats": {"stats": {"field": "n"}},
                  "n_hist": {"histogram": {"field": "n", "interval": 100_000}}}


def _c3_mix() -> dict:
    """Every ported agg type once on C3 (and each metric at least once),
    with cardinality(clientip), percentiles(size), a composite resumed
    `after` a key, and terms(size) with a sum beside, which takes the
    two-pass scheme (~99,900 distinct sizes > TWO_PASS_MIN_V)."""
    from elasticsearch_tpu_torch.corpus import C3_T0_MS

    day = 86_400_000
    return {
        "ip": {"cardinality": {"field": "clientip"}},
        "p": {"percentiles": {"field": "size"}},
        "c": {"composite": {"size": 10, "after": {"st": "200", "day": C3_T0_MS + 5 * day},
                            "sources": [{"st": {"terms": {"field": "status"}}},
                                        {"day": {"date_histogram": {"field": "@timestamp",
                                                                    "fixed_interval": "1d"}}}]},
              "aggs": {"b": {"sum": {"field": "size"}}}},
        "sizes": {"terms": {"field": "size", "size": 5}, "aggs": {"b": {"sum": {"field": "size"}}}},
        "mn": {"min": {"field": "size"}}, "mx": {"max": {"field": "@timestamp"}},
        "av": {"avg": {"field": "size"}}, "vc": {"value_count": {"field": "clientip"}},
        "st": {"stats": {"field": "size"}}, "es": {"extended_stats": {"field": "size"}},
        "wa": {"weighted_avg": {"value": {"field": "size"}, "weight": {"field": "size"}}},
        "h": {"histogram": {"field": "size", "interval": 10_000}},
        "dh": {"date_histogram": {"field": "@timestamp", "calendar_interval": "week"},
               "aggs": {"ips": {"cardinality": {"field": "clientip"}}}},
        "adh": {"auto_date_histogram": {"field": "@timestamp", "buckets": 10}},
        "r": {"range": {"field": "size", "ranges": [{"to": 1000}, {"from": 1000, "to": 50_000},
                                                    {"from": 50_000}]}},
        "dr": {"date_range": {"field": "@timestamp", "ranges": [
            {"to": "2015-01-10"}, {"from": "2015-01-10", "to": "2015-01-20"},
            {"from": "2015-01-20"}]}},
        "f": {"filter": {"term": {"status": "404"}}, "aggs": {"b": {"sum": {"field": "size"}}}},
        "fs": {"filters": {"filters": {"err": {"terms": {"status": ["404", "500"]}},
                                       "ok": {"term": {"status": "200"}}}}},
        "m": {"missing": {"field": "clientip"}},
        "g": {"global": {}, "aggs": {"a": {"avg": {"field": "size"}}}},
        "top": {"terms": {"field": "status"}, "aggs": {"t": {"top_hits": {"size": 2}}}},
        "rare": {"rare_terms": {"field": "status", "max_doc_count": 130_000}},
        "mt": {"multi_terms": {"terms": [{"field": "status"}, {"field": "clientip"}],
                               "size": 3}},
        "sig": {"significant_terms": {"field": "status"}},
        "ps": {"date_histogram": {"field": "@timestamp", "fixed_interval": "7d"},
               "aggs": {"b": {"sum": {"field": "size"}},
                        "cs": {"cumulative_sum": {"buckets_path": "b"}}}},
        "best": {"max_bucket": {"buckets_path": "ps>b"}},
    }


def _profiled_request(fn) -> dict:
    """One request under torch.profiler: wall, device busy ms and share, and
    the kernels launched (CUDA kernel events)."""
    wall_us, ops = _device_trace(fn)
    busy_us = sum(us for _, us, _ in ops)
    launches = sum(n for _, _, n in ops)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3, "busy_share": busy_us / wall_us,
            "device_launches": launches}


def _timed_requests(device, calls, runs: int) -> tuple[list, dict]:
    """Each call `runs` times in turn (after one warm-up each). -> (the last
    answers, {p50_ms, p99_ms} over every run)."""
    for c in calls:
        c()
    lat, out = [], []
    for _ in range(runs):
        out = []
        for c in calls:
            t0 = time.perf_counter()
            out.append(c())  # ends in a device-to-host copy
            lat.append((time.perf_counter() - t0) * 1e3)
    return out, _p(lat)


def _c3_index(state: dict, device, name: str, docs, shards: int) -> dict:
    from elasticsearch_tpu_torch.corpus import C3_MAPPINGS

    idx = _engine(state, device).create_index(name, C3_MAPPINGS, {"number_of_shards": shards})
    t0 = time.perf_counter()
    for i, d in docs:
        idx.index_doc(i, d)
    t1 = time.perf_counter()
    before = _on_card(device)
    idx.refresh()
    sync(device)
    t2 = time.perf_counter()
    base = idx.searcher
    pack = base.pack if shards == 1 else base.sp
    dv = pack.docvalues if shards == 1 else pack.global_docvalues
    dv_bytes = sum(a.nbytes for col in dv.values()
                   for a in (col.values, col.has_value, col.uniq_ords) if a is not None)
    dv_bytes += sum(col.values.size * 4 for col in dv.values() if col.kind == "ord")  # int64 there
    return {"index": idx, "docs": len(docs), "shards": shards, "index_doc_s": t1 - t0,
            "refresh_s": t2 - t1, "bytes_on_card": _on_card(device) - before,
            "docvalues_bytes": int(dv_bytes)}


def phase_aggs_index(device, rng, state: dict) -> None:
    """bench.py C3's corpus (`corpus.c3_corpus`) at AGGS_DOCS docs through
    EsIndex.index_doc and refresh on one shard, and the same docs (its first
    AGGS_SHARD_DOCS) on AGGS_SHARDS murmur3 shards, and those on one shard
    too when they are fewer: index_doc and refresh seconds, the docvalues'
    bytes on the card."""
    from elasticsearch_tpu_torch.corpus import c3_corpus

    t0 = time.perf_counter()
    docs = c3_corpus(rng, AGGS_DOCS)
    gen_s = time.perf_counter() - t0
    status = np.array([d["status"] for _i, d in docs])
    sizes = np.array([d["size"] for _i, d in docs], np.int64)
    one = _c3_index(state, device, "c3", docs, 1)
    four = _c3_index(state, device, "c3_shards", docs[:AGGS_SHARD_DOCS], AGGS_SHARDS)
    same = None
    if AGGS_SHARD_DOCS < AGGS_DOCS:  # the 4-shard index's docs on one shard
        same = _c3_index(state, device, "c3_one", docs[:AGGS_SHARD_DOCS], 1)
        state["c3_one"] = same.pop("index")
    state.update(c3=one.pop("index"), c3_shards=four.pop("index"),
                 c3_exact={st: int(sizes[status == st].sum()) for st in np.unique(status)},
                 c3_exact_shards={st: int(sizes[:AGGS_SHARD_DOCS][status[:AGGS_SHARD_DOCS] == st]
                                          .sum()) for st in np.unique(status)})
    state["aggs_build"] = {"generate_s": gen_s, "1": one, str(AGGS_SHARDS): four,
                           "1_same_docs": same}
    for key, b in (("1", one), (str(AGGS_SHARDS), four), ("1", same)):
        if b is None:
            continue
        log(f"aggs_index: C3, {b['docs']} docs on {key} shard(s): index_doc "
            f"{b['index_doc_s']:.1f} s, refresh {b['refresh_s']:.1f} s, "
            f"{b['docvalues_bytes']} docvalues bytes, {b['bytes_on_card']} bytes on the card")


def _check_c3_sums(out: dict, exact: dict, what: str) -> None:
    """The exact sum(size) of every status bucket equals numpy's int64 sum."""
    for b in out["aggregations"]["by_status"]["buckets"]:
        if b["bytes"]["value"] != exact[b["key"]]:
            raise AssertionError(f"{what}: sum(size) of {b['key']} is {b['bytes']['value']}, "
                                 f"numpy says {exact[b['key']]}")


def _agg_check(got: dict, want: dict, what: str, ints_only: bool = False) -> None:
    from elasticsearch_tpu_torch.aggs.check import agg_mismatches, without_floats

    bad = agg_mismatches(got.get("aggregations"), want.get("aggregations"))
    if ints_only:
        a, b = (json.dumps(without_floats(x.get("aggregations")), sort_keys=True)
                for x in (got, want))
        if a != b:
            bad.append("counts, keys, int sums or cardinalities differ")
    if bad:
        raise AssertionError(f"{what}: {bad[:5]}")


def _agg_paths(device, idx, state: dict, tag: str, exact: dict) -> dict:
    """C3's request, the wave of AGGS_WAVE and the mix on one index: p50/p99
    over AGGS_RUNS, M docs/s, launches (scan_topk counted by the wrappers,
    every kernel by the profiler) and the first request's busy share."""
    from elasticsearch_tpu_torch.corpus import C3_AGGS
    from elasticsearch_tpu_torch.ops import kernels

    n = sum(len(lst) for lst in idx.shard_docs)
    out = {}
    mix = _c3_mix()
    for name, aggs in (("c3", C3_AGGS), ("mix", mix)):
        call = (lambda a=aggs: idx.search(None, size=0, aggs=a))
        first = call()
        prof = _profiled_request(lambda: (call(), sync(device)))
        kernels.reset_launch_counts()
        answers, p = _timed_requests(device, [call], AGGS_RUNS)
        counts = dict(kernels.launch_counts)
        if counts["scan_topk"] != AGGS_RUNS + 1:
            raise AssertionError(f"{tag} {name}: scan_topk launched {counts['scan_topk']} times "
                                 f"for {AGGS_RUNS + 1} requests")
        if json.dumps(answers[-1], sort_keys=True) != json.dumps(first, sort_keys=True):
            raise AssertionError(f"{tag} {name}: two runs of one request differ")
        state.setdefault("aggs_launches", {})[f"{tag}_{name}"] = counts
        out[name] = {**p, "m_docs_per_s": n / p["p50_ms"] / 1e3, **prof,
                     "answer": first}
    _check_c3_sums(out["c3"]["answer"], exact, f"{tag} c3")
    # the same request from AGGS_WAVE concurrent wave entries: service time
    # per request, over AGGS_RUNS waves; the first wave under the profiler
    entries = [dict(query=None, size=0, aggs=C3_AGGS) for _ in range(AGGS_WAVE)]
    idx.search_wave(entries)
    prof = _profiled_request(lambda: (idx.search_wave(entries), sync(device)))
    walls = []
    for _ in range(AGGS_RUNS):
        t0 = time.perf_counter()
        rows = idx.search_wave(entries)
        walls.append((time.perf_counter() - t0) * 1e3)
    solo = json.dumps(out["c3"]["answer"], sort_keys=True)
    for row in rows:
        if json.dumps(row, sort_keys=True) != solo:
            raise AssertionError(f"{tag}: a wave row's aggregations differ from its solo search")
    w = _p(walls)
    service = w["p50_ms"] / AGGS_WAVE
    out["wave"] = {"entries": AGGS_WAVE, "runs": AGGS_RUNS, "wall_p50_ms": w["p50_ms"],
                   "wall_p99_ms": w["p99_ms"], "service_ms": service,
                   "service_p99_ms": w["p99_ms"] / AGGS_WAVE, "m_docs_per_s": n / service / 1e3,
                   "launches_per_request": prof["device_launches"] / AGGS_WAVE,
                   "busy_share": prof["busy_share"]}
    return out


def _c3_log(tag: str, out: dict) -> None:
    for name in ("c3", "mix"):
        o = out[name]
        log(f"aggs {tag} {name}: p50 {o['p50_ms']:.3f} ms p99 {o['p99_ms']:.3f} ms "
            f"({o['m_docs_per_s']:.1f} M docs/s); first request under the profiler "
            f"{o['wall_ms']:.3f} ms wall, device busy {o['busy_ms']:.3f} ms "
            f"({100 * o['busy_share']:.1f}%), {o['device_launches']} kernel launches")
    w = out["wave"]
    log(f"aggs {tag} wave of {w['entries']}: service p50 {w['service_ms']:.3f} ms p99 "
        f"{w['service_p99_ms']:.3f} ms per request over {w['runs']} waves "
        f"({w['m_docs_per_s']:.1f} M docs/s); the first wave under the profiler "
        f"{w['launches_per_request']:.1f} kernel launches per request, busy "
        f"{100 * w['busy_share']:.1f}%; every row equal to its solo search")


def phase_aggs(device, rng, state: dict) -> None:
    """On the 1-shard C3 index: C3's request at size 0, the same from
    AGGS_WAVE wave entries (service time), the mix of every agg type; both
    held to the device="cpu" run of the same pack; the exact sums against
    numpy; REST `_search` / `_msearch` against EsIndex.search; one round of
    AGGS_TIER_UPDATES updates on an AGGS_TIER_DOCS-doc C3 index, whose next
    agg request merges the tiers and equals a full refresh's answer. Then
    the 1M-doc BM25 index's C1 requests (phase traffic) with stats(n) and
    histogram(n) beside, one scan_topk launch each, AGGS_C1_CPU of them
    against the device="cpu" run."""
    from elasticsearch_tpu_torch.corpus import C3_AGGS, c3_corpus
    from elasticsearch_tpu_torch.ops import kernels

    idx = state["c3"]
    out = _agg_paths(device, idx, state, "c3_1", state["c3_exact"])
    _c3_log("1 shard", out)
    t0 = time.perf_counter()
    cpu = _cpu_twin_index(idx)
    for name, aggs in (("c3", C3_AGGS), ("mix", _c3_mix())):
        _agg_check(out[name]["answer"], cpu.search(None, size=0, aggs=aggs),
                   f"1 shard {name} against the device=cpu run")
    cpu_s = time.perf_counter() - t0
    state["aggs_answers"] = {name: out[name]["answer"] for name in ("c3", "mix")}
    # REST
    server, client = _serve(state, device)
    try:
        def rest():
            st, _h, got = client("POST", "/c3/_search", {"size": 0, "aggs": C3_AGGS})
            st2, _h, ms = client("POST", "/_msearch", raw=_ndjson(
                [{"index": "c3"}, {"size": 0, "aggs": C3_AGGS},
                 {"index": "c3"}, {"size": 0, "aggregations": {"ip": _c3_mix()["ip"]}}]))
            return st, got, st2, ms

        st, got, st2, ms = _rest_path(state, "aggs_rest", rest)
        state.setdefault("aggs_launches", {})["rest"] = state["rest_launches"].pop("aggs_rest")
    finally:
        client.close()
        server.stop()
    if st != 200 or st2 != 200:
        raise AssertionError(f"aggs over REST: statuses {st}, {st2}")
    _agg_check(got, out["c3"]["answer"], "REST _search")
    _agg_check(ms["responses"][0], out["c3"]["answer"], "REST _msearch")
    _agg_check(ms["responses"][1], idx.search(None, size=0, aggs={"ip": _c3_mix()["ip"]}),
               "REST _msearch (aggregations)")
    # tail tiers on a 100,000-doc C3 index
    docs = c3_corpus(np.random.default_rng(77), AGGS_TIER_DOCS)
    tiers = _engine(state, device).create_index("c3_tiers", state["c3"].mappings.to_dict())
    for i, d in docs:
        tiers.index_doc(i, d)
    tiers.refresh()
    picks = rng.choice(AGGS_TIER_DOCS, AGGS_TIER_UPDATES, replace=False)
    final = dict(docs)
    for j in picks:
        i, d = docs[int(j)]
        final[i] = dict(d, size=int(d["size"]) + 7, status="418" if j % 2 else d["status"])
        tiers.index_doc(i, final[i])
    refresh = _timed_refresh(tiers, device)
    if refresh["kind"] != "incremental" or not tiers._tails:
        raise AssertionError(f"aggs tiers: a {refresh['kind']} refresh left no tail segment")
    t1 = time.perf_counter()
    merged = tiers.search(None, size=0, aggs=C3_AGGS)
    merge_s = time.perf_counter() - t1
    if tiers._tails:
        raise AssertionError("aggs tiers: the agg request did not merge the tiers")
    full = _engine(state, device).create_index("c3_full", state["c3"].mappings.to_dict())
    for i, d in final.items():
        full.index_doc(i, d)
    full.refresh()
    if json.dumps(merged, sort_keys=True) != json.dumps(full.search(None, size=0, aggs=C3_AGGS),
                                                        sort_keys=True):
        raise AssertionError("aggs tiers: the merged answer differs from a full refresh's")
    for name, key in (("c3_tiers", "aggs_tiers"), ("c3_full", "aggs_full")):
        _drop_index(state, name, key, device)
    out["tiers"] = {"docs": AGGS_TIER_DOCS, "updates": AGGS_TIER_UPDATES,
                    "refresh_s": refresh["s"], "merge_and_search_s": merge_s}
    log(f"aggs: 1 shard held to the device=cpu run ({cpu_s:.1f} s); exact sums equal numpy's; "
        f"REST _search and _msearch equal EsIndex.search; tiers: {AGGS_TIER_UPDATES} updates on "
        f"{AGGS_TIER_DOCS} docs refresh {refresh['s']:.3f} s incrementally, the agg request "
        f"merges them in {merge_s:.2f} s and equals a full refresh's answer")
    # C1 traffic with aggs beside, on the 1M-doc BM25 index
    if "index" in state:
        bm25 = state["index"]
        reqs = [(q, size) for q, size, from_ in state["requests"] if from_ == 0][:AGGS_C1]
        calls = [(lambda q=q, s=size: bm25.search(q, size=s, aggs=AGGS_BESIDE_C1))
                 for q, size in reqs]
        first = calls[0]()
        prof = _profiled_request(lambda: (calls[0](), sync(device)))
        kernels.reset_launch_counts()
        answers, p = _timed_requests(device, calls, 1)
        counts = dict(kernels.launch_counts)
        if counts["scan_topk"] != 2 * len(calls):
            raise AssertionError(f"C1 with aggs: scan_topk launched {counts['scan_topk']} "
                                 f"times for {2 * len(calls)} requests")
        state.setdefault("aggs_launches", {})["c1_aggs"] = counts
        if json.dumps(answers[0], sort_keys=True) != json.dumps(first, sort_keys=True):
            raise AssertionError("C1 with aggs: two runs of one request differ")
        cpu_bm25 = _cpu_twin_index(bm25)
        for (q, size), got in zip(reqs[:AGGS_C1_CPU], answers):
            _agg_check(got, cpu_bm25.search(q, size=size, aggs=AGGS_BESIDE_C1),
                       "C1 with aggs against the device=cpu run")
        n_bm25 = sum(len(lst) for lst in bm25.shard_docs)
        out["c1"] = {"requests": len(calls), **p, **prof,
                     "m_docs_per_s": n_bm25 / p["p50_ms"] / 1e3,
                     "traffic_p50_ms": state.get("traffic_p50", {}).get((10, 0))}
        o = out["c1"]
        log(f"aggs: {len(calls)} C1 _search with stats(n) + histogram(n): p50 "
            f"{o['p50_ms']:.3f} ms p99 {o['p99_ms']:.3f} ms ({o['m_docs_per_s']:.1f} M docs/s; "
            f"traffic p50 without aggs "
            f"{o['traffic_p50_ms']}); first under the profiler busy "
            f"{100 * o['busy_share']:.1f}%, {o['device_launches']} kernel launches; "
            f"{AGGS_C1_CPU} equal the device=cpu run")
    for name in ("c3", "mix"):
        out[name].pop("answer")
    state["aggs"] = out


def phase_aggs_shards(device, state: dict) -> None:
    """The 4-shard C3 index answers C3's request, the wave and the mix:
    counts, keys, int sums and cardinalities byte-equal to a 1-shard index
    of the same docs, floats within 1e-6 relative, p50 beside that index's;
    held to its device="cpu" run. Then AGGS_KNN kNN `_search`es with
    terms(tag) beside on the 4-shard kNN index (phase knn_shards_index)."""
    from elasticsearch_tpu_torch.corpus import C3_AGGS
    from elasticsearch_tpu_torch.ops import kernels

    idx = state["c3_shards"]
    out = _agg_paths(device, idx, state, f"c3_{AGGS_SHARDS}", state["c3_exact_shards"])
    _c3_log(f"{AGGS_SHARDS} shards", out)
    cpu = _cpu_twin_index(idx)
    one_idx = state.get("c3_one", state["c3"])  # the same docs on one shard
    one_p50 = {}
    for name, aggs in (("c3", C3_AGGS), ("mix", _c3_mix())):
        got = out[name]["answer"]
        _agg_check(got, cpu.search(None, size=0, aggs=aggs),
                   f"{AGGS_SHARDS} shards {name} against the device=cpu run")
        answers, p = _timed_requests(device, [lambda a=aggs: one_idx.search(None, size=0,
                                                                            aggs=a)], AGGS_RUNS)
        one_p50[name] = p["p50_ms"]
        one = answers[0]
        if name == "mix":  # top_hits ties break by (shard, doc) here
            got, one = ({"aggregations": {k: v for k, v in x["aggregations"].items()
                                          if k != "top"}} for x in (got, one))
        _agg_check(got, one, f"{AGGS_SHARDS} shards {name} against 1 shard", ints_only=True)
    for name in ("c3", "mix"):
        out[name].pop("answer")
        out[name]["one_shard_p50_ms"] = one_p50[name]
    log(f"aggs_shards: {AGGS_SHARD_DOCS} docs: counts, keys, int sums and cardinalities equal "
        f"one shard's of the same docs (floats within 1e-6); p50 {out['c3']['p50_ms']:.3f} ms "
        f"against one shard's {one_p50['c3']:.3f}, mix {out['mix']['p50_ms']:.3f} against "
        f"{one_p50['mix']:.3f}")
    kidx = state.get("knn_shards_index")
    if kidx is not None:
        aggs = {"tags": {"terms": {"field": "tag"}}}
        near = state["knn_shards_near"][:AGGS_KNN]
        calls = [(lambda q=q: kidx.search(knn=_knn_body(q), size=KNN_K, aggs=aggs)) for q in near]
        prof = _profiled_request(lambda: (calls[0](), sync(device)))
        kernels.reset_launch_counts()
        answers, p = _timed_requests(device, calls, 1)
        counts = dict(kernels.launch_counts)
        state.setdefault("aggs_launches", {})["knn_terms"] = counts
        if counts["ann_gather_scan"] < 2 * len(calls):
            raise AssertionError(f"kNN with aggs: {counts['ann_gather_scan']} ann_gather_scan "
                                 f"launches for {2 * len(calls)} requests")
        for a in answers:
            tags = a["aggregations"]["tags"]["buckets"]
            if not tags or sum(b["doc_count"] for b in tags) > KNN_NC * AGGS_SHARDS:
                raise AssertionError("kNN with aggs: malformed tag buckets")
        n_knn = sum(len(lst) for lst in kidx.shard_docs)
        out["knn_terms"] = {"requests": len(calls), **p, **prof,
                            "m_docs_per_s": n_knn / p["p50_ms"] / 1e3,
                            "knn_p50_ms": state.get("knn_shards", {}).get("p50_ms")}
        o = out["knn_terms"]
        log(f"aggs_shards: {len(calls)} kNN _search with terms(tag) on {KNN_SHARDS} shards: p50 "
            f"{o['p50_ms']:.3f} ms p99 {o['p99_ms']:.3f} ms ({o['m_docs_per_s']:.1f} M docs/s; "
            f"kNN alone {o['knn_p50_ms']}); "
            f"busy {100 * o['busy_share']:.1f}%, {o['device_launches']} kernel launches; "
            f"launches {counts}")
    state["aggs_shards"] = out


# ---------------------------------------------------------------------------
# ES|QL, SQL and EQL (bench.py C10) on the C3 indices
# ---------------------------------------------------------------------------

# timed runs of each query on the 1M-doc and the 4-shard index (cut from 3
# to 1 for slice 18's phases)
ESQL_RUNS = 1
# the sequence query's index: the 4 x 12,500-doc C3 index (its state
# machine walks every event in Python)
ESQL_SEQUENCE = ('sequence by clientip with maxspan=1d [any where status == "404"] '
                 '[any where status == "500"]')
# each query's operators (the exchanges where the reference runs them)
ESQL_OPS = {"where_stats_sort": ["collect", "where", "stats_exchange", "sort"],
            "topn": ["collect", "topn_exchange", "keep"],
            "where_topn": ["collect", "where", "topn_exchange", "keep"],
            "eval_stats": ["collect", "eval", "stats_exchange"],
            "top_clients": ["collect", "stats_exchange", "sort", "limit"]}


def _esql_queries(index: str) -> dict:
    """bench.py C10's four queries (`bench.py:2281-2293`) on `index`, and
    the top-clients panel (~60,000 groups at 1M docs)."""
    return {
        "where_stats_sort": f'FROM {index} | WHERE size >= 50000 '
                            '| STATS c = COUNT(*), b = SUM(size) BY status | SORT status',
        "topn": f'FROM {index} | SORT size DESC | LIMIT 10 | KEEP clientip, size',
        "where_topn": f'FROM {index} | WHERE status == "404" | SORT size DESC | LIMIT 10 '
                      '| KEEP clientip, size',
        "eval_stats": f'FROM {index} | EVAL kb = size / 1024 | STATS m = MAX(kb), a = AVG(kb)',
        "top_clients": f'FROM {index} | STATS c = COUNT(*), b = SUM(size) BY clientip '
                       '| SORT c DESC, clientip | LIMIT 10',
    }


class _DoubleTally:
    """Doubles of the answers compared: how many are bit-equal, and the
    largest relative difference of the others."""

    def __init__(self):
        self.n = self.equal = 0
        self.max_rel = 0.0

    def add(self, got: float, want: float, what: str) -> None:
        self.n += 1
        if got == want:
            self.equal += 1
            return
        rel = abs(got - want) / max(abs(got), abs(want))
        if not rel <= 1e-12:
            raise AssertionError(f"{what}: {got} against {want} (relative {rel})")
        self.max_rel = max(self.max_rel, rel)

    def summary(self) -> dict:
        return {"doubles": self.n, "bit_equal": self.equal, "max_rel": self.max_rel}


def _esql_same(got, want, tally: _DoubleTally, what: str) -> None:
    """Two answers (ES|QL, SQL or EQL bodies) agree: keys, keywords, longs,
    counts and types equal, doubles within 1e-12 relative (tallied)."""
    if isinstance(want, float):
        if not isinstance(got, float):
            raise AssertionError(f"{what}: {got!r} against the double {want!r}")
        tally.add(got, want, what)
    elif isinstance(want, dict):
        keys = [k for k in want if k not in ("took", "profile")]
        if sorted(k for k in got if k not in ("took", "profile")) != sorted(keys):
            raise AssertionError(f"{what}: keys {sorted(got)} against {sorted(want)}")
        for k in keys:
            _esql_same(got[k], want[k], tally, f"{what}.{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{what}: {got!r:.200} against {want!r:.200}")
        for g, w in zip(got, want):
            _esql_same(g, w, tally, what)
    elif type(got) is not type(want) or got != want:
        raise AssertionError(f"{what}: {got!r} against {want!r}")


def _esql_same_up_to_ties(got: dict, want: dict, what: str) -> None:
    """SORT size DESC | LIMIT 10 on two indices of the same docs: the size
    column equal; rows above the last size equal as a set (equal sizes order
    by row, and 1 and 4 shards collect rows in other orders)."""
    cols = [c["name"] for c in want["columns"]]
    if got["columns"] != want["columns"] or len(got["values"]) != len(want["values"]):
        raise AssertionError(f"{what}: columns or row counts differ")
    s = cols.index("size")
    if [r[s] for r in got["values"]] != [r[s] for r in want["values"]]:
        raise AssertionError(f"{what}: the sizes differ")
    cut = want["values"][-1][s]
    if sorted(map(tuple, (r for r in got["values"] if r[s] > cut))) != \
            sorted(map(tuple, (r for r in want["values"] if r[s] > cut))):
        raise AssertionError(f"{what}: the rows above the last size differ")


def _esql_timed(engine, query: str, runs: int) -> tuple[dict, dict]:
    """`runs` profiled runs of one query. -> (the last answer, p50/p99 of
    the caller's walls, the last profile's per-operator split, rows in,
    peak_live_bytes); every run's answer equal, every profile's operator
    walls summing exactly to its wall."""
    import math

    from elasticsearch_tpu_torch.esql import esql_query

    walls, answers = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = esql_query(engine, {"query": query, "profile": True})
        walls.append((time.perf_counter() - t0) * 1e3)
        prof = out["profile"]
        ops = prof["drivers"][0]["operators"]
        if math.fsum(o["took_ms"] for o in ops) != prof["wall_ms"]:
            raise AssertionError(f"{query}: the operator walls do not sum to the wall")
        answers.append(out)
    first = json.dumps(answers[0]["values"])
    if any(json.dumps(a["values"]) != first for a in answers[1:]):
        raise AssertionError(f"{query}: two runs of one query differ")
    ops = prof["drivers"][0]["operators"]
    split = {o["operator"]: o["took_ms"] for o in ops}
    rows_in = ops[0]["rows_out"]
    return answers[-1], {**_p(walls), "rows_in": rows_in,
                         "rows_per_s": rows_in / (float(np.percentile(walls, 50)) / 1e3),
                         "operator_ms": split, "collect_share": split["collect"] / prof["wall_ms"],
                         "peak_live_bytes": prof["peak_live_bytes"],
                         "dominant_operator": prof["dominant_operator"],
                         "operators": [o["operator"] for o in ops]}


def _esql_routes(device, engine, index: str, exact: dict, what: str) -> dict:
    """The exchanges on the card against the host evaluator on one collected
    table: topn_exchange's rows equal the host sort's first 10 (a long key,
    and status desc then size), stats_exchange's STATS BY status equal
    `_run_stats` (counts, longs, min/max exact; doubles within 1e-12) and
    numpy's exact sums."""
    from elasticsearch_tpu_torch.esql.engine import (_eval_expr, _run_stage, _run_stats,
                                                     execute)
    from elasticsearch_tpu_torch.esql.exchange import stats_exchange, supported_stats
    from elasticsearch_tpu_torch.esql.topn import topn_exchange

    t = execute(engine, f"FROM {index}")
    t.columns["kb"] = _eval_expr(("bin", "/", ("col", "size"), ("lit", 1024)), t)
    for payload in ([("size", True, None)], [("status", True, None), ("size", False, None)]):
        sel = topn_exchange(t, t.shard_of, payload, 10, device)
        host, _ = _run_stage(engine, "sort", "sort", payload, t, t.shard_of, None)
        got = t.take(sel)
        for name, col in host.columns.items():
            if not (np.array_equal(got.columns[name].values, col.values[:10])
                    and np.array_equal(got.columns[name].null, col.null[:10])):
                raise AssertionError(f"{what}: topn_exchange {payload} column {name} differs "
                                     "from the host sort")
    aggs = [("c", ("call", "count", [("star",)])), ("b", ("call", "sum", [("col", "size")])),
            ("a", ("call", "avg", [("col", "size")])), ("lo", ("call", "min", [("col", "size")])),
            ("hi", ("call", "max", [("col", "size")])), ("sk", ("call", "sum", [("col", "kb")])),
            ("ak", ("call", "avg", [("col", "kb")])), ("mk", ("call", "max", [("col", "kb")]))]
    if not supported_stats({"aggs": aggs, "by": ["status"]}, t):
        raise AssertionError(f"{what}: STATS BY status does not take the exchange")
    got = stats_exchange(t, t.shard_of, aggs, ["status"], device)
    want = _run_stats(t, aggs, ["status"])
    tally = _DoubleTally()
    for name, col in want.columns.items():
        g = got.columns[name]
        if g.type != col.type or not np.array_equal(g.null, col.null):
            raise AssertionError(f"{what}: stats_exchange {name} types or nulls differ")
        for gv, wv in zip(g.values.tolist(), col.values.tolist()):
            if col.type == "double":
                tally.add(float(gv), float(wv), f"{what}: stats_exchange {name}")
            elif gv != wv:
                raise AssertionError(f"{what}: stats_exchange {name}: {gv} against {wv}")
    sums = dict(zip(got.columns["status"].values.tolist(), got.columns["b"].values.tolist()))
    if sums != exact:
        raise AssertionError(f"{what}: SUM(size) BY status {sums} against numpy's {exact}")
    return {"rows": t.nrows, "groups": got.nrows, **tally.summary()}


def phase_esql(device, state: dict) -> None:
    """bench.py C10's ES|QL mix and the top-clients panel on the C3 indices
    of phase aggs_index (1M docs on one shard; 4 x 12,500 and the same docs
    on one shard): ESQL_RUNS profiled runs of each on the 1M-doc and the
    4-shard index (p50/p99, input rows/s, the per-operator split and the
    collect's share, peak_live_bytes), each answer held to the device="cpu"
    engine on the same packs, the 4-shard answers to one shard's; the
    exchanges on the card against the host evaluator and numpy's sums on
    the 200,000-doc tables; SQL over REST on 1M docs, ES|QL and EQL over
    REST and an EQL sequence on 4 shards, against the cpu run; each
    exchange's device busy share from one profiled query at 1M docs."""
    from elasticsearch_tpu_torch.engine import Engine
    from elasticsearch_tpu_torch.esql import esql_query
    from elasticsearch_tpu_torch.esql.eql import eql_search
    from elasticsearch_tpu_torch.esql.sql import sql_query
    from elasticsearch_tpu_torch.ops import kernels

    engine = _engine(state, device)
    cpu = Engine(device="cpu")
    one = "c3_one" if "c3_one" in state else "c3"
    for name in {"c3", "c3_shards", one}:
        cpu.indices[name] = _cpu_twin_index(state[name])
    out = {"runs": ESQL_RUNS, "queries": {}}
    tally = _DoubleTally()
    answers = {}
    kernels.reset_launch_counts()
    for index in ("c3", "c3_shards") + ((one,) if one != "c3" else ()):
        for qname, q in _esql_queries(index).items():
            got, m = _esql_timed(engine, q, ESQL_RUNS if index != one else 1)
            if m["operators"][:-1] != ESQL_OPS[qname]:
                raise AssertionError(f"{index} {qname}: operators {m['operators']}")
            answers[index, qname] = got
            if index != one:
                out["queries"][f"{index}.{qname}"] = m
    state.setdefault("esql_launches", {})["esql"] = dict(kernels.launch_counts)
    cpu_s = time.perf_counter()
    for (index, qname), got in answers.items():
        if index != one:
            want = esql_query(cpu, {"query": _esql_queries(index)[qname]})
            _esql_same(got, want, tally, f"{index} {qname} against the device=cpu run")
    cpu_s = time.perf_counter() - cpu_s
    for qname in ESQL_OPS:  # 4 shards against one shard of the same docs
        got, want = answers["c3_shards", qname], answers[one, qname]
        if qname in ("topn", "where_topn"):
            _esql_same_up_to_ties(got, want, f"4 shards {qname}")
        else:
            _esql_same(got, want, tally, f"4 shards {qname} against one shard")
    out["routes"] = {name: _esql_routes(device, engine, name, state["c3_exact_shards"], name)
                     for name in dict.fromkeys(("c3_shards", one))}
    # SQL on 1M docs, ES|QL and EQL on 4 shards over REST, against the cpu run
    server, client = _serve(state, device)
    rest = {}
    try:
        sql = {"query": "SELECT status, COUNT(*), SUM(size) FROM c3 GROUP BY status"}
        esql = {"query": _esql_queries("c3_shards")["where_stats_sort"]}
        eql = {"query": 'any where status == "404"'}
        for what, path, body, want_fn in (
                ("sql", "/_sql", sql, lambda: sql_query(cpu, sql)),
                ("esql", "/_query", esql, lambda: esql_query(cpu, esql)),
                ("eql", "/c3_shards/_eql/search", eql, lambda: eql_search(cpu, "c3_shards", eql))):
            t0 = time.perf_counter()
            status, _h, resp = client("POST", path, body)
            rest[what] = {"ms": (time.perf_counter() - t0) * 1e3}
            if status != 200:
                raise AssertionError(f"REST {path}: {status} {resp}")
            _esql_same(resp, json.loads(json.dumps(want_fn())), tally, f"REST {path}")
            if what == "sql" and {r[0]: r[2] for r in resp["rows"]} != state["c3_exact"]:
                raise AssertionError(f"REST /_sql SUM(size) BY status {resp['rows']} against "
                                     "numpy's sums")
        status, _h, ring = client("GET", "/_esql/profile?n=4")
        if status != 200 or ring["retained"] != 4 or "stats" not in ring:
            raise AssertionError(f"GET /_esql/profile: {status}")
    finally:
        client.close()
        server.stop()
    t0 = time.perf_counter()
    seq = eql_search(engine, "c3_shards", {"query": ESQL_SEQUENCE, "size": 50})
    seq_ms = (time.perf_counter() - t0) * 1e3
    _esql_same(seq, eql_search(cpu, "c3_shards", {"query": ESQL_SEQUENCE, "size": 50}), tally,
               "EQL sequence against the device=cpu run")
    rest["eql_sequence"] = {"docs": sum(len(lst) for lst in state["c3_shards"].shard_docs),
                            "ms": seq_ms, "sequences": seq["hits"]["total"]["value"]}
    out["rest"] = rest
    out["against_cpu"] = {**tally.summary(), "cpu_s": cpu_s}
    # each exchange's device time and busy share: one profiled query at 1M
    out["profiled"] = {
        what: _profiled_request(lambda q=_esql_queries("c3")[qname]: (
            esql_query(engine, {"query": q}), sync(device)))
        for what, qname in (("topn_exchange", "topn"), ("stats_exchange", "where_stats_sort"))}
    cpu.close()
    state["esql"] = out
    for key, m in out["queries"].items():
        log(f"esql {key}: p50 {m['p50_ms']:.1f} ms p99 {m['p99_ms']:.1f} ms, "
            f"{m['rows_per_s'] / 1e6:.2f} M input rows/s, collect {100 * m['collect_share']:.1f}% "
            f"of the wall, peak_live_bytes {m['peak_live_bytes']}; operators (ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in m["operator_ms"].items()))
    a = out["against_cpu"]
    log(f"esql: every answer equal to the device=cpu run ({a['doubles']} doubles, "
        f"{a['bit_equal']} bit-equal, max relative {a['max_rel']:.3g}; {a['cpu_s']:.1f} s), "
        f"the 4-shard answers to one shard's; the exchanges equal the host evaluator: "
        f"{out['routes']}; REST and EQL: {rest}")
    for what, p in out["profiled"].items():
        log(f"esql profiled query through {what}: wall {p['wall_ms']:.3f} ms, device busy "
            f"{p['busy_ms']:.3f} ms ({100 * p['busy_share']:.3f}%), {p['device_launches']} "
            "kernel launches")

# ---------------------------------------------------------------------------
# the text DSL, field sort, collapse and rescore
# ---------------------------------------------------------------------------

# requests of each kind in phase dsl, drawn from real docs of the 1M-doc
# BM25 corpus with the phase's own stream
DSL_COUNTS = {"match_phrase": 200, "match_phrase_prefix": 100, "match_bool_prefix": 100,
              "prefix": 100, "wildcard": 100, "regexp": 50, "fuzzy": 5, "dis_max": 100,
              "ids": 100, "query_string": 100, "simple_query_string": 50}
# of each kind held to the device="cpu" run of the same pack (fuzzy: 3); cut
# from 50 for phase esql (the full run took 966 s of 1,200 with 50, on an
# NVIDIA H100 80GB HBM3 at 700 W), from 20 for slice 18's phases (1,235 s with
# 20 on that card)
DSL_CPU = 10
# a fuzzy query's expansion runs the edit distance over the whole dictionary
# on the host (~2 s at 100,000 terms), so fewer of them are checked again
DSL_CPU_FUZZY = 3
DSL_KEEP = 20  # of each kind kept for the 8-shard and the tiered checks (fuzzy: 1)
DSL_KEEP_FUZZY = 1  # a fuzzy request walks each shard's dictionary: ~8.5 s on 8 shards
DSL_TIER_KEEP = 5  # of each kept kind run on phase writes' tiers
# the kinds whose node each tier evaluates alone (a phrase prefix expands
# over one dictionary, so it merges the tiers: not run on phase writes' tiers)
DSL_TIER_KINDS = tuple(k for k in DSL_COUNTS if k != "match_phrase_prefix")
COLLAPSE_REQUESTS = 100
RESCORE_REQUESTS = 100
COLLAPSE_RESCORE_CPU = 25  # of each held to the device="cpu" run (50 before slice 18)
SORT_PAGES = 10  # search_after pages of Discover's request
SORT_PAGE = 100
REST_DSL = 100  # sorted searches with search_after, and phrase searches, over REST


def _dsl_requests(rng, lens, tok) -> dict:
    """kind -> [query bodies]: phrases of 2-3 consecutive tokens of a doc,
    a phrase prefix and a bool prefix (2 tokens, then the first 4
    characters of a third of 5 or more characters: at most 111 expansions),
    prefixes of 4 characters, `t12?4`-style wildcards, regexps with a digit
    class, fuzzy AUTO on terms of 5 characters (distance 1; max_expansions
    128, above the count of any such term's neighbours, so each shard
    expands the same terms as one shard), dis_max of two matches, ids
    of 10 ids, query_string (fields, AND/OR/NOT, a quoted phrase, a `t12*`
    wildcard) and simple_query_string."""
    starts = np.concatenate([[0], np.cumsum(lens[:-1])])
    n_docs = len(lens)

    def run(n, last_chars=0):
        while True:
            d = int(rng.integers(0, n_docs))
            if lens[d] >= n:
                s = starts[d] + int(rng.integers(0, lens[d] - n + 1))
                words = [f"t{t}" for t in tok[s: s + n]]
                if len(words[-1]) >= last_chars:
                    return words

    def term(min_chars, max_chars=99):
        while True:
            d = int(rng.integers(0, n_docs))
            t = f"t{tok[starts[d] + int(rng.integers(0, lens[d]))]}"
            if min_chars <= len(t) <= max_chars:
                return t

    make = {
        "match_phrase": lambda: {"match_phrase": {"body": " ".join(run(2 + int(rng.integers(0, 2))))}},
        "match_phrase_prefix": lambda: (lambda w: {"match_phrase_prefix": {
            "body": f"{w[0]} {w[1]} {w[2][:4]}"}})(run(3, 5)),
        "match_bool_prefix": lambda: (lambda w: {"match_bool_prefix": {
            "body": f"{w[0]} {w[1]} {w[2][:4]}"}})(run(3, 5)),
        "prefix": lambda: {"prefix": {"body": term(4)[:4]}},
        "wildcard": lambda: (lambda t: {"wildcard": {"body": f"{t[:3]}?{t[4:]}"}})(term(5)),
        "regexp": lambda: (lambda t: {"regexp": {"body": f"{t[:2]}[0-9]{t[3:]}"}})(term(5)),
        "fuzzy": lambda: {"fuzzy": {"body": {"value": term(5, 5), "fuzziness": "AUTO",
                                             "max_expansions": 128}}},
        "dis_max": lambda: {"dis_max": {"queries": [{"match": {"body": " ".join(run(2))}},
                                                    {"match": {"body": " ".join(run(2))}}],
                                        "tie_breaker": 0.3}},
        "ids": lambda: {"ids": {"values": [str(int(i)) for i in rng.integers(0, n_docs, 10)]}},
        "query_string": lambda: (lambda w, t: {"query_string": {
            "query": f'({w[0]} OR {w[1]}) AND "{w[2]} {w[3]}" NOT {w[4]} {t[:3]}*',
            "fields": ["body"]}})(run(5), term(4)),
        "simple_query_string": lambda: (lambda w, t: {"simple_query_string": {
            "query": f'{w[0]} +{w[1]} -{w[4]} "{w[2]} {w[3]}" {t[:3]}*',
            "fields": ["body"]}})(run(5), term(4)),
    }
    return {kind: [make[kind]() for _ in range(n)] for kind, n in DSL_COUNTS.items()}


def _dsl_keep(calls: list, kind: str) -> list:
    return calls[: DSL_KEEP_FUZZY if kind == "fuzzy" else DSL_KEEP]


def phase_dsl(device, state: dict, seed: int) -> None:
    """The text DSL on the 1M-doc BM25 index (one shard): DSL_COUNTS
    requests per kind at size 10, p50/p99 and scan_topk launches per kind
    (one per request), the busy share of one profiled request per kind, and
    the first DSL_CPU of each kind against the device="cpu" run of the same
    pack. The first DSL_KEEP of each kind and their answers are kept for
    the 8-shard (phase dsl_shards) and tiered (phase writes) checks."""
    from elasticsearch_tpu_torch.ops import kernels

    idx = state["index"]
    lens, tok = state["corpus"]
    rng = np.random.default_rng((seed, 14))
    t0 = time.perf_counter()
    reqs = _dsl_requests(rng, lens, tok)
    gen_s = time.perf_counter() - t0
    out, kept, launches = {}, {}, {}
    cpu = _cpu_twin_index(idx)
    views = _tier_views(idx)
    cpu_s = 0.0
    for kind, qs in reqs.items():
        calls = [dict(query=q, size=10) for q in qs]
        # a fuzzy query's host walk (~2 s) needs no warm-up of its own
        lat, answers, n = _timed_searches(idx, calls, warm=1 if kind == "fuzzy" else 5)
        if n["scan_topk"] != len(calls):
            raise AssertionError(f"dsl {kind}: scan_topk launched {n['scan_topk']} times for "
                                 f"{len(calls)} requests")
        launches[kind] = n
        matched = sum(1 for a in answers if a["hits"]["total"]["value"])
        if kind in ("match_phrase", "prefix", "ids") and matched < len(calls) * 0.9:
            raise AssertionError(f"dsl {kind}: only {matched} of {len(calls)} requests matched")
        prof = _profiled_request(lambda: idx.search(**calls[0]))
        t1 = time.perf_counter()
        n_cpu = DSL_CPU_FUZZY if kind == "fuzzy" else DSL_CPU
        worst, swapped, equal = _against_cpu(cpu, calls[:n_cpu], answers[:n_cpu],
                                             f"dsl {kind} cpu")
        cpu_s += time.perf_counter() - t1
        out[kind] = {"requests": len(calls), "matched": matched, **_p(lat),
                     "scan_topk": n["scan_topk"], "busy_share": prof["busy_share"],
                     "device_launches": prof["device_launches"], "cpu_max_rel": worst,
                     "cpu_byte_equal": equal}
        keep = _dsl_keep(calls, kind)
        kept[kind] = [(kw, a, _impact_bound(kw["query"], idx.mappings, views))
                      for kw, a in zip(keep, answers)]
        log(f"dsl {kind}: {len(calls)} requests ({matched} matched), {_percentiles(lat)}, "
            f"scan_topk {n['scan_topk']}, busy share {prof['busy_share']:.3f} of one request; "
            f"{min(n_cpu, len(calls))} equal the device=cpu run ({equal} byte-equal, max "
            f"relative {worst:.3g})")
    del cpu
    state["dsl_kept"] = kept
    state.setdefault("dsl_launches", {}).update(launches)
    state["dsl"] = {"generate_s": gen_s, "cpu_check_s": cpu_s, "kinds": out}


def phase_dsl_shards(device, state: dict) -> None:
    """The kept DSL requests on the 8-shard index: p50/p99 and launches per
    kind (one scan_topk per request over the S·n_max lanes), each answer
    held to the 1-shard index's (totals equal; scores within 1e-5 relative
    plus the impact tier's tie class, 2 * the larger of the two indices'
    sums of boost·idf·ubf/QMAX over the query's impact-served terms + 1e-7,
    0 for a query with none; ids up to ties within it)."""
    idx = state["shards_index"]
    kept = state.pop("dsl_kept")
    views8 = _tier_views(idx)
    out, launches, swapped = {}, {}, 0
    for kind, rows in kept.items():
        calls = [kw for kw, _a, _b in rows]
        lat, answers, n = _timed_searches(idx, calls, warm=0 if kind == "fuzzy" else 1)
        if n["scan_topk"] != len(calls):
            raise AssertionError(f"dsl_shards {kind}: scan_topk launched {n['scan_topk']} times")
        launches[f"{kind}_8shards"] = n
        for (kw, want, bound1), got in zip(rows, answers):
            gs, gi, gt = _hits_arrays(got)
            ws, wi, wt = _hits_arrays(want)
            if gt != wt:
                raise AssertionError(f"dsl 8 shards: total {gt} vs 1 shard {wt} for {kw}")
            bound = max(bound1, _impact_bound(kw["query"], idx.mappings, views8))
            tie = 2 * bound + 1e-7 if bound else 0.0
            swapped += _rows_match(gs, gi, ws, wi, f"dsl 8 shards vs 1 {kw}", rtol=1e-5, tie=tie)
        out[kind] = {"requests": len(calls), **_p(lat)}
    state.setdefault("dsl_launches", {}).update(launches)
    state["dsl_shards"] = out
    log(f"dsl_shards: {sum(len(r) for r in kept.values())} requests of {len(kept)} kinds on "
        f"8 shards equal the 1-shard answers ({swapped} positions swapped among ties); p50 ms "
        + ", ".join(f"{k} {v['p50_ms']:.2f}" for k, v in out.items()))


def _dsl_tiers(idx, state: dict, segments: int, cpu) -> dict:
    """Inside phase writes, on base + `segments` tail segments: the first
    DSL_TIER_KEEP kept requests of each tier-safe kind, one scan_topk launch
    per tier, each
    answer held to `cpu`, the device="cpu" twin of the same tiers; the
    tiers stay."""
    from elasticsearch_tpu_torch.ops import kernels

    out = {}
    for kind in DSL_TIER_KINDS:
        rows = state["dsl_kept"][kind][:DSL_TIER_KEEP]
        picks = [(kw["query"], kw["size"], 0) for kw, _a, _b in rows]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        answers = [idx.search(q, size=size) for q, size, _f in picks]
        wall = (time.perf_counter() - t0) * 1e3 / len(picks)
        n = dict(kernels.launch_counts)
        if n["scan_topk"] != len(picks) * (1 + segments) or len(idx._tails) != segments:
            raise AssertionError(f"dsl tiers {kind}: scan_topk {n['scan_topk']}, "
                                 f"{len(idx._tails)} segments")
        state.setdefault("dsl_launches", {})[f"{kind}_tiers"] = n
        worst = _tiered_cpu_check(idx, picks, answers, f"dsl tiers {kind}", cpu=cpu)
        out[kind] = {"requests": len(picks), "mean_ms": wall, "cpu_max_rel": worst}
    log(f"dsl tiers: {sum(v['requests'] for v in out.values())} requests of "
        f"{len(out)} kinds on 1 + {segments} tiers equal the device=cpu tiers (max relative "
        f"{max(v['cpu_max_rel'] for v in out.values()):.3g})")
    return out


def _collapse_rescore_requests(rng, lens, tok) -> tuple[list, list]:
    """C1 matches (`corpus.traffic`'s `or` form) collapsed on the long
    field `n`, and C1 matches rescored (window 100) by a match_phrase of two
    consecutive terms of a doc holding the match's terms."""
    from elasticsearch_tpu_torch.corpus import traffic

    qs = traffic(rng, lens, tok, COLLAPSE_REQUESTS + RESCORE_REQUESTS, 0, 0)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])])
    collapse = [dict(query=q, size=10, collapse={"field": "n"}) for q in qs[:COLLAPSE_REQUESTS]]
    rescore = []
    for q in qs[COLLAPSE_REQUESTS:]:
        d = int(rng.integers(0, len(lens)))
        s = starts[d] + int(rng.integers(0, max(lens[d] - 1, 1)))
        phrase = " ".join(f"t{t}" for t in tok[s: s + 2])
        body = q["match"]["body"]
        text = body["query"] if isinstance(body, dict) else body
        q2 = {"match": {"body": f"{text} {phrase}"}}
        rescore.append(dict(query=q2, size=10, rescore={"window_size": 100, "query": {
            "rescore_query": {"match_phrase": {"body": phrase}},
            "query_weight": 0.7, "rescore_query_weight": 1.3}}))
    return collapse, rescore


def phase_collapse_rescore(device, state: dict, seed: int) -> None:
    """On the 1M-doc BM25 index: COLLAPSE_REQUESTS C1 matches collapsed on
    `n` and RESCORE_REQUESTS C1 matches rescored by a phrase (window 100):
    p50/p99 and launches (one scan_topk per collapse, over the groups; one
    per rescore's first pass); the first COLLAPSE_RESCORE_CPU answers of
    each (collapse keys, hits, rescored scores) against the device="cpu"
    run of the same pack (totals equal, scores within 1e-6 relative, ids up
    to fp-ties, keys equal)."""
    idx = state["index"]
    lens, tok = state["corpus"]
    rng = np.random.default_rng((seed, 15))
    collapse, rescore = _collapse_rescore_requests(rng, lens, tok)
    cpu = _cpu_twin_index(idx)
    out = {}
    for name, calls in (("collapse", collapse), ("rescore", rescore)):
        lat, answers, n = _timed_searches(idx, calls)
        if n["scan_topk"] != len(calls):
            raise AssertionError(f"{name}: scan_topk launched {n['scan_topk']} times for "
                                 f"{len(calls)} requests")
        state.setdefault("dsl_launches", {})[name] = n
        prof = _profiled_request(lambda: idx.search(**calls[0]))
        picks = calls[:COLLAPSE_RESCORE_CPU]
        wants = [cpu.search(**kw) for kw in picks]
        worst, swapped, equal = _against_cpu(cpu, picks, answers, f"{name} cpu", wants=wants)
        for kw, got, want in zip(picks, answers, wants):
            if name != "collapse":
                continue
            keys = [h["fields"]["n"][0] for h in got["hits"]["hits"]]
            if len(set(keys)) != len(keys):
                raise AssertionError(f"collapse: two hits of one group for {kw}")
            for g, w in zip(got["hits"]["hits"], want["hits"]["hits"]):
                if g["_id"] == w["_id"] and g["fields"] != w["fields"]:
                    raise AssertionError(f"collapse keys differ from the cpu run's for {kw}")
        out[name] = {"requests": len(calls), **_p(lat), "scan_topk": n["scan_topk"],
                     "busy_share": prof["busy_share"], "cpu_max_rel": worst,
                     "cpu_byte_equal": equal}
        log(f"{name}: {len(calls)} requests, {_percentiles(lat)}, scan_topk {n['scan_topk']}, "
            f"busy share {prof['busy_share']:.3f}; {len(picks)} equal the device=cpu run ({equal} "
            f"byte-equal,"
            f" max relative {worst:.3g}, {swapped} swapped among fp-ties)")
    del cpu
    state["collapse_rescore"] = out


def _pages_of(one: list, size: int, n_pages: int) -> list:
    """The hits `n_pages` search_after pages of `size` give, read off one
    sorted page: each page starts after the last hit whose sort keys equal
    the previous page's last keys (search_after skips the rest of a
    full-key tie)."""
    out, start = [], 0
    for _ in range(n_pages):
        page = one[start: start + size]
        if not page:
            break
        out += page
        last = page[-1]["sort"]
        start += len(page)
        while start < len(one) and one[start]["sort"] == last:
            start += 1
    return out


def _same_sort(a: list, b: list) -> bool:
    """Two `sort` arrays: equal, a float within 1e-6 relative."""
    return len(a) == len(b) and all(
        x == y or (isinstance(x, float) and isinstance(y, float)
                   and abs(x - y) <= 1e-6 * max(abs(x), abs(y))) for x, y in zip(a, b))


def _sorted_equal(got: dict, want: dict, what: str, ids: bool = True) -> None:
    """`ids`: sort values and ids byte for byte. Else: sort values equal (a
    float within 1e-6 relative) and ids equal within every run of equal
    sort values but the last, which may continue past the page. Totals and
    aggregations equal."""
    g, w = got["hits"]["hits"], want["hits"]["hits"]
    if got["hits"].get("total") != want["hits"].get("total"):
        raise AssertionError(f"{what}: totals differ")
    if ids and json.dumps([(h["_id"], h["sort"]) for h in g]) != \
            json.dumps([(h["_id"], h["sort"]) for h in w]):
        raise AssertionError(f"{what}: sort values or ids differ")
    if len(g) != len(w) or not all(_same_sort(a["sort"], b["sort"]) for a, b in zip(g, w)):
        raise AssertionError(f"{what}: sort values differ")
    if not ids:
        runs = {}
        for h in w:
            runs.setdefault(json.dumps(h["sort"]), set()).add(h["_id"])
        runs_g = {}
        for h in g:
            runs_g.setdefault(json.dumps(h["sort"]), set()).add(h["_id"])
        last = json.dumps(w[-1]["sort"]) if w else None
        for key, s in runs.items():
            # a float key an ulp apart makes other runs: those compare by value
            if key != last and key in runs_g and runs_g[key] != s:
                raise AssertionError(f"{what}: ids differ beyond full-key ties")
    if json.dumps(got.get("aggregations"), sort_keys=True) != \
            json.dumps(want.get("aggregations"), sort_keys=True):
        raise AssertionError(f"{what}: aggregations differ")


def _sort_requests(rng) -> dict:
    """Discover's request (a range on @timestamp over one day, newest
    first, size 100), the status / size sort with missing, `_score` with a
    size tiebreak on a term filter, and terms(status) beside a sort."""
    from elasticsearch_tpu_torch.corpus import C3_T0_MS

    day = 86_400_000
    t0 = C3_T0_MS + int(rng.integers(0, 29)) * day
    discover = dict(query={"range": {"@timestamp": {"gte": t0, "lt": t0 + day}}},
                    sort=[{"@timestamp": "desc"}], size=SORT_PAGE)
    return {
        "discover": discover,
        "status_size": dict(query={"range": {"@timestamp": {"gte": t0, "lt": t0 + 3 * day}}},
                            sort=[{"status": {"order": "asc", "missing": "_first"}},
                                  {"size": {"order": "desc", "missing": "_last"}}], size=50),
        "score_size": dict(query={"term": {"status": "404"}},
                           sort=["_score", {"size": "desc"}], size=50),
        "terms_beside": dict(query={"range": {"@timestamp": {"gte": t0, "lt": t0 + day}}},
                             sort=[{"@timestamp": "desc"}], size=20,
                             aggs={"st": {"terms": {"field": "status"}}}),
    }


def phase_sort(device, state: dict, seed: int) -> None:
    """Field-sorted search on the C3 corpus: on the 1M-doc index, Discover's
    request and its 10 search_after pages (joined, equal to one page of
    1,000 as search_after reads it), the status / size sort with missing,
    `_score` with a size tiebreak and terms(status) beside a sort (its aggs
    equal the unsorted request's): p50/p99, no scan_topk launch on the
    sorted path, the busy share of one profiled request; sort values and
    ids equal to the device="cpu" run byte for byte. The same requests on
    the 4-shard index (4 x 12,500) equal the 1-shard index of the same
    docs up to full-key ties, and its device="cpu" run byte for byte."""
    from elasticsearch_tpu_torch.ops import kernels

    rng = np.random.default_rng((seed, 16))
    reqs = _sort_requests(rng)
    out = {}
    for tag, idx_key, ref_key in (("1", "c3", None), (str(AGGS_SHARDS), "c3_shards", "c3_one")):
        idx = state[idx_key]
        cpu = _cpu_twin_index(idx)
        lat, res = {}, {}
        for name, kw in reqs.items():
            for _ in range(2):  # warm-up
                idx.search(**kw)
            kernels.reset_launch_counts()
            ms = []
            for _ in range(10):
                t0 = time.perf_counter()
                res[name] = idx.search(**kw)
                ms.append((time.perf_counter() - t0) * 1e3)
            n = dict(kernels.launch_counts)
            state.setdefault("dsl_launches", {})[f"sort_{name}_{tag}"] = n
            if n["scan_topk"]:
                raise AssertionError(f"sort {name}: the sorted path launched scan_topk")
            lat[name] = _p(ms)
            _sorted_equal(res[name], cpu.search(**kw), f"sort {name} {tag} shard(s) vs cpu")
        # Discover's 10 pages, joined, against one page of 1,000
        kw = reqs["discover"]
        pages, cursor, page_ms = [], None, []
        for _ in range(SORT_PAGES):
            t0 = time.perf_counter()
            got = idx.search(**kw, search_after=cursor)
            page_ms.append((time.perf_counter() - t0) * 1e3)
            _sorted_equal(got, cpu.search(**kw, search_after=cursor),
                          f"sort page {len(pages) // SORT_PAGE} {tag} vs cpu")
            hits = got["hits"]["hits"]
            if not hits:
                break
            pages += hits
            cursor = hits[-1]["sort"]
        one = idx.search(**{**kw, "size": SORT_PAGES * SORT_PAGE * 2})["hits"]["hits"]
        want = _pages_of(one, SORT_PAGE, SORT_PAGES)
        if [(h["_id"], h["sort"]) for h in pages] != [(h["_id"], h["sort"]) for h in want]:
            raise AssertionError(f"sort {tag}: the joined pages differ from one page")
        # terms(status) beside the sort: the unsorted request's aggs
        unsorted = idx.search(reqs["terms_beside"]["query"], size=0,
                              aggs=reqs["terms_beside"]["aggs"])
        if json.dumps(res["terms_beside"]["aggregations"], sort_keys=True) != \
                json.dumps(unsorted["aggregations"], sort_keys=True):
            raise AssertionError(f"sort {tag}: the aggs beside the sort differ")
        prof = _profiled_request(lambda: idx.search(**reqs["discover"]))
        if ref_key is not None:  # the same docs on one shard, up to full-key ties
            one_idx = state.get(ref_key, state["c3"])
            for name, kw in reqs.items():
                _sorted_equal(res[name], one_idx.search(**kw), f"sort {name} 4 shards vs 1",
                              ids=False)
        del cpu
        out[tag] = {"requests": {k: v for k, v in lat.items()}, "page_p50_ms":
                    float(np.percentile(page_ms, 50)), "pages": len(pages) // SORT_PAGE,
                    "busy_share": prof["busy_share"],
                    "discover_total": res["discover"]["hits"]["total"]["value"]}
        log(f"sort {tag} shard(s): " + "; ".join(
            f"{k} p50 {v['p50_ms']:.2f} ms p99 {v['p99_ms']:.2f} ms" for k, v in lat.items())
            + f"; {len(pages)} hits in {len(pages) // SORT_PAGE} search_after pages (p50 "
            f"{np.percentile(page_ms, 50):.2f} ms) equal one page; no scan_topk launch; busy "
            f"share {prof['busy_share']:.3f}; equal the device=cpu run"
            + (" and the 1-shard index up to full-key ties" if ref_key else ""))
    state["sort"] = out


def phase_rest_dsl(device, state: dict, seed: int) -> None:
    """Over REST: REST_DSL sorted `_search`es with search_after on the 1M-doc
    C3 index (Discover's request, each page's cursor the last page's) and
    REST_DSL phrase `_search`es on the 1M-doc BM25 index; every body equal
    to EsIndex.search's answer byte for byte; p50/p99 and launches."""
    rng = np.random.default_rng((seed, 17))
    c3, bm25 = state["c3"], state["index"]
    reqs = _sort_requests(rng)["discover"]
    phrases = _dsl_requests(rng, *state["corpus"])["match_phrase"][:REST_DSL]
    server, c = _serve(state, device)
    try:
        def sorted_pages():
            lat, got, cursor = [], [], None
            for _ in range(REST_DSL):
                body = {"query": reqs["query"], "sort": reqs["sort"], "size": 10}
                if cursor is not None:
                    body["search_after"] = cursor
                t0 = time.perf_counter()
                status, _, resp = c("POST", f"/{c3.name}/_search", body)
                lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"sorted _search {status}: {resp}")
                got.append((body, resp))
                hits = resp["hits"]["hits"]
                cursor = hits[-1]["sort"] if hits else None
            return lat, got

        def phrase():
            lat, got = [], []
            for q in phrases:
                t0 = time.perf_counter()
                status, _, resp = c("POST", f"/{bm25.name}/_search", {"query": q, "size": 10})
                lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"phrase _search {status}: {resp}")
                got.append((q, resp))
            return lat, got

        slat, sgot = _rest_path(state, "sort_search_after", sorted_pages)
        plat, pgot = _rest_path(state, "phrase", phrase)
    finally:
        c.close()
        server.stop()
    for body, resp in sgot:
        _same_hits(resp, c3.search(body["query"], sort=body["sort"], size=10,
                                   search_after=body.get("search_after")), "REST sorted _search")
    for q, resp in pgot:
        _same_hits(resp, bm25.search(q, size=10), "REST phrase _search")
    rl = state["rest_launches"]
    if rl["sort_search_after"]["scan_topk"] or rl["phrase"]["scan_topk"] != len(pgot):
        raise AssertionError(f"REST dsl launches {rl['sort_search_after']} {rl['phrase']}")
    state.setdefault("rest", {})["dsl"] = {"sorted": _p(slat), "phrase": _p(plat)}
    log(f"rest_dsl: {len(sgot)} sorted `_search`es paged by search_after ({_percentiles(slat)})"
        f" and {len(pgot)} phrase `_search`es ({_percentiles(plat)}) equal EsIndex.search's")


# ---------------------------------------------------------------------------
# tenancy: bench.py C8's superpacks, the `_merge` lane, metering, fair share
# ---------------------------------------------------------------------------

TENANTS = 500  # tenants of 24 docs (bench.py C8, `config8_superpack`, has 1,000; cut for slice 19)
TENANT_DOCS = 24
TENANT_CLIENTS = 256  # closed-loop clients, 4 requests each
TENANT_REQS = 4
TENANT_PARITY_EVERY = 20  # every 20th tenant's rows held bit for bit
TENANT_REFRESH = 20  # tenants refreshed during the second loop
TENANT_QUERIES = [[("w3", 1.0), ("w7", 1.0)], [("w1", 1.0)]]  # bench.py C8's parity queries


def _tenant_docs(t: int) -> list:
    """bench.py C8's tenant t: 24 docs of 6 words from default_rng(10_000 + t),
    vocabularies of 20 and 40 words alternating (two block size classes)."""
    trng = np.random.default_rng(10_000 + t)
    vocab = 40 if t % 2 else 20
    return [(str(j), {"body": " ".join(f"w{int(x)}" for x in trng.integers(0, vocab, 6))})
            for j in range(TENANT_DOCS)]


def _tenant_closed_loop(svc, entries, names) -> tuple[float, list, list]:
    """bench.py C8's closed loop: TENANT_CLIENTS threads submit the entries
    in order, each waiting for its answer. -> (QPS, latencies ms, answers)."""
    import threading

    n = len(entries)
    lat, out = [0.0] * n, [None] * n
    it = iter(range(n))
    lock = threading.Lock()
    errors = []

    def client():
        try:
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                t0 = time.perf_counter()
                out[i] = svc.submit(dict(entries[i]), tenant=names[i % len(names)]).result(
                    timeout=600)
                lat[i] = (time.perf_counter() - t0) * 1e3
        except Exception as ex:  # noqa: BLE001 - re-raised below
            errors.append(ex)

    threads = [threading.Thread(target=client) for _ in range(TENANT_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return n / wall, lat, out


def _exact_arm_hits(idx, body: dict) -> dict:
    """The per-index exact arm's response to a term-disjunction body (the
    superpack lane's contract)."""
    from elasticsearch_tpu_torch.ops.batched import BatchTermSearcher, fetch

    fld, terms = _term_spec(idx, body["query"])
    size = body.get("size", 10)
    bts = BatchTermSearcher(idx._searcher)
    v, i, t = fetch([bts.run(fld, bts.plan(fld, [terms], size))])[0]
    kk = v.shape[1]
    return idx._term_hits(v[0], np.zeros(kk, np.int32), i[0], int(t[0]), kk, size, 0)


def phase_tenancy(device, state: dict) -> None:
    """bench.py C8 at its size on the card: 1,000 tenant indices of 24 docs,
    every one folded into the size-class superpacks; every 20th tenant's rows
    (C8's parity queries) bit for bit against its per-index exact arm on the
    card and against a device="cpu" engine's superpack of the same docs;
    256 closed-loop clients x 4 `match` requests with superpacks on (each
    answer equal to the per-index exact arm's), then off (each within the
    term lane's contract of the on answer); QPS, p50/p99, HBM bytes per
    tenant, padded waste, size classes, the shape keys (the reference's
    compiled programs: at most classes x 8 and fewer than the tenants),
    scan_topk launches per wave; a second loop while 20 tenants take a new
    doc and refresh on the engine thread: their refolds ride the queue as
    the `_merge` tenant and their new docs are then served from the lanes;
    every wave's tenant shares summing exactly to its device segment; and
    fair share clamping the heaviest tenant's weight under a tiny
    slo.tenant.device_ms_per_s, the static table back once it is off."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.engine import Engine
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.ops.batched import BatchTermSearcher, fetch
    from elasticsearch_tpu_torch.tenancy import shares_sum

    out: dict = {"tenants": TENANTS, "docs_per_tenant": TENANT_DOCS}
    engine = Engine(device=device)
    cpu = Engine(device="cpu")
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tenancy-engine")
    try:
        for e in (engine, cpu):
            e.settings.update({"transient": {"superpack.enabled": True}})
        names = [f"tenant{t:04d}" for t in range(TENANTS)]
        t0 = time.perf_counter()
        for t, name in enumerate(names):
            docs = _tenant_docs(t)
            for e in ((engine, cpu) if t % TENANT_PARITY_EVERY == 0 else (engine,)):
                e.create_index(name, {"properties": {"body": {"type": "text"}}})
                res = e.bulk([("index", name, i, d) for i, d in docs])
                if res["errors"]:
                    raise AssertionError(f"{name}: bulk errors")
                e.indices[name].refresh()
        sync(device)
        out["build_s"] = time.perf_counter() - t0
        mgr = engine.superpacks
        t0 = time.perf_counter()
        folded = sum(mgr.adopt(engine.indices[n]) for n in names)
        sync(device)
        out["fold_s"] = time.perf_counter() - t0
        if folded != TENANTS:
            raise AssertionError(f"{folded} of {TENANTS} tenants folded")
        classes = len(mgr.packs)
        if classes < 2:
            raise AssertionError(f"{classes} size class: the bucketing is not exercised")
        # ---- rows: the card's per-index exact arm and the cpu superpack
        sample = names[::TENANT_PARITY_EVERY]
        for name in sample:
            if not cpu.superpacks.adopt(cpu.indices[name]):
                raise AssertionError(f"{name}: not folded on the cpu engine")
        kernels.reset_launch_counts()
        rows = {name: mgr.msearch(name, "body", TENANT_QUERIES, 10) for name in sample}
        solo_launches = dict(kernels.launch_counts)
        for name in sample:
            v, _s, i, t = rows[name]
            bts = BatchTermSearcher(engine.indices[name]._searcher)
            ev, ei, et = fetch([bts.run("body", bts.plan("body", TENANT_QUERIES, 10))])[0]
            cv, _cs, ci, ct = cpu.superpacks.msearch(name, "body", TENANT_QUERIES, 10)
            for wv, wi, wt, against in ((ev, ei, et, "its exact arm"),
                                        (cv, ci, ct, "the cpu superpack")):
                ok = np.array_equal(t, wt)
                for q in range(len(TENANT_QUERIES)):
                    k = int(np.isfinite(wv[q]).sum())
                    ok &= (int(np.isfinite(v[q]).sum()) == k
                           and np.array_equal(v[q][:k].view(np.uint32),
                                              wv[q][:k].view(np.uint32))
                           and np.array_equal(i[q][:k], wi[q][:k]))
                if not ok:
                    raise AssertionError(f"{name}: superpack rows differ from {against}")
        out["parity_tenants"] = len(sample)
        # ---- the closed loop, superpacks on then off
        svc = engine.serving
        svc.bind_executor(pool.submit)
        engine.settings.update({"transient": {"serving.enabled": True}})
        n_reqs = TENANT_CLIENTS * TENANT_REQS
        bodies = [{"query": {"match": {"body": f"w{i % 20} w{(i * 7) % 20}"}}, "size": 10}
                  for i in range(n_reqs)]
        entries = [svc.classify(names[i % TENANTS], b, {}) for i, b in enumerate(bodies)]
        if any(e is None for e in entries):
            raise AssertionError("a C8 request is not wave-eligible")
        loops = {}
        for mode in ("on", "off"):
            engine.settings.update({"transient": {"superpack.enabled": mode == "on"}})
            for i in range(32):  # warm-up
                svc.submit(dict(entries[i]), tenant="warm").result(timeout=600)
            svc.drain(60.0)
            before = dict(svc.counters)
            kernels.reset_launch_counts()
            qps, lat, answers = _tenant_closed_loop(svc, entries, names)
            svc.drain(60.0)
            launches = dict(kernels.launch_counts)
            waves = svc.counters["waves"] - before["waves"]
            packed = svc.counters["superpack_packed"] - before["superpack_packed"]
            loops[mode] = {"qps": qps, **_p(lat), "waves": waves, "superpack_packed": packed,
                           "launches": launches,
                           "scan_topk_per_wave": launches["scan_topk"] / max(waves, 1)}
            if mode == "on":
                out_on = answers
                if packed != n_reqs:
                    raise AssertionError(f"{packed} of {n_reqs} requests took the superpack lane")
            elif packed:
                raise AssertionError("the superpack lane served with superpacks off")
            else:
                out_off = answers
        state["tenancy_launches"] = {"superpack_on": loops["on"]["launches"],
                                     "superpack_off": loops["off"]["launches"],
                                     "solo": solo_launches}
        if not loops["on"]["launches"]["scan_topk"]:
            raise AssertionError("the superpack lane launched no scan_topk")
        # every on answer equals its per-index exact arm's; every off answer
        # is within the term lane's contract of it
        swapped = 0
        for i, body in enumerate(bodies):
            idx = engine.indices[names[i % TENANTS]]
            want = _exact_arm_hits(idx, body)
            if out_on[i] != want:
                raise AssertionError(f"request {i}: the superpack answer differs from the "
                                     "per-index exact arm's")
            swapped += _wave_rows_match(out_off[i], out_on[i], _impact_class(idx, body["query"]),
                                        f"request {i} with superpacks off")
        out["off_swapped"] = swapped
        st = mgr.stats()
        programs = mgr.compiled_program_count()
        if not (programs <= classes * 8 and programs < TENANTS):
            raise AssertionError(f"{programs} shape keys for {classes} size classes")
        per_index = [sum(t.numel() * t.element_size() for t in
                         engine.indices[n]._searcher.dev.values() if hasattr(t, "numel"))
                     for n in names]
        out.update(size_classes=classes, compiled_programs=programs,
                   hbm_bytes_per_tenant=st["hbm_bytes_per_tenant"],
                   per_index_bytes_per_tenant=float(np.mean(per_index)),
                   padded_waste_bytes=st["padded_waste_bytes"],
                   padded_waste_pct=st["padded_waste_pct"], loops=loops)
        # ---- the `_merge` lane: 20 tenants refresh during a second loop
        engine.settings.update({"transient": {"superpack.enabled": True}})
        fresh = names[1:TENANTS:TENANTS // TENANT_REFRESH][:TENANT_REFRESH]
        old = {n: mgr.member_of(n) for n in fresh}
        merges = svc.counters["merges"]

        def refresh_tenants():
            for j, name in enumerate(fresh):
                def write(name=name, j=j):
                    idx = engine.indices[name]
                    idx.index_doc("new", {"body": f"fresh{j} w1"})
                    idx.refresh()
                pool.submit(write).result()

        writer = threading.Thread(target=refresh_tenants)
        writer.start()
        _tenant_closed_loop(svc, entries, names)
        writer.join()
        # a request of each refreshed tenant finds its lane stale and queues
        # the refold as the `_merge` tenant
        for name in fresh:
            svc.submit(svc.classify(name, {"query": {"match": {"body": "w1"}}}, {}),
                       tenant=name).result(timeout=600)
        deadline = time.monotonic() + 120.0
        while any(mgr.member_of(n) is old[n] for n in fresh) and time.monotonic() < deadline:
            time.sleep(0.01)
        svc.drain(60.0)
        stale = [n for n in fresh if mgr.member_of(n) is old[n]]
        if stale:
            raise AssertionError(f"{len(stale)} refreshed tenants were not refolded")
        before = svc.counters["superpack_packed"]
        for j, name in enumerate(fresh):
            r = svc.submit(svc.classify(name, {"query": {"match": {"body": f"fresh{j}"}}}, {}),
                           tenant=name).result(timeout=600)
            if [h["_id"] for h in r["hits"]["hits"]] != ["new"]:
                raise AssertionError(f"{name}: the new doc is not served")
        if svc.counters["superpack_packed"] - before != len(fresh):
            raise AssertionError("the refolded tenants were not served from their lanes")
        out["merge_lane"] = {"tenants": len(fresh), "merges": svc.counters["merges"] - merges}
        # ---- metering: every wave's shares sum to its device segment
        waves = svc.tenant_waves()
        for w in waves:
            if shares_sum(v["device_ms"] for v in w["tenants"].values()) != w["device_ms"]:
                raise AssertionError(f"a wave's tenant shares miss its device segment: {w}")
        out["metering"] = {"waves_checked": len(waves),
                           "ledger_rows": len(engine.metering.rows())}
        # ---- fair share
        burn = engine.metering.burn_rates()
        heavy = max((t for t in burn if t != svc.MERGE_TENANT), key=lambda t: burn[t])
        engine.settings.update({"transient": {"planner.tenant.fairshare": True,
                                              "slo.tenant.device_ms_per_s": 1e-6}})
        eff = svc.stats()["fairshare"]["effective_weights"]
        if not 0.25 <= eff.get(heavy, 1.0) < 1.0:
            raise AssertionError(f"fair share left {heavy} at {eff.get(heavy)}")
        engine.settings.update({"transient": {"planner.tenant.fairshare": False}})
        fs = svc.stats()["fairshare"]
        if fs["effective_weights"] != fs["static_weights"]:
            raise AssertionError("turning fair share off kept the clamped table")
        out["fairshare"] = {"tenant": heavy, "burn_ms_per_s": burn[heavy],
                            "clamped_weight": eff[heavy]}
    finally:
        engine.close()
        cpu.close()
        pool.shutdown(wait=True)
    _release(device)
    state["tenancy"] = out
    on, off = out["loops"]["on"], out["loops"]["off"]
    log(f"tenancy: {TENANTS} tenants of {TENANT_DOCS} docs built in {out['build_s']:.1f} s, "
        f"folded in {out['fold_s']:.1f} s into {out['size_classes']} size classes; "
        f"{out['parity_tenants']} tenants' rows bit-equal to the exact arm and the cpu run; "
        f"superpacks on {on['qps']:.1f} QPS (p50 {on['p50_ms']:.2f} ms, p99 {on['p99_ms']:.2f} "
        f"ms, {on['waves']} waves, {on['scan_topk_per_wave']:.2f} scan_topk per wave), off "
        f"{off['qps']:.1f} QPS (p50 {off['p50_ms']:.2f} ms, p99 {off['p99_ms']:.2f} ms, "
        f"{off['waves']} waves); {out['compiled_programs']} shape keys; "
        f"{out['hbm_bytes_per_tenant']} superpack bytes per tenant against "
        f"{out['per_index_bytes_per_tenant']:.0f} per index, padded waste "
        f"{out['padded_waste_pct']}%; merge lane {out['merge_lane']}; metering "
        f"{out['metering']}; fair share {out['fairshare']}")
    log(json.dumps({"tenancy": out}))


# ---------------------------------------------------------------------------
# scripts: scripted queries, script_fields, runtime fields, scripted _update
# ---------------------------------------------------------------------------

SCRIPT_REQUESTS = 100  # of each kind
SCRIPT_CPU = 20  # of each kind held to the device="cpu" twin
SCRIPT_SHARDS_KEEP = 10  # of each kind held on the 8-shard index to one shard
SCRIPT_UPDATES = 1_000
SCRIPT_KINDS = ("script_score", "function_score", "random_score", "script_filter")


def _script_bodies(state: dict) -> dict:
    """SCRIPT_REQUESTS bodies of each kind over the corpus's `body` and its
    long `n`, their terms from phase traffic's requests."""
    bodies = {k: [] for k in SCRIPT_KINDS}
    reqs = state["requests"]
    for j in range(SCRIPT_REQUESTS):
        q = reqs[j % len(reqs)][0]
        bodies["script_score"].append({"script_score": {
            "query": q, "script": {"source": "_score * params.a + doc['n'].value / 1000",
                                   "params": {"a": 1 + j % 3}}}})
        bodies["function_score"].append({"function_score": {
            "query": q, "functions": [
                {"field_value_factor": {"field": "n", "factor": 0.01, "modifier": "log1p"}},
                {"gauss": {"n": {"origin": 500 + 10 * j, "scale": 200}}},
                {"filter": {"range": {"n": {"gte": 900}}}, "weight": 2.0}],
            "score_mode": "sum", "boost_mode": "multiply"}})
        bodies["random_score"].append({"function_score": {
            "query": q, "functions": [{"random_score": {"seed": j}}], "boost_mode": "replace"}})
        bodies["script_filter"].append({"bool": {
            "must": [q], "filter": [{"script": {"script": f"doc['n'].value % 7 == {j % 7}"}}]}})
    return bodies


def phase_scripts(device, state: dict) -> None:
    """Scripted search on phase index's 1M-doc index: 100 each of
    script_score, function_score (field_value_factor, a gauss decay, a
    filtered weight), random_score and a bool with a script filter (p50/p99,
    scan_topk launches), 20 of each against the device="cpu" twin; then
    script_fields at size 10 and a runtime long field in a range filter, a
    terms agg and a sort, each against the twin. 10 each of script_score and
    function_score (exact BM25 inside) are kept for the 8-shard index."""
    from elasticsearch_tpu_torch.ops import kernels

    idx = state["index"]
    cpu = _cpu_twin_index(idx)
    bodies = _script_bodies(state)
    out, launches, keep = {}, {}, {}
    for kind, qs in bodies.items():
        calls = [{"query": q, "size": 10} for q in qs]
        lat, answers, n = _timed_searches(idx, calls)
        launches[kind] = n
        if n["scan_topk"] != len(calls):
            raise AssertionError(f"{kind}: {n['scan_topk']} scan_topk launches for "
                                 f"{len(calls)} requests")
        worst, swapped, equal = _against_cpu(cpu, calls[:SCRIPT_CPU], answers[:SCRIPT_CPU],
                                             f"scripts {kind}")
        out[kind] = {**_p(lat), "against_cpu": {"max_rel": worst, "swapped": swapped,
                                                "equal": equal, "n": SCRIPT_CPU}}
        if kind in ("script_score", "function_score"):
            keep[kind] = list(zip(calls[:SCRIPT_SHARDS_KEEP], answers[:SCRIPT_SHARDS_KEEP]))
    q0 = state["requests"][0][0]
    sf = {"n2": {"script": {"source": "doc['n'].value * params.f", "params": {"f": 2}}},
          "scored": {"script": "_score + doc['n'].value"}}
    rm = {"n_mod": {"type": "long", "script": "emit(doc['n'].value % 13)"}}
    extra = {
        "script_fields": {"query": q0, "size": 10, "script_fields": sf},
        "runtime_range": {"query": {"range": {"n_mod": {"gte": 10}}}, "size": 10,
                          "runtime_mappings": rm},
        "runtime_terms": {"query": q0, "size": 0, "runtime_mappings": rm,
                          "aggs": {"m": {"terms": {"field": "n_mod", "size": 13}}}},
        "runtime_sort": {"query": q0, "size": 10, "runtime_mappings": rm,
                         "sort": [{"n_mod": "desc"}, {"n": "asc"}]},
    }
    for what, kw in extra.items():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = idx.search(**kw)
        ms = (time.perf_counter() - t0) * 1e3
        launches[what] = dict(kernels.launch_counts)
        want = cpu.search(**kw)
        if what == "script_fields":
            _against_cpu(cpu, [kw], [got], "script_fields", wants=[want])
            for g, w in zip(got["hits"]["hits"], want["hits"]["hits"]):
                gf, wf = g["fields"], w["fields"]
                if g["_id"] == w["_id"] and (gf["n2"] != wf["n2"] or not np.isclose(
                        gf["scored"][0], wf["scored"][0], rtol=1e-6)):
                    raise AssertionError(f"script_fields of {g['_id']} differ from the cpu run")
        elif got != want:
            raise AssertionError(f"scripts {what}: differs from the device=cpu run")
        out[what] = {"ms": ms}
    if not launches["runtime_sort"]["scan_topk"] and not launches["runtime_range"]["scan_topk"]:
        raise AssertionError("the runtime-field searches launched no scan_topk")
    state["scripts_keep"] = keep
    state.setdefault("scripts_launches", {}).update(launches)
    state["scripts"] = out
    for kind in SCRIPT_KINDS:
        m = out[kind]
        log(f"scripts {kind}: p50 {m['p50_ms']:.2f} ms p99 {m['p99_ms']:.2f} ms, "
            f"{launches[kind]['scan_topk'] / SCRIPT_REQUESTS:.1f} scan_topk per request; "
            f"against the cpu run {m['against_cpu']}")
    log("scripts: " + ", ".join(f"{w} {out[w]['ms']:.1f} ms" for w in extra)
        + "; each equal to the cpu run")


def phase_scripts_update(device, state: dict) -> None:
    """1,000 scripted `_update`s over REST on the 1M-doc index (after phase
    writes: the index's tiers take them as any write), then a refresh: every
    source equal to a device="cpu" engine's after the same calls on the same
    docs, and a range search over the updated field equal to the cpu twin's
    answer."""
    from elasticsearch_tpu_torch.engine import Engine

    idx = state["index"]
    rng = np.random.default_rng(17)
    live = [i for i, e in idx._docs.items() if e.alive]
    ids = [live[j] for j in rng.choice(len(live), SCRIPT_UPDATES, replace=False)]
    cpu = Engine(device="cpu")
    twin = cpu.create_index("corpus", {"properties": {"body": {"type": "text"},
                                                      "n": {"type": "long"}}})
    for i in ids:
        twin.index_doc(i, json.loads(json.dumps(idx._docs[i].source)))
    scripts = [{"script": {"source": "ctx._source.n += params.k", "params": {"k": 1000}}},
               {"script": "ctx._source.n *= 2; ctx._source.n = ctx._source.n - 1"},
               {"script": "ctx.op = 'noop'"}]
    server, client = _serve(state, device)
    try:
        t0 = time.perf_counter()
        for j, i in enumerate(ids):
            body = scripts[j % len(scripts)]
            status, _h, resp = client("POST", f"/corpus/_update/{i}", body)
            if status != 200:
                raise AssertionError(f"_update {i}: {status} {resp}")
            want = cpu.update_doc_api("corpus", i, json.loads(json.dumps(body)))
            if resp["result"] != want["result"]:
                raise AssertionError(f"_update {i}: {resp['result']} vs {want['result']}")
        update_s = time.perf_counter() - t0
        status, _h, _r = client("POST", "/corpus/_refresh")
    finally:
        client.close()
        server.stop()
    for i in ids:
        if idx.get_doc(i)["_source"] != twin.get_doc(i)["_source"]:
            raise AssertionError(f"doc {i}: the source differs from the cpu run's")
    q = {"range": {"n": {"gte": 1000}}}
    got = idx.search(q, size=10)
    want = _cpu_twin_index(idx).search(q, size=10)
    if got != want:
        raise AssertionError("the range over the updated field differs from the cpu twin")
    cpu.close()
    state.setdefault("scripts", {})["updates"] = {"n": SCRIPT_UPDATES, "s": update_s,
                                                  "range_total": got["hits"]["total"]["value"]}
    log(f"scripts_update: {SCRIPT_UPDATES} scripted _updates over REST in {update_s:.2f} s, "
        f"refreshed ({idx.last_refresh_kind}); every source equal to the cpu run's; a range "
        f"over the updated field equal to the cpu twin ({got['hits']['total']['value']} hits)")


def phase_scripts_shards(device, state: dict) -> None:
    """The kept script_score and function_score requests on the 8-shard
    index of the same docs, held to the one-shard answers (global
    statistics, exact BM25 inside: scores within 1e-6 relative, ids up to
    fp-ties); random_score (its values follow the per-shard docids) and the
    script filter (its query scores from each shard's impact codes) held to
    the 8-shard index's device="cpu" twin."""
    idx8 = state["shards_index"]
    out, launches = {}, {}
    for kind, kept in state["scripts_keep"].items():
        calls = [kw for kw, _ans in kept]
        lat, answers, n = _timed_searches(idx8, calls, warm=0)
        launches[f"{kind}_8shards"] = n
        worst, swapped, _eq = _against_cpu(None, calls, answers, f"8-shard {kind}",
                                           wants=[ans for _kw, ans in kept])
        out[kind] = {**_p(lat), "max_rel": worst, "swapped": swapped}
    bodies = _script_bodies(state)
    twin = _cpu_twin_index(idx8)
    for kind in ("random_score", "script_filter"):
        calls = [{"query": q, "size": 10} for q in bodies[kind][:SCRIPT_SHARDS_KEEP]]
        lat, answers, n = _timed_searches(idx8, calls, warm=0)
        launches[f"{kind}_8shards"] = n
        worst, swapped, equal = _against_cpu(twin, calls, answers, f"8-shard {kind}")
        out[kind] = {**_p(lat), "max_rel": worst, "equal": equal}
    for name, n in launches.items():
        if not n["scan_topk"]:
            raise AssertionError(f"{name}: no scan_topk launch")
    state.setdefault("scripts_launches", {}).update(launches)
    state.setdefault("scripts", {})["shards"] = out
    log(f"scripts_shards: {SCRIPT_SHARDS_KEEP} of each kind on {N_SHARDS} shards against one "
        f"shard, random_score against the cpu twin: {out}")
    log(json.dumps({"scripts": state["scripts"]}))


# ---------------------------------------------------------------------------
# slice 18: the other field types and query kinds (geo, ip / date_nanos,
# the long-tail kinds, the host matchers, analysis). No kernel of its own:
# every request ends in scan_topk (one launch per request, k=1 at size 0).
# ---------------------------------------------------------------------------

# Rally's geonames track has 11.4M docs: the 1-shard index is cut to 125,000,
# the sharded check to 4 x 6,250 held to one shard of the same 25,000 docs
# (1M and 4 x 50,000 took 111 s to build of a run over its time budget, and
# 4 x 25,000 with its one shard 14.5 s of a run at 1,053 s of its 1,200;
# 250,000 took 15 s of a run at 1,023 s, with slice 19's phases, on an
# NVIDIA H100 80GB HBM3 at 700 W; 4 x 12,500 cut again to make room for
# slice 20's phases)
GEO_DOCS = 125_000
GEO_SHARD_DOCS = 6_250
GEO_SHARDS = 4
GEO_COUNTS = {"geo_distance": 100, "geo_bounding_box": 100, "distance_feature": 100,
              "rank_feature": 200, "terms_set": 20}  # rank_feature: 50 of each function
GEO_AGG_RUNS = 25
SLICE18_CPU = 10  # requests per kind held to the device="cpu" twin (and to one shard)
# bench.py C3 under the http_logs mapping (ip, date_nanos), cut from C3's
# 1M (its phase took 61 s of a run over its time budget, on an NVIDIA H100
# 80GB HBM3 at 700 W)
TYPED_DOCS = 250_000
TYPED_COUNTS = {"ip_term": 100, "cidr_16": 50, "cidr_24": 50, "ip_range": 50, "ip_terms": 50,
                "nanos_range": 50}
DISCOVER_PAGES, DISCOVER_SIZE = 10, 100
EXTRA_COUNTS = {"more_like_this": 100, "combined_fields": 50, "pinned": 50, "wrapper": 20,
                "intervals": 50}
EXTRA_SHARD_MLT = 20  # more_like_this by _id on the 8-shard index
EXTRA_CPU = 10  # of each extra kind held to the 1M-doc index's cpu run
EXTRA_WITNESS_DOCS = 24_000  # the 8-shard witness, built on the card and on the host
# Rally's nested track has 11.2M StackOverflow questions, its percolator
# track 100,000 stored queries: cut to 12,500 questions (the host walk over
# 50,000 took 0.2 s a request, on an NVIDIA H100 80GB HBM3 at 700 W; 25,000
# cut again to make room for slice 20's phases, the walk following the
# questions) and 1,000 queries
QA_DOCS = 12_500
NESTED_REQUESTS = 20
NESTED_CPU = 3
PERCOLATOR_QUERIES = 1_000
PERCOLATE_REQUESTS = 10
PERCOLATE_CPU = 3
MATCHER_WALKS = 3  # requests whose host walk is timed on its own
# 100,000 took the phase 38 s of a run over its time budget (the host
# analysis of two fields), on an NVIDIA H100 80GB HBM3 at 700 W
ANALYSIS_DOCS = 30_000
ANALYSIS_REQUESTS = 50  # match and match_phrase, per analyzed field
ANALYSIS_SETTINGS = {"analysis": {
    "filter": {"sg": {"type": "synonym_graph", "synonyms": ["t1, t2", "t3 => t30", "t5, t6, t7"]},
               "eg": {"type": "edge_ngram", "min_gram": 2, "max_gram": 4}},
    "analyzer": {"syn_ngram": {"tokenizer": "standard", "filter": ["lowercase", "sg", "eg"]}}}}
ANALYSIS_MAPPINGS = {"properties": {"en": {"type": "text", "analyzer": "english"},
                                    "cu": {"type": "text", "analyzer": "syn_ngram"}}}


def _index_docs(state: dict, device, name: str, mappings: dict, docs, shards: int = 1,
                settings: dict | None = None) -> tuple:
    """docs through create_index / index_doc / refresh. -> (index, index_doc
    s, refresh s)."""
    idx = _engine(state, device).create_index(
        name, mappings, {"number_of_shards": shards, **(settings or {})})
    t0 = time.perf_counter()
    for i, d in docs:
        idx.index_doc(i, d)
    t1 = time.perf_counter()
    idx.refresh()
    sync(device)
    return idx, t1 - t0, time.perf_counter() - t1


# requests of a kind in its one profiled window, its first ones repeated
BUSY_WINDOW = 20


EMPTY_TRACES = {"retried": [], "not_measured": []}  # kinds whose busy window came back empty


def _window_busy(calls: list, what: str) -> dict:
    """Calls under the profiler in one trace: wall, device busy share.
    CUPTI has handed back traces of such requests with no kernel record at
    all, three in a row (PERF.md §7); the calls are then traced once more
    over a window four times as long, and if that too holds none the share
    is None (not measured), logged and counted in EMPTY_TRACES."""
    try:
        return _profiled_request(lambda: [c() for c in calls])
    except EmptyTraceError as e:
        log(f"profiler: {what}: {e}; tracing a window of {4 * len(calls)} requests")
        EMPTY_TRACES["retried"].append(what)
    try:
        return _profiled_request(lambda: [c() for c in calls * 4])
    except EmptyTraceError as e:
        log(f"profiler: {what}: busy share not measured ({e})")
        EMPTY_TRACES["not_measured"].append(what)
        return {"busy_share": None}


def _kind_busy(idx, calls: list, what: str) -> dict:
    """Requests of a kind under the profiler, in one trace (`_window_busy`).
    Its other checks stand when the share is not measured: its launch
    counts show the kernel ran."""
    return _window_busy([lambda kw=kw: idx.search(**kw) for kw in calls], what)


def _run_kind(idx, calls: list, what: str, cpu=None, n_cpu: int = SLICE18_CPU,
              per_request: int | None = 1, compare=None, warm: int = 5,
              window: int = BUSY_WINDOW) -> dict:
    """A kind's requests timed through EsIndex.search (after `warm` of them)
    between a reset and a read of the launch counts (scan_topk:
    `per_request` launches each when given, else at least one in all), one
    more under the profiler (`window` of them in one trace), and the first
    `n_cpu` held to `cpu` (the device="cpu" twin: `_against_cpu`, or
    `compare(calls, answers)`)."""
    lat, answers, n = _timed_searches(idx, calls, warm=min(warm, len(calls)))
    if per_request is not None and n["scan_topk"] != per_request * len(calls):
        raise AssertionError(f"{what}: {n['scan_topk']} scan_topk launches for "
                             f"{len(calls)} requests")
    if per_request is None and not n["scan_topk"] and what not in ("discover",):
        raise AssertionError(f"{what}: no scan_topk launch")
    busy = _kind_busy(idx, [calls[j % min(len(calls), 5)] for j in range(window)], what)
    out = {**_p(lat), "requests": len(calls), "scan_topk_per_request": n["scan_topk"] / len(calls),
           "busy_share": busy["busy_share"], "launches": n}
    if cpu is not None:
        if compare is not None:
            out["against_cpu"] = compare(calls[:n_cpu], answers[:n_cpu])
        else:
            worst, swapped, equal = _against_cpu(cpu, calls[:n_cpu], answers[:n_cpu], what)
            out["against_cpu"] = {"max_rel": worst, "swapped": swapped, "equal": equal,
                                  "n": min(n_cpu, len(calls))}
    out["answers"] = answers
    return out


def _log_kinds(phase: str, kinds: dict) -> None:
    for kind, m in kinds.items():
        busy = "not measured" if m["busy_share"] is None else f"{m['busy_share']:.3f}"
        log(f"{phase} {kind}: {m['requests']} requests, p50 {m['p50_ms']:.3f} ms p99 "
            f"{m['p99_ms']:.3f} ms, {m['scan_topk_per_request']:.2f} scan_topk per request, "
            f"device busy {busy}; against the cpu run "
            f"{m.get('against_cpu')}; held to one shard {m.get('against_one_shard')}")


def _kinds_summary(kinds: dict) -> dict:
    return {k: {x: v for x, v in m.items() if x not in ("answers", "launches")}
            for k, m in kinds.items()}


def _geo_requests(rng, docs, lat, lon) -> dict:
    """The geo phase's traffic over real doc points."""
    n = len(docs)
    pick = rng.integers(0, n, size=1000).tolist()
    pts = [(float(lat[j]), float(lon[j])) for j in pick]
    out: dict = {k: [] for k in GEO_COUNTS}
    for j in range(GEO_COUNTS["geo_distance"]):
        la, lo = pts[j]
        out["geo_distance"].append({"geo_distance": {
            "distance": ("1km", "10km", "100km")[j % 3], "location": {"lat": la, "lon": lo}}})
    for j in range(GEO_COUNTS["geo_bounding_box"]):
        la, lo = pts[100 + j]
        h, w = float(rng.uniform(0.2, 3.0)), float(rng.uniform(0.2, 3.0))
        if j % 10 == 0:  # ten across the dateline
            box = {"top": min(la + h, 89.0), "bottom": max(la - h, -89.0),
                   "left": float(rng.uniform(170, 179.5)), "right": float(rng.uniform(-179.5, -170))}
        else:
            box = {"top_left": {"lat": min(la + h, 89.0), "lon": max(lo - w, -180.0)},
                   "bottom_right": {"lat": max(la - h, -89.0), "lon": min(lo + w, 180.0)}}
        out["geo_bounding_box"].append({"geo_bounding_box": {"location": box}})
    for j in range(GEO_COUNTS["distance_feature"]):
        la, lo = pts[200 + j]
        name = docs[pick[300 + j]][1]["name"].split()[0]
        out["distance_feature"].append({"bool": {
            "must": [{"match": {"name": name}}],
            "should": [{"distance_feature": {"field": "location", "origin": {"lat": la, "lon": lo},
                                             "pivot": "50km"}}]}})
    fns = [{"log": {"scaling_factor": 2}}, {"sigmoid": {"pivot": 300, "exponent": 0.7}},
           {"linear": {}}]
    for j in range(GEO_COUNTS["rank_feature"]):  # saturation (default or given pivot), then
        f = ([{"saturation": {}}, {"saturation": {"pivot": 500}}][j % 2] if j < 50  # the rest
             else fns[min(j // 50 - 1, 2)])
        out["rank_feature"].append({"rank_feature": {"field": "pop_rank", **f}})
    for j in range(GEO_COUNTS["terms_set"]):
        terms = [f"k{int(x)}" for x in rng.choice(12, size=int(rng.integers(2, 5)), replace=False)]
        out["terms_set"].append({"terms_set": {"codes": {
            "terms": terms, "minimum_should_match_field": "required_matches"}}})
    return out


def phase_geo_index(device, rng, state: dict) -> None:
    """A geonames-shaped corpus (`corpus.geonames_corpus`, the fields of
    Rally's geonames track) of GEO_DOCS docs on one shard, and its first
    GEO_SHARDS x GEO_SHARD_DOCS docs on GEO_SHARDS shards and on one shard:
    index_doc and refresh seconds, the geo columns' bytes."""
    from elasticsearch_tpu_torch.corpus import GEONAMES_MAPPINGS, geonames_corpus

    t0 = time.perf_counter()
    docs, lat, lon = geonames_corpus(rng, GEO_DOCS)
    gen_s = time.perf_counter() - t0
    build = {"generate_s": gen_s}
    idx, ti, tr = _index_docs(state, device, "geonames", GEONAMES_MAPPINGS, docs)
    build["1"] = {"docs": len(docs), "index_doc_s": ti, "refresh_s": tr}
    m = GEO_SHARDS * GEO_SHARD_DOCS
    sh, ti4, tr4 = _index_docs(state, device, "geonames_shards", GEONAMES_MAPPINGS, docs[:m],
                               GEO_SHARDS)
    one, ti1, tr1 = _index_docs(state, device, "geonames_one", GEONAMES_MAPPINGS, docs[:m])
    build[str(GEO_SHARDS)] = {"docs": m, "index_doc_s": ti4, "refresh_s": tr4}
    build["1_same_docs"] = {"docs": m, "index_doc_s": ti1, "refresh_s": tr1}
    col = idx.searcher.pack.docvalues
    build["geo_column_bytes"] = int(sum(col[f].values.nbytes + col[f].has_value.nbytes
                                        for f in ("location#lat", "location#lon")))
    state.update(geo=idx, geo_shards=sh, geo_one=one, geo_docs=docs,
                 geo_lat32=lat.astype(np.float32).astype(np.float64),
                 geo_lon32=lon.astype(np.float32).astype(np.float64), geo_build=build)
    log(f"geo_index: geonames {json.dumps(build)}")


def _geo_edges():
    """`tests/geo_edges.py`, the float64 boundary-doc helpers that the geo
    checks share with the port's CPU tests."""
    import importlib
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("geo_edges")


def _geo_distance_compare(state: dict, cpu):
    """geo_distance on the card against the cpu twin: the match sets (all
    hits, size 10,000) equal but for boundary docs (float64 distance within
    1e-5 relative of the radius), which are counted."""
    from elasticsearch_tpu_torch.query.geo import parse_distance_meters

    boundary_docs = _geo_edges().boundary_docs

    def compare(calls, answers):
        edge_total = diff_total = 0
        idx = state["geo"]
        for kw in calls:
            full = {**kw, "size": 10_000}
            got = {h["_id"] for h in idx.search(**full)["hits"]["hits"]}
            want = {h["_id"] for h in cpu.search(**full)["hits"]["hits"]}
            (spec,) = kw["query"].values()
            o = spec["location"]
            edge = {str(i) for i in np.flatnonzero(boundary_docs(
                state["geo_lat32"], state["geo_lon32"], o["lat"], o["lon"],
                parse_distance_meters(spec["distance"])))}
            if got - edge != want - edge:
                raise AssertionError(f"geo_distance {kw}: the card's match set differs from the "
                                     f"cpu run's beyond {len(edge)} boundary docs")
            edge_total += len(edge)
            diff_total += len(got ^ want)
        return {"n": len(calls), "boundary_docs": edge_total, "boundary_docs_differing": diff_total}
    return compare


def _geotile_against_cpu(got: dict, want: dict, state: dict, precision: int) -> dict:
    """geotile_grid on the card against the cpu run: the docs that moved to
    another tile are at most the boundary docs (a float64 tile coordinate
    within 1e-4 of a tile edge, where the card's f32 `log`, `tan` and `cos`
    may round across it); the buckets with equal counts have equal
    centroids."""
    edge = int(_geo_edges().tile_boundary_docs(state["geo_lat32"], state["geo_lon32"],
                                               precision).sum())
    g = {b["key"]: b for b in got["aggregations"]["t"]["buckets"]}
    w = {b["key"]: b for b in want["aggregations"]["t"]["buckets"]}
    moved = sum(max(0, g.get(k, {"doc_count": 0})["doc_count"]
                    - w.get(k, {"doc_count": 0})["doc_count"]) for k in set(g) | set(w))
    if moved > edge:
        raise AssertionError(f"geotile_grid: {moved} docs in other tiles than the cpu run's, "
                             f"{edge} boundary docs")
    for k, b in w.items():
        if k in g and g[k]["doc_count"] == b["doc_count"] and g[k]["c"] != b["c"] and moved == 0:
            raise AssertionError(f"geotile_grid: tile {k}'s centroid differs")
    return {"n": 1, "buckets": len(w), "docs_moved": moved, "boundary_docs": edge}


def phase_geo(device, rng, state: dict) -> None:
    """The geo traffic on the GEO_DOCS-doc geonames index: geo_distance at 1, 10
    and 100 km around real doc points, geo_bounding_box (10 across the
    dateline), distance_feature on the location in a bool with a match on
    the name, rank_feature in each function, terms_set; p50/p99, scan_topk
    launches per request (one), device busy share; SLICE18_CPU of each held
    to the device="cpu" twin (geo_distance: match sets equal but for counted
    boundary docs). Then geotile_grid (precision 6) with a geo_centroid
    sub-agg and geo_bounds under a filter, GEO_AGG_RUNS timed runs each (k=1
    at size 0), held to the twin; and the same kinds on the GEO_SHARDS-shard
    index held to one shard of its docs."""
    idx, docs = state["geo"], state["geo_docs"]
    cpu = _cpu_twin_index(idx)
    reqs = _geo_requests(rng, docs, state["geo_lat32"], state["geo_lon32"])
    kinds = {}
    for kind, qs in reqs.items():
        calls = [{"query": q, "size": 10} for q in qs]
        kinds[kind] = _run_kind(idx, calls, f"geo {kind}", cpu, compare=(
            _geo_distance_compare(state, cpu) if kind == "geo_distance" else None))
    agg_calls = {
        "geotile_grid": {"query": None, "size": 0, "aggs": {"t": {
            "geotile_grid": {"field": "location", "precision": 6},
            "aggs": {"c": {"geo_centroid": {"field": "location"}}}}}},
        "geo_bounds": {"query": {"range": {"population": {"gte": 1000}}}, "size": 0, "aggs": {
            "f": {"filter": {"term": {"feature_class": "P"}},
                  "aggs": {"b": {"geo_bounds": {"field": "location"}}}}}},
    }
    for kind, kw in agg_calls.items():
        m = _run_kind(idx, [kw] * GEO_AGG_RUNS, f"geo {kind}")
        got, want = m["answers"][-1], cpu.search(**kw)
        if kind == "geotile_grid":
            m["against_cpu"] = _geotile_against_cpu(got, want, state, 6)
        elif got != want:
            raise AssertionError(f"geo {kind}: the aggregations differ from the cpu run's")
        else:
            m["against_cpu"] = {"equal": True, "n": 1}
        kinds[kind] = m
    tiles = kinds["geotile_grid"]["answers"][-1]["aggregations"]["t"]["buckets"]
    if sum(b["doc_count"] for b in tiles) > len(docs) or not tiles:
        raise AssertionError("geotile_grid: malformed buckets")
    # the sharded index against one shard of the same docs (no text: the
    # scores are equal up to rounding); the text-scored kinds against its twin
    sh, one = state["geo_shards"], state["geo_one"]
    sh_cpu = _cpu_twin_index(sh)
    sub = _geo_requests(np.random.default_rng(7), docs[:GEO_SHARDS * GEO_SHARD_DOCS],
                        state["geo_lat32"], state["geo_lon32"])
    for kind, qs in sub.items():
        calls = [{"query": q, "size": 10} for q in qs[:SLICE18_CPU]]
        m = _run_kind(sh, calls, f"geo {kind} {GEO_SHARDS} shards",
                      None if kind in ("geo_distance", "geo_bounding_box", "rank_feature")
                      else sh_cpu)
        if kind in ("geo_distance", "geo_bounding_box"):  # constant scores: the whole sets
            for kw in calls:
                full = {**kw, "size": 10_000}
                if ({h["_id"] for h in sh.search(**full)["hits"]["hits"]}
                        != {h["_id"] for h in one.search(**full)["hits"]["hits"]}):
                    raise AssertionError(f"geo {kind} on {GEO_SHARDS} shards: the match set "
                                         f"differs from one shard's")
        if kind in ("geo_distance", "geo_bounding_box", "rank_feature"):
            wants = [one.search(**kw) for kw in calls]
            worst, swapped, equal = _against_cpu(None, calls, m["answers"],
                                                 f"geo {kind} shards", wants=wants)
            m["against_one_shard"] = {"max_rel": worst, "swapped": swapped, "equal": equal,
                                      "n": len(calls)}
        kinds[f"{kind}_{GEO_SHARDS}shards"] = m
    _log_kinds("geo", kinds)
    state.setdefault("slice18_launches", {}).update(
        {f"geo_{k}": m["launches"] for k, m in kinds.items()})
    state["geo_out"] = _kinds_summary(kinds)
    _drop_index(state, "geonames_shards", "geo_shards", device)
    _drop_index(state, "geonames_one", "geo_one", device)


def _sorted_pages(idx, sort, pages: int, size: int) -> tuple[list, list]:
    """`pages` search_after pages of `size` hits. -> (hits, latencies ms)."""
    hits, lat, after = [], [], None
    for _ in range(pages):
        kw = {"query": {"match_all": {}}, "size": size, "sort": sort}
        if after is not None:
            kw["search_after"] = after
        t0 = time.perf_counter()
        page = idx.search(**kw)["hits"]["hits"]
        lat.append((time.perf_counter() - t0) * 1e3)
        if not page:
            break
        hits += page
        after = page[-1]["sort"]
    return hits, lat


def phase_field_types(device, rng, state: dict) -> None:
    """bench.py C3's corpus (TYPED_DOCS docs) under the mapping Rally's
    http_logs track gives it (`corpus.C3_TYPED_MAPPINGS`: clientip ip,
    @timestamp date_nanos, one doc in ten with sub-millisecond digits): ip
    term, CIDR /16 and /24 terms, ip range, terms on clientip, a date_nanos
    range with sub-millisecond bounds (p50/p99, scan_topk per request, busy
    share, SLICE18_CPU of each held to the cpu twin); Discover's page sorted
    by clientip and by @timestamp, DISCOVER_PAGES search_after pages of
    DISCOVER_SIZE each, equal to the twin's pages (the sort path: no
    scan_topk), the ip keys in address order and the nanos keys int64 in
    order."""
    from elasticsearch_tpu_torch.corpus import C3_TYPED_MAPPINGS, c3_corpus, c3_typed_docs
    from elasticsearch_tpu_torch.index.mappings import format_date_nanos, ip_sort_key
    from elasticsearch_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    docs = c3_typed_docs(c3_corpus(rng, TYPED_DOCS), rng)
    gen_s = time.perf_counter() - t0
    idx, ti, tr = _index_docs(state, device, "http_typed", C3_TYPED_MAPPINGS, docs)
    cpu = _cpu_twin_index(idx)
    ips = [d["clientip"] for _i, d in docs[:5000]]
    t_ns = [1_420_070_400_000_000_000 + int(x) for x in rng.integers(0, 30 * 86_400_000_000_000,
                                                                      size=TYPED_COUNTS["nanos_range"])]
    reqs = {
        "ip_term": [{"term": {"clientip": ips[j]}} for j in range(TYPED_COUNTS["ip_term"])],
        "cidr_16": [{"term": {"clientip": ".".join(ips[j].split(".")[:2]) + ".0.0/16"}}
                    for j in range(TYPED_COUNTS["cidr_16"])],
        "cidr_24": [{"term": {"clientip": ".".join(ips[j].split(".")[:3]) + ".0/24"}}
                    for j in range(TYPED_COUNTS["cidr_24"])],
        "ip_range": [{"range": {"clientip": {"gte": ips[j], "lt": ips[j + 1]}
                               if ip_sort_key(ips[j]) < ip_sort_key(ips[j + 1]) else
                               {"gte": ips[j + 1], "lt": ips[j]}}}
                     for j in range(TYPED_COUNTS["ip_range"])],
        "ip_terms": [{"terms": {"clientip": ips[j * 4: j * 4 + 4]}}
                     for j in range(TYPED_COUNTS["ip_terms"])],
        "nanos_range": [{"range": {"@timestamp": {"gt": format_date_nanos(t),
                                                  "lte": format_date_nanos(t + 3_600_000_000_500)}}}
                        for t in t_ns],
    }
    kinds = {k: _run_kind(idx, [{"query": q, "size": 10} for q in qs], f"field_types {k}", cpu)
             for k, qs in reqs.items()}
    discover = {}
    for key, sort in (("clientip", [{"clientip": "asc"}]), ("@timestamp", [{"@timestamp": "desc"}])):
        kernels.reset_launch_counts()
        hits, lat = _sorted_pages(idx, sort, DISCOVER_PAGES, DISCOVER_SIZE)
        n = dict(kernels.launch_counts)
        want, _l = _sorted_pages(cpu, sort, DISCOVER_PAGES, DISCOVER_SIZE)
        if [(h["_id"], h["sort"]) for h in hits] != [(h["_id"], h["sort"]) for h in want]:
            raise AssertionError(f"field_types discover {key}: pages differ from the cpu run's")
        keys = [h["sort"][0] for h in hits]
        if key == "clientip":
            ok = [ip_sort_key(k) for k in keys] == sorted(ip_sort_key(k) for k in keys)
        else:
            ok = all(isinstance(k, int) for k in keys) and keys == sorted(keys, reverse=True)
        if not ok or len(hits) != DISCOVER_PAGES * DISCOVER_SIZE:
            raise AssertionError(f"field_types discover {key}: keys out of order")
        discover[key] = {**_p(lat), "pages": DISCOVER_PAGES, "size": DISCOVER_SIZE,
                         "scan_topk": n["scan_topk"], "equal_cpu": True}
    _log_kinds("field_types", kinds)
    log(f"field_types discover: {json.dumps(discover)}")
    build = {"generate_s": gen_s, "docs": len(docs), "index_doc_s": ti, "refresh_s": tr}
    log(f"field_types: http_logs-typed C3 {json.dumps(build)}")
    state.setdefault("slice18_launches", {}).update(
        {f"types_{k}": m["launches"] for k, m in kinds.items()})
    state["types_out"] = {**_kinds_summary(kinds), "discover": discover, "build": build}
    _drop_index(state, "http_typed", "http_typed", device)


def _extra_requests(rng, lens, tok, n_docs: int) -> dict:
    """The long-tail kinds on the BM25 corpus: like texts of real docs,
    combined_fields over the body, pinned ids above an organic match,
    wrapped matches, intervals over mid-frequency terms (ranks 50-500)."""
    import base64

    from elasticsearch_tpu_torch.corpus import doc_texts

    starts = np.concatenate([[0], np.cumsum(lens)])
    pick = rng.integers(0, n_docs, size=400).tolist()
    texts = doc_texts(lens[pick], np.concatenate([tok[starts[d]: starts[d + 1]] for d in pick]))
    mid = lambda: f"t{int(rng.integers(50, 500))}"  # noqa: E731
    out = {"more_like_this": [{"more_like_this": {"fields": ["body"], "like": texts[j],
                                                  "min_term_freq": 1, "min_doc_freq": 5}}
                              for j in range(EXTRA_COUNTS["more_like_this"])],
           "combined_fields": [{"combined_fields": {"query": " ".join(texts[100 + j].split()[:3]),
                                                    "fields": ["body"]}}
                               for j in range(EXTRA_COUNTS["combined_fields"])],
           "pinned": [{"pinned": {"ids": [str(int(x)) for x in rng.integers(0, n_docs, size=3)],
                                  "organic": {"match": {"body": " ".join(
                                      texts[150 + j].split()[:2])}}}}
                      for j in range(EXTRA_COUNTS["pinned"])],
           "wrapper": [{"wrapper": {"query": base64.b64encode(json.dumps(
               {"match": {"body": " ".join(texts[200 + j].split()[:3])}}).encode()).decode()}}
               for j in range(EXTRA_COUNTS["wrapper"])],
           "intervals": []}
    for j in range(EXTRA_COUNTS["intervals"]):
        k = j % 4
        if k == 0:
            rule = {"match": {"query": f"{mid()} {mid()}", "ordered": True, "max_gaps": j % 4}}
        elif k == 1:
            rule = {"match": {"query": f"{mid()} {mid()}", "max_gaps": j % 4}}
        elif k == 2:
            rule = {"any_of": {"intervals": [{"match": {"query": f"{mid()} {mid()}", "max_gaps": 1}},
                                             {"match": {"query": f"{mid()} {mid()}",
                                                        "ordered": True}}]}}
        else:
            rule = {"all_of": {"intervals": [{"match": {"query": mid()}},
                                             {"match": {"query": f"{mid()} {mid()}",
                                                        "max_gaps": 3}}]}}
        out["intervals"].append({"intervals": {"body": rule}})
    return out


def phase_extra(device, rng, state: dict) -> None:
    """The long-tail kinds on phase index's 1M-doc BM25 index (before phase
    writes adds tiers): more_like_this with the texts of real docs as
    `like`, combined_fields, pinned, wrapper and intervals (ordered and
    unordered, max_gaps 0-3, any_of / all_of): p50/p99, scan_topk per
    request, busy share, SLICE18_CPU of each held to the cpu twin."""
    idx = state["index"]
    lens, tok = state["corpus"]
    cpu = _cpu_twin_index(idx)
    reqs = _extra_requests(rng, lens, tok, len(lens))
    kinds = {k: _run_kind(idx, [{"query": q, "size": 10} for q in qs], f"extra {k}", cpu,
                          n_cpu=EXTRA_CPU) for k, qs in reqs.items()}
    for k, m in kinds.items():
        m["matched_requests"] = sum(1 for a in m["answers"] if a["hits"]["total"]["value"])
        if not m["matched_requests"]:
            raise AssertionError(f"extra {k}: no request matched a doc")
    # the host half of intervals: the position walk per request
    from elasticsearch_tpu_torch.query.dsl import parse_query

    t0 = time.perf_counter()
    for q in reqs["intervals"]:
        parse_query(q, idx.mappings).prepare(idx._searcher.view)
    kinds["intervals"]["host_walk_s_per_request"] = (time.perf_counter() - t0) / len(
        reqs["intervals"])
    _log_kinds("extra", kinds)
    state.setdefault("slice18_launches", {}).update(
        {f"extra_{k}": m["launches"] for k, m in kinds.items()})
    state["extra_out"] = _kinds_summary(kinds)


def _mlt_id_calls(n_docs: int) -> list:
    """EXTRA_SHARD_MLT more_like_this requests, each by two `_id`s."""
    ids = np.random.default_rng(18).integers(0, n_docs, size=EXTRA_SHARD_MLT * 2).tolist()
    return [{"query": {"more_like_this": {"like": [{"_id": str(ids[2 * j])},
                                                   {"_id": str(ids[2 * j + 1])}],
                                          "min_term_freq": 1, "min_doc_freq": 5}}, "size": 10}
            for j in range(EXTRA_SHARD_MLT)]


def _mlt_as_bool(idx, spec: dict) -> dict:
    """The bool of term queries a more_like_this by `_id` (min_term_freq,
    min_doc_freq, the defaults otherwise) selects, worked out apart from
    the node: the like docs' sources by realtime get, analyzed, tf times
    the idf of the global df over n_max x S docs, the top 25 by (score
    desc, field, term), 30% of them required."""
    from collections import Counter

    from elasticsearch_tpu_torch.ops.scoring import bm25_idf

    sp = idx._searcher.sp
    fields = sorted(f for f, ft in idx.mappings.fields.items() if ft.type == "text")
    tf: Counter = Counter()
    for fld in fields:
        an = idx.mappings.fields[fld].get_analyzer()
        for like in spec["like"]:
            v = idx.get_doc(like["_id"])["_source"].get(fld)
            if isinstance(v, str):
                tf.update((fld, t) for t in an.terms(v))
    n_docs = sp.n_max * sp.S
    scored = sorted(((f * bm25_idf(n_docs, sp.global_df.get(k, 0)), k[0], k[1])
                     for k, f in tf.items() if f >= spec["min_term_freq"]
                     and sp.global_df.get(k, 0) >= spec["min_doc_freq"]),
                    key=lambda x: (-x[0], x[1], x[2]))[:25]
    if not scored:
        return {"match_none": {}}
    return {"bool": {"should": [{"term": {f: t}} for _s, f, t in scored],
                     "minimum_should_match": max(1, int(len(scored) * 30 / 100))}}


def phase_extra_shards(device, state: dict) -> None:
    """EXTRA_SHARD_MLT more_like_this by `_id` on the 8-shard index (each
    like doc's source from its shard's `doc_sources`, the terms over the
    global df), each answer `==` that of the bool of term queries it should
    select (`_mlt_as_bool`, from the docs' stored sources; a cpu twin of
    the 1M-doc 8-shard index costs ~20-40 s of host work). Then the
    witness: the corpus's first EXTRA_WITNESS_DOCS docs on 8 shards, built
    by the card's engine (the routed card build) and by a device="cpu"
    engine (the host route): each shard's card-built pack byte for byte
    against the host-built one, and the same more_like_this by `_id` on
    the card against the cpu engine's answers (scores within 1e-6
    relative, ids up to fp-ties), each `==` the cpu engine's bool of its
    terms."""
    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs
    from elasticsearch_tpu_torch.engine import Engine

    idx8 = state["shards_index"]
    calls = _mlt_id_calls(len(state["corpus"][0]))
    m = _run_kind(idx8, calls, "extra more_like_this by _id, 8 shards")
    for kw, got in zip(calls, m["answers"]):
        want = idx8.search(_mlt_as_bool(idx8, kw["query"]["more_like_this"]), size=10)
        if got != want:
            raise AssertionError(f"more_like_this by _id on 8 shards differs from the bool of "
                                 f"its terms: {kw}")
    m["against_terms_bool"] = {"n": len(calls), "equal": len(calls)}
    lens, tok = state["corpus"]
    n = EXTRA_WITNESS_DOCS
    docs = [(str(i), d) for i, d in enumerate(
        corpus_docs(lens[:n], tok[: int(lens[:n].sum())], state["nums"][:n]))]
    mark = _profile_mark(state)
    card, _ti, _tr = _index_docs(state, device, "mlt_witness", MAPPINGS, docs, shards=N_SHARDS)
    (prof,) = _new_profiles(state, mark)
    if prof["basis"].get("flat_csr") != "device":
        raise AssertionError(f"the witness's refresh did not take the card's route: "
                             f"{prof['basis']}")
    cpu = Engine(device="cpu")
    host = cpu.create_index("mlt_witness", MAPPINGS, {"number_of_shards": N_SHARDS})
    for i, d in docs:
        host.index_doc(i, d)
    host.refresh()
    n_arrays = n_bytes = 0
    for k, (g, w) in enumerate(zip(card.searcher.sp.shards, host.searcher.sp.shards)):
        a, b = _compare_packs(g, w, f"mlt_witness shard {k}")
        n_arrays, n_bytes = n_arrays + a, n_bytes + b
    wcalls = _mlt_id_calls(n)
    answers = [card.search(**kw) for kw in wcalls]
    worst, swapped, equal = _against_cpu(host, wcalls, answers, "more_like_this by _id, witness")
    for kw in wcalls:
        want = host.search(_mlt_as_bool(host, kw["query"]["more_like_this"]), size=10)
        if host.search(**kw) != want:
            raise AssertionError(f"more_like_this by _id on the cpu engine differs from the bool "
                                 f"of its terms: {kw}")
    if not any(a["hits"]["total"]["value"] for a in answers):
        raise AssertionError("more_like_this by _id, witness: no request matched a doc")
    cpu.close()
    _drop_index(state, "mlt_witness", "mlt_witness", device)
    m["against_cpu"] = {"docs": n, "shards": N_SHARDS, "arrays": n_arrays, "bytes": n_bytes,
                        "max_rel": worst, "swapped": swapped, "equal": equal, "n": len(wcalls)}
    _log_kinds("extra_shards", {"more_like_this_ids_8shards": m})
    state.setdefault("slice18_launches", {})["extra_mlt_ids_8shards"] = m["launches"]
    state.setdefault("extra_out", {})["more_like_this_ids_8shards"] = _kinds_summary({"m": m})["m"]


def phase_matchers(device, rng, state: dict) -> None:
    """nested: QA_DOCS StackOverflow-shaped questions (1-5 nested answers
    each, `corpus.qa_corpus`) and NESTED_REQUESTS nested queries with a
    range and a bool inside; percolate: PERCOLATOR_QUERIES stored match,
    term and bool queries over the BM25 vocabulary and PERCOLATE_REQUESTS
    requests of 1-4 documents. p50/p99, scan_topk per request, busy share,
    the host seconds of the per-request walk; NESTED_CPU nested and PERCOLATE_CPU
    percolate held to the cpu twin."""
    from elasticsearch_tpu_torch.corpus import (PERCOLATOR_MAPPINGS, QA_MAPPINGS,
                                                percolator_queries, qa_corpus)
    from elasticsearch_tpu_torch.query.dsl import parse_query

    qa, ti, tr = _index_docs(state, device, "qa", QA_MAPPINGS, qa_corpus(rng, QA_DOCS))
    nested = []
    for j in range(NESTED_REQUESTS):
        lo = int(rng.integers(0, 8))
        d0 = 1_230_768_000_000 + int(rng.integers(0, 7 * 365)) * 86_400_000
        inner = {"bool": {"must": [{"range": {"answers.score": {"gte": lo}}},
                                   {"range": {"answers.date": {"gte": d0,
                                                               "lt": d0 + 30 * 86_400_000}}}]}}
        if j % 2:
            inner["bool"]["must_not"] = [{"term": {"answers.user": f"u{int(rng.integers(0, 100))}"}}]
        nested.append({"nested": {"path": "answers", "query": inner}})
    qa_cpu = _cpu_twin_index(qa)
    kinds = {"nested": _run_kind(qa, [{"query": q, "size": 10} for q in nested], "nested",
                                 qa_cpu, n_cpu=NESTED_CPU, warm=1, window=5)}
    t0 = time.perf_counter()
    for q in nested[:MATCHER_WALKS]:
        parse_query(q, qa.mappings).prepare(qa._searcher.view)
    kinds["nested"]["host_walk_s_per_request"] = (time.perf_counter() - t0) / MATCHER_WALKS
    perc, tp, trp = _index_docs(state, device, "perc", PERCOLATOR_MAPPINGS,
                                percolator_queries(rng, PERCOLATOR_QUERIES))
    reqs = []
    for _ in range(PERCOLATE_REQUESTS):
        docs = [{"body": " ".join(f"t{int(x)}" for x in rng.integers(0, 2000, size=40)),
                 "tag": f"g{int(rng.integers(0, 20))}"} for _ in range(int(rng.integers(1, 5)))]
        reqs.append({"percolate": {"field": "query", "documents": docs}})
    # one percolate is thousands of eager launches: a window of three
    kinds["percolate"] = _run_kind(perc, [{"query": q, "size": 10} for q in reqs], "percolate",
                                   _cpu_twin_index(perc), n_cpu=PERCOLATE_CPU, warm=1, window=3)
    t0 = time.perf_counter()
    for q in reqs[:MATCHER_WALKS]:
        node = parse_query(q, perc.mappings)
        node.matching_docids(node.prepare(perc._searcher.view), device)
    kinds["percolate"]["host_walk_s_per_request"] = (time.perf_counter() - t0) / MATCHER_WALKS
    if not any(m["hits"]["total"]["value"] for m in kinds["percolate"]["answers"]):
        raise AssertionError("percolate: no stored query matched any request")
    _log_kinds("matchers", kinds)
    build = {"qa": {"docs": QA_DOCS, "index_doc_s": ti, "refresh_s": tr},
             "percolator": {"queries": PERCOLATOR_QUERIES, "index_doc_s": tp, "refresh_s": trp}}
    log(f"matchers: {json.dumps(build)}; host walk s per request: nested "
        f"{kinds['nested']['host_walk_s_per_request']:.3f}, percolate "
        f"{kinds['percolate']['host_walk_s_per_request']:.3f}")
    state.setdefault("slice18_launches", {}).update(
        {f"matchers_{k}": m["launches"] for k, m in kinds.items()})
    state["matchers_out"] = {**_kinds_summary(kinds), "build": build}
    for name in ("qa", "perc"):
        _drop_index(state, name, name, device)


def phase_analysis(device, rng, state: dict) -> None:
    """ANALYSIS_DOCS docs of the BM25 corpus's texts under `english` and a
    custom analyzer with synonym_graph and edge_ngram filters (the host
    route of the refresh, by the analyzers' type: the `build.analyze`
    basis), ANALYSIS_REQUESTS match and match_phrase requests per field
    (p50/p99, scan_topk, busy share, SLICE18_CPU held to the cpu twin); then
    over REST a `PUT /_synonyms/{set}`, an index whose search analyzer
    names the set, and a search that sees the set's new rules after a
    second PUT reloads it."""
    import copy

    from elasticsearch_tpu_torch.corpus import doc_texts, make_corpus

    lens, tok, _nums = make_corpus(rng, ANALYSIS_DOCS)
    texts = doc_texts(lens, tok)
    docs = [(str(i), {"en": t, "cu": t}) for i, t in enumerate(texts)]
    mark = _profile_mark(state)
    idx, ti, tr = _index_docs(state, device, "analysis", ANALYSIS_MAPPINGS, docs,
                              settings=copy.deepcopy(ANALYSIS_SETTINGS))
    (prof,) = _new_profiles(state, mark)
    if prof["basis"].get("build.analyze") != "host_analyzer":
        raise AssertionError(f"analysis: the refresh's analyze basis is {prof['basis']}")
    cpu = _cpu_twin_index(idx)
    starts = np.concatenate([[0], np.cumsum(lens)])
    reqs: dict = {}
    for fld in ("en", "cu"):
        for kind in ("match", "match_phrase"):
            qs = []
            for _ in range(ANALYSIS_REQUESTS):
                d = int(rng.integers(0, ANALYSIS_DOCS))
                w = [f"t{int(x)}" for x in tok[starts[d]: starts[d] + 2]]
                qs.append({kind: {fld: " ".join(w)}})
            reqs[f"{kind}_{fld}"] = qs
    kinds = {k: _run_kind(idx, [{"query": q, "size": 10} for q in qs], f"analysis {k}", cpu)
             for k, qs in reqs.items()}
    server, client = _serve(state, device)
    try:
        st, _h, r = client("PUT", "/_synonyms/s18", {"synonyms_set": [{"synonyms": "t1, t2"}]})
        if st != 200 or r["result"] not in ("created", "updated"):
            raise AssertionError(f"PUT /_synonyms: {st} {r}")
        st, _h, r = client("PUT", "/syn_rest", {
            "settings": {"analysis": {"filter": {"syn": {"type": "synonym", "synonyms_set": "s18"}},
                                      "analyzer": {"a": {"tokenizer": "standard",
                                                         "filter": ["lowercase", "syn"]}}}},
            "mappings": {"properties": {"t": {"type": "text", "search_analyzer": "a"}}}})
        if st != 200:
            raise AssertionError(f"PUT /syn_rest: {st} {r}")
        client("POST", "/_bulk?refresh=true", raw=_ndjson(
            x for i, t in enumerate(texts[:2000]) for x in ({"index": {"_index": "syn_rest",
                                                                      "_id": str(i)}}, {"t": t})))
        q = {"query": {"match": {"t": "zzz9"}}, "size": 0}
        before = client("POST", "/syn_rest/_search", q)[2]["hits"]["total"]["value"]
        st, _h, r = client("PUT", "/_synonyms/s18", {"synonyms_set": [
            {"synonyms": "t1, t2"}, {"synonyms": "zzz9, t4"}]})
        after = client("POST", "/syn_rest/_search", q)[2]["hits"]["total"]["value"]
        t4 = client("POST", "/syn_rest/_search", {"query": {"match": {"t": "t4"}}, "size": 0})[2][
            "hits"]["total"]["value"]
        if r["result"] != "updated" or before != 0 or after != t4 or not after:
            raise AssertionError(f"synonyms reload: before {before}, after {after}, t4 {t4}")
        client("DELETE", "/syn_rest")
    finally:
        server.stop()
    rest = {"before_reload_hits": before, "after_reload_hits": after}
    _log_kinds("analysis", kinds)
    build = {"docs": ANALYSIS_DOCS, "index_doc_s": ti, "refresh_s": tr,
             "analyze_basis": prof["basis"].get("build.analyze")}
    log(f"analysis: {json.dumps(build)}; synonyms reload over REST {rest}")
    state.setdefault("slice18_launches", {}).update(
        {f"analysis_{k}": m["launches"] for k, m in kinds.items()})
    state["analysis_out"] = {**_kinds_summary(kinds), "build": build, "rest": rest}
    _drop_index(state, "analysis", "analysis", device)


# ---------------------------------------------------------------------------
# slice 19: the fetch sub-phases with highlight, the suggesters, profile: true
# ---------------------------------------------------------------------------

FETCH_HIGHLIGHT = 100  # 20 with a highlight_query, 20 with require_field_match off
FETCH_DOCVALUES = 50  # docvalue_fields on the long field, 25 with the format "#.0"
FETCH_STORED = 50  # stored_fields `_none_` and a list
FETCH_REST = 50  # over REST, with serving off and with serving on
FETCH_CPU = 10  # of each kind held to the device="cpu" twin
SUGGEST_DOCS = 100_000  # geonames place names, on 1 shard and on 4 x 25,000
SUGGEST_SHARDS = 4
SUGGEST_PREFIXES = 200  # of 1-4 characters at size 5, SUGGEST_SKIP with skip_duplicates
SUGGEST_SKIP = 50
SUGGEST_REST = 20  # prefixes again through `_search` over REST
SUGGEST_TERM = 10  # real terms with one edit, on the BM25 corpus
SUGGEST_PHRASE = 3  # of 2 tokens
SUGGEST_CPU = {"completion": 20, "term": 3, "phrase": 3}
SUGGEST_MAPPINGS = {"properties": {"population": {"type": "long"},
                                   "suggest": {"type": "completion"}}}
PROFILE_REQUESTS = 50  # profile: true bools of 4 match clauses on 1 shard
PROFILE_SHARD_REQUESTS = 10  # on the 8-shard index
PROFILE_CPU = 5  # trees held to the device="cpu" run


def _fetched(idx, body: dict, mappings) -> dict:
    """A `_search` with its fetch phase, as the REST layer runs it."""
    from elasticsearch_tpu_torch.search.fetch import apply_fetch_phase

    res = idx.search(body["query"], size=body.get("size", 10))
    apply_fetch_phase(res["hits"]["hits"], body, lambda _name: mappings)
    return res


def _fetch_parts(res: dict) -> dict:
    return {h["_id"]: (h.get("_source"), h.get("fields"), h.get("highlight"))
            for h in res["hits"]["hits"]}


def _same_fetch(got: dict, want: dict, what: str) -> int:
    """The fetched parts (`_source`, `fields`, `highlight`) of every hit in
    both answers equal. -> hits compared."""
    g, w = _fetch_parts(got), _fetch_parts(want)
    common = g.keys() & w.keys()
    if len(common) < len(w) - 2:
        raise AssertionError(f"{what}: {len(common)} of {len(w)} hits in common")
    for i in common:
        if g[i] != w[i]:
            raise AssertionError(f"{what}: hit {i}: {g[i]} vs {w[i]}")
    return len(common)


def _fetch_requests(rng, lens, tok) -> dict:
    starts = np.concatenate([[0], np.cumsum(lens)])

    def words(n):
        d = int(rng.integers(0, len(lens)))
        ln = int(lens[d])
        at = int(rng.integers(0, max(ln - n, 0) + 1))
        return " ".join(f"t{int(x)}" for x in tok[starts[d] + at: starts[d] + min(at + n, ln)])

    hl = []
    for j in range(FETCH_HIGHLIGHT):
        opts = {"fragment_size": 100, "number_of_fragments": 3}
        body = {"query": {"match": {"body": words(4)}}, "size": 10}
        if j < 20:
            opts["highlight_query"] = {"match": {"body": words(2)}}
        elif j < 40:
            body["query"] = {"bool": {"should": [{"match": {"body": words(2)}},
                                                 {"range": {"n": {"gte": 0}}}]}}
            body["highlight"] = {"require_field_match": False, "fields": {"body": opts}}
            hl.append(body)
            continue
        body["highlight"] = {"fields": {"body": opts}}
        hl.append(body)
    dv = [{"query": {"match": {"body": words(3)}}, "size": 10,
           "docvalue_fields": ["n"] if j % 2 else [{"field": "n", "format": "#.0"}]}
          for j in range(FETCH_DOCVALUES)]
    stored = [{"query": {"match": {"body": words(3)}}, "size": 10,
               "stored_fields": "_none_" if j % 2 else ["n", "body"]}
              for j in range(FETCH_STORED)]
    return {"highlight": hl, "docvalue_fields": dv, "stored_fields": stored}


def phase_fetch_highlight(device, rng, state: dict) -> None:
    """The fetch sub-phases on the 1M-doc index of phase index (what a
    results page sends): FETCH_HIGHLIGHT highlighted `_search`es on the
    text field (fragment_size 100, 3 fragments; 20 with a highlight_query,
    20 with require_field_match off), FETCH_DOCVALUES with docvalue_fields
    on the long field (half with the format "#.0"), FETCH_STORED with
    stored_fields (`_none_` and a list): p50/p99 of search + fetch and of
    the fetch alone, one scan_topk launch per request, the device's busy
    share over 20 highlighted requests, FETCH_CPU of each kind held to the
    device="cpu" twin (hits, fragments, fields, sources). Then FETCH_REST
    of them over REST with serving off and on (the wave applies the fetch
    phase to each entry: equal to serving off)."""
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.search.fetch import apply_fetch_phase

    idx = state["index"]
    lens, tok = state["corpus"]
    kinds = _fetch_requests(rng, lens, tok)
    cpu = _cpu_twin_index(idx)
    out, launches = {}, {}
    for kind, bodies in kinds.items():
        for b in bodies[:3]:  # warm-up
            _fetched(idx, b, idx.mappings)
        kernels.reset_launch_counts()
        lat, fetch_lat, answers = [], [], []
        for b in bodies:
            t0 = time.perf_counter()
            res = idx.search(b["query"], size=10)
            t1 = time.perf_counter()
            apply_fetch_phase(res["hits"]["hits"], b, lambda _name: idx.mappings)
            t2 = time.perf_counter()
            lat.append((t2 - t0) * 1e3)
            fetch_lat.append((t2 - t1) * 1e3)
            answers.append(res)
        launches[kind] = dict(kernels.launch_counts)
        if launches[kind]["scan_topk"] != len(bodies):
            raise AssertionError(f"fetch {kind}: {launches[kind]['scan_topk']} scan_topk "
                                 f"launches for {len(bodies)} requests")
        marked = sum(bool(h.get("highlight")) for a in answers for h in a["hits"]["hits"])
        if kind == "highlight" and marked < len(bodies):
            raise AssertionError(f"fetch highlight: {marked} hits highlighted")
        if kind == "stored_fields" and any("_source" in h for a in answers[1::2]
                                           for h in a["hits"]["hits"]):
            raise AssertionError("fetch stored_fields: _none_ kept a _source")
        wants = [_fetched(cpu, b, idx.mappings) for b in bodies[:FETCH_CPU]]
        worst, swapped, _eq = _against_cpu(cpu, [{"query": b["query"], "size": 10}
                                                 for b in bodies[:FETCH_CPU]],
                                           answers[:FETCH_CPU], f"fetch {kind}", wants=wants)
        compared = sum(_same_fetch(a, w, f"fetch {kind} against the cpu run")
                       for a, w in zip(answers, wants))
        busy = (_window_busy([lambda b=b: _fetched(idx, b, idx.mappings)
                              for b in bodies[:BUSY_WINDOW]], f"fetch {kind}")
                if kind == "highlight" else {"busy_share": None})
        out[kind] = {"requests": len(bodies), **_p(lat), "fetch_p50_ms": float(
            np.percentile(fetch_lat, 50)), "fetch_p99_ms": float(np.percentile(fetch_lat, 99)),
            "busy_share": busy["busy_share"], "highlighted_hits": marked,
            "against_cpu": {"n": FETCH_CPU, "max_rel": worst, "swapped": swapped,
                            "hits_compared": compared}}
        log(f"fetch {kind}: {len(bodies)} requests, p50 {out[kind]['p50_ms']:.3f} ms p99 "
            f"{out[kind]['p99_ms']:.3f} ms (the fetch phase p50 {out[kind]['fetch_p50_ms']:.3f} "
            f"ms), scan_topk {launches[kind]['scan_topk']}, busy {busy['busy_share']}; "
            f"{compared} hits equal the cpu run's")
    # over REST: the same bodies, serving off, then on from 8 clients
    bodies = [b for k in kinds.values() for b in k[: FETCH_REST // 3 + 1]][:FETCH_REST]
    reqs = [("POST", "/corpus/_search", b) for b in bodies]
    server, c = _serve(state, device)
    try:
        def solo():
            got = [c(*r) for r in reqs]
            if any(st != 200 for st, _h, _r in got):
                raise AssertionError(f"fetch over REST: statuses {[g[0] for g in got]}")
            return [r for _st, _h, r in got]

        off = _rest_path(state, "fetch_serving_off", solo)
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": True}})
        before = c("GET", "/_serving/stats")[2]["serving"]
        on, lat_on, wall = _rest_path(state, "fetch_serving_on",
                                      lambda: _concurrent(server.port, reqs, 8))
        delta = _serving_delta(c("GET", "/_serving/stats")[2]["serving"], before)
        c("PUT", "/_cluster/settings", {"transient": {"serving.enabled": False}})
    finally:
        c.close()
        server.stop()
    # the wave's arms may swap the last hits in a tie class: every hit is
    # counted, the common ones compared, the others logged
    rest_compared = rest_left_out = 0
    for j, (a, b) in enumerate(zip(on, off)):
        if len(a["hits"]["hits"]) != len(b["hits"]["hits"]):
            raise AssertionError(f"fetch over REST {j}: {len(a['hits']['hits'])} hits with "
                                 f"serving on, {len(b['hits']['hits'])} off")
        n = _same_fetch(a, b, f"fetch over REST {j}: serving on against off")
        rest_compared += n
        rest_left_out += len(b["hits"]["hits"]) - n
    rl = state["rest_launches"]
    launches["rest_serving_off"] = rl.pop("fetch_serving_off")
    launches["rest_serving_on"] = rl.pop("fetch_serving_on")
    if delta["waves"] < 1 or launches["rest_serving_off"]["scan_topk"] != len(reqs):
        raise AssertionError(f"fetch over REST: waves {delta['waves']}, launches {launches}")
    out["rest"] = {"requests": len(reqs), "serving_on": {**_p(lat_on), "wall_s": wall,
                                                        "waves": delta["waves"],
                                                        "mean_wave": delta["mean_wave"]},
                   "hits_compared": rest_compared, "hits_left_out": rest_left_out}
    log(f"fetch over REST: {len(reqs)} requests with serving off and on ({delta['waves']} waves, "
        f"mean {delta['mean_wave']:.1f}): {rest_compared} hits equal, {rest_left_out} hits of "
        f"the serving-off answers not in the wave's; launches {launches}")
    state["fetch_launches"] = launches
    state["fetch_out"] = out


def _completion_key(opts: list) -> list:
    return [(o["text"], o["_score"]) for o in opts]


def _same_completion(got: list, want: list, what: str) -> None:
    """Completion options of two indices of the same docs: texts and
    weights equal in order; ids equal but within a run of equal (weight,
    text), whose docs the shards order otherwise (and the last run, which
    `size` may cut at another doc)."""
    if _completion_key(got) != _completion_key(want):
        raise AssertionError(f"{what}: {_completion_key(got)} vs {_completion_key(want)}")
    runs_g, runs_w = {}, {}
    for o in got:
        runs_g.setdefault((o["_score"], o["text"]), set()).add(o["_id"])
    for o in want:
        runs_w.setdefault((o["_score"], o["text"]), set()).add(o["_id"])
    last = (want[-1]["_score"], want[-1]["text"]) if want else None
    for key, ids in runs_w.items():
        if key != last and runs_g[key] != ids:
            raise AssertionError(f"{what}: ids of {key} differ")


def phase_suggest(device, rng, state: dict) -> None:
    """The suggesters (a search-as-you-type box): SUGGEST_DOCS geonames
    place names (`corpus.geonames_corpus`, Rally geonames' `name`, weighted
    by `population`) in a `completion` field on 1 shard and on
    SUGGEST_SHARDS, built on the card and, on 1 shard, packed again on the
    host route (device="cpu": the packs' completion lists equal, the cpu
    answers read the host pack); SUGGEST_PREFIXES prefixes of 1-4
    characters of real names at size 5 (SUGGEST_SKIP with
    skip_duplicates) through Engine.suggest_multi on both (the 4-shard
    answers held to the 1-shard ones), SUGGEST_REST through `_search` over
    REST; `term` suggestions of SUGGEST_TERM real terms with one edit and
    `phrase` suggestions of SUGGEST_PHRASE 2-token texts on the BM25
    corpus's 1M-doc index; SUGGEST_CPU of each against the device="cpu"
    runs. p50/p99 of each, the device's busy share of a `_search` with a
    completion suggestion beside."""
    from elasticsearch_tpu_torch.corpus import geonames_corpus
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.query.executor import ShardSearcher
    from elasticsearch_tpu_torch.search.suggest import run_suggest

    t0 = time.perf_counter()
    docs, _lat, _lon = geonames_corpus(rng, SUGGEST_DOCS)
    src = [(i, {"population": d["population"],
                "suggest": {"input": d["name"], "weight": d["population"]}}) for i, d in docs]
    gen_s = time.perf_counter() - t0
    one, ti1, tr1 = _index_docs(state, device, "suggest", SUGGEST_MAPPINGS, src)
    four, ti4, tr4 = _index_docs(state, device, "suggest4", SUGGEST_MAPPINGS, src,
                                 shards=SUGGEST_SHARDS)
    # the same docs packed with device="cpu" (the host route), searched there
    host, trh, _stages, _bases = _host_pack([(i, e.parsed) for i, e in one._docs.items()],
                                            one.mappings)
    card_list = one.searcher.pack.completion["suggest"]
    if card_list != host.completion["suggest"]:
        raise AssertionError("suggest: the card-built completion list differs from the "
                             "device=cpu build's")
    ids4 = sorted((inp, w, four.shard_docs[s][d][0])
                  for inp, w, s, d in four.searcher.sp.completion["suggest"])
    if ids4 != sorted((inp, w, one.shard_docs[0][d][0]) for inp, w, d in card_list):
        raise AssertionError("suggest: the 4-shard completion list differs from 1 shard's")
    cpu = _cpu_twin_index(one)
    cpu._searcher = ShardSearcher(host, device="cpu", mappings=one.mappings)
    names = [d["name"] for _i, d in docs]
    pick = rng.integers(0, len(names), size=SUGGEST_PREFIXES)
    bodies = [{"c": {"prefix": names[j][: 1 + k % 4], "completion": {
        "field": "suggest", "size": 5, "skip_duplicates": k < SUGGEST_SKIP}}}
        for k, j in enumerate(pick.tolist())]
    engine = _engine(state, device)
    out, launches, answers = {}, {}, {}
    for name, target in (("completion", "suggest"), ("completion_4_shards", "suggest4")):
        engine.suggest_multi(target, bodies[0])  # warm-up
        kernels.reset_launch_counts()
        lat, got = [], []
        for b in bodies:
            t2 = time.perf_counter()
            got.append(engine.suggest_multi(target, b))
            lat.append((time.perf_counter() - t2) * 1e3)
        launches[name] = dict(kernels.launch_counts)
        out[name] = {"requests": len(bodies), **_p(lat),
                     "options": sum(len(a["c"][0]["options"]) for a in got)}
        answers[name] = got
    one_ans = answers["completion"]
    for j, (a, b) in enumerate(zip(answers["completion_4_shards"], one_ans)):
        _same_completion(a["c"][0]["options"], b["c"][0]["options"],
                         f"suggest {bodies[j]} on {SUGGEST_SHARDS} shards against 1")
    for j in range(SUGGEST_CPU["completion"]):
        if run_suggest(cpu, bodies[j]) != one_ans[j]:
            raise AssertionError(f"suggest {bodies[j]}: the card differs from the cpu run")
    if out["completion"]["options"] < len(bodies):
        raise AssertionError(f"suggest: {out['completion']['options']} options")
    # through `_search` over REST: a completion suggestion beside a size-0 search
    rest_bodies = [{"size": 0, "suggest": b} for b in bodies[:SUGGEST_REST]]
    server, c = _serve(state, device)
    try:
        lat_rest = []

        def rest():
            got = []
            for b in rest_bodies:
                t2 = time.perf_counter()
                got.append(c("POST", "/suggest/_search", b)[2])
                lat_rest.append((time.perf_counter() - t2) * 1e3)
            return got

        rest_ans = _rest_path(state, "suggest_rest", rest)
    finally:
        c.close()
        server.stop()
    launches["rest"] = state["rest_launches"].pop("suggest_rest")
    for j, r in enumerate(rest_ans):
        if r["suggest"] != one_ans[j]:
            raise AssertionError(f"suggest over REST {rest_bodies[j]} differs")
    out["rest"] = {"requests": len(rest_bodies), **_p(lat_rest)}
    busy = _window_busy([lambda b=b: (engine.search_multi("suggest", size=0),
                                      engine.suggest_multi("suggest", b["suggest"]))
                         for b in rest_bodies], "suggest completion")
    out["completion"]["busy_share"] = busy["busy_share"]
    # term and phrase suggestions on the BM25 corpus
    idx = state["index"]
    lens, tok = state["corpus"]
    starts = np.concatenate([[0], np.cumsum(lens)])

    def real_term():
        d = int(rng.integers(0, len(lens)))
        return f"t{int(tok[starts[d] + int(rng.integers(0, lens[d]))])}"

    def one_edit(term: str) -> str:
        # a letter inserted past the prefix_length of 1: a word the
        # dictionary lacks (its terms are t<rank>), one edit from the term
        pos = int(rng.integers(1, len(term) + 1))
        return term[:pos] + "abcdefghijklmnopqrsuvwxyz"[int(rng.integers(0, 25))] + term[pos:]

    term_bodies = [{"t": {"text": one_edit(real_term()), "term": {"field": "body"}}}
                   for _ in range(SUGGEST_TERM)]
    phrase_bodies = [{"p": {"text": f"{real_term()} {one_edit(real_term())}",
                            "phrase": {"field": "body"}}} for _ in range(SUGGEST_PHRASE)]
    t2 = time.perf_counter()
    engine.suggest_multi("corpus", term_bodies[0])  # the first sorts the field's terms
    first_s = time.perf_counter() - t2
    cpu = _cpu_twin_index(idx)
    for name, reqs in (("term", term_bodies), ("phrase", phrase_bodies)):
        lat, answers = [], []
        for b in reqs:
            t2 = time.perf_counter()
            answers.append(engine.suggest_multi("corpus", b))
            lat.append((time.perf_counter() - t2) * 1e3)
        found = sum(bool(e["options"]) for a in answers for v in a.values() for e in v)
        if not found:
            raise AssertionError(f"suggest {name}: no options")
        for j in range(SUGGEST_CPU[name]):
            if run_suggest(cpu, reqs[j]) != answers[j]:
                raise AssertionError(f"suggest {name} {reqs[j]}: the card differs from the cpu run")
        out[name] = {"requests": len(reqs), **_p(lat), "entries_with_options": found}
    out["term"]["first_call_s"] = first_s
    build = {"docs": SUGGEST_DOCS, "generate_s": gen_s, "index_doc_s": ti1, "refresh_s": tr1,
             f"{SUGGEST_SHARDS}_shards_index_doc_s": ti4,
             f"{SUGGEST_SHARDS}_shards_refresh_s": tr4, "host_build_s": trh}
    for name, m in out.items():
        log(f"suggest {name}: " + json.dumps(m))
    log(f"suggest: build {json.dumps(build)}; completion lists equal on the card and the cpu, "
        f"1 shard and {SUGGEST_SHARDS}; launches {launches}")
    state["suggest_launches"] = launches
    state["suggest_out"] = {**out, "build": build}
    for name in ("suggest", "suggest4"):
        _drop_index(state, name, name, device)


def _profile_body(rng, lens, tok, starts) -> dict:
    d = int(rng.integers(0, len(lens)))
    words = dict.fromkeys(f"t{int(x)}" for x in tok[starts[d]: starts[d + 1]])
    return {"query": {"bool": {"should": [{"match": {"body": w}} for w in list(words)[:4]]}},
            "size": 10, "profile": True}


def _count_nodes(tree: dict) -> int:
    return 1 + sum(_count_nodes(c) for c in tree.get("children", ()))


def _strip_profile(tree):
    """A profile tree without its timings (the breakdown's counts kept)."""
    if isinstance(tree, list):
        return [_strip_profile(x) for x in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: (_strip_profile(v) if k != "breakdown" else
                {bk: bv for bk, bv in v.items() if bk.endswith("_count")})
            for k, v in tree.items() if k not in ("time_in_nanos", "rewrite_time")}


def _profile_requests(state: dict, device, idx, bodies, tag: str, n_cpu: int) -> dict:
    """Each profiled `_search` over REST between a reset and a read of the
    launch counts: the tree's node count, scan_topk launches (the search's
    own + 2 per profiled node) and the scan_topk events of every shard's
    `device` section, which must agree; `n_cpu` trees held to the
    device="cpu" run (types, descriptions and children, timings left out)."""
    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.search.profile import profile_shards

    server, c = _serve(state, device)
    try:
        c("POST", f"/{idx.name}/_search", bodies[0])  # warm-up
        lat, rows, answers = [], [], []
        total = dict.fromkeys(kernels.launch_counts, 0)
        for b in bodies:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            st, _h, r = c("POST", f"/{idx.name}/_search", b)
            lat.append((time.perf_counter() - t0) * 1e3)
            n = dict(kernels.launch_counts)
            if st != 200:
                raise AssertionError(f"search_profile {tag}: {st} {r}")
            for k, v in n.items():
                total[k] += v
            nodes = _count_nodes(r["profile"]["shards"][0]["searches"][0]["query"][0])
            events = [sum(k["name"] == "scan_topk" for k in e["device"]["kernels"])
                      for e in r["profile"]["shards"]]
            if len(events) != idx.num_shards or set(events) != {n["scan_topk"]} or \
                    n["scan_topk"] != 1 + 2 * nodes:
                raise AssertionError(f"search_profile {tag}: {nodes} nodes, {n['scan_topk']} "
                                     f"scan_topk launches, device sections' events {events}")
            rows.append((nodes, n["scan_topk"], events[0]))
            answers.append(r)
        busy = _window_busy([lambda b=b: c("POST", f"/{idx.name}/_search", b)
                             for b in bodies[:5]], f"search_profile {tag}")
        plain = []
        for b in bodies[:20]:
            q = {k: v for k, v in b.items() if k != "profile"}
            t0 = time.perf_counter()
            c("POST", f"/{idx.name}/_search", q)
            plain.append((time.perf_counter() - t0) * 1e3)
    finally:
        c.close()
        server.stop()
    if n_cpu:
        cpu = _cpu_twin_index(idx)
        for b, r in zip(bodies[:n_cpu], answers):
            want = profile_shards(cpu, parse_query(b["query"], idx.mappings), 0, "node-0")
            got = [{k: v for k, v in e.items() if k not in ("device", "phases")}
                   for e in r["profile"]["shards"]]
            want = [{k: v for k, v in e.items() if k != "device"} for e in want]
            if _strip_profile(got) != _strip_profile(want):
                raise AssertionError(f"search_profile {tag}: the tree of {b['query']} differs "
                                     f"from the cpu run's")
    return {"requests": len(bodies), **_p(lat), "plain_p50_ms": float(np.percentile(plain, 50)),
            "busy_share": busy["busy_share"], "nodes": sorted({x[0] for x in rows}),
            "scan_topk_per_request": total["scan_topk"] / len(bodies),
            "device_events_equal_launches": len(rows), "trees_against_cpu": n_cpu,
            "launches": total}


def phase_search_profile(device, rng, state: dict) -> None:
    """PROFILE_REQUESTS `profile: true` bools of 4 match clauses (the
    traffic's `or` shape, terms of a real doc) over REST on the 1M-doc
    index of phase index (`_profile_requests`), PROFILE_CPU trees against
    the device="cpu" run; p50 against the same requests unprofiled."""
    lens, tok = state["corpus"]
    starts = np.concatenate([[0], np.cumsum(lens)])
    bodies = [_profile_body(rng, lens, tok, starts) for _ in range(PROFILE_REQUESTS)]
    state["profile_bodies"] = bodies[:PROFILE_SHARD_REQUESTS]
    m = _profile_requests(state, device, state["index"], bodies, "1 shard", PROFILE_CPU)
    log("search_profile 1 shard: " + json.dumps({k: v for k, v in m.items() if k != "launches"}))
    state.setdefault("search_profile_launches", {})["1_shard"] = m.pop("launches")
    state.setdefault("search_profile_out", {})["1_shard"] = m


def phase_search_profile_shards(device, rng, state: dict) -> None:
    """PROFILE_SHARD_REQUESTS of phase search_profile's bodies (drawn from
    its stream when it did not run) on the 8-shard index: every shard's
    `device` section holds the request's scan_topk launches."""
    bodies = state.get("profile_bodies")
    if bodies is None:
        lens, tok = state["corpus"]
        starts = np.concatenate([[0], np.cumsum(lens)])
        bodies = [_profile_body(rng, lens, tok, starts) for _ in range(PROFILE_SHARD_REQUESTS)]
    m = _profile_requests(state, device, state["shards_index"], bodies,
                          f"{N_SHARDS} shards", 0)
    log(f"search_profile {N_SHARDS} shards: " + json.dumps(
        {k: v for k, v in m.items() if k != "launches"}))
    state.setdefault("search_profile_launches", {})[f"{N_SHARDS}_shards"] = m.pop("launches")
    state.setdefault("search_profile_out", {})[f"{N_SHARDS}_shards"] = m


# ---------------------------------------------------------------------------
# Slice 20: search templates, searches over several indices with can_match,
# `_rank_eval` and the RRF retriever, the search-side APIs. No kernel of its
# own: every search ends in scan_topk (the RRF retriever's kNN leg also in
# ann_gather_scan); the analyze, validate, termvectors, field caps and mget
# requests launch nothing.
# ---------------------------------------------------------------------------

TEMPLATE_STORED = 200  # the traffic's `or` matches through one stored template
TEMPLATE_INLINE = 50  # inline templates with a range section (10 take its default)
TEMPLATE_MSEARCH = 10  # `_msearch/template` bodies of TEMPLATE_MSEARCH_ENTRIES
TEMPLATE_MSEARCH_ENTRIES = 32
TEMPLATE_CPU = 20  # held to the device="cpu" run
STORED_TEMPLATE = '{"query": {"match": {"body": "{{q}}"}}, "size": {{size}}}'
RANGE_TEMPLATE = ('{"query": {"bool": {"must": [{"match": {"body": "{{q}}"}}], "filter": '
                  '[{"range": {"n": {"gte": {{lo}}{{^lo}}0{{/lo}}, "lt": {{hi}}}}}]}}, '
                  '"size": {{size}}}')
# Rally's http_logs track keeps one index per span of days: C3's 30 days of
# @timestamp (120,000 docs) as 6 indices of 5 days, searched as `logs-*`
MULTI_DOCS = 120_000
MULTI_INDICES = 6
MULTI_DAYS = 5  # per index
MULTI_COUNTS = {"last_5_days": 50, "last_15_days": 50, "no_range": 50, "sorted": 25}
MULTI_SKIPPED = {"last_5_days": 5, "last_15_days": 3, "no_range": 0}  # indices can_match skips
MULTI_MGETS, MULTI_MGET_IDS = 5, 100
RANK_EVAL_REQUESTS = 20  # `_rank_eval`s of RANK_EVAL_QUERIES rated queries, on the 1M index
RANK_EVAL_QUERIES = 10
RANK_EVAL_CPU = 5  # `_rank_eval`s held to the device="cpu" run (a 1M-doc search on the host)
RANK_EVAL_METRICS = ({"precision": {"k": 10}}, {"recall": {"k": 10}},
                     {"mean_reciprocal_rank": {"k": 10}}, {"dcg": {"k": 10}},
                     {"dcg": {"k": 10, "normalize": True}},
                     {"expected_reciprocal_rank": {"k": 10, "maximum_relevance": 3}})
RRF_REQUESTS = 50  # standard + knn retrievers on the 50,000-doc kNN index
RRF_CPU = 10  # held to the device="cpu" run (its ANN twin costs ~0.2-0.3 s a request)
RRF_WINDOW = 50
EXPLAIN_MATCHED, EXPLAIN_UNMATCHED = 40, 10
EXPLAIN_CPU = 10  # of each kind held to the device="cpu" run (4 exact 1M-doc searches each)
VALIDATE, VALIDATE_INVALID = 20, 5
ANALYZE = 20
TERMVECTORS = 50


def _cpu_engine(indices):
    """An Engine(device="cpu") holding each index's device="cpu" twin
    (`_cpu_twin_index`) under its name."""
    from elasticsearch_tpu_torch.engine import Engine

    engine = Engine(device="cpu")
    for idx in indices:
        engine.indices[idx.name] = _cpu_twin_index(idx)
    return engine


def _doc_terms(lens, tok, starts, d: int) -> list:
    """The distinct terms of doc d of a C1 corpus, in text order."""
    return list(dict.fromkeys(f"t{int(x)}" for x in tok[starts[d]: starts[d + 1]]))


def _rest_timed(c, method: str, path, bodies, what: str, per_request=None,
                raw: bool = False) -> tuple[list, list, dict]:
    """Each body through the REST client (`path`, or `path(j)`) between a
    reset and a read of the launch counts: every answer 200, and
    `per_request(j)` scan_topk launches on request j when given (each
    request counted on its own). -> (latencies ms, answers, launches
    summed)."""
    from elasticsearch_tpu_torch.ops import kernels

    lat, out = [], []
    total = dict.fromkeys(kernels.launch_counts, 0)
    for j, b in enumerate(bodies):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, _h, r = c(method, path(j) if callable(path) else path,
                      **({"raw": b} if raw else {"body": b}))
        lat.append((time.perf_counter() - t0) * 1e3)
        if st != 200:
            raise AssertionError(f"{what}: {st} {r}")
        n = dict(kernels.launch_counts)
        if per_request is not None and n["scan_topk"] != per_request(j):
            raise AssertionError(f"{what}: request {j} launched scan_topk {n['scan_topk']} "
                                 f"times, not {per_request(j)}")
        for k, v in n.items():
            total[k] += v
        out.append(r)
    return lat, out, total


def _bare(resp: dict) -> dict:
    return {k: v for k, v in _strip(resp).items() if k != "status"}


def _same_json(a, b) -> bool:
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def phase_templates(device, rng, state: dict) -> None:
    """On the 1M-doc index, over REST: TEMPLATE_STORED of the traffic's `or`
    matches through one stored template (`PUT /_scripts/c1-match`),
    TEMPLATE_INLINE inline templates with a range section, and
    TEMPLATE_MSEARCH `_msearch/template` bodies of TEMPLATE_MSEARCH_ENTRIES
    of them: p50/p99, one scan_topk launch per rendered search, every answer
    `==` the plain `_search` of its rendered body on the card, the busy
    share of a window of templated searches, TEMPLATE_CPU answers against
    the device="cpu" run."""
    from elasticsearch_tpu_torch.corpus import N_MAX, traffic
    from elasticsearch_tpu_torch.search.templates import resolve_template

    idx = state["index"]
    name = idx.name
    lens, tok = state["corpus"]
    texts = [q["match"]["body"]["query"] for q, _s, _f in state.get("requests", [])
             if "match" in q and q["match"]["body"]["operator"] == "or"][:TEMPLATE_STORED]
    if len(texts) < TEMPLATE_STORED:  # phase traffic did not run: draw its shape
        texts = [q["match"]["body"]["query"]
                 for q in traffic(rng, lens, tok, TEMPLATE_STORED, 0, 0)]
    bodies = [{"id": "c1-match", "params": {"q": t, "size": 10}} for t in texts]
    for j, q in enumerate(traffic(rng, lens, tok, TEMPLATE_INLINE, 0, 0)):
        lo = int(rng.integers(0, N_MAX // 2))
        params = {"q": q["match"]["body"]["query"], "hi": lo + N_MAX // 4, "size": 10}
        if j % 5:
            params["lo"] = lo
        bodies.append({"source": RANGE_TEMPLATE, "params": params})
    server, c = _serve(state, device)
    try:
        st, _h, r = c("PUT", "/_scripts/c1-match", {"script": {"lang": "mustache",
                                                                "source": STORED_TEMPLATE}})
        if st != 200 or not r.get("acknowledged"):
            raise AssertionError(f"templates: PUT /_scripts/c1-match {st} {r}")
        rendered = [resolve_template(state["engine"], b)[1] for b in bodies]
        c("POST", f"/{name}/_search/template", bodies[0])  # warm-up
        lat, answers, n_tpl = _rest_timed(c, "POST", f"/{name}/_search/template", bodies,
                                          "templates", per_request=lambda j: 1)
        plain_lat, plain, n_plain = _rest_timed(c, "POST", f"/{name}/_search", rendered,
                                                "templates plain", per_request=lambda j: 1)
        for j, (a, p) in enumerate(zip(answers, plain)):
            if not _same_json(_strip(a), _strip(p)):
                raise AssertionError(f"templates: {bodies[j]} differs from its rendered body's "
                                     f"plain _search")
        picks = [[(j * TEMPLATE_MSEARCH_ENTRIES + e) % len(bodies)
                  for e in range(TEMPLATE_MSEARCH_ENTRIES)] for j in range(TEMPLATE_MSEARCH)]
        raws = [_ndjson([x for j in pick for x in ({"index": name}, bodies[j])])
                for pick in picks]
        ms_lat, ms_answers, n_ms = _rest_timed(
            c, "POST", "/_msearch/template", raws, "msearch/template", raw=True,
            per_request=lambda j: TEMPLATE_MSEARCH_ENTRIES)
        for pick, r in zip(picks, ms_answers):
            for j, entry in zip(pick, r["responses"]):
                if entry.get("status") != 200 or not _same_json(_bare(entry),
                                                                 _strip(answers[j])):
                    raise AssertionError(f"msearch/template: entry {bodies[j]} differs")
        busy = _window_busy([lambda b=b: c("POST", f"/{name}/_search/template", b)
                             for b in bodies[:BUSY_WINDOW]], "templates")
        st, _h, gone = c("DELETE", "/_scripts/c1-match")
        if st != 200:
            raise AssertionError(f"templates: DELETE /_scripts/c1-match {st} {gone}")
    finally:
        c.close()
        server.stop()
    cpu = _cpu_twin_index(idx)
    calls = [dict(query=b["query"], size=b["size"]) for b in rendered[:TEMPLATE_CPU]]
    worst, swapped, equal = _against_cpu(cpu, calls, answers[:TEMPLATE_CPU],
                                         "templates against the device=cpu run")
    del cpu
    state["templates_launches"] = {"search_template": n_tpl, "plain": n_plain,
                                   "msearch_template": n_ms}
    out = {"requests": len(bodies), "stored": TEMPLATE_STORED, "inline": TEMPLATE_INLINE,
           **_p(lat), "plain_p50_ms": float(np.percentile(plain_lat, 50)),
           "msearch_template": {"bodies": TEMPLATE_MSEARCH,
                                "entries": TEMPLATE_MSEARCH_ENTRIES, **_p(ms_lat)},
           "scan_topk_per_request": n_tpl["scan_topk"] / len(bodies),
           "busy_share": busy["busy_share"], "equal_plain": len(bodies),
           "cpu": {"n": len(calls), "max_rel": worst, "swapped": swapped, "equal": equal}}
    state["templates_out"] = out
    log("templates: " + json.dumps(out))


def phase_search_apis(device, rng, state: dict) -> None:
    """On the 1M-doc index, over REST: EXPLAIN_MATCHED `_explain`s of a bool
    of 3 match clauses on terms of the doc (1 + 3 scan_topk launches each:
    the whole query and each clause alone, in exact BM25) and
    EXPLAIN_UNMATCHED of a doc the query misses (1 launch); VALIDATE
    `_validate/query` (VALIDATE_INVALID invalid, half with `explain`),
    ANALYZE `_analyze` and TERMVECTORS `_termvectors` with term_statistics
    (no launch). p50/p99 per kind, the busy share of a window of explains;
    EXPLAIN_CPU explanations of each kind and every other answer `==` the
    device="cpu" run's."""
    from elasticsearch_tpu_torch.engine import admin

    idx = state["index"]
    name = idx.name
    lens, tok = state["corpus"]
    starts = np.concatenate([[0], np.cumsum(lens)])
    n_docs = len(lens)
    explains = []
    while len(explains) < EXPLAIN_MATCHED:
        d = int(rng.integers(0, n_docs))
        words = _doc_terms(lens, tok, starts, d)
        if len(words) >= 3:
            w = [words[int(x)] for x in rng.choice(len(words), 3, replace=False)]
            explains.append((str(d), {"bool": {"must": [{"match": {"body": w[0]}}],
                                               "should": [{"match": {"body": w[1]}},
                                                          {"match": {"body": w[2]}}]}}))
    while len(explains) < EXPLAIN_MATCHED + EXPLAIN_UNMATCHED:
        d, e = (int(x) for x in rng.integers(0, n_docs, 2))
        mine = set(_doc_terms(lens, tok, starts, d))
        other = [t for t in _doc_terms(lens, tok, starts, e) if t not in mine]
        if len(other) >= 2:
            explains.append((str(d), {"bool": {"must": [{"match": {"body": other[0]}}],
                                               "should": [{"match": {"body": other[1]}}]}}))
    lo = int(rng.integers(0, 500_000))
    valid = [{"match": {"body": " ".join(_doc_terms(lens, tok, starts, int(d))[:2])}}
             for d in rng.integers(0, n_docs, VALIDATE - VALIDATE_INVALID - 5)]
    valid += [{"bool": {"must": [{"match": {"body": "t1"}}],
                        "filter": [{"range": {"n": {"gte": lo + k}}}]}} for k in range(5)]
    invalid = [{"no_such_query": {}}, {"range": {"n": {"gte": "abc"}}},
               {"bool": {"must": "x"}}, {"match": {}}, {"term": {}}]
    validates = [({"query": q}, j % 2 == 0) for j, q in enumerate(valid + invalid)]
    analyzes = [{"text": " ".join(_doc_terms(lens, tok, starts, int(d))[:8]).upper(),
                 **({"field": "body"} if j % 2 else
                    {"analyzer": ("standard", "whitespace", "simple")[j % 3]})}
                for j, d in enumerate(rng.integers(0, n_docs, ANALYZE))]
    tv_ids = [str(int(d)) for d in rng.integers(0, n_docs, TERMVECTORS)]
    server, c = _serve(state, device)
    try:
        c("POST", f"/{name}/_explain/{explains[0][0]}", {"query": explains[0][1]})  # warm-up
        ex_lat, ex_answers, n_ex = _rest_timed(
            c, "POST", lambda j: f"/{name}/_explain/{explains[j][0]}",
            [{"query": q} for _d, q in explains], "explain",
            per_request=lambda j: 1 + 3 if j < EXPLAIN_MATCHED else 1)
        for j, r in enumerate(ex_answers):
            if r["matched"] != (j < EXPLAIN_MATCHED) or \
                    len(r["explanation"]["details"]) != (3 if j < EXPLAIN_MATCHED else 0):
                raise AssertionError(f"explain: {explains[j]} -> {r}")
        busy = _window_busy([lambda d=d, q=q: c("POST", f"/{name}/_explain/{d}", {"query": q})
                             for d, q in explains[:5]], "explain")
        va_lat, va_answers, n_va = _rest_timed(
            c, "POST", lambda j: f"/{name}/_validate/query" + (
                "?explain=true" if validates[j][1] else ""),
            [b for b, _e in validates], "validate", per_request=lambda j: 0)
        an_lat, an_answers, n_an = _rest_timed(c, "POST", f"/{name}/_analyze", analyzes,
                                               "analyze", per_request=lambda j: 0)
        tv_lat, tv_answers, n_tv = _rest_timed(
            c, "GET", lambda j: f"/{name}/_termvectors/{tv_ids[j]}",
            [{"term_statistics": True} for _ in tv_ids], "termvectors", per_request=lambda j: 0)
    finally:
        c.close()
        server.stop()
    if sum(not r["valid"] for r in va_answers) != VALIDATE_INVALID:
        raise AssertionError(f"validate: {[r['valid'] for r in va_answers]}")
    if not all(r["found"] and r["term_vectors"]["body"]["terms"] for r in tv_answers) or \
            not all("doc_freq" in t for r in tv_answers
                    for t in r["term_vectors"]["body"]["terms"].values()):
        raise AssertionError("termvectors: a doc without its body's terms or their df")
    t0 = time.perf_counter()
    cpu = _cpu_engine([idx])
    try:
        twin = cpu.get_index(name)
        held = list(range(EXPLAIN_CPU)) + list(range(EXPLAIN_MATCHED,
                                                     EXPLAIN_MATCHED + EXPLAIN_CPU))
        for j in held:
            d, q = explains[j]
            if not _same_json({"_index": name, **twin.explain(d, q)}, ex_answers[j]):
                raise AssertionError(f"explain: {d} {q} differs from the device=cpu run")
        for (b, e), got in zip(validates, va_answers):
            if not _same_json(admin.validate_query(cpu, name, b, e), got):
                raise AssertionError(f"validate: {b} differs from the device=cpu run")
        for b, got in zip(analyzes, an_answers):
            if not _same_json(admin.analyze(cpu, name, dict(b)), got):
                raise AssertionError(f"analyze: {b} differs from the device=cpu run")
        for d, got in zip(tv_ids, tv_answers):
            if not _same_json(admin.termvectors(cpu, name, d, {"term_statistics": True}), got):
                raise AssertionError(f"termvectors: {d} differs from the device=cpu run")
    finally:
        cpu.close()
    cpu_s = time.perf_counter() - t0
    state["search_apis_launches"] = {"explain": n_ex, "validate": n_va, "analyze": n_an,
                                     "termvectors": n_tv}
    out = {"explain": {"requests": len(explains), "matched": EXPLAIN_MATCHED, **_p(ex_lat),
                       "scan_topk_per_request": n_ex["scan_topk"] / len(explains),
                       "busy_share": busy["busy_share"]},
           "validate": {"requests": len(validates), "invalid": VALIDATE_INVALID, **_p(va_lat)},
           "analyze": {"requests": len(analyzes), **_p(an_lat)},
           "termvectors": {"requests": len(tv_ids), **_p(tv_lat),
                           "terms": sum(len(r["term_vectors"]["body"]["terms"])
                                        for r in tv_answers)},
           "cpu": {"explain": len(held), "validate": len(validates),
                   "analyze": len(analyzes), "termvectors": len(tv_ids), "s": cpu_s}}
    state["search_apis_out"] = out
    log("search_apis: " + json.dumps(out))


def _rank_eval_bodies(rng, idx, lens, tok) -> list:
    """RANK_EVAL_REQUESTS `_rank_eval` bodies of RANK_EVAL_QUERIES `or`
    matches each, the metrics in turn; each query's ratings: its exact-BM25
    top 10 (`_exact_hits`) rated 3, 2, 1 by rank band (1-3, 4-6, 7-10) and
    5 seeded docs rated 0."""
    from elasticsearch_tpu_torch.corpus import traffic

    queries = traffic(rng, lens, tok, RANK_EVAL_REQUESTS * RANK_EVAL_QUERIES, 0, 0)
    bodies = []
    for r in range(RANK_EVAL_REQUESTS):
        requests = []
        for j, q in enumerate(queries[r * RANK_EVAL_QUERIES: (r + 1) * RANK_EVAL_QUERIES]):
            top = [h["_id"] for h in _exact_hits(idx, q, 10)["hits"]]
            ratings = [{"_index": idx.name, "_id": i, "rating": 3 - min(rank // 3, 2)}
                       for rank, i in enumerate(top)]
            ratings += [{"_index": idx.name, "_id": str(int(d)), "rating": 0}
                        for d in rng.integers(0, len(lens), 5)]
            requests.append({"id": f"r{r}q{j}", "request": {"query": q}, "ratings": ratings})
        bodies.append({"requests": requests,
                       "metric": RANK_EVAL_METRICS[r % len(RANK_EVAL_METRICS)]})
    return bodies


def _ranked_against_cpu(engine, cpu, index: str, calls, what: str) -> int:
    """Each search_multi kwargs on the card's engine and on the cpu one:
    totals equal, scores within 1e-6 relative, ids up to fp-ties
    (`_rows_match`). -> positions swapped."""
    swapped = 0
    for kw in calls:
        gs, gi, gt = _hit_rows_of(engine.search_multi(index, **kw))
        ws, wi, wt = _hit_rows_of(cpu.search_multi(index, **kw))
        if gt != wt or gs.shape != ws.shape:
            raise AssertionError(f"{what}: total {gt} vs the cpu run's {wt}")
        swapped += _rows_match(gs[None], gi[None], ws[None], wi[None], what)
    return swapped


def phase_rank_eval(device, rng, state: dict) -> None:
    """RANK_EVAL_REQUESTS `_rank_eval`s over REST on the 1M-doc index
    (`_rank_eval_bodies`; no index in the path: the ratings name it):
    p50/p99, RANK_EVAL_QUERIES scan_topk launches each (one per rated
    search), the busy share of a window; RANK_EVAL_CPU of them against the
    device="cpu" run: every query's ranked list equal (metric scores within
    1e-12, the details `==`), or its searches equal up to fp-ties."""
    from elasticsearch_tpu_torch.search.rankeval import rank_eval

    idx = state["index"]
    lens, tok = state["corpus"]
    bodies = _rank_eval_bodies(rng, idx, lens, tok)
    server, c = _serve(state, device)
    try:
        c("POST", "/_rank_eval", bodies[0])  # warm-up
        lat, answers, n = _rest_timed(c, "POST", "/_rank_eval", bodies, "rank_eval",
                                      per_request=lambda j: RANK_EVAL_QUERIES)
        busy = _window_busy([lambda b=b: c("POST", "/_rank_eval", b) for b in bodies[:2]],
                            "rank_eval")
    finally:
        c.close()
        server.stop()
    t0 = time.perf_counter()
    cpu = _cpu_engine([idx])
    equal_lists = swapped = 0
    try:
        for b, got in zip(bodies[:RANK_EVAL_CPU], answers):
            want = rank_eval(cpu, b)
            metric = next(iter(b["metric"]))
            differ = []
            for req in b["requests"]:
                g, w = got["details"][req["id"]], want["details"][req["id"]]
                if g["hits"] == w["hits"]:
                    equal_lists += 1
                    if abs(g["metric_score"] - w["metric_score"]) > 1e-12 or \
                            g["unrated_docs"] != w["unrated_docs"]:
                        raise AssertionError(f"rank_eval {metric}: {req['id']} {g} vs {w}")
                else:
                    differ.append(dict(query=req["request"]["query"], size=10))
            swapped += _ranked_against_cpu(state["engine"], cpu, idx.name, differ,
                                           f"rank_eval {metric}")
            if not differ and abs(got["metric_score"] - want["metric_score"]) > 1e-12:
                raise AssertionError(f"rank_eval {metric}: {got['metric_score']} vs "
                                     f"{want['metric_score']}")
    finally:
        cpu.close()
    state["rank_eval_launches"] = {"rank_eval": n}
    scores = {}
    for b, a in zip(bodies, answers):
        scores.setdefault(json.dumps(b["metric"], sort_keys=True), []).append(a["metric_score"])
    out = {"requests": len(bodies), "queries_each": RANK_EVAL_QUERIES, **_p(lat),
           "scan_topk_per_request": n["scan_topk"] / len(bodies),
           "busy_share": busy["busy_share"],
           "mean_metric": {k: float(np.mean(v)) for k, v in scores.items()},
           "cpu": {"bodies": RANK_EVAL_CPU, "equal_lists": equal_lists, "swapped": swapped,
                   "s": time.perf_counter() - t0}}
    state["rank_eval_out"] = out
    log("rank_eval: " + json.dumps(out))


def phase_rrf(device, rng, state: dict) -> None:
    """RRF_REQUESTS `_search`es with an `rrf` retriever over REST on the
    50,000-doc kNN index: a `standard` match of 2-4 C1 terms and a `knn`
    section at a near-data query (window RRF_WINDOW, rank_constant 60):
    p50/p99, per request ann_gather_scan once per shard and scan_topk at
    least once, the busy share of a window; RRF_CPU against the
    device="cpu" run: the fused list and its scores `==`, or its
    sub-retrievers' searches equal up to fp-ties (the kNN section's f32
    rescore adds in another order on the host)."""
    from elasticsearch_tpu_torch.search.rankeval import rrf_retriever_search

    idx = state["knn_index"]
    near = state["knn_index_near"]
    lens, tok = state["knn_index_text"]
    retrievers = []
    for q, kb in _hybrid_requests(rng, lens, tok, near, RRF_REQUESTS):
        kb = {k: v for k, v in kb.items() if k != "boost"}
        retrievers.append({"rrf": {"retrievers": [{"standard": {"query": q}}, {"knn": kb}],
                                   "rank_constant": 60, "rank_window_size": RRF_WINDOW}})
    path = f"/{idx.name}/_search"
    server, c = _serve(state, device)
    try:
        c("POST", path, {"retriever": retrievers[0], "size": 10})  # warm-up
        lat, answers, n = _rest_timed(c, "POST", path,
                                      [{"retriever": r, "size": 10} for r in retrievers], "rrf")
        busy = _window_busy([lambda r=r: c("POST", path, {"retriever": r, "size": 10})
                             for r in retrievers[:5]], "rrf")
    finally:
        c.close()
        server.stop()
    if n["ann_gather_scan"] != idx.num_shards * len(retrievers) or \
            n["scan_topk"] < len(retrievers):
        raise AssertionError(f"rrf: launches {n} for {len(retrievers)} requests")
    for a in answers:
        sc = [h["_score"] for h in a["hits"]["hits"]]
        if not sc or sc != sorted(sc, reverse=True):
            raise AssertionError("rrf: malformed fused hits")
    t0 = time.perf_counter()
    cpu = _cpu_engine([idx])
    equal = swapped = 0
    try:
        for r, got in zip(retrievers[:RRF_CPU], answers):
            want = rrf_retriever_search(cpu, idx.name, r, 10, 0)
            if [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
                    [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]:
                equal += 1
                continue
            std, knn = r["rrf"]["retrievers"]
            swapped += _ranked_against_cpu(
                state["engine"], cpu, idx.name,
                [dict(query=std["standard"]["query"], size=RRF_WINDOW, from_=0),
                 dict(knn=knn["knn"], size=RRF_WINDOW, from_=0)], "rrf sub-retrievers")
    finally:
        cpu.close()
    state["rrf_launches"] = {"rrf": n}
    out = {"requests": len(retrievers), **_p(lat),
           "launches_per_request": {k: v / len(retrievers) for k, v in n.items() if v},
           "busy_share": busy["busy_share"],
           "cpu": {"n": RRF_CPU, "equal": equal, "swapped": swapped,
                   "s": time.perf_counter() - t0}}
    state["rrf_out"] = out
    log("rrf: " + json.dumps(out))


def _multi_requests(rng, docs) -> dict:
    """MULTI_COUNTS `_search` bodies over `logs-*`: a `match` on a doc's
    clientip or status, with a range on the last 5 or 15 days or none;
    Discover's page sorted by @timestamp desc at size 100."""
    from elasticsearch_tpu_torch.corpus import C3_T0_MS

    day = 86_400_000
    out = {}
    for kind, n in MULTI_COUNTS.items():
        bodies = []
        for j in range(n):
            src = docs[int(rng.integers(0, len(docs)))][1]
            match = {"match": {"clientip": src["clientip"]}} if j % 2 else \
                {"match": {"status": src["status"]}}
            if kind == "sorted":
                bodies.append({"query": match, "sort": [{"@timestamp": "desc"}], "size": 100})
            elif kind == "no_range":
                bodies.append({"query": match, "size": 10})
            else:
                since = C3_T0_MS + (30 - (5 if kind == "last_5_days" else 15)) * day
                bodies.append({"query": {"bool": {"must": [match], "filter": [
                    {"range": {"@timestamp": {"gte": since}}}]}}, "size": 10})
        out[kind] = bodies
    return out


def phase_multi_index(device, rng, state: dict) -> None:
    """C3's corpus (MULTI_DOCS docs, 30 days) split by date into
    MULTI_INDICES indices of MULTI_DAYS days (`logs-0` ... `logs-5`), and
    the same docs as one index; over REST on `logs-*` (`_multi_requests`):
    per request the skipped indices (`_shards.skipped`) and one scan_topk
    launch per searched index (a skipped index launches nothing), p50/p99
    per kind, the busy share of a window; every answer and its skipped
    count `==` the device="cpu" run's; the sorted pages' sort values and
    totals equal the one index's, ids up to full-key ties; `_field_caps`
    over `logs-*` and MULTI_MGETS `_mget`s of MULTI_MGET_IDS ids across the
    indices `==` the cpu run's."""
    from elasticsearch_tpu_torch.corpus import C3_MAPPINGS, C3_T0_MS, c3_corpus

    docs = c3_corpus(rng, MULTI_DOCS)
    span = MULTI_DAYS * 86_400_000
    groups = [[] for _ in range(MULTI_INDICES)]
    for i, d in docs:
        groups[(d["@timestamp"] - C3_T0_MS) // span].append((i, d))
    t0 = time.perf_counter()
    idxs = [_index_docs(state, device, f"logs-{k}", C3_MAPPINGS, g)[0]
            for k, g in enumerate(groups)]
    build_s = time.perf_counter() - t0
    one = _index_docs(state, device, "logs_all", C3_MAPPINGS, docs)[0]
    reqs = _multi_requests(rng, docs)
    mgets = [{"docs": [{"_index": f"logs-{(j + k) % MULTI_INDICES}", "_id": docs[int(x)][0]}
                       for k, x in enumerate(rng.integers(0, len(docs), MULTI_MGET_IDS))]}
             for j in range(MULTI_MGETS)]
    kinds, launches = {}, {}
    server, c = _serve(state, device)
    try:
        c("POST", "/logs-*/_search", reqs["no_range"][0])  # warm-up
        for kind, bodies in reqs.items():
            lat, answers, n = _rest_timed(
                c, "POST", "/logs-*/_search", bodies, f"multi_index {kind}",
                per_request=None if kind == "sorted" else
                (lambda j, s=MULTI_SKIPPED[kind]: MULTI_INDICES - s))
            for b, a in zip(bodies, answers):
                if kind != "sorted" and a["_shards"]["skipped"] != MULTI_SKIPPED[kind]:
                    raise AssertionError(f"multi_index {kind}: {a['_shards']} for {b}")
            kinds[kind] = {"requests": len(bodies), **_p(lat), "answers": answers,
                           "scan_topk_per_request": n["scan_topk"] / len(bodies)}
            launches[kind] = n
        busy = _window_busy([lambda b=b: c("POST", "/logs-*/_search", b)
                             for b in reqs["last_5_days"][:BUSY_WINDOW]], "multi_index")
        st, _h, caps = c("GET", "/logs-*/_field_caps?fields=*")
        mget_answers = [c("POST", "/_mget", b)[2] for b in mgets]
    finally:
        c.close()
        server.stop()
    t1 = time.perf_counter()
    cpu = _cpu_engine(idxs)
    try:
        for kind, bodies in reqs.items():
            for b, got in zip(bodies, kinds[kind]["answers"]):
                want = cpu.search_multi("logs-*", query=b["query"], size=b["size"],
                                        sort=b.get("sort"))
                if want.pop("skipped_shards") != got["_shards"]["skipped"] or \
                        not _same_json(_strip(got), want):
                    raise AssertionError(f"multi_index {kind}: {b} differs from the cpu run")
        for b, got in zip(reqs["sorted"], kinds["sorted"]["answers"]):
            _sorted_equal(got, one.search(b["query"], sort=b["sort"], size=b["size"]),
                          f"multi_index sorted {b['query']} against one index", ids=False)
        if st != 200 or not _same_json(caps, cpu.field_caps("logs-*")):
            raise AssertionError(f"multi_index: _field_caps {st} differs from the cpu run")
        for b, got in zip(mgets, mget_answers):
            if not _same_json(got["docs"], cpu.mget([(d["_index"], d["_id"])
                                                     for d in b["docs"]])):
                raise AssertionError("multi_index: an _mget differs from the cpu run")
    finally:
        cpu.close()
    cpu_s = time.perf_counter() - t1
    engine = state["engine"]
    for name in [i.name for i in idxs] + [one.name]:
        engine.delete_index(name)
    del idxs, one, cpu
    _release(device)  # one full collection: each takes seconds on this run's heap
    state["multi_index_launches"] = launches
    out = {"indices": MULTI_INDICES, "docs": [len(g) for g in groups], "build_s": build_s,
           "kinds": {k: {x: v for x, v in m.items() if x != "answers"} for k, m in kinds.items()},
           "busy_share_last_5_days": busy["busy_share"], "field_caps_fields": len(caps["fields"]),
           "mget_docs": MULTI_MGETS * MULTI_MGET_IDS, "cpu_s": cpu_s}
    state["multi_index_out"] = out
    log("multi_index: " + json.dumps(out))


def phase_report(device, state: dict) -> None:
    """The card, then a line and a JSON entry for each kernel this run
    measured (all five in a full run)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    if "shapes" in state:
        log("shapes: " + json.dumps(state["shapes"]))
    if "knn_build" in state:
        log("knn_build: " + json.dumps(state["knn_build"]))
    if "knn" in state:
        log("knn: " + json.dumps(state["knn"]))
    for key in ("shards_build", "shards", "c5_build", "c5", "rest", "writes", "impact_search",
                "bf16", "planner", "planner_knn", "knn_shards_build", "knn_shards", "hybrid",
                "knn_writes", "aggs_build", "aggs", "aggs_shards", "dsl", "dsl_shards",
                "collapse_rescore", "sort", "esql", "geo_build", "geo_out", "types_out",
                "extra_out", "matchers_out", "analysis_out", "fetch_out", "suggest_out",
                "search_profile_out", "templates_out", "search_apis_out", "rank_eval_out",
                "multi_index_out", "rrf_out"):
        if key in state:
            log(f"{key}: " + json.dumps(state[key]))
    log(f"empty busy windows: retried {EMPTY_TRACES['retried']}, not measured "
        f"{EMPTY_TRACES['not_measured']}")
    rows = state.get("msearch_rows", [])
    per_batch = {n: [(r["k"], r["launches"][n]) for r in rows] for n in KERNEL_OPS}
    measured = {"scan_topk": ("B=512 N=1M k=10 streamed", state.get("scan_msearch")),
                "tiered_candidates": ("B=512 D=896 N=1M kb=64", state.get("tiered")),
                "impact_gather": ("Q=512 R=64 uint16", state.get("impact")),
                "fused_tile_candidates": (state.get("fused", {}).get("shape"), state.get("fused")),
                "ann_gather_scan": (state.get("ann", {}).get("shape"), state.get("ann"))}
    for name, (shape, m) in measured.items():
        if m is None:
            continue
        log(f"kernel {name}: launches per {C1_BATCH}-query batch (k, n) {per_batch[name]}; at {shape}: "
            f"{m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}), plain "
            f"{m['plain_ms']:.3f} ms, library "
            + ("none" if m["library_ms"] is None else f"{m['library_ms']:.4f} ms"))
    launches = state.get("msearch_launches", {})  # None below: a count this run did not take
    kernels = []
    if "streamed" in state:
        st = state["streamed"]
        kernels.append({
            "name": "scan_topk",
            "route": "cuda",
            "source": "elasticsearch_tpu_torch/csrc/scan_topk.cu",
            "replaces": "elasticsearch_tpu/ops/kernels.py:114",
            "launches": state["launches"]["scan_topk"] if "launches" in state else None,
            "max_abs_err": state["max_abs_err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": "bytes",
            "library_ms": st["library_ms"],
            "matmul": {key: v for key, v in state.get("shapes", {}).items()
                       if key.startswith("matmul")},
        })
    knn = state.get("knn", {})
    ann_launches = (knn["c4_launches"]["ann_gather_scan"]
                    + knn["search_launches"]["ann_gather_scan"]) if knn else None
    for name, key, replaces, n_launch in (
            ("tiered_candidates", "tiered", "elasticsearch_tpu/ops/kernels.py:301",
             launches.get("tiered_candidates")),
            ("impact_gather", "impact", "elasticsearch_tpu/ops/kernels.py:494",
             launches.get("impact_gather")),
            ("fused_tile_candidates", "fused", "elasticsearch_tpu/ops/fused.py:217",
             launches.get("fused_tile_candidates")),
            ("ann_gather_scan", "ann", "elasticsearch_tpu/ann/kernels.py:139", ann_launches)):
        m = state.get(key)
        if m is None:
            continue
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"elasticsearch_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": n_launch,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
    sharded = state.get("sharded_launches", {})
    rest = state.get("rest_launches", {})
    writes = state.get("writes_launches", {})
    planner = state.get("planner_launches", {})
    knn_paths = state.get("knn_launches", {})
    agg_paths = state.get("aggs_launches", {})
    dsl_paths = state.get("dsl_launches", {})
    esql_paths = state.get("esql_launches", {})
    tenancy_paths = state.get("tenancy_launches", {})
    scripts_paths = state.get("scripts_launches", {})
    s18 = state.get("slice18_launches", {})
    s18_groups = {"launches_geo": "geo_", "launches_types": "types_",
                  "launches_extra": "extra_", "launches_matchers": "matchers_",
                  "launches_analysis": "analysis_"}
    for entry in kernels:  # the launches of the sharded, REST and write paths, each its own count
        if entry["name"] in SHARDED_KERNELS and sharded:
            entry["launches_sharded"] = {path: n[entry["name"]] for path, n in sharded.items()}
        if rest:
            entry["launches_rest"] = {path: n[entry["name"]] for path, n in rest.items()}
        if writes:
            entry["launches_writes"] = {path: n[entry["name"]] for path, n in writes.items()}
        if planner:  # the impact `_search` paths, msearch(bf16=True) and the planner's batches
            entry["launches_planner"] = {path: n[entry["name"]] for path, n in planner.items()}
        if knn_paths:  # kNN on 4 shards, exists, the hybrid, tiered kNN after writes
            entry["launches_knn"] = {path: n[entry["name"]] for path, n in knn_paths.items()}
        if agg_paths:  # C3 on 1 and 4 shards, its mix, REST, C1 and kNN with aggs beside
            entry["launches_aggs"] = {path: n[entry["name"]] for path, n in agg_paths.items()}
        if dsl_paths:  # each DSL kind on 1 and 8 shards and on tiers, collapse, rescore, sort
            entry["launches_dsl"] = {path: n[entry["name"]] for path, n in dsl_paths.items()}
        if esql_paths:  # the ES|QL queries on 1 and 4 shards: torch programs, no kernel
            entry["launches_esql"] = {path: n[entry["name"]] for path, n in esql_paths.items()}
        if tenancy_paths:  # C8's superpack loop (on), the per-index loop (off), solo rows
            entry["launches_tenancy"] = {path: n[entry["name"]]
                                         for path, n in tenancy_paths.items()}
        if scripts_paths:  # each scripted kind on 1 and 8 shards, script_fields, runtime
            entry["launches_scripts"] = {path: n[entry["name"]]
                                         for path, n in scripts_paths.items()}
        for key, paths in (("launches_fetch", state.get("fetch_launches")),
                           ("launches_suggest", state.get("suggest_launches")),
                           ("launches_search_profile", state.get("search_profile_launches")),
                           ("launches_templates", state.get("templates_launches")),
                           ("launches_search_apis", state.get("search_apis_launches")),
                           ("launches_rank_eval", state.get("rank_eval_launches")),
                           ("launches_multi_index", state.get("multi_index_launches")),
                           ("launches_rrf", state.get("rrf_launches"))):
            if paths:  # slices 19 and 20: each path's launches, its own count
                entry[key] = {path: n[entry["name"]] for path, n in paths.items()}
        for key, prefix in s18_groups.items():  # slice 18's kinds, each path its own count
            paths = {p[len(prefix):]: n[entry["name"]] for p, n in s18.items()
                     if p.startswith(prefix)}
            if paths:
                entry[key] = paths
    for name, path in REST_KERNEL_PATHS:  # each REST path that ran launched its kernels
        if path in rest and not rest[path][name]:
            raise AssertionError(f"the REST path {path} launched no {name}")
    if "build" in state:
        log(json.dumps({"build": state["build"]}))
    log(json.dumps({"kernels": kernels}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--c5-docs", type=int, default=50_000,
                    help="docs per shard of bench.py C5 (8 shards; C5 has 1,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    try:
        from elasticsearch_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the elasticsearch_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    # the aggregation phases draw from their own stream, so the phases
    # after them see the same data whether they run or not
    agg_rng = np.random.default_rng((args.seed, 13))
    # each slice-18 phase draws from a stream of its own, so a phase run
    # alone sees the data it sees in the full run
    s18_rng = {ph: np.random.default_rng((args.seed, 18, k)) for k, ph in enumerate(
        ("extra", "geo_index", "geo", "field_types", "matchers", "analysis"))}
    s19_rng = {ph: np.random.default_rng((args.seed, 21, k)) for k, ph in enumerate(
        ("fetch_highlight", "suggest", "search_profile"))}
    s20_rng = {ph: np.random.default_rng((args.seed, 20, k)) for k, ph in enumerate(
        ("templates", "multi_index", "rank_eval", "search_apis", "rrf"))}
    state: dict = {}
    for phase in PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        mark = _profile_mark(state)
        if phase == "build":
            built = _build.build_all()
            for name in built:
                for line in _build.build_log(name).splitlines():
                    if "registers" in line or "Compiling entry" in line:
                        log(f"  ptxas {name}: {line.strip()}")
        elif phase == "kernels":
            phase_kernels(device, rng, args.docs, state)
        elif phase == "index":
            phase_index(device, rng, args.docs, state)
        elif phase == "traffic":
            phase_traffic(device, rng, state)
        elif phase == "cpu":
            phase_cpu(state)
        elif phase == "msearch":
            phase_msearch(device, rng, state)
        elif phase == "msearch_check":
            phase_msearch_check(state)
        elif phase == "msearch_cpu":
            phase_msearch_cpu(state)
        elif phase == "profile":
            phase_profile(state)
        elif phase == "impact_search":
            phase_impact_search(device, state)
        elif phase == "bf16":
            phase_bf16(device, state)
        elif phase == "planner":
            phase_planner(device, state)
        elif phase == "impact_search_shards":
            phase_impact_search_shards(device, state)
        elif phase == "planner_knn":
            phase_planner_knn(device, state)
        elif phase == "writes":
            phase_writes(device, rng, state)
        elif phase == "aggs_index":
            phase_aggs_index(device, agg_rng, state)
        elif phase == "aggs":
            phase_aggs(device, agg_rng, state)
        elif phase == "aggs_shards":
            phase_aggs_shards(device, state)
        elif phase == "esql":
            phase_esql(device, state)
        elif phase == "rest":
            phase_rest(device, rng, state)
        elif phase == "shards_index":
            phase_shards_index(device, state)
        elif phase == "shards":
            phase_shards(device, rng, state)
        elif phase == "rest_shards":
            phase_rest_shards(device, rng, state)
        elif phase == "c5_index":
            phase_c5_index(device, state, args.c5_docs)
        elif phase == "c5":
            phase_c5(device, state)
        elif phase == "knn_index":
            phase_knn_index(device, rng, KNN_VECTORS, KNN_DOCS, state)
        elif phase == "knn_kernels":
            phase_knn_kernels(device, rng, state)
        elif phase == "knn":
            phase_knn(device, rng, state)
        elif phase == "knn_check":
            phase_knn_check(device, state)
        elif phase == "rest_knn":
            phase_rest_knn(device, state)
        elif phase == "knn_shards_index":
            phase_knn_shards_index(device, rng, KNN_SHARD_DOCS, state)
        elif phase == "knn_shards":
            phase_knn_shards(device, rng, state)
        elif phase == "hybrid":
            phase_hybrid(device, rng, state)
        elif phase == "knn_writes":
            phase_knn_writes(device, rng, state)
        elif phase == "dsl":
            phase_dsl(device, state, args.seed)
        elif phase == "collapse_rescore":
            phase_collapse_rescore(device, state, args.seed)
        elif phase == "sort":
            phase_sort(device, state, args.seed)
        elif phase == "rest_dsl":
            phase_rest_dsl(device, state, args.seed)
        elif phase == "dsl_shards":
            phase_dsl_shards(device, state)
        elif phase == "scripts":
            phase_scripts(device, state)
        elif phase == "scripts_update":
            phase_scripts_update(device, state)
        elif phase == "scripts_shards":
            phase_scripts_shards(device, state)
        elif phase == "tenancy":
            phase_tenancy(device, state)
        elif phase == "extra":
            phase_extra(device, s18_rng["extra"], state)
        elif phase == "extra_shards":
            phase_extra_shards(device, state)
        elif phase == "fetch_highlight":
            phase_fetch_highlight(device, s19_rng["fetch_highlight"], state)
        elif phase == "suggest":
            phase_suggest(device, s19_rng["suggest"], state)
        elif phase == "search_profile":
            phase_search_profile(device, s19_rng["search_profile"], state)
        elif phase == "search_profile_shards":
            phase_search_profile_shards(device, s19_rng["search_profile"], state)
        elif phase in ("templates", "search_apis", "rank_eval", "multi_index", "rrf"):
            {"templates": phase_templates, "search_apis": phase_search_apis,
             "rank_eval": phase_rank_eval, "multi_index": phase_multi_index,
             "rrf": phase_rrf}[phase](device, s20_rng[phase], state)
        elif phase == "geo_index":
            phase_geo_index(device, s18_rng["geo_index"], state)
        elif phase == "geo":
            phase_geo(device, s18_rng["geo"], state)
        elif phase == "field_types":
            phase_field_types(device, s18_rng["field_types"], state)
        elif phase == "matchers":
            phase_matchers(device, s18_rng["matchers"], state)
        elif phase == "analysis":
            phase_analysis(device, s18_rng["analysis"], state)
        elif phase == "report":
            phase_report(device, state)
        if phase in BUILD_PHASES and phase != "c5_index":
            _log_build(state, phase, _new_profiles(state, mark))
        log(f"phase {phase}: {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
