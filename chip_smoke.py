#!/usr/bin/env python3
"""On-card smoke test of femto_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed 1234] [--parent DIR]

Needs one CUDA card and nvcc; without them it exits non-zero and prints no
result.  It imports neither jax nor femto_tpu.  Phases (any failure exits
non-zero):

1. card and toolchain: nvidia-smi name and power limit, CUDA, nvcc, triton;
2. build every kernel under femto_tpu_torch/csrc/ with nvcc for sm_90a
   (and, beside them, the other-route builds of H, K18a, D, C, E and of
   the all-symbol rank in R and K18f, and a pointer-chase latency probe);
   ptxas must report no local memory in kernel C's kernels, nor in
   kernel E's, mesh_flags', mesh_scan's and compact_rows' kernels;
3. kernel L's gather_rows and gather_cols at edge shapes (1 to 8 columns,
   int32 and int64, idx views off a 16-byte boundary, -1 and
   out-of-range indices, 0, 1, 65,536 and 2^26 rows), kernel D's extract
   on both routes (a warp a walk, a thread a walk) at B = 1, 5, the
   crossover and one past it, from the last segment's pad rows, side
   segments and continued run-length segments on every layout, and
   the paged one-step extract on both; kernel E's psi walk on both
   routes (a warp a walk, a thread a walk) and as built, 64 steps from
   C[c] and C[c+1] - 1 of every present code, from the rows whose step
   lands on the first or last field of a segment, on the last segment,
   on side and continued segments and on the prose's stream_edges
   segments, and from rows before each document's end, at all of them,
   1 and 5 walks, on every layout of the 8 MiB builds, the prose's row
   tiers and the pad_shape builds; kernel D's locate on both
   routes on the row tiers (the 8 MiB corpus's, the prose's, and the
   prose built at mark_period 3) at B = 1, 5, 65,536 and 2^17, from the
   last segment's rows, side segments and continued segments, at the
   build's mark_period and at a shorter one where walks reach no mark,
   with the route each call took; then
   each kernel against its plain PyTorch version, bit for bit, on an 8 MiB
   seeded corpus (zipf English with one document twice, a repeat-heavy, a
   binary and an empty doc): the suffix sort's kernels one by one and the
   sort as a whole in each of its regimes against the plain versions on
   the CPU, kernels M and N one by one at the shapes vseg and vrle builds
   give them (that corpus, its zipf documents alone, 8 MiB of prose at
   seg 2048), the builds of every tier, and the search kernels on each
   layout (full, compact, packed, vseg, vrle; the packed one also at a
   31-symbol alphabet, vseg and vrle also on the prose); the query
   engine's kernels on each of those indexes: kernel C's backward_step
   (with -1, absent and out-of-alphabet lanes) and backward_search_steps,
   one layer of kernel R's regex_fork (also on each rank route forced:
   an entry's rows ranked for every code at once, or each fork's by
   femto::occ; on the row tiers from ranges whose ends lie on side and
   continued segments, and from ranges between row0 - 1, row0, row0 + 1,
   n_rows - 1 and n_rows), H and regex_merge from fixed
   frontiers (exact, approximate, an NFA too wide for shared memory; the
   merge also at capacities that overflow), K18f's masked_occ_rows as one
   shard at edge rows (row0 and its neighbours, segment ends, the last
   segment, n_rows, the segments' end, side and continued segments) on
   both routes, regex_fork's layers and masked_occ_rows also on pad_shape
   builds (row0 > 0: full, vseg and vrle); kernel C's four entries on
   both routes (a warp or a thread a pattern or lane) and as built on
   every layout, the prose's (side and continued segments) and the
   pad_shape builds, backward_search and backward_search_steps at 64
   columns and at 1, 5 and every pattern, the one-step entries on lanes
   whose ends share a segment (empty and reversed ranges too), end on
   side and continued segments or between row0 - 1 and n_rows, with -1,
   absent and outside-alphabet symbols, and on the five layouts a
   whole run_regexp_device on the card against the same search on a CPU
   copy of the index (the plain versions) and the host engine, with a
   forced capacity retry; the chunked path's kernels: P's doc_lists and
   flatten_ragged at seg 64, 256, 2048 and 65504 (the largest
   l1_group_for takes: its rows sort in global memory), Q's expand_u8 on
   documents with headers, bytes 0 and 255 and an empty document, G's
   sa_keys with n_real and K on a padded text, a whole padded suffix sort
   against the CPU's and the unpadded one, bwt_from_sa, a pad_shape build
   with doc lists, four-chunk build_chunked_prepared runs (uniform and
   prefetch both ways) against the CPU's, merge_indexes and
   IncrementalIndex against a direct build; paged serving (K16): kernel
   T's apply_faults (with evictions and dropped entries), C's masked step,
   D's lf_walk_step, resolve_marks and the one-step extract on half-filled
   caches with a random seg_slot of the 8 MiB vseg and vrle and the prose
   vrle index, each also against itself on the resident index, a whole
   paged locate walk step by step on both of D's routes (done lanes'
   segments evicted), and a
   whole PagedIndex on the card against the same file opened on the CPU
   (answers, stats, slot maps, clock, cache); kernel S's lcp_round and
   lcp_compact round by round (W 32 up to 4096, its twin document's
   pairs sharing 64 KiB) and with more slots than lanes, and lcp_array
   against host Kasai (ft_kasai, or _kasai_np where make fails: printed);
   the sharded index's kernels (K18) on a LocalMesh of 4 shards: each at
   the inputs a sharded build of the 8 MiB corpus gives it (seed keys,
   payload, splitters, the bucket exchange, the rebalance, group starts,
   scans, compaction, psum fetches, placements, the mesh prefix,
   add_base and add_mesh_base), mesh_scan and compact_rows at edge
   shapes (no flag, every flag, one at a shard's first or last slot,
   random, runs; m 100, 2^20 + 1 and one below, at, one and 17 past
   each kernel's tile, at Dl 4 and at Dl 1 with shard0 2, the flags 0, 1
   and 4 bytes past 16-byte alignment; compact_rows at off the counts'
   prefix and past M, 1 to 9 columns with the global index among them;
   both at 4 x (2^24 + 3) flags, more tiles than the card holds at once),
   mesh_flags at 1 to 6 key columns, first both ways, m 1, 15, 16, 17,
   1000 and 2^24 + 3, Dl 4 from shard0 0 and 4 and Dl 1 from shard0 2,
   keys 0 and 4 bytes past 16-byte alignment, ties across shard
   boundaries, the last three of
   the list above also at edge
   shapes (A of 1, 3, 256 and 1024 columns, 0, 1, 5 and 2^18 rows, 1 or
   4 local shards from shard 0 or 3 of 8, x 16-B aligned or not, int32
   values that wrap, op "max" on negative rows, C and the base on and
   off), bucket_pack also at edge shapes (0, 1 and past one block's
   records a shard, tile multiples and a run over 9 tiles, 2 to 128
   buckets, cap below, at and above the largest bucket, 1 to 8 columns,
   valid flags, every record dropped), the owner and masked occ / LF answers
   on the full, compact and packed sharded indexes, masked_occ_rows at
   edge rows and each shard's block ends on every tier and at a sharded
   search's widest layer, on both rank routes; the whole full-tier
   sharded build on the card against the same build on the CPU (every
   FMArrays block, meta, LAST_BUILD_STATS), dist_suffix_array's real rows
   against the suffix array, and every tier's count (routed and psum) of
   1024 patterns and locate of 4096 rows against the single-device
   index;
4e. run right after phase 3, while the card holds nothing else: the
   chunked path at full size, build_chunked_prepared of 129 zipf
   documents of 2^24 symbols (n = 2,164,260,864, past 2^31) in chunks of
   at most 2^28 symbols (full tier, seg 256, mark_period 20, doc lists,
   the uint8 upload, prefetch: 9 chunks, the last one document padded to
   row0 251,658,240); the needle's locate and count, 32768 patterns cut
   from the text (each >= 1, the MultiIndex count the sum over the
   chunks), located offsets held to the text and match rows' contexts to
   the patterns, a Boolean docs_query held to its terms' documents,
   sampled doc lists of every chunk held to their plain version, the
   padded tail chunk held to an unpadded build of its document (counts,
   locate, a 65536-step backward extract, range_docs, contexts over its
   real rows, all past n); MiB/s, ms per chunk, peak device memory, the
   tail chunk's sort with and without n_real; the launch counts of this
   path alone (path "chunked"); its kernels' phase 5 rows at its shapes;
   one two-chunk build profiled for phase 6 (busy share, how much of the
   pinned uploads ran under kernels, no library sort or scan);
4. the first main path at full size (a 256 MiB zipf-English corpus in
   64 KiB documents): build_index(tier="full", seg=256, mark_period=20),
   count of 32768 16-symbol patterns, locate of 65536 rows (walk and
   direct), and extract_document of 8 documents, each checked, the suffix
   array held to be a permutation in suffix order on 65536 adjacent row
   pairs; then one build of the twin corpus (the same documents with
   document 1 a copy of document 0: a duplicate document sends the suffix
   sort past its extension rounds into rank_init and the doubling rounds,
   which the main corpus does not reach), checked the same way; the
   kernels' launch counts are read around this phase alone, and printed
   after the first build too;
4h. run right after phase 4, while the card holds its index only: the
   sharded path (K18) on a LocalMesh of 4 shards of one card, through
   build_index_sharded, sharded_backward_search and sharded_locate:
   phase 4's corpus built in the full, compact and packed tiers, each
   held to phase 4's index (count of its 32768 patterns, ranges shifted
   by row0, and locate of its 65536 rows, routed and psum), the sharded
   SA of the real rows to phase 4's; build MiB/s, LAST_BUILD_STATS,
   peak device memory, count steps/s and locate rows/s; one full build
   of the twin corpus (the replicated doubling tail at full size); the
   DistMesh code path on NCCL at world size 1 in this process
   (bins.exchange, a sharded build and the count of 4096 patterns equal
   to LocalMesh(1)'s); the launch counts of this path alone (path
   "sharded"); its kernels' phase 5 rows at its shapes; one sharded
   build profiled for phase 6; then the sharded query engine (the
   "sharded_query" path): bench.py's regexes on every tier and the prose
   queries held to phase 4d's answers, K18f masked_occ_rows' device ms
   summed over the regex and approximate queries' calls as built and on
   each rank route, and its rows at the widest layers;
4b. the second main path on the same corpora: build_index of the compact
   and packed tiers, a .ftpu round trip of the packed index (save_flat,
   load), then on both tiers count, locate and extract as in 4, and on all
   three tiers extract_context_batch of 4096 match rows and range_docs of
   64 pattern ranges, each checked against the full tier and the
   documents, and one compact build of the twin corpus, with its own
   launch counts; each tier's index bytes per character;
4c. the third main path: build_index of the vseg and vrle tiers (a) on
   phase 4's corpus and (b) on real English prose
   (english_prose: examples/corpus_real's sources, walked so that one
   installation gives the same bytes; 64 KiB documents, seg 2048), each
   served through count, locate, extract, context and range_docs and held
   to the full tier of the same corpus (prose counts also to a text
   scan), the prose vrle index through a .ftpu file and back; it fails
   unless the prose vrle index holds run-length and continued segments;
   segments by mode and bytes per character of each tier;
4d. the fourth main path, the query engine: bench.py's two regex
   queries through run_regexp_device on phase 4's zipf full, compact and
   packed indexes, and ten regex, approximate, Boolean and icase queries
   through count_query, docs_query and find_strings on the prose vseg and
   vrle indexes, backward_search_steps on all five; every answer held to
   the host engine on the same index (which must not have run during the
   device part: no query may take term_ranges' fallback), exact regexes
   to a text scan with Python re, Boolean document sets to scans of
   their terms; per query the median of 3 latencies, layers, the widest
   live frontier, match ranges and host reads of the device (syncs); the
   launch counts of the device part (path "query") and of the host
   engine's run (path "query_host") are read apart; then regex_fork's
   device ms summed over one pass of the regex and approximate queries
   (CUDA events around each call, queued behind a spin kernel), as built
   and on each rank route forced, the answers equal, and kernel C's the
   same way on each of its routes: backward_search over the prose
   queries, backward_search_steps over the report's calls and the host
   engine's backward_step over every query and term;
4f. paged serving (K16): phase 4c's zipf vrle index (at a quarter and
   half of its rows), its zipf vseg index (a quarter) and its prose vrle
   index (a quarter, seg 2048) through save_flat and load_paged, each
   cold (a fresh cache) and warm: count of phase 4's 32768 patterns, the
   same count over 32768 draws from 64 of them, locate of 65536 rows,
   phase 4d's prose queries through the engine (prose; a query whose
   layer touches more segments than the cache holds is refused, as
   femto_tpu refuses it, and recorded); extract_document of one 8191-byte
   document of the prose in 8 KiB documents; every answer held to the
   resident index's, warm repeats whose cold faults fit the cache held to
   no fault; ms, faults, hits, fetched MiB, dispatches, the fault path's
   GB/s, us per extracted character and the ratio to the resident call;
   the paged path's launch counts; kernel C's masked step's device ms
   over one count of each cell on each of C's routes; its kernels' phase
   5 rows at the zipf quarter's shapes; one cold count profiled for
   phase 6;
4g. the LCP analytics (K17): lcp_array of phase 4's corpus and of its
   twin from the suffix arrays built on the card, held to a host byte
   compare at 65536 sampled ranks (lcp[0] == 0), and of the prose,
   whose unique_lengths and suffix_similarity equal those from host
   Kasai's LCP; ms, MiB/s, rounds, live lanes per round, the largest
   LCP; kernel S's phase 5 rows at the first round's shape; one
   lcp_array profiled for phase 6;
5. numbers: medians of 3 runs, per-kernel times beside their bounds, their
   plain versions and a one-call PyTorch yardstick where one exists; the
   kernels at the main paths' shapes are compared with their plain
   versions again (that one comparison run times the plain version); the
   "kernels" line has one row per kernel and main path that launched it,
   with that path's own launch count and the card's name and power
   limit; kernel R's fork and merge and H are
   also held to their plain versions at the widest layers of APPROX 2
   parameter and 0{1,64}1 on the prose vrle index; kernel H's and K18a
   bucket_pack's routes are each held against the other route (a build
   of the source with another limit) on their paths' own calls; kernel L
   in 5 rounds in turns with index_select at the pull and the direct
   tier (the call, its own device item and its queued device work apart,
   the host us of each part of one call), gather_cols against one gather_rows a column at the sharded
   local sort's call; kernel D's warp route (a build with
   -DFEMTO_D_WARP_MAX=0x7fffffff) in 3 rounds in turns with its thread
   route (the design before, a build with -DFEMTO_D_WARP_MAX=0), with
   the route the source picks: kernel R's regex_fork and K18f's
   masked_occ_rows on their two rank routes (each forced by a build with
   -DFEMTO_R_ROW_RANK=0 or =1) in 5 rounds in turns at the widest layers
   (regex_fork also at an exact and a class layer on every layout, with
   the codes its entries rank; chip_rank_routes.py times both routes
   over more layers, layouts and segs), each beside a second bound (each
   entry's or row's rows read once); kernel C's rows (every entry at its
   paths' calls) with its warp route in 5 rounds in turns with its
   thread route (builds with -DFEMTO_C_WARP_MAX=0x7fffffff and =0), the
   route the source picks, the bound with a shared segment's row read
   once beside the bound of each end's row read apart, and C's device ms
   summed over the count rates' calls on each route; D's routes: extract on every layout's 8192-step walk
   and on the context batch's backward walk, locate on the prose's
   65,536 walks (vseg, vrle) and the paged lf_walk_step at phase 4f's
   first step (zipf vseg and vrle quarter caches); both extract routes
   at and past each layout's limit (chip_d_routes.py times every entry
   over a wider range), the row tiers' walk locate rates on the thread
   route too, and each walk's latency floor (steps x the card's
   dependent-load latency from a pointer chase over 1 GiB) beside its
   bytes bound; mesh_scan and compact_rows at their first sharded calls
   (_group_state's cummax, dist_sort's compaction) with the bound of the
   design before (old_bound_ms); kernel E's rows (4096 walks x 64 steps)
   with its warp route in 5 rounds in turns with its thread route (builds
   with -DFEMTO_E_WARP_MAX=0x7fffffff and =0), the route the source picks,
   each route's dependent round trips a step and the latency floor of the
   picked one; and, given --parent DIR (the parent commit unpacked by git
   archive), kernel E's rows and mesh_flags' at its first sharded call in
   5 rounds in turns with the parent's build of the same source through
   the same wrapper, held to it bit for bit;
6. where the time goes: device time by kernel and the device's busy share
   over one build, count, locate and extract of the full tier, one
   build, count, locate and context of the packed tier, the vseg and vrle
   builds, one build, count, locate and context of the prose vrle
   index, and one APPROX 1 ther query on the zipf full and the prose vrle
   index (with the host time per layer) (torch.profiler; a count's
   kernel C device ms and a context's kernel E device ms also from CUDA
   events around their calls, which the profiler has missed);
   the two-chunk build of phase 4e, the cold paged count of 4f, the
   lcp_array of 4g and the sharded build of 4h (with their largest idle
   gaps, and the sharded build's launches of K18a's and K18b's entries
   and kernel L's device ms and launches; it fails unless every
   mesh_scan call and every compact_rows call of up to 8 columns is one
   launch, and unless one call of each alone shows its tile kernel and
   memsets only, no fill of compact_rows' outputs)
   join these; a build or
   query whose
   device items include a library sort or scan fails, and
   the build's device time outside the port's own kernels and copies is
   printed by name.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that the "kernels" JSON line.  The
full record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
DOC_SIZE = 1 << 16
PATLEN = 16
N_PATTERNS = 32768
N_LOCATE = 65536
N_CONTEXT = 4096  # extract_context_batch rows: 32 before, 16 + 48 from
CTX = (32, PATLEN, 48)
N_RANGES = 64     # range_docs ranges, of 6-symbol patterns
MAIN_MIB = 256  # the main path's corpus size
ZIPF_LETTERS = b"etaoin shrdlucmfwypvbgkqjxz.,\n"
TIER_LAYOUTS = ("full", "compact", "packed")   # phase 4b
ROW_LAYOUTS = ("vseg", "vrle")                 # phase 4c
LAYOUTS = TIER_LAYOUTS + ROW_LAYOUTS
PROSE_MIB = 32    # english_prose budget (phase 4c)
PROSE_MIN_MIB = 4
PROSE_SEG = 2048  # the real-text leg's segment size
PARITY_PROSE_MIB = 8
EXTRACT_STEPS = 8192  # phase 5's extract rows: steps of one walk
# phase 4e, the chunked path: the corpus of tests/test_big_corpus.py's
# test_over_2to31_symbols, 129 documents of 2^24 symbols (SEOF included),
# each body its own zipf draw, built in chunks of at most 2^28 symbols
CHUNK_DOC = 1 << 24
CHUNK_NDOCS = 129            # n = 2,164,260,864 > 2^31
CHUNK_MAX = 1 << 28          # 16 documents a chunk: 9 chunks, the last one
#                              document padded to the chunks' shape
CHUNK_NEEDLE = b"NEEDLE-XYZZY"
CHUNK_NEEDLE_DOCS = (0, 64, 128)   # planted at offset 1000 + d
CHUNK_TAIL_STEPS = 65536     # backward extract from the tail document's end
# phase 4f, paged serving: (index, share of its rows the cache holds)
PAGED_CELLS = (("zipf vrle", 0.25), ("zipf vrle", 0.5), ("zipf vseg", 0.25),
               ("prose vrle", 0.25))
N_SKEW = 64        # the skewed count draws its patterns from 64 of them
EXTRACT_DOC = 8192  # the paged extract's prose documents (8191 bytes each)
# phase 4g, LCP: sampled ranks held to a host byte compare
N_LCP_SAMPLES = 65536
SIMILARITY_MIN_LCP = 64  # suffix_similarity's pairs on the prose
SHARD_D = 4                  # phase 3's and 4h's LocalMesh shards
SHARD_TIERS = ("full", "compact", "packed")
SHARD_LAYOUTS = SHARD_TIERS + ROW_LAYOUTS
N_NCCL_PATTERNS = 4096       # phase 4h's count on the NCCL DistMesh
N_DOC_LIST_SEGS = 256        # 4h's sampled segments of the doc lists
NCCL_DOCS_QUERY = "'the' AND 'ing'"  # 4h's docs query on the NCCL DistMesh
CKPT_DOCS = 256              # 4h's checkpointed build: 2^24 symbols
N_CHUNK_SEGS = 64            # sampled segments of each chunk's doc lists
# phase 3's doc-list segment sizes; 65504 is the largest l1_group_for takes
DOC_LIST_SEGS = (64, 256, 2048, 65504)
ROW_KERNELS = ("seg_syms", "vseg_rows", "side_rows", "vrle_slot_count",
               "vrle_pack", "cont_flatten")
# the kernels each main path must launch: phase 4 (full tier), 4b
# (compact, packed) and 4c (vseg, vrle).  The suffix sort and its payload
# (kernels G-L): every build runs them; the main corpus ends in the
# extension rounds, the twin corpus (one document twice), built once on
# the first two paths, goes on to rank_init and doubling
SORT_KERNELS = ("sym_hist", "sa_keys", "radix_sort_pairs", "group_flags",
                "tied_compact", "rank_init", "round_keys[extension]",
                "round_keys[doubling]", "round_commit", "sa_payload",
                "gather_rows")
PATH_KERNELS = {
    "full": SORT_KERNELS + (
        "occ_build", "marks_build", "backward_search[full]",
        "lf_locate[full]", "lf_extract[full]"),
    "tiers": SORT_KERNELS + (
        "occ_build_compact", "marks_build", "pack_build")
    + tuple(f"{k}[{lay}]" for k in ("backward_search", "lf_locate",
                                    "lf_extract", "psi_walk")
            for lay in TIER_LAYOUTS),
    # phase 4c builds no twin: rank_init and doubling run only when the
    # prose repeats itself at length, so they are not required
    "rows": tuple(k for k in SORT_KERNELS
                  if k not in ("rank_init", "round_keys[doubling]"))
    + ("occ_build_compact", "marks_build") + ROW_KERNELS
    + tuple(f"{k}[{lay}]" for k in ("backward_search", "lf_locate",
                                    "lf_extract", "psi_walk")
            for lay in ROW_LAYOUTS),
    # phase 4d: the device frontier on all five layouts (zipf full,
    # compact, packed; prose vseg, vrle), H between its fork and merge,
    # the too-few-matches report on all five, and on the prose the
    # literal terms (C), documents (D) and strings (E); no backward_step,
    # which only the host engine runs
    "query": ("radix_sort_pairs", "regex_merge")
    + tuple(f"{k}[{lay}]" for k in ("regex_fork", "backward_search_steps")
            for lay in LAYOUTS)
    + tuple(f"{k}[{lay}]" for k in ("backward_search", "lf_locate",
                                    "psi_walk")
            for lay in ROW_LAYOUTS),
    # phase 4d's reference: the host engine (term_ranges' answer past the
    # frontier's largest capacities) on the same queries and indexes
    "query_host": tuple(f"backward_step[{lay}]" for lay in LAYOUTS),
    # phase 4e: every chunk uploaded as bytes (Q) and built with doc lists
    # (P), the 8 whole chunks unpadded, the tail chunk padded (G's n_real);
    # zipf documents that differ end in the extension rounds; count,
    # locate, context (E) and a backward extract on the full tier
    "chunked": tuple(k for k in SORT_KERNELS
                     if k not in ("rank_init", "round_keys[doubling]"))
    + ("sa_keys[n_real]", "expand_u8", "doc_lists", "flatten_ragged",
       "occ_build", "marks_build", "backward_search[full]",
       "lf_locate[full]", "lf_extract[full]", "psi_walk[full]"),
    # phase 4f: paged serving of the zipf vseg and vrle and the prose vrle
    # indexes (K16): the cache update (T), C's masked step, D's locate
    # step and mark decode, the one-step extract (prose vrle) and the host
    # engine's free-lane step (the prose queries' regex terms)
    "paged": ("apply_faults", "resolve_marks", "lf_extract[vrle]",
              "backward_step[vrle]")
    + tuple(f"{k}[{lay}]" for k in ("backward_step_masked", "lf_walk_step")
            for lay in ROW_LAYOUTS),
    # phase 4g: lcp_array on the zipf corpus and its twin, and the prose
    # (K17, kernel S)
    "lcp": ("lcp_round", "lcp_compact"),
    # phase 4h: the sharded build of all five tiers on a LocalMesh
    # (K18a-K18e around G, H, L, A, A', F, B; the row tiers' M and N per
    # shard, K18g), the doc lists (P per shard) and sharded count and
    # locate, routed and psum (K18f on each layout)
    "sharded": ("bucket_pack", "owner_place", "splitter_bucket",
                "rebalance_local", "mesh_exclusive", "add_mesh_base",
                "seed_keys",
                "payload_block", "mesh_flags", "mesh_scan", "compact_rows",
                "fetch_owned", "sym_hist", "radix_sort_pairs", "gather_rows",
                "gather_cols",
                "occ_build", "occ_build_compact", "pack_build",
                "marks_build", "doc_lists", "flatten_ragged") + ROW_KERNELS
    + tuple(f"{k}[{lay}]" for k in ("owner_occ", "masked_occ", "owner_lf",
                                    "masked_lf")
            for lay in SHARD_LAYOUTS),
    # phase 4h's query engine over the sharded indexes (K18h): bench.py's
    # regexes on the zipf ones of every tier, the prose
    # queries on the prose vseg and vrle ones (count and docs queries),
    # the frontier's ranks by K18f's masked_occ_rows, R's given-ranges
    # fork, H and R's merge; literal terms and offsets through the routed
    # search and locate
    "sharded_query": ("regex_fork_ranked", "radix_sort_pairs", "regex_merge",
                      "bucket_pack", "owner_place")
    + tuple(f"masked_occ_rows[{lay}]" for lay in SHARD_LAYOUTS)
    + tuple(f"{k}[{lay}]" for k in ("owner_occ", "owner_lf")
            for lay in ROW_LAYOUTS),
}
KERNELS = {  # entry -> (source, the femto_tpu function it replaces)
    "occ_build": ("femto_tpu_torch/csrc/occ_build.cu",
                  "femto_tpu/ops/build_ops.py:197"),
    "occ_build_compact": ("femto_tpu_torch/csrc/occ_build.cu",
                          "femto_tpu/ops/build_ops.py:169"),
    "marks_build": ("femto_tpu_torch/csrc/marks_build.cu",
                    "femto_tpu/ops/build_ops.py:1033"),
    "pack_build": ("femto_tpu_torch/csrc/pack_build.cu",
                   "femto_tpu/ops/build_ops.py:923"),
    "sym_hist": ("femto_tpu_torch/csrc/sa_keys.cu", "femto_tpu/suffix.py:68"),
    "sa_keys": ("femto_tpu_torch/csrc/sa_keys.cu", "femto_tpu/suffix.py:99"),
    "radix_sort_pairs": ("femto_tpu_torch/csrc/radix_sort.cu",
                         "femto_tpu/suffix.py:148"),
    "group_flags": ("femto_tpu_torch/csrc/sa_groups.cu",
                    "femto_tpu/suffix.py:157"),
    "tied_compact": ("femto_tpu_torch/csrc/sa_groups.cu",
                     "femto_tpu/suffix.py:167"),
    "rank_init": ("femto_tpu_torch/csrc/sa_rounds.cu",
                  "femto_tpu/suffix.py:272"),
    "round_keys[extension]": ("femto_tpu_torch/csrc/sa_rounds.cu",
                              "femto_tpu/suffix.py:204"),
    "round_keys[doubling]": ("femto_tpu_torch/csrc/sa_rounds.cu",
                             "femto_tpu/suffix.py:302"),
    "round_commit": ("femto_tpu_torch/csrc/sa_rounds.cu",
                     "femto_tpu/suffix.py:302"),
    "sa_payload": ("femto_tpu_torch/csrc/sa_payload.cu",
                   "femto_tpu/ops/build_ops.py:82"),
    "gather_rows": ("femto_tpu_torch/csrc/sa_payload.cu",
                    "femto_tpu/search.py:71"),
    # the columns a sharded local sort carries through its sort
    "gather_cols": ("femto_tpu_torch/csrc/sa_payload.cu",
                    "femto_tpu/parallel/dist_sort.py:80"),
    "seg_syms": ("femto_tpu_torch/csrc/vseg_build.cu",
                 "femto_tpu/ops/build_ops.py:211"),
    "vseg_rows": ("femto_tpu_torch/csrc/vseg_build.cu",
                  "femto_tpu/ops/build_ops.py:383"),
    "side_rows": ("femto_tpu_torch/csrc/vseg_build.cu",
                  "femto_tpu/ops/build_ops.py:269"),
    "vrle_slot_count": ("femto_tpu_torch/csrc/vrle_build.cu",
                        "femto_tpu/ops/build_ops.py:523"),
    "vrle_pack": ("femto_tpu_torch/csrc/vrle_build.cu",
                  "femto_tpu/ops/build_ops.py:582"),
    "cont_flatten": ("femto_tpu_torch/csrc/vrle_build.cu",
                     "femto_tpu/ops/build_ops.py:863"),
}
KERNELS["regex_merge"] = ("femto_tpu_torch/csrc/regex_frontier.cu",
                          "femto_tpu/query/regexp_device.py:197")
KERNELS.update({
    "sa_keys[n_real]": ("femto_tpu_torch/csrc/sa_keys.cu",
                        "femto_tpu/suffix.py:99"),
    "expand_u8": ("femto_tpu_torch/csrc/text_expand.cu",
                  "femto_tpu/fmindex.py:80"),
    "doc_lists": ("femto_tpu_torch/csrc/doc_lists.cu",
                  "femto_tpu/ops/build_ops.py:834"),
    "flatten_ragged": ("femto_tpu_torch/csrc/doc_lists.cu",
                       "femto_tpu/ops/build_ops.py:863"),
})
KERNELS.update({
    "apply_faults": ("femto_tpu_torch/csrc/paged.cu",
                     "femto_tpu/paged.py:53"),
    "resolve_marks": ("femto_tpu_torch/csrc/lf_walk.cu",
                      "femto_tpu/paged.py:86"),
    "lcp_round": ("femto_tpu_torch/csrc/lcp.cu", "femto_tpu/lcp.py:33"),
    "lcp_compact": ("femto_tpu_torch/csrc/lcp.cu", "femto_tpu/lcp.py:57"),
})
KERNELS.update({
    "bucket_pack": ("femto_tpu_torch/csrc/exchange.cu",
                    "femto_tpu/parallel/bins.py:37"),
    "owner_place": ("femto_tpu_torch/csrc/exchange.cu",
                    "femto_tpu/parallel/bins.py:148"),
    "splitter_bucket": ("femto_tpu_torch/csrc/sample_sort.cu",
                        "femto_tpu/parallel/dist_sort.py:40"),
    # dist_sort's rebalance, one launch a sort; rebalance_place, the same
    # kernel, serves a DistMesh's offsets to other processes
    "rebalance_local": ("femto_tpu_torch/csrc/sample_sort.cu",
                        "femto_tpu/parallel/dist_sort.py:51"),
    "rebalance_place": ("femto_tpu_torch/csrc/sample_sort.cu",
                        "femto_tpu/parallel/dist_sort.py:51"),
    "mesh_exclusive": ("femto_tpu_torch/csrc/sample_sort.cu",
                       "femto_tpu/parallel/dist_build.py:88"),
    "add_base": ("femto_tpu_torch/csrc/sample_sort.cu",
                 "femto_tpu/parallel/dist_build.py:1010"),
    # ops/dist_ops.add_mesh_base: the prefix inside add_base's kernel, an
    # entry of its own (the sharded path calls add_base with a given base
    # nowhere)
    "add_mesh_base": ("femto_tpu_torch/csrc/sample_sort.cu",
                      "femto_tpu/parallel/dist_build.py:1010"),
    "seed_keys": ("femto_tpu_torch/csrc/dist_rounds.cu",
                  "femto_tpu/parallel/dist_build.py:216"),
    "payload_block": ("femto_tpu_torch/csrc/dist_rounds.cu",
                      "femto_tpu/parallel/dist_build.py:247"),
    "mesh_flags": ("femto_tpu_torch/csrc/dist_rounds.cu",
                   "femto_tpu/parallel/dist_build.py:280"),
    "mesh_scan": ("femto_tpu_torch/csrc/dist_rounds.cu",
                  "femto_tpu/parallel/dist_build.py:195"),
    "compact_rows": ("femto_tpu_torch/csrc/dist_rounds.cu",
                     "femto_tpu/parallel/dist_build.py:305"),
    "fetch_owned": ("femto_tpu_torch/csrc/dist_rounds.cu",
                    "femto_tpu/parallel/dist_build.py:344"),
})
KERNELS["regex_fork_ranked"] = ("femto_tpu_torch/csrc/regex_frontier.cu",
                                "femto_tpu/parallel/dist_query.py:572")
for _lay in SHARD_LAYOUTS:
    KERNELS.update({
        f"owner_occ[{_lay}]": ("femto_tpu_torch/csrc/dist_query.cu",
                               "femto_tpu/parallel/dist_query.py:216"),
        f"masked_occ[{_lay}]": ("femto_tpu_torch/csrc/dist_query.cu",
                                "femto_tpu/parallel/dist_query.py:58"),
        # the sharded frontier's ranks: _occ_local_dense of every symbol
        # at each row, in backward_step_pair_sharded
        f"masked_occ_rows[{_lay}]": ("femto_tpu_torch/csrc/dist_query.cu",
                                     "femto_tpu/parallel/dist_query.py:99"),
        f"owner_lf[{_lay}]": ("femto_tpu_torch/csrc/dist_query.cu",
                              "femto_tpu/parallel/dist_query.py:320"),
        f"masked_lf[{_lay}]": ("femto_tpu_torch/csrc/dist_query.cu",
                               "femto_tpu/parallel/dist_query.py:155"),
    })
for _lay in ROW_LAYOUTS:
    KERNELS[f"backward_step_masked[{_lay}]"] = (
        "femto_tpu_torch/csrc/backward_search.cu", "femto_tpu/paged.py:64")
    KERNELS[f"lf_walk_step[{_lay}]"] = ("femto_tpu_torch/csrc/lf_walk.cu",
                                        "femto_tpu/paged.py:73")
# entries that no path of the port calls, each with the entry whose call
# on the sharded path runs its kernel: phase 5 times it at that call
# (add_base: the sharded build adds its bases through add_mesh_base;
# rebalance_place: the offsets of a DistMesh, at rebalance_local's call
# of the seed sort, at the neighbour offset that moves more records)
NO_CALLER = {"add_base": "add_mesh_base", "rebalance_place": "rebalance_local"}
# device items that would mean a build or a query fell back to a library
# sort or scan
LIBRARY_SORT_NAMES = ("RadixSort", "Onesweep", "cub::", "thrust::")
# kernel H's own kernels (csrc/radix_sort.cu): phase 6 sums their device
# items in each build and query, and checks their calls against the sorts
H_KERNELS = ("radix_digit_hist", "radix_tile_pass", "radix_block_sort")
# each of kernel H's routes (h_route), the route its sorts take instead in
# a build of csrc/radix_sort.cu with the flag, and that flag: phase 5 holds
# every route against that one on the query path's own sorts (h_route_rows)
H_ALTERNATIVES = {
    "one_block": ("few_key_tiles", "-DFEMTO_H_ONE_BLOCK=0"),
    "few_key_tiles": ("full_tiles", "-DFEMTO_H_FEW_MAX=0"),
    "full_tiles": ("few_key_tiles", "-DFEMTO_H_FEW_MAX=0x7fffffff"),
}
# kernels that lose to one library call by less than the cost of a call
# (ROADMAP Q1): phase 5 also takes their own device items from
# torch.profiler, beside the CUDA-event time of the whole call
ITEM_ROWS = ("owner_place", "mesh_exclusive", "add_base", "add_mesh_base",
             "bucket_pack", "gather_rows", "gather_cols", "owner_lf[vseg]",
             "owner_lf[vrle]")
# the device item of a row whose __global__ function has another name
# than <row>_kernel (a prefix of the names where a row has two kernels:
# bucket_pack_block and bucket_pack_tile; gather_cols_kernel behind both
# of L's entries)
ITEM_KERNELS = {"add_mesh_base": "add_base_kernel",
                "bucket_pack": "bucket_pack_",
                "gather_rows": "gather_cols_",
                "gather_cols": "gather_cols_",
                # owner_lf_kernel (a thread a request), owner_lf_warp_kernel
                "owner_lf[vseg]": "owner_lf_",
                "owner_lf[vrle]": "owner_lf_"}
# kernels whose library call takes about their own time, where one round
# in turns cannot say which is faster (host- and launch-bound times move
# 20-90% from run to run, PERF.md): timed in turns this many rounds
TURN_ROUNDS = {"radix_sort_pairs": 5, "mesh_exclusive": 5, "add_base": 3,
               "add_mesh_base": 3, "bucket_pack": 3, "owner_place": 5,
               "gather_rows": 5}
# rounds in turns of kernel D's two routes (d_fields): the warp route has
# led on every row in every run PERF.md records, so fewer rounds than a
# close call needs
D_TURN_ROUNDS = 3
# each of K18a bucket_pack's routes (k18a_route), the route its calls take
# instead in a build of csrc/exchange.cu with the flag, and that flag: phase
# 4h holds every route against the other on the sharded query path's own
# calls (k18a_route_rows)
K18A_ALTERNATIVES = {
    "one_block": ("tiles", "-DFEMTO_K18A_ONE_BLOCK_MAX=0"),
    "tiles": ("one_block", "-DFEMTO_K18A_ONE_BLOCK_MAX=0x7fffffff"),
}
for _lay in LAYOUTS:
    _row = _lay in ROW_LAYOUTS  # the row tiers' own steps (K11-K13)
    KERNELS.update({
        f"backward_step[{_lay}]": ("femto_tpu_torch/csrc/backward_search.cu",
                                   "femto_tpu/ops/rank.py:681"),
        f"backward_search_steps[{_lay}]": (
            "femto_tpu_torch/csrc/backward_search.cu",
            "femto_tpu/ops/search_ops.py:87"),
        f"regex_fork[{_lay}]": ("femto_tpu_torch/csrc/regex_frontier.cu",
                                "femto_tpu/query/regexp_device.py:142"),
        f"backward_search[{_lay}]": (
            "femto_tpu_torch/csrc/backward_search.cu",
            "femto_tpu/ops/rank.py:629" if _row
            else "femto_tpu/ops/search_ops.py:23"),
        f"lf_locate[{_lay}]": ("femto_tpu_torch/csrc/lf_walk.cu",
                               "femto_tpu/ops/rank.py:895" if _row
                               else "femto_tpu/ops/search_ops.py:115"),
        f"lf_extract[{_lay}]": ("femto_tpu_torch/csrc/lf_walk.cu",
                                "femto_tpu/ops/search_ops.py:342"),
        f"psi_walk[{_lay}]": ("femto_tpu_torch/csrc/psi_walk.cu",
                              "femto_tpu/ops/rank.py:577" if _row
                              else "femto_tpu/ops/search_ops.py:399"),
    })


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def zipf_table():
    """The 65536-entry quantile table of zipf-distributed English letters
    (p ~ 1/rank over 30 symbols)."""
    p = 1.0 / np.arange(1, len(ZIPF_LETTERS) + 1)
    edges = np.round(np.cumsum(p / p.sum()) * 65536).astype(np.int64)
    return np.repeat(np.frombuffer(ZIPF_LETTERS, np.uint8),
                     np.diff(np.concatenate([[0], edges])))


def zipf_bytes(rng, n):
    """n bytes of zipf-distributed English letters, drawn through
    zipf_table."""
    return zipf_table()[rng.integers(0, 65536, size=n, dtype=np.int64)]


def chunk_corpus(rng):
    """Phase 4e's PreparedText: CHUNK_NDOCS documents of CHUNK_DOC symbols,
    each body a zipf draw of its own (through uint16 indices: 2 bytes a
    symbol of scratch, not 8), the needle planted at offset 1000 + d in
    the documents CHUNK_NEEDLE_DOCS."""
    from femto_tpu_torch.alphabet import (CHARACTER_OFFSET, SEOF,
                                          PreparedText, bytes_to_alpha)

    table = zipf_table()
    needle = bytes_to_alpha(CHUNK_NEEDLE)
    text = np.empty(CHUNK_NDOCS * CHUNK_DOC, np.uint16)
    for d in range(CHUNK_NDOCS):
        s = d * CHUNK_DOC
        body = table[rng.integers(0, 65536, size=CHUNK_DOC - 1,
                                  dtype=np.uint16)]
        np.add(body, CHARACTER_OFFSET, out=text[s: s + CHUNK_DOC - 1],
               dtype=np.uint16)
        if d in CHUNK_NEEDLE_DOCS:
            text[s + 1000 + d: s + 1000 + d + len(needle)] = needle
        text[s + CHUNK_DOC - 1] = SEOF
    return PreparedText(
        text=text,
        doc_starts=np.arange(CHUNK_NDOCS + 1, dtype=np.int64) * CHUNK_DOC,
        infos=[b"doc%d" % d for d in range(CHUNK_NDOCS)])


def zipf_docs(rng, n_docs):
    """n_docs documents of DOC_SIZE - 1 bytes (DOC_SIZE symbols with SEOF)."""
    body = zipf_bytes(rng, n_docs * DOC_SIZE).reshape(n_docs, DOC_SIZE)
    return [body[i, : DOC_SIZE - 1].tobytes() for i in range(n_docs)]


def small_docs(rng):
    """~8 MiB: zipf English with one document twice (a long doubling tail
    for the suffix sort) plus a repeat-heavy, a binary and an empty doc."""
    docs = zipf_docs(rng, 123)
    docs.insert(1, docs[0])
    docs.append((b"abcabcabd" * (DOC_SIZE // 9 + 1))[: DOC_SIZE - 1])
    docs.append(b"a" * 8192)
    docs.append(rng.integers(0, 256, size=DOC_SIZE - 1, dtype=np.uint8)
                .tobytes())
    docs.append(b"")
    return docs


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def as_i64(t):
    import torch

    from femto_tpu_torch.ops.rank import u16_to_i32, u32_to_i64

    if t.dtype == torch.uint16:
        return u16_to_i32(t).long()
    if t.dtype == torch.uint32:
        return u32_to_i64(t)
    return t.long()


def max_abs_err(name, got, want):
    """Max |got - want| over matching tensors; raises unless bit-equal.
    Equal tensors are found equal without a widened copy (the sharded
    rows compare buffers of several GiB)."""
    import torch

    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}[{i}]: {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        if g.dtype not in (torch.uint16, torch.uint32) and torch.equal(g, w):
            continue
        if g.numel():
            err = max(err, int((as_i64(g) - as_i64(w)).abs().max()))
    check(err == 0, f"{name}: kernel differs from its plain version "
                    f"(max abs err {err})")
    return err


def cuda_ms(fn, reps=3):
    """Median device time of fn in ms (CUDA events), after one warm-up."""
    import torch

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
    return statistics.median(times)


def in_turns(run_k, library, rounds=1):
    """A kernel and the library call beside it, timed in turns (kernel,
    library, library, kernel; cuda_ms each), `rounds` times: (the median of
    the rounds' kernel means, the median of their library means, each
    round's four ms in that order)."""
    fours = []
    for _ in range(rounds):
        k1 = cuda_ms(run_k)
        l1 = cuda_ms(library)
        l2 = cuda_ms(library)
        k2 = cuda_ms(run_k)
        fours.append([k1, l1, l2, k2])
    return (statistics.median((f[0] + f[3]) / 2 for f in fours),
            statistics.median((f[1] + f[2]) / 2 for f in fours), fours)


def turn_fields(name, run_k, library):
    """A kernel's ms and its library call's (in_turns, TURN_ROUNDS[name]
    rounds) and the row's fields of those turns: each round's four ms and,
    over several rounds, the rounds in which the kernel came first and
    both calls' queued_ms."""
    rounds = TURN_ROUNDS.get(name, 1)
    ms, lib_ms, fours = in_turns(run_k, library, rounds)
    more = {"turns_ms": fours}
    if rounds > 1:
        more["kernel_ahead_rounds"] = sum(
            k1 + k2 < l1 + l2 for k1, l1, l2, k2 in fours)
        more["queued_ms"] = queued_ms(run_k)
        more["library_queued_ms"] = queued_ms(library)
    return ms, lib_ms, more


def full_fields(name, run_k, full):
    """The kernel in turns with the library's whole function, where the
    row's library call computes less (TURN_ROUNDS[name] rounds):
    library_full_ms, each round's four ms, the rounds in which the kernel
    came first, and the whole function's queued_ms."""
    ms, lib_ms, fours = in_turns(run_k, full, TURN_ROUNDS.get(name, 1))
    return {"library_full_ms": lib_ms, "library_full_turns_ms": fours,
            "kernel_ahead_of_full_rounds": sum(
                k1 + k2 < l1 + l2 for k1, l1, l2, k2 in fours),
            "library_full_queued_ms": queued_ms(full)}


# torch.cuda._sleep's kernel: the warm-up of a profiler session and the
# spin that keeps the card busy while a call is queued (queued_ms)
SPIN_KERNEL = "spin_kernel"


def profiler_warm_up():
    """Run inside a torch.profiler session before what it measures: late in
    a long process the profiler has dropped the first device events of a
    session (PERF.md, section 5), so a few spin kernels and a pause go first;
    their items (SPIN_KERNEL) are left out of every sum."""
    import torch

    for _ in range(16):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.05)


def device_items(fn, reps=3, per_call=None):
    """The median ms of each of fn's device items (kernels, copies, fills,
    memsets) over reps calls after a warm-up, from torch.profiler: {name:
    ms}; with a dict `per_call`, also each item's events a call there.  A
    median of an item's own events holds where the profiler drops some of
    them, as it has late in a long process; a sum over the calls would
    not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_warm_up()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    each = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and SPIN_KERNEL not in e.name):
            each.setdefault(e.name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    if per_call is not None:
        per_call.update({k: len(v) / reps for k, v in each.items()})
    return {k: statistics.median(v) for k, v in each.items()}


def queued_ms(fn, reps=5):
    """Device ms of fn with the host's cost of the call hidden: a spin
    kernel keeps the card busy while the events and fn are queued behind
    it, so the events time fn's device work alone (median of reps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def item_fields(name, run_k, library, tries=5, reps=10):
    """The call and its kernel apart: the device ms of the kernel's own
    item (<name>_kernel, or ITEM_KERNELS[name]) and the library call's
    items (one of each a call), from torch.profiler (device_items over
    `reps` calls), and both calls' queued_ms.  A session that saw no such
    item (the profiler drops a session's first events late in the script)
    is run again, up to `tries` sessions, for the kernel and for the
    library alike, and the row says how many each took; "not measured"
    where none saw it."""
    item = ITEM_KERNELS.get(name, f"{name}_kernel")
    for attempt in range(1, tries + 1):
        per_call = {}
        own = [ms for k, ms in device_items(run_k, reps, per_call).items()
               if item in k]
        if own:
            break
    out = {"kernel_device_ms": own[0] if own else "not measured",
           "kernel_item_sessions": attempt,
           # the call's device operations (kernels, memsets, fills)
           "kernel_items_per_call": {k[:100]: c for k, c in per_call.items()},
           "queued_ms": queued_ms(run_k)}
    if library is not None:
        for lib_attempt in range(1, tries + 1):
            lib = device_items(library, reps)
            if lib:
                break
        out["library_device_ms"] = (sum(lib.values()) if lib
                                    else "not measured")
        out["library_item_sessions"] = lib_attempt
        out["library_queued_ms"] = queued_ms(library)
    return out


def h_fields(keys, bit_lo, bit_hi):
    """Kernel H's shape on a row: m, the bit range and the kernels one
    call launches there (csrc/radix_sort.cu's own count)."""
    from femto_tpu_torch import kernels

    m = keys.shape[0]
    return {"m": m, "bits": [bit_lo, bit_hi],
            "kernels_per_call": kernels.size("radix_sort_kernels", m, bit_lo,
                                             bit_hi)}


def k18a_route(mm):
    """The route K18a's bucket_pack takes for shards of mm records
    (csrc/exchange.cu's own choice): "one_block" or "tiles"."""
    from femto_tpu_torch import kernels

    return "tiles" if kernels.size("bucket_pack_tile", mm) else "one_block"


def k18a_shape(dest, cols, kw):
    """bucket_pack's shape on a row: the shards, their records, D, cap,
    the columns, whether valid flags were given, and the route."""
    Dl, mm = dest.shape
    return {"Dl": Dl, "mm": mm, "D": kw["D"], "cap": kw["cap"],
            "ncols": len(cols), "valid_given": kw.get("valid") is not None,
            "pack_route": k18a_route(mm)}


def h_route(m, bit_lo, bit_hi):
    """The route kernel H takes for a sort of m keys (csrc/radix_sort.cu's
    own choice): "one_block", "few_key_tiles" (tiles smaller than a large
    sort's), "full_tiles", or None (m = 0: nothing launched)."""
    from femto_tpu_torch import kernels

    if kernels.size("radix_sort_kernels", m, bit_lo, bit_hi) == 0:
        return None
    tile = kernels.size("radix_sort_tile", m)
    if tile == 0:
        return "one_block"
    full = kernels.size("radix_sort_tile", 2**31 - 1)
    return "few_key_tiles" if tile < full else "full_tiles"


def h_call_sizes(sorts):
    """How a path's sorts ((m, bit_lo, bit_hi) each) fall on kernel H's
    routes (h_route), with the largest m and the calls at each bit
    width."""
    routes = {"one_block": 0, "few_key_tiles": 0, "full_tiles": 0}
    widths = {}
    for m, lo, hi in sorts:
        route = h_route(m, lo, hi)
        if route is not None:
            routes[route] += 1
            widths[hi - lo] = widths.get(hi - lo, 0) + 1
    return {"calls": sum(routes.values()), **routes,
            "largest_m": max((m for m, _, _ in sorts), default=0),
            "calls_by_bits": dict(sorted(widths.items()))}


# kernel D's routes for extract, locate and the paged step (csrc/lf_walk.cu
# femto_lf_walk_route) and K18f owner_lf's on the row tiers (csrc/
# dist_query.cu femto_owner_lf_route; the rule of csrc/fm_common.cuh), the
# route every call takes in a build of csrc/lf_walk.cu or csrc/
# dist_query.cu with the flag, and that flag: phase 3 holds both routes to
# the plain version and phase 5 times the warp route against the thread
# route (the design before it) through the same wrapper
D_ALTERNATIVES = {
    "warp": ("thread", "-DFEMTO_D_WARP_MAX=0"),
    "thread": ("warp", "-DFEMTO_D_WARP_MAX=0x7fffffff"),
}
# the all-symbol rank's routes (csrc/fm_common.cuh row_rank_min): kernel
# R's regex_fork ranks an entry's two rows for every code at once ("rows")
# or a fork's first and last by femto::occ ("codes"), K18f's
# masked_occ_rows a row a warp ("rows") or a (row, symbol) lane a thread
# ("codes", masked_occ's design); the route every call takes in a build of
# csrc/regex_frontier.cu or csrc/dist_query.cu with the flag, and that
# flag: phase 3 holds both routes to the plain versions, phases 4d and 4h
# sum each route's device ms over the query paths' calls and phase 5 times
# one route against the other in turns
R_ALTERNATIVES = {
    "rows": ("codes", "-DFEMTO_R_ROW_RANK=0"),
    "codes": ("rows", "-DFEMTO_R_ROW_RANK=1"),
}
# kernel C's routes for its four entries (csrc/fm_common.cuh c_route_smem,
# exposed as femto_backward_search_route): a warp a pattern or lane, or a
# thread a pattern or lane (the design before, with the shared segment
# row); the route every call takes in a build of csrc/backward_search.cu
# with the flag, and that flag: phase 3 holds both routes to the plain
# versions, phase 5 times the warp route against the thread route in
# turns and sums each route's device ms over the count and query paths'
# calls; chip_c_routes.py sweeps them
C_ALTERNATIVES = {
    "warp": ("thread", "-DFEMTO_C_WARP_MAX=0"),
    "thread": ("warp", "-DFEMTO_C_WARP_MAX=0x7fffffff"),
}
# kernel E's routes (csrc/psi_walk.cu psi_route_smem, exposed as
# femto_psi_walk_route): a warp a walk (the 32-way checkpoint search and
# the warp select) or a thread a walk (the design before); the route every
# call takes in a build of csrc/psi_walk.cu with the flag, and that flag:
# phase 3 holds both routes to the plain version, phase 5 times one
# against the other in turns; chip_e_routes.py sweeps them
E_ALTERNATIVES = {
    "warp": ("thread", "-DFEMTO_E_WARP_MAX=0"),
    "thread": ("warp", "-DFEMTO_E_WARP_MAX=0x7fffffff"),
}
# the builds of sources with other routes or settings (a name, or
# "source:what" where one source has two sets), each with its
# alternatives
ROUTE_BUILDS = {"radix_sort": H_ALTERNATIVES, "exchange": K18A_ALTERNATIVES,
                "lf_walk": D_ALTERNATIVES, "dist_query": D_ALTERNATIVES,
                "regex_frontier": R_ALTERNATIVES,
                "dist_query:rank": R_ALTERNATIVES,
                "backward_search": C_ALTERNATIVES,
                "psi_walk": E_ALTERNATIVES}
# The card's dependent global-load latency: one thread follows a random
# cycle through an array past L2, one load waiting for the last (phase 5's
# latency floor of the LF walks).  Built beside the sources in phase 2; a
# measuring tool, not a kernel of the port.
CHASE_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase_kernel(const unsigned* __restrict__ next,
                             long long steps, unsigned* out) {
  unsigned i = *out;  // each run goes on where the last one stopped
  for (long long t = 0; t < steps; ++t) i = __ldcg(next + i);
  *out = i;
}
extern "C" int femto_chase(const void* next, long long steps, void* out,
                           void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(next), steps, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""
CHASE_WORDS = 1 << 28      # 1 GiB of uint32: 20 times L2
CHASE_STEPS = 1 << 16


def start_route_builds(sources=None):
    """Each source of ROUTE_BUILDS (or of `sources`, a list of its keys)
    built with each flag of its alternatives, one nvcc each, started now
    (beside kernels.build) and read by route_libs: {source: {route:
    (process, library path)}}."""
    from femto_tpu_torch import kernels

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    out = {}
    for name in sources or ROUTE_BUILDS:
        alternatives = ROUTE_BUILDS[name]
        src = name.split(":")[0]
        out[name] = {}
        for route, (_, flag) in alternatives.items():
            so = os.path.join(kernels.BUILD_DIR, f"lib{src}.not_{route}.so")
            out[name][route] = (subprocess.Popen(
                [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *flag.split(),
                 "-o", so, os.path.join(kernels.CSRC, src + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    return out


# the libraries route_libs has bound, by path
_ROUTE_LIBS = {}


def route_libs(builds, name):
    """The libraries of the other-route builds `name` of ROUTE_BUILDS
    (start_route_builds' builds[name]), bound as kernels.bind binds their
    source, once each: {route: lib}."""
    from femto_tpu_torch import kernels

    src = name.split(":")[0]
    libs = {}
    for route, (proc, so) in builds.items():
        if so not in _ROUTE_LIBS:
            out, _ = proc.communicate()
            check(proc.returncode == 0,
                  f"nvcc failed for {src}.cu {ROUTE_BUILDS[name][route][1]}:"
                  f"\n{out}")
            _ROUTE_LIBS[so] = kernels.bind(so, src)
        libs[route] = _ROUTE_LIBS[so]
    return libs


def rank_forced(builds, name):
    """The builds of `name` ("regex_frontier" or "dist_query:rank") that
    force each route of the all-symbol rank: {route: lib}."""
    libs = route_libs(builds[name], name)
    return {R_ALTERNATIVES[route][0]: lib for route, lib in libs.items()}


def c_forced(builds):
    """The builds of csrc/backward_search.cu (start_route_builds'
    builds) that force each of kernel C's routes: {route: lib}."""
    libs = route_libs(builds["backward_search"], "backward_search")
    return {C_ALTERNATIVES[route][0]: lib for route, lib in libs.items()}


def e_forced(builds):
    """The builds of csrc/psi_walk.cu (start_route_builds' builds) that
    force each of kernel E's routes: {route: lib}."""
    libs = route_libs(builds["psi_walk"], "psi_walk")
    return {E_ALTERNATIVES[route][0]: lib for route, lib in libs.items()}


def e_block_bytes(arrays, B):
    """Kernel E's route for a call of B walks on an index, as csrc/
    psi_walk.cu psi_route_smem picks it: the warp route's shared memory a
    block in bytes, 0 on the thread route."""
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    return kernels.size("psi_walk_route", S.fm_view(arrays)[0], B)


def e_route(arrays, B):
    """"warp" or "thread": the route of a psi walk of B rows."""
    return "warp" if e_block_bytes(arrays, B) else "thread"


def e_search_rounds(n_seg):
    """The warp route's dependent round trips of its 32-way checkpoint
    search over n_seg segments, at most: each round keeps one of the 33
    pieces its 32 pivots cut the interval into."""
    rounds, N = 0, n_seg
    while N > 1:
        N = -(-N // 33)
        rounds += 1
    return rounds


def c_block_bytes(arrays, B, entry="backward_search"):
    """Kernel C's route for a call of `entry` of B patterns or lanes on an
    index, as csrc/fm_common.cuh c_route_smem picks it: the warp route's
    shared memory a block in bytes, 0 on the thread route."""
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    return kernels.size("backward_search_route", S.fm_view(arrays)[0], B,
                        int(entry.startswith("backward_step")))


def c_route(arrays, B, entry="backward_search"):
    """"warp" or "thread": the route of a call of kernel C's `entry`."""
    return "warp" if c_block_bytes(arrays, B, entry) else "thread"


def c_route_fields(forced, run, name, rounds=5):
    """Kernel C's two routes on one call, run() (forced: c_forced's
    builds; route_turns)."""
    return route_turns("backward_search", forced, run, name, "warp",
                       "thread", rounds)


def c_fields(forced, arrays, B, run, name, old_bound_ms):
    """Phase 5's fields of a row of kernel C (a call of B patterns or
    lanes, run(); name: the row's, "entry[layout]" first): the route it
    takes as built and its block's shared memory, both routes in turns
    (c_route_fields) and the bound of the design before the shared row
    (each end's segment read apart)."""
    entry = name.split("[")[0]
    return {"c_route": c_route(arrays, B, entry),
            "c_block_bytes": c_block_bytes(arrays, B, entry),
            "old_bound_ms": old_bound_ms,
            "c_routes": c_route_fields(forced, run, name)}


def route_turns(src, forced, run, name, first, second, rounds=5):
    """One call, run(), on two routes of csrc/<src>.cu, each forced by its
    build (forced: {route: lib}, kernels.variant around the same wrapper):
    held to each other bit for bit, timed in turns (`rounds` rounds,
    `first` first) and queued behind a spin kernel; the fields are named
    by the routes."""
    from femto_tpu_torch import kernels

    def on(route):
        def call():
            with kernels.variant(src, forced[route]):
                return run()
        return call

    a, b = on(first), on(second)
    max_abs_err(f"{name}: {first} route against {second} route",
                _flat([a()]), _flat([b()]))
    ms, other_ms, fours = in_turns(a, b, rounds)
    out = {f"{first}_ms": ms, f"{second}_ms": other_ms, "turns_ms": fours,
           f"{first}_ahead_rounds": sum(k1 + k2 < l1 + l2
                                        for k1, l1, l2, k2 in fours),
           f"{first}_queued_ms": queued_ms(a),
           f"{second}_queued_ms": queued_ms(b)}
    log(f"    {name}: {first} route {ms:.4g} ms, {second} route "
        f"{other_ms:.4g}, {first} first in {out[f'{first}_ahead_rounds']} "
        f"of {rounds}; queued {out[f'{first}_queued_ms']:.4g} / "
        f"{out[f'{second}_queued_ms']:.4g}")
    return out


def rank_route_fields(src, forced, run, name, rounds=5):
    """Phase 5's fields of a rank entry's two routes on one call, run()
    (forced: rank_forced's builds of csrc/<src>.cu; route_turns, rows
    first)."""
    return {"rank_routes": route_turns(src, forced, run, name, "rows",
                                       "codes", rounds)}


# cycles of the spin kernel queued before each call that route_sums times
# (longer than a wrapper's host part: the events then time the device work)
SUM_SPIN_CYCLES = 400_000


def route_sums(mod, entry, src, forced, runs):
    """The device ms of `entry`'s calls (mod.entry, a wrapper) summed over
    one pass of runs ({key: fn}, each returning what its answer is held
    by), as built and with each route forced (forced: {route: a build of
    csrc/<src>.cu that forces it}, rank_forced's or c_forced's), after a
    pass untimed: every call between two CUDA events queued behind a spin
    kernel, so that its host part is hidden.  Each forced pass's answers
    equal the as-built pass's.  {route: {"ms", "calls",
    "per_run_ms"}}."""
    import torch

    from femto_tpu_torch import kernels

    orig = getattr(mod, entry)
    out, answers = {}, {}
    for fn in runs.values():  # a pass untimed: the first pays the warm-up
        fn()
    for route, lib in [("as_built", None)] + sorted(forced.items()):
        events, key = [], [None]

        def timed(*a, **kw):
            torch.cuda._sleep(SUM_SPIN_CYCLES)
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            res = orig(*a, **kw)
            e.record()
            events.append((key[0], s, e))
            return res

        setattr(mod, entry, timed)
        try:
            with kernels.variant(src, lib):
                for k, fn in runs.items():
                    key[0] = k
                    got = fn()
                    if route == "as_built":
                        answers[k] = got
                    else:
                        check(got == answers[k], f"{entry} {k}: the {route} "
                                                 f"route's answer differs")
        finally:
            setattr(mod, entry, orig)
        torch.cuda.synchronize()
        per = {}
        for k, s, e in events:
            per[k] = per.get(k, 0.0) + s.elapsed_time(e)
        out[route] = {"ms": sum(per.values()), "calls": len(events),
                      "per_run_ms": per}
    log(f"    {entry}'s device ms summed over the path's calls: "
        + ", ".join(f"{r} {v['ms']:.4g} ms ({v['calls']} calls)"
                    for r, v in out.items()))
    return out


def route_pair(src, lib, run, want, name, route, other):
    """One call, run(), through csrc/<src>.cu as built and through `lib`,
    the build of it that sends the call down route `other` instead
    (kernels.variant around both, so that both pay the swap), both held
    bit for bit to `want`, then timed in turns (5 rounds, as built first)
    and queued behind a spin kernel: the row's fields."""
    from femto_tpu_torch import kernels

    def as_built():
        with kernels.variant(src, None):
            return run()

    def instead():
        with kernels.variant(src, lib):
            return run()

    max_abs_err(name, as_built(), want)
    max_abs_err(f"{name}, {other}", instead(), want)
    ms, other_ms, fours = in_turns(as_built, instead, 5)
    return {"route": route, "ms": ms, "other_route": other,
            "other_ms": other_ms, "turns_ms": fours,
            "built_ahead_rounds": sum(k1 + k2 < l1 + l2
                                      for k1, l1, l2, k2 in fours),
            "queued_ms": queued_ms(as_built),
            "other_queued_ms": queued_ms(instead)}


def log_route_row(what, row):
    log(f"    {what}: {row['route']} {row['ms']:.4g} ms, {row['other_route']} "
        f"{row['other_ms']:.4g}, first in {row['built_ahead_rounds']} of 5 "
        f"rounds; queued {row['queued_ms']:.4g} / "
        f"{row['other_queued_ms']:.4g}")


def h_route_rows(builds, sorts):
    """Kernel H's routes against each other on the paths' own sorts.
    sorts: {tag: (keys, bit_lo, bit_hi)}; builds: start_route_builds'
    builds["radix_sort"].
    Each sort by H as built and by the build that sends it down the route
    H_ALTERNATIVES names (route_pair, both through sort_ops' wrapper):
    {tag: row}."""
    from femto_tpu_torch.ops import sort_ops as SO

    libs = route_libs(builds, "radix_sort")
    rows = {}
    for tag, (keys, lo, hi) in sorts.items():
        m, route = keys.shape[0], h_route(keys.shape[0], lo, hi)
        want = SO.radix_sort_pairs_plain(keys, None, lo, hi)
        rows[tag] = {"m": m, "bits": [lo, hi], **route_pair(
            "radix_sort", libs[route],
            lambda: SO.radix_sort_pairs(keys, None, lo, hi), want,
            f"radix_sort_pairs({tag})", route, H_ALTERNATIVES[route][0])}
        del want
        log_route_row(f"H on {tag} (m={m}, bits {lo}:{hi})", rows[tag])
    return rows


@contextlib.contextmanager
def k18a_calls(got):
    """While open, every call of ops/dist_ops.bucket_pack is recorded into
    `got`: of each route (k18a_route) and power of two of the records a
    shard, the call with the most records, its arguments copied at the
    call, as {(route, bits): (mm, [dest, cols], kwargs)}, bits =
    mm.bit_length().  Timed calls run outside it."""
    from femto_tpu_torch.ops import dist_ops as DO

    fn = DO.bucket_pack

    def hook(dest, cols, **kw):
        mm = dest.shape[1]
        key = (k18a_route(mm), mm.bit_length())
        if key not in got or mm > got[key][0]:
            got[key] = (mm, _copied([dest, list(cols)]), _copied(kw))
        return fn(dest, cols, **kw)

    DO.bucket_pack = hook
    try:
        yield got
    finally:
        DO.bucket_pack = fn


def k18a_route_rows(builds, calls):
    """K18a bucket_pack's routes against each other on a path's own calls
    (k18a_calls' record): each call through the source as built and
    through the build that sends it down the other route
    (K18A_ALTERNATIVES; route_pair, both through dist_ops' wrapper).
    builds: start_route_builds' builds["exchange"].  {tag: row}."""
    from femto_tpu_torch.ops import dist_ops as DO

    libs = route_libs(builds, "exchange")
    rows = {}
    for (route, bits), (mm, (dest, cols), kw) in sorted(calls.items()):
        tag = f"{route}, largest below 2^{bits}"
        want = _flat(DO.bucket_pack_plain(dest, cols, **kw))
        rows[tag] = {**k18a_shape(dest, cols, kw), **route_pair(
            "exchange", libs[route],
            lambda: _flat(DO.bucket_pack(dest, cols, **kw)), want,
            f"bucket_pack({tag})", route, K18A_ALTERNATIVES[route][0])}
        del want
        log_route_row(f"bucket_pack on {tag} (Dl {dest.shape[0]}, mm {mm}, "
                      f"D {kw['D']}, cap {kw['cap']}, {len(cols)} columns)",
                      rows[tag])
    return rows


def start_chase_build():
    """CHASE_SRC compiled into the build directory: (process, library)."""
    from femto_tpu_torch import kernels

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cu = os.path.join(kernels.BUILD_DIR, "chase.cu")
    with open(cu, "w") as f:
        f.write(CHASE_SRC)
    so = os.path.join(kernels.BUILD_DIR, "libchase.so")
    return (subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                              so, cu], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), so)


# dependent_load_ns' reading, by the probe's library: measured once a run
# (phases 4f and 5 read it)
_LATENCY_NS = {}


def dependent_load_ns(build):
    """The card's dependent global-load latency in ns: CHASE_STEPS loads
    along one random cycle through CHASE_WORDS words (a warm-up run
    first; median of 3), each waiting for the one before; each run goes
    on along the cycle from where the last one stopped, so that no run
    finds the last one's words in L2.  Measured at the first call."""
    import ctypes

    import torch

    proc, so = build
    if so in _LATENCY_NS:
        return _LATENCY_NS[so]
    out, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc failed for the latency probe:\n{out}")
    lib = ctypes.CDLL(so)
    fn = lib.femto_chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    perm = torch.randperm(CHASE_WORDS, device="cuda", generator=g)
    nxt = torch.empty(CHASE_WORDS, dtype=torch.int64, device="cuda")
    nxt[perm] = torch.roll(perm, -1)
    nxt = nxt.to(torch.int32)
    del perm
    res = torch.zeros(1, dtype=torch.int32, device="cuda")

    def run():
        rc = fn(nxt.data_ptr(), CHASE_STEPS, res.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the latency probe failed: cudaError_t {rc}")

    ms = cuda_ms(run)
    del nxt
    _LATENCY_NS[so] = ms * 1e6 / CHASE_STEPS
    return _LATENCY_NS[so]


def d_block_bytes(arrays, B, entry="lf_extract"):
    """The dynamic shared memory of a block on the warp route that kernel
    D's `entry` (lf_extract, lf_locate or lf_walk_step) takes for B walks
    on an index, 0 where the call takes the thread route (csrc/
    lf_walk.cu's own choice, femto_lf_walk_route)."""
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    view, _ = S.fm_view(arrays)
    return kernels.size("lf_walk_route", view, B, int(entry == "lf_extract"))


def d_route(arrays, B, entry="lf_extract"):
    """The route of kernel D's `entry` for B walks on an index: "warp" or
    "thread"."""
    return "warp" if d_block_bytes(arrays, B, entry) else "thread"


def d_crossover(arrays, entry="lf_extract"):
    """The largest B that takes the warp route on an index (0: none;
    None: every B up to 2^24 does)."""
    lo, hi = 0, 1 << 24
    if d_route(arrays, hi, entry) == "warp":
        return None
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if d_route(arrays, mid, entry) == "warp":
            lo = mid
        else:
            hi = mid - 1
    return lo


def d_both_routes(libs, run, want, name):
    """A call of kernel D, run(), through each route (the builds of
    D_ALTERNATIVES, kernels.variant around the same wrapper), held bit
    for bit to `want`."""
    from femto_tpu_torch import kernels

    for route, lib in libs.items():
        # libs[route] sends every call down the other route
        with kernels.variant("lf_walk", lib):
            got = run()
        max_abs_err(f"{name}, {D_ALTERNATIVES[route][0]} route", got, want)


def segment_kind_rows(A, n, seg, rng, k=256):
    """Up to k in-text rows of a row-tier index's side segments (vseg and
    vrle) and of its continued run-length segments (vrle): {kind: rows}."""
    import torch

    woff = A.seg_woff.cpu().numpy()
    sets = {}
    for kind, segs in (("side", np.nonzero(woff > 0)[0]),
                       ("continued", np.nonzero(woff < -1)[0])):
        if len(segs):
            pick = segs[rng.integers(0, len(segs), k)]
            r = pick * seg + rng.integers(0, seg, k)
            sets[kind] = torch.from_numpy(r[r < n].astype(np.int32))
    return sets


def parity_extract_routes(indexes, libs, rng, errs):
    """Phase 3's hold of kernel D's extract on both routes: on every
    layout (the 8 MiB corpus's full, compact, packed, packed31, vseg,
    vrle and the prose's vseg and vrle), walks of B = 1, of 5, of the
    crossover B and one more (where the warp route's limit lies past
    2^17 walks, of 2^17 walks), from rows that reach the last segment's pad
    rows (rows past n stay put and emit their pad code), from the side
    segments (vseg) and from continued run-length segments (vrle), each
    route and the wrapper as built against the plain version."""
    import torch

    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.ops import search_ops as S

    rec = {}
    for name, ix in indexes.items():
        A = ix.arrays
        n, seg = ix.meta.n, ix.meta.seg
        dev = A.bwt.device
        cross = d_crossover(A)
        top = R.n_segments(A) * seg
        sets = {
            "B1": torch.tensor([n - 1], dtype=torch.int32),
            "B5": torch.from_numpy(rng.integers(0, n, 5).astype(np.int32)),
            # the last segment's rows up to its end: the pad rows past n
            "pad": torch.arange(max(0, (n - 1) // seg * seg), top,
                                dtype=torch.int32)[-64:],
        }
        for tag, size in ((("crossover", cross),
                           ("crossover_plus_1", cross + 1))
                          if cross is not None and cross <= 1 << 17
                          else (("large", 1 << 17),)):
            sets[tag] = torch.from_numpy(
                rng.integers(0, n, size).astype(np.int32))
        if R.is_row_tier(A):
            sets.update(segment_kind_rows(A, n, seg, rng))
        for tag, rows in sets.items():
            rows = rows.to(dev).contiguous()
            steps = 8 if rows.shape[0] > 4096 else 200
            want = S.extract_backward_plain(A, rows, steps)
            got = S.extract_backward(A, rows, steps)
            key = f"lf_extract[{name}]({tag}, B={rows.shape[0]})"
            errs[key] = max_abs_err(key, got, want)
            d_both_routes(libs, lambda: S.extract_backward(A, rows, steps),
                          want, key)
            del want, got
        rec[name] = {"crossover_B": cross,
                     "sets": {k: {"B": int(v.shape[0]),
                                  "route": d_route(A, int(v.shape[0]))}
                              for k, v in sets.items()}}
    log(f"    D extract: both routes equal the plain version on every "
        f"layout: {rec}")
    return rec


def parity_locate_routes(indexes, libs, rng, errs):
    """Phase 3's hold of kernel D's locate on both routes on the row tiers
    (indexes: {name: (index, the suffix array of its text)}): walks of B
    = 1, 5, 65,536 and 2^17 rows, every in-text row of the last segment,
    rows in side segments and in continued run-length segments, each at
    the build's mark_period (offsets held to the suffix array too) and at
    3 or, on a period-3 build, 1, where some walks reach no mark; each
    route and the wrapper as built against the plain version, bit for
    bit, with the route each call took and its block's shared memory."""
    import torch

    from femto_tpu_torch.ops import search_ops as S

    rec = {}
    for name, (ix, sa) in indexes.items():
        A = ix.arrays
        n, seg, mp = ix.meta.n, ix.meta.seg, ix.meta.mark_period
        dev = A.bwt.device
        sets = {
            "B1": torch.tensor([n - 1], dtype=torch.int32),
            "B5": torch.from_numpy(rng.integers(0, n, 5).astype(np.int32)),
            "B65536": torch.from_numpy(
                rng.integers(0, n, 65536).astype(np.int32)),
            "B131072": torch.from_numpy(
                rng.integers(0, n, 1 << 17).astype(np.int32)),
            "last_segment": torch.arange((n - 1) // seg * seg, n,
                                         dtype=torch.int32),
            **segment_kind_rows(A, n, seg, rng),
        }
        rec[name] = {"mark_period": mp, "sets": {}}
        for tag, rows in sets.items():
            rows = rows.to(dev).contiguous()
            B = rows.shape[0]
            for period in (mp, 3 if mp > 3 else 1):
                if B > 65536 and period != mp:
                    continue
                want = S.locate_rows_plain(A, period, rows)
                got = S.locate_rows(A, period, rows)
                key = f"lf_locate[{name}]({tag}, B={B}, period {period})"
                errs[key] = max_abs_err(key, [got], [want])
                d_both_routes(libs, lambda: [S.locate_rows(A, period, rows)],
                              [want], key)
                if period == mp:
                    check(torch.equal(want, sa[rows.long()]),
                          f"{key}: offsets != the suffix array")
                elif B >= 64:
                    check(bool((want < 0).any()),
                          f"{key}: every walk reached a mark")
                del want, got
            rec[name]["sets"][tag] = {
                "B": B, "route": d_route(A, B, "lf_locate"),
                "block_bytes": d_block_bytes(A, B, "lf_locate")}
    log(f"    D locate: both routes equal the plain version on the row "
        f"tiers: {rec}")
    return rec


def parity_gather_edges(rng, errs):
    """Phase 3's hold of kernel L at edge shapes: gather_rows and
    gather_cols of 1, 3 and 8 columns, int32 and int64, idx views that
    start 0, 4 and 12 bytes past a 16-B boundary (and outputs 4 or 8
    bytes past one), -1 and out-of-range indices, at 0, 1, 65,536 and
    2^26 rows (2^26: 1 and 8 columns), against the plain versions."""
    import torch

    from femto_tpu_torch.ops import sort_ops as SO

    dev = torch.device("cuda")
    n = 1 << 20
    held = 0
    for dtype in (torch.int32, torch.int64):
        for m in (0, 1, 65536, 1 << 26):
            for ncols in ((1, 8) if m == 1 << 26 else (1, 3, 8)):
                for off in ((0, 3) if m == 1 << 26 else (0, 1, 3)):
                    srcs = [torch.randint(-2**31, 2**31 - 1, (n,),
                                          dtype=torch.int64,
                                          device=dev).to(dtype)
                            for _ in range(ncols)]
                    big = torch.randint(-3, n + 3, (m + 3,),
                                        dtype=torch.int32, device=dev)
                    idx = big[off: off + m]
                    outs = torch.empty((ncols, m + 1), dtype=dtype,
                                       device=dev)[:, 1:]
                    got = SO.gather_cols(srcs, idx, list(outs.unbind(0)))
                    want = [SO.gather_rows_plain(c, idx) for c in srcs]
                    tag = (f"gather_cols({dtype}, m={m}, ncols={ncols}, "
                           f"idx +{4 * off} B)")
                    errs[tag] = max_abs_err(tag, got, want)
                    tag = f"gather_rows({dtype}, m={m}, idx +{4 * off} B)"
                    errs[tag] = max_abs_err(
                        tag, [SO.gather_rows(srcs[0], idx)], want[:1])
                    held += 1
                    del srcs, big, outs, got, want
    log(f"    L: gather_rows and gather_cols equal their plain versions at "
        f"{held} edge shapes")


def _host_us(fn, reps=2000):
    """Host us a call of fn (perf_counter over reps calls after 50)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def l_host_parts(src, idx):
    """Host us of each part of one gather_rows call at these inputs (the
    direct tier's): the wrapper's checks, on_card and the output's
    allocation; in kernels.launch the name check, the cached bound
    function and the raw stream handle; the ctypes call itself; the whole
    launch, the whole call and index_select's."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import sort_ops as SO

    m = idx.shape[0]
    out = torch.empty(m, dtype=src.dtype, device=src.device)
    lib = kernels._lib("sa_payload")
    fn = lib.femto_gather_rows
    stream = torch.cuda.current_stream().cuda_stream
    raw = lambda: torch._C._cuda_getCurrentRawStream(  # noqa: E731
        torch._C._cuda_getDevice())
    args = (src.data_ptr(), src.shape[0], src.element_size(), idx.data_ptr(),
            m, out.data_ptr())

    parts = {
        "checks": lambda: (src.dtype in SO._GATHER_DTYPES,
                           kernels.check(src, "src", src.dtype, 1),
                           kernels.check(idx, "idx", torch.int32, 1)),
        "on_card": lambda: kernels.on_card(src, idx),
        "output_new_empty": lambda: src.new_empty(m),
        "data_ptrs_and_sizes": lambda: (src.data_ptr(), src.shape[0],
                                        src.element_size(), idx.data_ptr(),
                                        idx.shape[0], out.data_ptr()),
        "name_check": lambda: "gather_rows" in kernels.launches,
        "cached_fn": lambda: kernels._fns.get("gather_rows"),
        "stream_raw": raw,
        "ctypes_call": lambda: fn(*args, stream),
        "launch": lambda: kernels.launch("gather_rows", *args),
        "whole_call": lambda: SO.gather_rows(src, idx),
        "index_select_call": lambda: torch.index_select(src, 0, idx),
    }
    got = {k: _host_us(f) for k, f in parts.items()}
    check(raw() == stream, "the raw stream handle is not the current "
                           "stream's")
    log(f"    L host us by part (direct tier, {m} rows): {got}")
    return got


def d_fields(libs, entry, arrays, B, steps, run, lat_ns):
    """Kernel D's `entry` (lf_extract, lf_locate or lf_walk_step) on each
    route, each forced by its build (D_ALTERNATIVES, kernels.variant
    around the same wrapper): the warp route against the thread route
    (the design before it), D_TURN_ROUNDS rounds in turns, both routes'
    queued_ms, the own device item of the route the source picks
    (d_route), and the walk's latency floor: steps (the longest walk's
    dependent steps) times the card's dependent-load latency, with the
    share of it the warp route reached."""
    from femto_tpu_torch import kernels

    def warp():
        with kernels.variant("lf_walk", libs["thread"]):
            return run()

    def thread():
        with kernels.variant("lf_walk", libs["warp"]):
            return run()

    max_abs_err(f"{entry}: the warp route against the thread route",
                warp(), thread())
    ms, t_ms, fours = in_turns(warp, thread, D_TURN_ROUNDS)
    items = {}
    for _ in range(5):
        items = {k: v for k, v in device_items(run, 3).items()
                 if entry in k}
        if items:
            break
    floor = steps * lat_ns / 1e6
    return {"d_route": d_route(arrays, B, entry),
            "block_bytes": d_block_bytes(arrays, B, entry), "B": B,
            "steps": steps, "warp_route_ms": ms, "thread_route_ms": t_ms,
            "turns_ms": fours,
            "warp_ahead_rounds": sum(k1 + k2 < l1 + l2
                                     for k1, l1, l2, k2 in fours),
            "warp_queued_ms": queued_ms(warp),
            "thread_queued_ms": queued_ms(thread),
            "kernel_device_ms": (sum(items.values()) if items
                                 else "not measured"),
            "kernel_items": {k[:80]: v for k, v in items.items()},
            "latency_floor_ms": floor, "latency_floor_share": floor / ms}


def e_fields(forced, arrays, B, steps, run, name, lat_ns):
    """Phase 5's fields of a row of kernel E (a walk of B rows and `steps`
    steps, run()): the route the source picks (e_route) and its block's
    shared memory, both routes in turns (route_turns, each forced by its
    build, warp first), each route's dependent DRAM round trips a step
    (the warp route's 32-way search rounds over n_seg and its row fetch;
    the thread route's bisect of n_seg and its row scan; a side or
    continued segment's second fetch is not counted) and the latency floor
    of the route the source picks (steps x its round trips a step x the
    card's dependent-load latency), with the share of it reached; and,
    with PARENT, the parent's build in turns (parent_fields)."""
    from femto_tpu_torch.ops import rank as R

    n_seg = R.n_segments(arrays)
    trips = {"warp": e_search_rounds(n_seg) + 1,
             "thread": max(n_seg - 1, 1).bit_length() + 1}
    route = e_route(arrays, B)
    routes = route_turns("psi_walk", forced, run, name, "warp", "thread")
    floor = steps * trips[route] * lat_ns / 1e6
    return {"e_route": route, "e_block_bytes": e_block_bytes(arrays, B),
            "B": B, "steps": steps, "n_seg": n_seg, "e_routes": routes,
            "round_trips_a_step": trips, "latency_floor_ms": floor,
            "latency_floor_share": floor / routes[f"{route}_ms"],
            **parent_fields(name, "psi_walk", run)}


def locate_checks(arrays, mark_period, rows):
    """The most mark checks a locate walk of these rows makes (each a
    dependent step): the lockstep walk's rounds until every walk is done
    or mark_period + 1 checks are made."""
    import torch

    from femto_tpu_torch.ops import rank as R

    done = torch.zeros_like(rows, dtype=torch.bool)
    r = rows
    for i in range(mark_period + 1):
        nxt, bit, _ = R.lf_grank_step(arrays, r)
        done = done | bit
        if bool(done.all()):
            return i + 1
        r = torch.where(done, r, nxt)
    return mark_period + 1


def d_route_probe(libs, indexes, rng, sizes, steps_list=(32,),
                  entry="lf_extract"):
    """Kernel D's two routes (each forced by its build) on each layout's
    index at the batch sizes sizes(layout, arrays): {layout: {steps: {B:
    {route, warp_ms, thread_ms, warp_queued_ms, thread_queued_ms}}}},
    both routes held to each other; `route` is the one the source picks.
    entry "lf_extract": walks of `steps` steps; "lf_locate": locate at
    mark_period `steps`; "lf_walk_step": the first step of a paged walk
    (`steps` unused) on the index as given."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    out = {}
    for lay, A, n in indexes:
        out[lay] = {}
        for steps in steps_list:
            out[lay][steps] = {}
            for B in sizes(lay, A):
                rows = torch.from_numpy(
                    rng.integers(0, n, B).astype(np.int32)).to(A.bwt.device)

                zero = torch.zeros_like(rows)
                done = torch.zeros(B, dtype=torch.bool, device=rows.device)

                def call():
                    if entry == "lf_locate":
                        return [S.locate_rows(A, steps, rows)]
                    if entry == "lf_walk_step":
                        return S.lf_walk_step(A, rows, zero, zero, done, 0)
                    return S.extract_backward(A, rows, steps)

                def warp():
                    with kernels.variant("lf_walk", libs["thread"]):
                        return call()

                def thread():
                    with kernels.variant("lf_walk", libs["warp"]):
                        return call()

                max_abs_err(f"{entry}[{lay}] routes, B={B}", warp(),
                            thread())
                out[lay][steps][B] = {
                    "route": d_route(A, B, entry),
                    "warp_ms": cuda_ms(warp), "thread_ms": cuda_ms(thread),
                    "warp_queued_ms": queued_ms(warp),
                    "thread_queued_ms": queued_ms(thread)}
                del rows, zero, done
            log(f"    D {entry} routes on {lay}, {steps} (queued, warp / "
                f"thread): " + ", ".join(
                    f"B={B}: {v['warp_queued_ms']:.4g} / "
                    f"{v['thread_queued_ms']:.4g}"
                    for B, v in out[lay][steps].items()))
    return out


@contextlib.contextmanager
def l_call_sizes(got):
    """While open, kernel L's launches through the module attributes
    ops/sort_ops.gather_rows and gather_cols are counted into `got` by
    (entry, m, columns, bytes an element)."""
    from femto_tpu_torch.ops import sort_ops as SO

    rows_fn, cols_fn = SO.gather_rows, SO.gather_cols

    def rows_hook(src, idx):
        if idx.shape[0]:
            key = ("gather_rows", idx.shape[0], 1, src.element_size())
            got[key] = got.get(key, 0) + 1
        return rows_fn(src, idx)

    def cols_hook(srcs, idx, outs=None):
        for k in range(0, len(srcs) if idx.shape[0] else 0,
                       SO.MAX_GATHER_COLS):
            key = ("gather_cols", idx.shape[0],
                   len(srcs[k:k + SO.MAX_GATHER_COLS]),
                   srcs[0].element_size())
            got[key] = got.get(key, 0) + 1
        return cols_fn(srcs, idx, outs)

    SO.gather_rows, SO.gather_cols = rows_hook, cols_hook
    try:
        yield got
    finally:
        SO.gather_rows, SO.gather_cols = rows_fn, cols_fn


def per_column_fields(a, run_k):
    """gather_cols at a captured call (srcs, idx, outs) against the form
    before it, one gather_rows a column and a copy into each output, in
    5 rounds in turns (as timed_row's more)."""
    from femto_tpu_torch.ops import sort_ops as SO

    srcs, idx = a[0], a[1]
    outs = [o.clone() for o in a[2]]

    def per_column():
        for c, o in zip(srcs, outs):
            o.copy_(SO.gather_rows(c, idx))
        return outs

    max_abs_err("gather_cols against one gather_rows a column", run_k(),
                _flat([per_column()]))
    ms, pc_ms, fours = in_turns(run_k, per_column, 5)
    return {"ncols": len(srcs), "m": idx.shape[0],
            "turns_gather_cols_ms": ms, "per_column_ms": pc_ms,
            "per_column_turns_ms": fours,
            "ahead_of_per_column_rounds": sum(k1 + k2 < l1 + l2
                                              for k1, l1, l2, k2 in fours),
            "per_column_queued_ms": queued_ms(per_column)}


def wall_runs(fn, reps=3):
    """[seconds] of reps runs of fn, each ending in a device sync."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def summary(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "runs": len(xs)}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def text_tensor(prepared, dev):
    import torch

    return torch.from_numpy(prepared.text.view(np.int16)).to(dev).to(
        torch.int32)


def text_patterns(text, rng, B, P, min_len=1):
    """int32[B, P] patterns drawn from the text's codes (a tensor on the
    card): lengths min_len to P, right-aligned, -1 on the left."""
    import torch

    n = text.shape[0]
    pos = torch.from_numpy(rng.integers(0, n - P, B)).to(text.device)
    lens = torch.from_numpy(rng.integers(min_len, P + 1, B)).to(text.device)
    pats = text[pos[:, None] + torch.arange(P, device=text.device)]
    pad = torch.arange(P, device=text.device)[None, :] < (P - lens)[:, None]
    return torch.where(pad, -1, pats).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# bounds: bytes each function must move for this run's data, over HBM rate
# ---------------------------------------------------------------------------


def bound_occ_build(n, n_seg, seg):
    return (8 * n + 2 * n_seg * seg + 4 * n + 4 * 261 * n_seg
            + 4 * 262) / HBM_BYTES_PER_S * 1e3


def bound_occ_build_compact(n, n_seg, seg, K, grp):
    """pull and the symbol map in; bwt, a_row, the uint16 checkpoints, the
    L1 rows and C out."""
    return (8 * n + 4 * 261 + 2 * n_seg * seg + 4 * n + 2 * K * n_seg
            + 4 * K * (n_seg // grp) + 4 * (K + 1)) / HBM_BYTES_PER_S * 1e3


def bound_pack_build(n_seg, seg, W):
    return (2 * n_seg * seg + 4 * 261 + 4 * n_seg * W) / HBM_BYTES_PER_S * 1e3


def bound_marks_build(n, n_seg, seg, n_marks, mark_vals_len, ndocs):
    return (4 * n + 4 * n_marks + n_seg * seg // 8 + 4 * n_seg
            + 4 * mark_vals_len + 4 * ndocs) / HBM_BYTES_PER_S * 1e3


def _row_prefix_bytes(arrays):
    """Bytes of the code-area words a row-tier function must read to count
    the first off rows of segments s (a tensor function of s and off): the
    fixed-width or side words up to off, or the slot words up to the
    first slot that starts at or past off, and one symbol-list word."""
    import torch

    from femto_tpu_torch.ops import rank as R

    def prefix(s, off):
        ctx = R.RowCtx(arrays, s)
        g = ctx.g
        off = off.long()
        per_main, per_side = 32 // g.w_main, 32 // g.w_side
        words = torch.where(ctx.is_side, (off + per_side - 1) // per_side,
                            (off + per_main - 1) // per_main)
        if ctx.sv is not None:
            w_slot, _ = R.vrle_slot_geom(
                arrays.seg_nsym.view(torch.uint8)[s.long()])
            k = (ctx.sv[2] < off[:, None]).sum(dim=1)
            words = torch.where(ctx.mode_rle, (k * w_slot + 31) // 32, words)
        return 4 * words + 4
    return prefix


def _layout_bytes(arrays):
    """(bytes of one code read, of one checkpoint, of a row prefix of off
    rows of segments s as a tensor function of (s, off), of the symbol map
    per use) of an index's layout."""
    from femto_tpu_torch.ops import rank as R

    lay = R.layout(arrays)
    ckpt = 4 if lay == "full" else 6          # int32 | uint16 + L1 int32
    remap = 4 if R.is_remapped(arrays) else 0
    if R.is_row_tier(arrays):
        # the code word, the relative word + the L1 int, the prefix
        return 4, 8, _row_prefix_bytes(arrays), remap
    if lay == "packed":
        per_word, _ = R.pack_geometry(arrays)
        return 4, ckpt, \
            lambda s, off: 4 * ((off + per_word - 1) // per_word), remap
    return 2, ckpt, lambda s, off: 2 * off, remap


def _step_bytes(arrays, c, first, last, active, shared=True):
    """Bytes one FM step moves on the lanes where `active`: the symbol
    map (c in the alphabet), C[c] (c present) and, for first and last
    inside the segments, one checkpoint and the counted prefix -- where
    `shared` and both lie in one segment, one checkpoint and the prefix up
    to the larger offset for both (the least a step must read; without
    `shared`, each end's own, as kernel C's design before the shared row
    read them)."""
    import torch

    from femto_tpu_torch.ops import rank as R

    seg = R.seg_size(arrays)
    n_seg = R.n_segments(arrays)
    _, ckpt, prefix, remap = _layout_bytes(arrays)
    total = remap * int((active & (c < 261)).sum())
    valid = active & (R.map_char(arrays, c) >= 0)
    total += 4 * int(valid.sum())
    end = n_seg * seg
    one = torch.zeros_like(valid)
    if shared:
        one = (valid & (first < end) & (last < end)
               & (first.long() // seg == last.long() // seg))
        hi = torch.maximum(first, last).long()
        total += int((one * (ckpt + prefix(hi // seg, hi % seg))).sum())
    for r in (first, last):
        inside = valid & (r < end) & ~one
        rs = torch.clamp(r.long(), max=end - 1)
        total += int((inside * (ckpt + prefix(rs // seg, r.long() % seg))
                      ).sum())
    return total


def bound_backward_search(arrays, pats, n_rows, row0, steps=False,
                          shared=True):
    """Patterns + outputs + per valid step the symbol map, C[c] and, for
    first and last, one checkpoint and the bytes of segment prefix
    counted (steps: backward_search_steps, whose lanes stop once their
    range is empty, with three more outputs); a segment that holds both
    ends read once where `shared` (_step_bytes)."""
    import torch

    from femto_tpu_torch.ops import rank as R

    B, P = pats.shape
    first = torch.full((B,), row0, dtype=torch.int32, device=pats.device)
    last = torch.full((B,), n_rows, dtype=torch.int32, device=pats.device)
    total = 4 * B * P + (20 if steps else 8) * B
    for j in range(P - 1, -1, -1):
        col = pats[:, j]
        active = col >= 0
        if steps:
            active = active & (last > first)
        total += _step_bytes(arrays, col, first, last, active, shared)
        nf, nl = R.backward_step_pair(arrays, col, first, last)
        first = torch.where(active, nf, first)
        last = torch.where(active, nl, last)
    return total / HBM_BYTES_PER_S * 1e3


def bound_locate(arrays, mark_period, rows):
    """Rows in, offsets out; per step the mark word, and on a miss the
    code, C[c], a checkpoint and the counted prefix; on a hit the
    segment's earlier mark words, mark_ckpt and two mark_vals words."""
    import torch

    from femto_tpu_torch.ops import rank as R

    seg = R.seg_size(arrays)
    code, ckpt, prefix, _ = _layout_bytes(arrays)
    total = 8 * rows.shape[0]
    done = torch.zeros_like(rows, dtype=torch.bool)
    r = rows
    for _ in range(mark_period + 1):
        if bool(done.all()):
            break
        nxt, bit, _ = R.lf_grank_step(arrays, r)
        act = ~done
        off = (r % seg).long()
        hit = bit & act
        miss = act & ~bit
        total += 4 * int(act.sum())
        total += int((hit * (4 * (off // 32) + 12)).sum())
        total += int((miss * (code + 4 + ckpt + prefix(r.long() // seg, off))
                      ).sum())
        done = done | hit
        r = torch.where(done, r, nxt)
    return total / HBM_BYTES_PER_S * 1e3


def bound_extract(arrays, isa, seof_pos, dlen):
    """The rows an extract of one doc visits are isa[seof - t]; per step a
    code, C[c], a checkpoint, the counted prefix, the symbol map and the
    output int."""
    import torch

    from femto_tpu_torch.ops import rank as R

    seg = R.seg_size(arrays)
    code, ckpt, prefix, remap = _layout_bytes(arrays)
    pos = seof_pos - torch.arange(dlen, device=isa.device)
    rows = isa[pos]
    total = 8 + int((code + 4 + ckpt + remap + 4
                     + prefix(rows // seg, rows % seg)).sum())
    return total / HBM_BYTES_PER_S * 1e3


def bound_psi(arrays, rows, num_steps):
    """Rows in and C once; per step one checkpoint (the hit segment's
    base), the row prefix up to the hit, the symbol map and the output
    int, counted over this run's walk (ops/rank.psi_step)."""
    from femto_tpu_torch.ops import rank as R

    seg = R.seg_size(arrays)
    K = R.alpha_count(arrays)
    _, ckpt, prefix, remap = _layout_bytes(arrays)
    per_step = ckpt + remap + 4
    total = 4 * rows.shape[0] + 4 * (K + 1)
    r = rows
    for _ in range(num_steps):
        r, _ = R.psi_step(arrays, r)
        total += per_step * r.shape[0] + int(
            prefix(r.long() // seg, r.long() % seg + 1).sum())
    return total / HBM_BYTES_PER_S * 1e3


SECTOR = 32  # bytes of one DRAM sector: a random gathered row's traffic


def gather_bytes(srcs, idx):
    """Bytes kernel L must move for one call: idx read once, every
    distinct row it gathers read once in each column, and each output
    written once (this run's data: a permutation reads all of src).
    With them the bytes of one 32-byte sector a gathered row (what a
    random gather costs the card), as the row's sector_bound_ms."""
    import torch

    m, e = idx.numel(), srcs[0].element_size()
    ok = (idx >= 0) & (idx < srcs[0].numel())
    distinct = int(torch.unique(idx[ok]).numel())
    return (4 * m + len(srcs) * (distinct + m) * e,
            4 * m + len(srcs) * (SECTOR + e) * m)


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound_sort_kernels(n, ndocs, m):
    """Bytes each suffix-sort function must move, whatever its design, at
    text length n with m tied slots: each element it reads and each it
    writes once, at the element's own size (a sort once, not once a pass);
    gather_rows: sa is a permutation, so every payload word is read once
    (gather_bytes counts other calls)."""
    return {
        "sym_hist": 4 * n + 4 * 513,
        "sa_keys": 4 * n + 4 * 512 + 8 * n,
        "radix_sort_pairs": 24 * n,             # key and value, in and out
        "group_flags": 8 * n + n,
        "tied_compact": n + 8 * m,              # flags in; slots, bases out
        # sa in, n ranks out, then the m tied slots' bases over them
        "rank_init": 4 * n + 4 * n + 8 * m + 4 * m,
        # per slot: slot, base, sa and one key word in, pos and key out
        "round_keys[extension]": (4 + 4 + 4 + 8 + 12) * m,
        # per slot: slot, sa and two ranks in, pos and key out
        "round_keys[doubling]": (4 + 4 + 8 + 12) * m,
        # per slot: slot, sorted pos and new base in, sa and rank out
        "round_commit": 12 * m + 8 * m,
        "sa_payload": 4 * n + 4 * (ndocs + 1) + 8 * n,
        "gather_rows": 4 * n + 8 * n + 8 * n,
    }


def index_bytes(arrays):
    """Bytes of an index's device arrays (FMArrays fields, no sa_direct)."""
    return sum(t.numel() * t.element_size() for t in arrays if t is not None)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_toolchain(record):
    import torch

    from femto_tpu_torch import kernels

    card = card_line()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    check(nvcc.returncode == 0, "nvcc --version failed")
    try:
        import triton  # noqa: F401  (recorded, never used by the port)
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    record["toolchain"] = {
        "card": card, "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "triton": triton_v, "python": sys.version.split()[0],
        "device_count": torch.cuda.device_count(),
    }
    log(f"[1] card: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {record['toolchain']['nvcc']}; "
        f"triton {triton_v}")


def phase_build(record):
    """Every source at once (kernels.build), and the other-route builds of
    ROUTE_BUILDS (H, K18a, D, the all-symbol rank, C, E) and the latency
    probe beside them:
    returns start_route_builds' with the latency probe's build under
    "chase"."""
    from femto_tpu_torch import kernels

    t0 = time.perf_counter()
    routes = start_route_builds()
    routes["chase"] = start_chase_build()
    per = kernels.build()
    total = time.perf_counter() - t0
    record["build_seconds"] = {"total": total, **per}
    ptxas = {src: [ln.strip() for ln in log_.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, log_ in kernels.build_logs.items()}
    record["ptxas"] = ptxas
    log(f"[2] built {sorted(per)} in {total:.2f}s (parallel nvcc)")
    for src, lines in ptxas.items():
        for ln in lines:
            log(f"    {src}: {ln}")
    # kernel C's kernels keep every value in registers: an indexed register
    # array would show as a stack frame (local memory)
    if "backward_search" in kernels.build_logs:
        local = [int(v) for v in re.findall(
            r"(\d+) bytes (?:stack frame|lmem|spill stores|spill loads)",
            kernels.build_logs["backward_search"])]
        check(local and max(local) == 0,
              f"kernel C's kernels use local memory: {local}")
        record["c_local_bytes"] = {"max": max(local), "records": len(local)}
        log(f"    backward_search: 0 bytes of local memory in {len(local)} "
            f"ptxas records")
    # mesh_scan's and compact_rows' tile kernels and mesh_flags' six too
    # (compact_rows' column loop is unrolled over its 8 columns, mesh_flags'
    # over its key count: a column indexed by a variable would copy the
    # parameter block to local memory), and kernel E's ten (its warp
    # route's registers hold C and a row's words, indexed by constants)
    for src, kinds, count in (
            ("dist_rounds", ("mesh_scan_tile", "compact_rows_tile",
                             "mesh_flags_kernel"), 9),
            ("psi_walk", ("psi_walk_kernel", "psi_walk_warp_kernel"), 10)):
        if src in kernels.build_logs:
            local = kernel_local_bytes(kernels.build_logs[src], kinds)
            check(len(local) == count and max(local.values()) == 0,
                  f"{src}'s kernels {kinds} use local memory, or ptxas "
                  f"reported fewer than their {count}: {local}")
            record[f"{src}_local_bytes"] = local
            log(f"    {src}: 0 bytes of local memory in {len(local)} "
                f"kernels ({', '.join(kinds)})")
    return routes


def sort_round(SO, sa, slots, base, shift, key_bits, rank=None, h=0,
               key0=None, w=0, drop=0):
    """One round of the suffix sort over the tied slots from a copy of the
    state (doubling with ``rank``, else extension from ``key0``), through
    whichever of kernel and plain version the tensors' device selects:
    [pos, key, sorted key, sorted pos, next slots, next bases, sa after,
    rank after (doubling)]."""
    sa = sa.clone()
    if rank is not None:
        rank = rank.clone()
        pos, key = SO.round_keys(sa, slots, shift=shift, rank=rank, h=h)
    else:
        pos, key = SO.round_keys(sa, slots, shift=shift, base=base,
                                 key0=key0, w=w, drop=drop)
    skey, spos = SO.radix_sort_pairs(key, pos, 0, key_bits)
    s2, b2, _, base_all = SO.tied_compact(SO.group_flags(skey), slots,
                                          want_all=rank is not None)
    SO.round_commit(sa, rank, slots, spos, base_all, skey=skey, shift=shift,
                    base=base)
    out = [pos, key, skey, spos, s2, b2, sa]
    return out + [rank] if rank is not None else out


def parity_sort_kernels(rng, docs, prepared, text, ds, errs):
    """Kernels G-L one by one against their plain versions on the card, and
    the suffix sort as a whole, in each regime, against the plain versions
    on the CPU."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch import suffix as TS
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import sort_ops as SO

    dev = text.device
    n, ndocs = prepared.n, prepared.num_docs

    def hold(name, got, want):
        torch.cuda.synchronize()
        errs[name] = max_abs_err(name, got, want)

    def t_dev(a):
        return torch.from_numpy(a).to(dev)

    # G: the histogram (also of symbols outside [0, 512)) and the keys at
    # the corpus's near-full byte alphabet and at the zipf documents' K = 31
    bad = torch.cat([text[: 1 << 20], t_dev(np.array([512, -7, 1 << 30],
                                                     np.int32))])
    for tag, t in (("text", text), ("outside", bad)):
        hold(f"sym_hist({tag})", [SO.sym_hist(t)], [SO.sym_hist_plain(t)])
    check(int(SO.sym_hist(bad)[512]) == 3, "sym_hist: outside count")
    zipf_text = text_tensor(tt.prepare_documents(docs[:32]), dev)
    state = {}
    for tag, t in (("bytes", text), ("zipf", zipf_text)):
        used = TS.text_alphabet(t)
        bits, per = TS.key_widths(len(used))
        lut = t_dev(TS.alpha_lut(used))
        key0 = SO.sa_keys(t, lut, bits=bits, per=per)
        hold(f"sa_keys(K={len(used)},bits={bits},per={per})", [key0],
             [SO.sa_keys_plain(t, lut, bits=bits, per=per)])
        state[tag] = (t, key0, bits, per, len(used))
    check(state["bytes"][2:4] == (9, 7) and state["bytes"][4] >= 128,
          "the parity corpus should have a near-full byte alphabet")
    check(state["zipf"][2:5] == (5, 12, 31), "the zipf docs have 31 symbols")

    # H (csrc/radix_sort.cu): random 63-bit keys with many duplicates at
    # m = 1, about the few-key tile (1024), the tile and the one-block
    # limit (both 4096) and the few-key tiles' limit (2^18), and at
    # (1 << 22) + 77; the bit ranges the paths sort (the first sort's
    # 0:60, a round's 8:29, dist_sort's biased int32 keys at 0:32) and the
    # edges (0:63, 0:5, 62:63); all-equal, sorted and reverse-sorted keys;
    # values given and 0..m-1.  Each case runs twice (the tile counter
    # hands the tiles to whichever blocks come first) and both runs equal
    # the plain version bit for bit
    sort_errs = {}

    def hold_sort(name, k, vv, lo, hi):
        got = SO.radix_sort_pairs(k, vv, lo, hi)
        again = SO.radix_sort_pairs(k, vv, lo, hi)
        want = SO.radix_sort_pairs_plain(k, vv, lo, hi)
        torch.cuda.synchronize()
        sort_errs[name] = max(max_abs_err(name, got, want),
                              max_abs_err(f"{name} again", again, got))

    t_h = time.perf_counter()
    check(kernels.size("radix_sort_kernels", 4096, 0, 63) == 1
          and kernels.size("radix_sort_kernels", 4097, 0, 63) == 9
          and [kernels.size("radix_sort_tile", m) for m in (
              4096, 4097, 1 << 18, (1 << 18) + 1)] == [0, 1024, 1024, 4096],
          "kernel H: one launch up to 4096 keys, 1 + passes above; tiles "
          "of 1024 keys up to 2^18, of 4096 above")
    for m in (1, 1023, 1024, 1025, 4095, 4096, 4097, 1 << 18,
              (1 << 18) + 1, (1 << 22) + 77):
        keys = rng.integers(0, 2**63 - 1, size=m, dtype=np.int64)
        keys[rng.integers(0, m, size=m // 2)] = keys[0]
        keys[::3] &= 0xFFFFFF
        vals = rng.integers(0, 2**31 - 1, size=m).astype(np.int32)
        k, v = t_dev(keys), t_dev(vals)
        biased = t_dev(rng.integers(-2**31, 2**31, size=m).astype(np.int64)
                       + 2**31)
        srt = torch.sort(k)[0]
        cases = [(f"bits={lo}:{hi}", k, lo, hi)
                 for lo, hi in ((0, 63), (0, 60), (8, 29), (0, 5), (62, 63))]
        cases += [("dist_sort keys, bits=0:32", biased, 0, 32),
                  ("all equal", torch.full_like(k, int(keys[0])), 0, 63),
                  ("sorted", srt, 0, 63), ("reverse", srt.flip(0), 0, 63)]
        for tag, kk, lo, hi in cases:
            for vv in (v, None):
                hold_sort(f"radix_sort_pairs(m={m},{tag},"
                          f"vals={'given' if vv is not None else 'iota'})",
                          kk, vv, lo, hi)
    errs[f"radix_sort_pairs ({len(sort_errs)} cases, each sorted twice)"] = \
        max(sort_errs.values())
    # the kernels a sort launches, as the profiler sees them: 1 + passes
    # above 4096 pairs (a histogram, then a tile pass a pass), 1 up to it
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        SO.radix_sort_pairs(k, None, 0, 63)
        SO.radix_sort_pairs(k[:4096], None, 0, 63)
        torch.cuda.synchronize()
    calls = {h: sum(e.count for e in prof.key_averages() if h in e.key)
             for h in H_KERNELS}
    check(calls == {"radix_digit_hist": 1, "radix_tile_pass": 8,
                    "radix_block_sort": 1},
          f"kernel H's launches for a sort of {k.shape[0]} and one of 4096 "
          f"pairs over 63 bits: {calls}")
    log(f"    H held to its plain version in {len(sort_errs)} cases, each "
        f"sorted twice ({time.perf_counter() - t_h:.1f}s); its kernels for a "
        f"sort of {k.shape[0]} and one of 4096 pairs over 63 bits "
        f"(torch.profiler): {calls}")
    for tag, (t, key0, bits, per, K) in state.items():
        nn = t.shape[0]
        skey, sa = SO.radix_sort_pairs(key0, None, 0, per * bits)
        hold(f"radix_sort_pairs(first sort, {tag})", [skey, sa],
             SO.radix_sort_pairs_plain(key0, None, 0, per * bits))
        # I: flags and the tied slots, directly and through a slot list
        flags = SO.group_flags(skey)
        hold(f"group_flags({tag})", [flags], [SO.group_flags_plain(skey)])
        got = SO.tied_compact(flags, want_all=True)
        want = SO.tied_compact_plain(flags, want_all=True)
        check(got[2] == want[2] and got[2] > 0, f"tied count ({tag})")
        hold(f"tied_compact({tag})", [got[0], got[1], got[3]],
             [want[0], want[1], want[3]])
        slots, base, m, _ = got
        sub = SO.group_flags(base.long())
        got = SO.tied_compact(sub, slots, want_all=True)
        want = SO.tied_compact_plain(sub, slots, want_all=True)
        check(got[2] == want[2] == m, f"tied count through slots ({tag})")
        hold(f"tied_compact(slots, {tag})", [got[0], got[1], got[3]],
             [want[0], want[1], want[3]])
        # J: the rank array, then one doubling and one extension round
        # from the same state
        rank = SO.rank_init(sa, slots, base)
        hold(f"rank_init({tag})", [rank],
             [SO.rank_init_plain(sa, slots, base)])
        base_bits = max(1, (nn - 1).bit_length())
        e = min(per, (63 - base_bits) // bits)
        rounds = {
            "doubling": dict(shift=nn.bit_length(),
                             key_bits=nn.bit_length() + base_bits,
                             rank=rank, h=per),
            "extension": dict(shift=e * bits, key_bits=e * bits + base_bits,
                              key0=key0, w=per, drop=(per - e) * bits),
        }
        cpu = [x.cpu() for x in (sa, slots, base)]
        for mode, kw in rounds.items():
            kw_cpu = {k: v.cpu() if torch.is_tensor(v) else v
                      for k, v in kw.items()}
            hold(f"round_keys+round_commit({mode}, {tag})",
                 [x.cpu() for x in sort_round(SO, sa, slots, base, **kw)],
                 sort_round(SO, *cpu, **kw_cpu))
    del state

    # K: the payload with and without marks (the corpus holds an empty doc)
    check(any(len(d) == 0 for d in docs), "the corpus needs an empty doc")
    for mp in (0, 20):
        kw = dict(n=n, mark_period=mp, ndocs=ndocs)
        hold(f"sa_payload(mark_period={mp})",
             [BO.build_sa_payload(text, ds, **kw)],
             [BO.sa_payload_plain(text, ds, **kw)])
    # L: int32 and int64 sources, indices outside the source
    payload = BO.build_sa_payload(text, ds, n=n, mark_period=20, ndocs=ndocs)
    idx = t_dev(np.concatenate([
        rng.integers(0, n, size=1 << 20), [-1, n, 2**31 - 1]]
    ).astype(np.int32))
    for tag, src in (("int64", payload), ("int32", text)):
        hold(f"gather_rows({tag})", [SO.gather_rows(src, idx)],
             [SO.gather_rows_plain(src, idx)])

    # the sort as a whole on the card against the plain versions on the CPU,
    # once in each regime
    repeats = tt.prepare_documents(
        [(b"abcabcabd" * 8000)[:65535], b"a" * 8192, b"", b"ab" * 3000])
    planted = text_tensor(tt.prepare_documents(docs[2:18]), dev)
    half = planted.shape[0] // 2
    planted[half: half + 40] = planted[1000:1040]  # ties extension ends
    texts = {
        # docs[0] and docs[1] are the same document
        "extension+doubling": text_tensor(tt.prepare_documents(docs[:16]),
                                          dev),
        "doubling": text_tensor(repeats, dev),
        "sorted": t_dev(rng.integers(3, 259, size=1 << 20).astype(np.int32)),
        "extension": planted,
    }
    regimes = {}
    for regime, t in texts.items():
        pl = t_dev(rng.integers(0, 2**40, size=t.shape[0]))
        sa_k, pull_k = tt.suffix_array(t, payload=pl)
        stats = {k: v for k, v in TS.last_stats.items()}
        sa_p, pull_p = tt.suffix_array(t.cpu(), payload=pl.cpu())
        check(stats == TS.last_stats, f"{regime}: the card's rounds "
              f"{stats} differ from the CPU's {TS.last_stats}")
        check(stats["regime"] == regime,
              f"expected the {regime} regime, got {stats}")
        hold(f"suffix_array({regime})", [sa_k.cpu(), pull_k.cpu()],
             [sa_p, pull_p])
        regimes[regime] = stats
        log(f"    suffix_array n={t.shape[0]}: {stats}")
    return regimes


def same_index(name, got, want, lists=True):
    """Every FMArrays field, the meta and (with lists) the doc lists of two
    indexes bit for bit."""
    for k, w in want.arrays._asdict().items():
        g = getattr(got.arrays, k)
        check((g is None) == (w is None), f"{name}: field {k}")
        if w is not None:
            max_abs_err(f"{name} field {k}", [g.cpu()], [w.cpu()])
    check(dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta),
          f"{name}: meta {got.meta} != {want.meta}")
    if lists:
        for k in ("chunk_doc_offsets_np", "chunk_docs_np"):
            g, w = getattr(got, k), getattr(want, k)
            check(w is not None and g.dtype == w.dtype
                  and np.array_equal(g, w), f"{name}: {k} differs")


def parity_chunked(docs, prepared, sa, ds, errs):
    """The chunked path's kernels against their plain versions on the card
    (P's doc_lists and flatten_ragged at four segment sizes and on a
    pad_shape build, Q's expand_u8, G's sa_keys with n_real and a whole
    padded suffix sort, bwt_from_sa through L), then small chunked builds
    on the card against the same on the CPU."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import fmindex as TF
    from femto_tpu_torch import multi as TM
    from femto_tpu_torch import suffix as TS
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import sort_ops as SO

    dev = sa.device
    n = prepared.n

    def hold(name, got, want):
        torch.cuda.synchronize()
        errs[name] = max_abs_err(name, got, want)

    # P at four segment sizes (65504: the rows sort in global memory)
    for seg in DOC_LIST_SEGS:
        n_seg = n // seg + 1
        vals, counts = BO.doc_lists(sa, ds, n_real=n, n_seg=n_seg, seg=seg)
        want = BO.doc_lists_plain(sa, ds, n_real=n, n_seg=n_seg, seg=seg)
        hold(f"doc_lists(seg={seg})", [vals.contiguous(), counts], want)
        offsets = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
        offsets[1:] = torch.cumsum(counts.long(), 0)
        hold(f"flatten_ragged(seg={seg})",
             [BO.flatten_ragged(vals, counts, offsets)],
             [BO.flatten_ragged_plain(vals, counts, offsets)])
    # Q: headers, bytes 0 and 255, an empty document, a padded tail
    headers = [b"hdr %d" % i if i % 5 == 0 else b"" for i in range(len(docs))]
    hprep = tt.prepare_documents(docs, headers=headers)
    check(any(len(d) == 0 for d in docs) and b"\x00" in docs[-2]
          and b"\xff" in docs[-2], "the corpus needs an empty and a binary "
                                   "document")
    hn = hprep.n
    for nb, nd in ((hn, hprep.num_docs), (hn + 4099, hprep.num_docs + 3)):
        esc = TF._escape_positions(hprep, nd)
        u8 = torch.from_numpy(TM._content_u8(hprep.text, nb)).to(dev)
        pos = [torch.from_numpy(p).to(dev) for p in esc]
        got = BO.expand_u8(u8, hn, *pos)
        hold(f"expand_u8(n_build={nb})", [got],
             [BO.expand_u8_plain(u8, hn, *pos)])
        check(torch.equal(got[:hn].cpu(), torch.from_numpy(
            hprep.text.astype(np.int32))) and not bool(got[hn:].any()),
            "expand_u8 does not give the prepared text back")
    # G with n_real, then the padded sort as a whole and bwt_from_sa
    pad = 70001
    t = torch.cat([text_tensor(prepared, dev),
                   torch.zeros(pad, dtype=torch.int32, device=dev)])
    used = TS.text_alphabet(t)
    bits, per = TS.key_widths(len(used))
    lut = torch.from_numpy(TS.alpha_lut(used)).to(dev)
    hold("sa_keys[n_real]",
         [SO.sa_keys(t, lut, bits=bits, per=per, n_real=n)],
         [SO.sa_keys_plain(t, lut, bits=bits, per=per, n_real=n)])
    # K on a padded text: the padded documents' starts are marked too
    dsp = torch.cat([ds, torch.full((2,), n, dtype=torch.int32, device=dev)])
    kw = dict(n=n + pad, mark_period=20, ndocs=dsp.shape[0] - 1)
    hold("sa_payload(padded)", [BO.build_sa_payload(t, dsp, **kw)],
         [BO.sa_payload_plain(t, dsp, **kw)])
    sa_k = tt.suffix_array(t, n_real=n)
    stats = dict(TS.last_stats)
    sa_p = tt.suffix_array(t.cpu(), n_real=n)
    check(stats == TS.last_stats, "padded sort: card and CPU rounds differ")
    hold("suffix_array(n_real)", [sa_k.cpu()], [sa_p])
    check(torch.equal(sa_k[:pad].cpu(), torch.arange(
        n + pad - 1, n - 1, -1, dtype=torch.int32)),
        "the pad suffixes do not lead, shortest first")
    check(torch.equal(sa_k[pad:].cpu(), sa.cpu()),
          "the padded SA's real rows differ from the unpadded SA")
    hold("bwt_from_sa", [tt.bwt_from_sa(t, sa_k).cpu()],
         [tt.bwt_from_sa(t.cpu(), sa_k.cpu())])
    del t, sa_k, sa_p
    # a pad_shape build with doc lists: card against CPU
    sub = tt.prepare_documents(docs[:40], headers=headers[:40])
    kw = dict(seg=256, mark_period=20, doc_chunks=True,
              pad_shape=(sub.n + 5000, sub.num_docs + 2))
    same_index("pad_shape build", tt.build_index(sub, device="cuda", **kw),
               tt.build_index(sub, device="cpu", **kw))
    # small chunked builds (four chunks, the last one padded), card against
    # CPU; merge_indexes and IncrementalIndex against direct builds
    cdocs = docs[2:20] + docs[-4:]
    cheaders = headers[2:20] + headers[-4:]
    cprep = tt.prepare_documents(cdocs, headers=cheaders)
    cmax = 6 * DOC_SIZE + 64
    kw = dict(max_chunk_symbols=cmax, seg=256, mark_period=20)
    runs = {}
    for uniform in (True, False):
        want = TM.build_chunked_prepared(cprep, uniform=uniform,
                                         prefetch=False, device="cpu", **kw)
        check(len(want.indexes) == 4, "the small chunked corpus should "
              "give four chunks")
        for prefetch in (True, False):
            got = TM.build_chunked_prepared(cprep, uniform=uniform,
                                            prefetch=prefetch,
                                            device="cuda", **kw)
            for i, (g, w) in enumerate(zip(got.indexes, want.indexes)):
                same_index(f"chunk {i} (uniform={uniform}, "
                           f"prefetch={prefetch})", g, w)
            runs[uniform, prefetch] = got
    padded = runs[True, True].indexes[-1].meta.row0
    check(padded > 0, "the uniform build's last chunk should be padded")
    mi = runs[True, True]
    pats = [cdocs[d][o: o + 12] for d, o in ((0, 100), (7, 2000), (17, 9))]
    pats += [b"\x00\xff", b"hdr 5"]
    direct = tt.build_index(cprep, seg=256, mark_period=20, device="cuda")
    check(np.array_equal(mi.count(pats), tt.count(direct, pats)),
          "chunked counts differ from the direct build's")
    same_index("merge_indexes", TM.merge_indexes(
        mi.indexes, seg=256, mark_period=20, device="cuda"), direct,
        lists=False)
    inc = TM.IncrementalIndex(max_shards=2, seg=256, mark_period=20,
                              device="cuda")
    for i in range(0, len(cdocs), 8):
        inc.add_documents(cdocs[i: i + 8])
    check(len(inc.multi.indexes) == 2 and inc.num_docs == len(cdocs),
          "IncrementalIndex should hold two shards of every document")
    # (add_documents takes no headers: the header pattern is left out)
    check(np.array_equal(inc.count(pats[:-1]), tt.count(direct, pats[:-1])),
          "IncrementalIndex counts differ from the direct build's")
    log(f"    chunked parity: doc lists at seg {DOC_LIST_SEGS}, expand_u8 "
        f"with headers and pads, sa_keys and suffix_array with n_real "
        f"(rounds {stats}), bwt_from_sa, a pad_shape build with doc lists, "
        f"four-chunk builds (uniform and prefetch both ways; the last chunk "
        f"has row0 {padded}), merge_indexes and IncrementalIndex")


# ---------------------------------------------------------------------------
# the row tiers (vseg, vrle): real prose, kernels M and N at a build's shapes
# ---------------------------------------------------------------------------

_PROSE = {}


PROSE_PACKAGES = ("numpy", "scipy", "pandas", "sklearn", "torch")


def _walk_key(obj, path):
    """Who an object is in the prose walk: a module by its name, a class
    by its qualified name, anything else by the path it was reached by."""
    import inspect

    try:
        if inspect.ismodule(obj):
            return "module", obj.__name__
        if inspect.isclass(obj):
            return "class", f"{obj.__module__}.{obj.__qualname__}"
    except Exception:
        pass
    return "path", path


def english_prose(budget):
    """Up to `budget` bytes of unique English prose from the sources of
    examples/corpus_real.english_prose: the pydoc topics, then the
    docstrings of the installed PROSE_PACKAGES, walked depth first in
    name order, each object once by its _walk_key, each text once by its
    hash, with warnings silenced only during the walk.  No object
    identity enters the walk, and texts that change between processes
    (examples marked "may vary", memory addresses) are left out, so that
    one installation gives the same bytes in every process started with
    the same PYTHONHASHSEED (sets print in hash order)."""
    import hashlib
    import importlib
    import inspect
    import warnings

    import pydoc_data.topics as topics

    parts, seen, total = [], set(), 0
    volatile = re.compile(r"may vary|0x[0-9a-fA-F]{6,}")

    def texts():
        for k in sorted(topics.topics):
            yield topics.topics[k]
        for pkg in PROSE_PACKAGES:
            try:
                mod = importlib.import_module(pkg)
            except Exception:
                continue
            visited = set()
            stack = [(pkg, mod)]
            while stack:
                path, obj = stack.pop()
                key = _walk_key(obj, path)
                if key in visited:
                    continue
                visited.add(key)
                try:
                    doc = inspect.getdoc(obj)
                except Exception:
                    doc = None
                if doc:
                    yield doc
                if key[0] == "module" and key[1].startswith(pkg):
                    kids = dir(obj)
                elif key[0] == "class":
                    kids = dir(obj)
                else:
                    continue
                for name in kids:
                    try:
                        a = getattr(obj, name)
                    except Exception:
                        continue
                    if key[0] == "module" or callable(a):
                        stack.append((f"{path}.{name}", a))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for text in texts():
            if volatile.search(text):
                continue
            b = text.encode("utf-8", "replace")
            h = hashlib.blake2b(b, digest_size=12).digest()
            if len(b) >= 200 and h not in seen:
                seen.add(h)
                parts.append(b)
                total += len(b) + 1
            if total >= budget:
                break
    return b"\n".join(parts)[:budget]


def prose_bytes():
    """PROSE_MIB of unique English prose (english_prose), made once a run;
    its blake2b digest names the text beside every prose number."""
    import hashlib

    if "bytes" not in _PROSE:
        t0 = time.perf_counter()
        # a process of its own, at a fixed hash seed: english_prose's text
        # depends on neither this process's imports nor its seed
        here = os.path.dirname(os.path.abspath(__file__))
        buf = _PROSE["bytes"] = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.stdout."
             f"buffer.write(chip_smoke.english_prose({PROSE_MIB << 20}))"],
            cwd=here, env={**os.environ, "PYTHONHASHSEED": "0"},
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, check=True,
            timeout=600).stdout
        _PROSE["seconds"] = time.perf_counter() - t0
        _PROSE["blake2b"] = hashlib.blake2b(buf, digest_size=16).hexdigest()
        mib = len(buf) / 2**20
        log(f"    prose corpus: {mib:.4f} MiB ({len(buf)} B) of unique "
            f"English prose, blake2b {_PROSE['blake2b']} (made in "
            f"{_PROSE['seconds']:.1f}s)")
        check(mib >= PROSE_MIN_MIB,
              f"the prose corpus is {mib:.2f} MiB, under {PROSE_MIN_MIB} "
              f"MiB: too little installed documentation on this host")
    return _PROSE["bytes"]


def prose_docs(nbytes=None):
    """The prose in documents of DOC_SIZE - 1 bytes (the last shorter)."""
    buf = prose_bytes()[:nbytes]
    step = DOC_SIZE - 1
    return [buf[i: i + step] for i in range(0, len(buf), step)]


def seg_modes(seg_woff):
    """Segments by mode: seg_woff -1 RLE, < -1 RLE with a continuation, 0
    fixed-width codes, > 0 side table."""
    w = seg_woff.long()
    return {"rle": int((w == -1).sum()), "continuation": int((w < -1).sum()),
            "fixed": int((w == 0).sum()), "side": int((w > 0).sum())}


def stream_edges(plan):
    """Segments at the edges of a vrle build's slot walk: streams that end
    exactly at the code area's last word, continued streams that end
    exactly at a word boundary, and the continuation stored last in the
    flat store (its window reads the guard granules)."""
    from femto_tpu_torch.ops import build_ops as BO

    woff = plan.seg_woff
    w_slot, _ = BO.vrle_slot_geom_np(plan.nsym.cpu().numpy().astype(np.int32))
    bits = plan.slots.astype(np.int64) * w_slot
    last = (plan.cont_idx[np.argmax(plan.offs[:-1])[None]]
            if len(plan.cont_idx) else plan.cont_idx)
    return {"code_end": np.nonzero((woff == -1)
                                   & (bits == 32 * plan.code_words))[0],
            "cont_end": np.nonzero((woff < -1) & (bits % 32 == 0))[0],
            "last_cont": last}


def bound_row_kernels(st):
    """Bytes each of kernels M and N must move at a row build's shapes:
    every input once, every output once.  vseg_rows reads the BWT of the
    fixed-width segments only (seg_woff 0: a side segment's code area is
    zeros) and the slot words of the run-length ones; cont_flatten reads
    each continuation word once and writes the whole store once."""
    n_seg, seg = st["bwt"].shape
    K = st["hist"].shape[1]
    plan = st["plan"]
    smax, s_store = plan.smax, plan.s_store
    total = st["rows"].shape[1]
    woff = st["extra"]["seg_woff"].long()
    n_rle = int((woff < 0).sum())
    n_fixed = int((woff == 0).sum())
    code_words = plan.code_words
    out = {
        "seg_syms": 4 * n_seg * K + 4 * n_seg * smax + n_seg,
        "vseg_rows": (2 * n_fixed * seg + 4 * n_rle * code_words
                      + 4 * 261 + 4 * n_seg * s_store + n_seg + 4 * n_seg
                      + 4 * n_seg * (seg // 32) + 4 * n_seg + 2 * n_seg * K
                      + 4 * n_seg * total),
        "vrle_slot_count": 2 * n_seg * seg + 4 * 261 + 4 * n_seg * smax
        + n_seg + 4 * n_seg,
    }
    ovf = st.get("ovf")
    if ovf is not None and ovf.numel():
        Ws = st["extra"]["seg_ovf"].shape[1]
        out["side_rows"] = (2 * ovf.numel() * seg + 4 * 261 + 4 * ovf.numel()
                            + 4 * (ovf.numel() + 1) * Ws)
    if st.get("words"):
        out["vrle_pack"] = (2 * n_rle * seg + 4 * 261 + 4 * n_rle * smax
                            + n_seg + 4 * n_seg + 4 * n_seg * st["words"])
    if st.get("cwords") is not None:
        m = st["cwords"].numel()
        out["cont_flatten"] = (4 * int(st["cwords"].sum()) + 12 * m
                               + 4 * st["extra"]["seg_cont"].numel())
    return {k: bound_ms(v) for k, v in out.items()}


def row_stage(prepared, seg, tier, mark_period=20):
    """A build of `tier` on the card taken apart: the stages up to kernel
    B, then build_row_tier, and each of kernels M and N (as that build
    runs them) with its plain version: {"runs": {entry: (kernel, plain)},
    and the stage's tensors}."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.fmindex import l1_group_for
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.suffix import text_alphabet

    dev = torch.device("cuda")
    n, ndocs = prepared.n, prepared.num_docs
    text = text_tensor(prepared, dev)
    ds = torch.from_numpy(prepared.doc_starts.astype(np.int32)).to(dev)
    used = np.asarray(text_alphabet(text), np.int32)
    payload = BO.build_sa_payload(text, ds, n=n, mark_period=mark_period,
                                  ndocs=ndocs)
    sa, pull = tt.suffix_array(text, payload=payload, alpha=used)
    del payload, text
    grp = l1_group_for(seg)
    n_seg = -(-(n // seg + 1) // grp) * grp
    amap_np = np.full(261, -1, np.int32)
    amap_np[used] = np.arange(len(used), dtype=np.int32)
    amap = torch.from_numpy(amap_np).to(dev)
    arev = torch.from_numpy(used).to(dev)
    bwt, a_row, occ_rel, _, _, hist = BO.occ_build_compact(
        pull, amap, arev, n_seg=n_seg, seg=seg, want_hist=True)
    del pull
    mark_bits, mark_ckpt = BO.marks_build(
        sa, a_row, n_seg=n_seg, seg=seg, mark_period=mark_period,
        ndocs=ndocs)[:2]
    del a_row, sa
    plan = BO.row_plan(tier, bwt, hist, amap)
    rows, extra = BO.build_row_tier(plan, bwt, amap, occ_rel, mark_bits,
                                    mark_ckpt)
    st = dict(bwt=bwt, hist=hist, rows=rows, extra=extra, plan=plan)
    smax, cw = plan.smax, plan.code_words
    syms, nsym = plan.syms, plan.nsym
    woff = extra["seg_woff"]
    runs = {"seg_syms": (lambda: BO.seg_syms(hist, smax),
                         lambda: BO.seg_syms_plain(hist, smax))}
    rle = None
    if tier == "vrle":
        slot_args = (bwt, amap, syms, nsym)
        runs["vrle_slot_count"] = (
            lambda: [BO.vrle_slot_count(*slot_args)],
            lambda: [BO.vrle_slot_count_plain(*slot_args)])
        words = cw + plan.C_words
        if plan.has_rle:
            st["words"] = words
            runs["vrle_pack"] = (
                lambda: [BO.vrle_pack(*slot_args, woff, words=words)],
                lambda: [BO.vrle_pack_plain(*slot_args, woff, words=words)])
            rle = BO.vrle_pack(*slot_args, woff, words=words)
        if len(plan.cont_idx):
            cont, cwords, offs = (
                torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (plan.cont_idx, plan.cwords, plan.offs[:-1]))
            st["cwords"] = cwords
            kw = dict(first=cw, total=plan.cont_total)
            runs["cont_flatten"] = (
                lambda: [BO.cont_flatten(rle, cont, cwords, offs, **kw)],
                lambda: [BO.cont_flatten_plain(rle, cont, cwords, offs,
                                               **kw)])
    row_args = (bwt, amap, syms, nsym, woff, mark_bits, mark_ckpt, occ_rel)
    row_kw = dict(w_main=plan.w_main, code_words=cw, s_store=plan.s_store,
                  wide=plan.wide, rle=rle)
    runs["vseg_rows"] = (lambda: [BO.vseg_rows(*row_args, **row_kw)],
                         lambda: [BO.vseg_rows_plain(*row_args, **row_kw)])
    ovf = torch.nonzero(woff > 0).flatten().to(torch.int32)
    st["ovf"] = ovf
    if ovf.numel():
        runs["side_rows"] = (
            lambda: [BO.side_rows(bwt, amap, ovf, w_side=plan.w_side)],
            lambda: [BO.side_rows_plain(bwt, amap, ovf, w_side=plan.w_side)])
    st["runs"] = runs
    return st


def parity_row_kernels(prepared, prose, docs, errs):
    """Kernels M and N one by one against their plain versions on the
    card, at the shapes a vseg and a vrle build give them: of the 8 MiB
    parity corpus (a near-full byte alphabet: u16 lists, side rows) and
    its zipf documents alone (31 symbols) at seg 256, and of 8 MiB of
    prose at seg PROSE_SEG; each build's rows equal the kernel's own
    output."""
    import torch

    import femto_tpu_torch as tt

    cases = (("parity", prepared, 256),
             ("zipf", tt.prepare_documents(docs[:124]), 256),
             ("prose", prose, PROSE_SEG))
    seen = {}
    for cname, prep, seg in cases:
        for tier in ROW_LAYOUTS:
            st = row_stage(prep, seg, tier)
            for name, (run_k, run_p) in st["runs"].items():
                tag = f"{name}({cname}, {tier})"
                got, want = run_k(), run_p()
                torch.cuda.synchronize()
                errs[tag] = max_abs_err(tag, got, want)
                seen[name] = seen.get(name, 0) + 1
            max_abs_err(f"build_row_tier({cname}, {tier}) rows",
                        [st["rows"]], st["runs"]["vseg_rows"][0]())
            modes = seg_modes(st["extra"]["seg_woff"])
            p = st["plan"]
            plan = {k: getattr(p, k) for k in (
                "w_main", "code_words", "C_words", "s_store", "smax",
                "w_side", "wide", "ngr", "has_rle")}
            log(f"    {cname} {tier} (seg {seg}): plan {plan}, "
                f"segments by mode {modes}")
            if cname == "prose" and tier == "vrle":
                check(modes["rle"] > 0 and modes["continuation"] > 0,
                      f"8 MiB of prose gave no RLE or no continuation "
                      f"segments: {modes}")
                edges = stream_edges(p)
                edges["seg_woff"] = p.seg_woff
            del st
    check(set(seen) == set(ROW_KERNELS),
          f"kernels M and N not all held: {sorted(seen)}")
    return edges


def parity_prose_search(prose, ix, rng, errs, edges):
    """Kernels C, D and E on the vseg and vrle indexes of 8 MiB of prose
    (seg PROSE_SEG: run-length, continued, fixed and side segments)
    against their plain versions, and the answers against the full tier
    and the text.  D's locate also starts from every offset of the
    segments at the slot walk's edges (stream_edges), its extract from
    every fourth, and E's psi from the rows one text position before
    those, so that its select lands there."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.search import pack_patterns

    dev = torch.device("cuda")
    n = prose.n
    text = text_tensor(prose, dev)
    sa = ix["full"].sa_direct
    docs = prose_docs(int(PARITY_PROSE_MIB * 2**20))
    pats = []
    for _ in range(2000):
        d = int(rng.integers(0, len(docs)))
        L = int(rng.integers(1, 33))
        if len(docs[d]) > L:
            o = int(rng.integers(0, len(docs[d]) - L))
            pats.append(docs[d][o: o + L])
    pats += [b"", b"\x00absent\xff", b"the ", b"e" * 40]
    packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
    pt = torch.from_numpy(packed).to(dev)
    check(np.array_equal(edges["seg_woff"],
                         ix["vrle"].arrays.seg_woff.cpu().numpy()),
          "prose vrle: the build's plan and the index disagree on seg_woff")
    kinds = {k: len(v) for k, v in edges.items() if k != "seg_woff"}
    check(kinds["code_end"] + kinds["cont_end"] > 0
          and kinds["last_cont"] == 1,
          f"8 MiB of prose: no stream ends at a word boundary, or no "
          f"continuation ({kinds})")
    picked = np.unique(np.concatenate([
        edges["code_end"][:2], edges["cont_end"][:2], edges["last_cont"]]))
    edge_rows = (picked[:, None] * PROSE_SEG
                 + np.arange(PROSE_SEG)).ravel()
    edge_rows = torch.from_numpy(
        edge_rows[edge_rows < n].astype(np.int32)).to(dev)
    isa = torch.empty(n, dtype=torch.int64, device=dev)
    isa[sa.long()] = torch.arange(n, device=dev)
    # LF of each edge row: psi from there steps into the edge segment
    before = isa[(sa[edge_rows.long()].long() - 1) % n].to(torch.int32)
    del isa
    log(f"    prose vrle slot-walk edges: segments {picked.tolist()} of "
        f"{kinds} (segments of each kind)")
    rows = torch.cat([
        torch.from_numpy(rng.integers(0, n, size=16384).astype(np.int32)),
        torch.arange(0, 512, dtype=torch.int32),
        torch.arange(n - 512, n, dtype=torch.int32)]).to(dev)
    rows = torch.cat([rows, edge_rows])
    want_c = S.backward_search(ix["full"].arrays, n, pt)
    for lay in ROW_LAYOUTS:
        arrays = ix[lay].arrays
        c_k = S.backward_search(arrays, n, pt)
        c_p = S.backward_search_plain(arrays, n, pt)
        d_k = S.locate_rows(arrays, 20, rows)
        d_p = S.locate_rows_plain(arrays, 20, rows)
        er = torch.cat([rows[:256], edge_rows[::4]]).contiguous()
        pr = torch.cat([rows[:256], before[::4]]).contiguous()
        e_k = S.extract_backward(arrays, er, 200)
        e_p = S.extract_backward_plain(arrays, er, 200)
        p_k = S.psi_walk(arrays, pr, 40)
        p_p = S.psi_walk_plain(arrays, pr, 40)
        torch.cuda.synchronize()
        for name, got, want in (("backward_search", c_k, c_p),
                                ("lf_locate", [d_k], [d_p]),
                                ("lf_extract", e_k, e_p),
                                ("psi_walk", [p_k], [p_p])):
            tag = f"{name}[{lay}](prose)"
            errs[tag] = max_abs_err(tag, got, want)
        # absent symbols give (0, 0) on a remapped tier: compare counts
        check(torch.equal(c_k[1] - c_k[0], want_c[1] - want_c[0]),
              f"prose {lay}: counts differ from the full tier's")
        check(torch.equal(d_k, sa[rows.long()]),
              f"prose {lay}: walk locate != suffix array")
        pos = sa[pr.long()].long()[:, None] + torch.arange(40, device=dev)
        want = text[pos.clamp(max=n - 1)]
        seof = (want == 2).int()
        upto = (torch.cumsum(seof, dim=1) - seof) == 0
        check(torch.equal(p_k[upto], want[upto]),
              f"prose {lay}: psi walk != the text after each row")
        for d in (0, len(docs) - 1):
            check(tt.extract_document(ix[lay], d) == docs[d],
                  f"prose {lay}: extract doc {d}")
    modes = seg_modes(ix["vrle"].arrays.seg_woff)
    check(modes["rle"] > 0 and modes["continuation"] > 0,
          f"8 MiB of prose: no RLE or continuation segments ({modes})")
    log(f"    8 MiB prose (n={n}, seg {PROSE_SEG}): C, D, E on vseg and "
        f"vrle equal their plain versions; vrle segments by mode {modes}")
    return {"edge_segments": picked.tolist(), "edge_kinds": kinds,
            "edge_rows": int(edge_rows.numel()), "modes_vrle": modes}


# ---------------------------------------------------------------------------
# the query engine: kernel C's step entries and kernel R (K1, K15)
# ---------------------------------------------------------------------------

# bench.py's two regex queries (bench.py:330-334) with its frontier caps
ZIPF_QUERIES = {
    "alternation": ('("the "|"and "|"ing "|"ion ")', 256),
    "approx1": ("APPROX 1 ther", 1024),
}
# phase 4d (b) on the prose vseg and vrle indexes: name -> (query, the
# Python re of an exact term or of an approximate term's word, or None,
# icase); Booleans are scanned from their terms.  A bare space separates terms that concatenate, so a space
# of the pattern is escaped.
PROSE_QUERIES = {
    "classes": (r"[Tt]he\ [a-z]{2,4}s\ ", rb"[Tt]he [a-z]{2,4}s ", False),
    "alternation": (r"(return|yield|raise)\ ", rb"(?:return|yield|raise) ",
                    False),
    "repeat64": ("0{1,64}1", rb"0{1,64}1", False),
    "approx1": ("APPROX 1 function", rb"function", False),
    "approx2": ("APPROX 2 parameter", rb"parameter", False),
    "and": ("array AND matrix", None, False),
    "not": ("tensor NOT gradient", None, False),
    "then": ("default THEN 20 None", None, False),
    "within": ("shape WITHIN 10 array", None, False),
    "icase": ("NumPy", rb"numpy", True),
}
# entries of a frontier whose forks regex_fork_plain takes at once in
# phase 5's comparisons at the widest layers
FORK_CHUNK = 256
# the regex whose NFA does not fit the fork kernel's shared memory
# (784 states, 9088 transitions)
WIDE_NFA_QUERY = "(a|b|c|d|e|f|g|h|i|j|k|l){1,64}"


def cpu_copy(ix):
    """The index with its tensors on the CPU: the wrappers there take the
    plain versions."""
    from femto_tpu_torch.fmindex import FMArrays

    return dataclasses.replace(
        ix, arrays=FMArrays(*(None if a is None else a.cpu()
                              for a in ix.arrays)),
        sa_direct=None)


def match_tuples(ms):
    return sorted((m.first, m.last, m.cost, m.match) for m in ms)


def term_nfa(term):
    """The NFA of a term, as term_ranges compiles it."""
    from femto_tpu_torch import query as Q
    from femto_tpu_torch.query.planning import streamline

    return Q.compile_nfa(streamline(term.regexp))


def query_nfa(q):
    """(parsed term, its NFA) of a one-term query."""
    from femto_tpu_torch import query as Q

    node = Q.parse_query(q)
    return node, term_nfa(node)


def fixed_frontier(ix, pt, nd, cfg, rng, n_live, F):
    """A frontier of n_live live entries (capacity F): the ranges of
    suffixes of 2 to 4 symbols of the patterns pt, costs drawn from
    {0, ..., cost_bound - 1, NO_COST} per state (state 0 live)."""
    import torch

    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import search_ops as S

    dev = pt.device
    cut = pt.clone()
    cut[:, : pt.shape[1] - int(rng.integers(2, 5))] = -1
    f, l = S.backward_search(ix.arrays, ix.meta.n_rows, cut,
                             row0=ix.meta.row0)
    live = torch.nonzero(l > f).flatten()
    check(live.numel() > 0, "no non-empty pattern range")
    live = live.repeat(-(-n_live // live.numel()))[:n_live]
    first = torch.zeros(F, dtype=torch.int32, device=dev)
    last = torch.zeros(F, dtype=torch.int32, device=dev)
    first[:n_live], last[:n_live] = f[live], l[live]
    vals = np.append(np.arange(cfg.cost_bound), RO.NO_COST)
    c = vals[rng.integers(0, len(vals), size=(F, nd.S))].astype(np.int32)
    c[:, 0] = 0
    costs = torch.from_numpy(c).to(dev)
    return first, last, costs


def segment_kind_ranges(ix, rng, k=64):
    """Up to k (first, last) ranges of a row-tier index whose ends lie on
    its side and continued run-length segments (segment_kind_rows, end
    rows paired and ordered), or None where it has neither."""
    import torch

    from femto_tpu_torch.ops import rank as R

    if not R.is_row_tier(ix.arrays):
        return None
    kinds = segment_kind_rows(ix.arrays, ix.meta.n_rows,
                              R.seg_size(ix.arrays), rng, k)
    if not kinds:
        return None
    r = torch.cat(list(kinds.values()))
    r = r[torch.randperm(r.numel(), generator=torch.Generator().manual_seed(
        int(rng.integers(0, 2**31))))]
    h = min(k, r.numel() // 2)
    a, b = r[:h], r[h: 2 * h]
    return torch.minimum(a, b), torch.maximum(a, b) + 1


def edge_ranges(ix):
    """(first, last) ranges between rank_edge_rows' row0 - 1, row0,
    row0 + 1, n_rows - 1 and n_rows (those at or past 0, first < last),
    int32 on the CPU."""
    import torch

    meta = ix.meta
    ends = sorted({r for r in (meta.row0 - 1, meta.row0, meta.row0 + 1,
                               meta.n_rows - 1, meta.n_rows) if r >= 0})
    pairs = [(a, b) for a in ends for b in ends if a < b]
    return (torch.tensor([a for a, _ in pairs], dtype=torch.int32),
            torch.tensor([b for _, b in pairs], dtype=torch.int32))


def parity_query_layer(ix, tag, pt, rng, errs, r_forced=None):
    """One layer of regex_fork + H + regex_merge from fixed frontiers,
    kernel against plain, exact, approximate and over the wide NFA; the
    merge also at capacities that overflow; regex_fork also on each rank
    route forced (r_forced: rank_forced's builds), where on a row tier
    the frontier's first entries span rows of side and continued
    segments, and the next ones ranges between row0 - 1, row0, row0 + 1,
    n_rows - 1 and n_rows (edge_ranges)."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import sort_ops as SO
    from femto_tpu_torch.query import regexp_device as RD

    dev = pt.device
    kinds = segment_kind_ranges(ix, rng)
    for kind, q, n_live, F, depth in (
            ("exact", '(the|and|[a-z]i)n[gd] ', 300, 512, 1),
            ("approx", "APPROX 2 there", 300, 512, 2),
            ("approx1 depth0", "APPROX 1 ther", 200, 256, 0),
            ("wide", WIDE_NFA_QUERY, 6, 8, 3)):
        node, nfa = query_nfa(q)
        nd, cfg, _ = RD._initial_state(ix, nfa, node.approx, F, 64)
        first, last, costs = fixed_frontier(ix, pt, nd, cfg, rng, n_live, F)
        h = 0
        if kinds is not None:
            h = min(kinds[0].numel(), n_live)
            first[:h], last[:h] = kinds[0][:h].to(dev), kinds[1][:h].to(dev)
        e_f, e_l = edge_ranges(ix)
        e = min(e_f.numel(), n_live - h)
        first[h: h + e], last[h: h + e] = e_f[:e].to(dev), e_l[:e].to(dev)
        name = f"regex_fork[{tag}]({kind})"
        got = RO.regex_fork(ix.arrays, first, last, costs, n_live, nd, cfg,
                            depth > 0)
        want = RO.regex_fork_plain(ix.arrays, first, last, costs, n_live,
                                   nd, cfg, depth > 0)
        torch.cuda.synchronize()
        errs[name] = max_abs_err(name, got, want)
        for route, lib in (r_forced or {}).items():
            with kernels.variant("regex_frontier", lib):
                alt = RO.regex_fork(ix.arrays, first, last, costs, n_live,
                                    nd, cfg, depth > 0)
            torch.cuda.synchronize()
            errs[f"{name}, {route} route"] = max_abs_err(
                f"{name}, {route} route", alt, want)
        keys, fcosts = got
        skeys, sidx = SO.radix_sort_pairs(keys, None, 0, 2 * cfg.half_bits)
        for F2, R2 in ((F, 4096), (4, 3)):
            bufs = {who: [first[:F2].clone(), last[:F2].clone(),
                          costs[:F2].clone(),
                          torch.full((4, R2), 7, dtype=torch.int32,
                                     device=dev),
                          torch.tensor([2, 0, 0, 0, 0, 0, 0, 0],
                                       dtype=torch.int32, device=dev)]
                    for who in ("kernel", "plain")}
            RO.regex_merge(skeys, sidx, fcosts, nd, cfg, depth,
                           *bufs["kernel"])
            RO.regex_merge_plain(skeys, sidx, fcosts, nd, cfg, depth,
                                 *bufs["plain"])
            torch.cuda.synchronize()
            mname = f"regex_merge[{tag}]({kind}, F={F2}, R={R2})"
            errs[mname] = max_abs_err(mname, bufs["kernel"], bufs["plain"])
        if kind == "exact":
            check(int(bufs["kernel"][4][1]) == 1,
                  f"{tag}: the merge at capacity 4 did not overflow")


def parity_query_kernels(indexes, pt, rng, errs, whole, r_forced=None):
    """Kernel C's backward_step and backward_search_steps and kernel R on
    every index of the parity phase, each against its plain version bit
    for bit (regex_fork also on each rank route forced: r_forced); on
    the indexes in `whole`, a whole run_regexp_device on the card
    against the same search on a CPU copy of the index (the plain
    versions), exact and approximate, with a forced capacity retry."""
    import torch

    from femto_tpu_torch import query as Q
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.query import regexp_device as RD

    dev = pt.device
    for name, ix in indexes.items():
        A, nn = ix.arrays, ix.meta.n_rows
        B = 8192
        c = rng.integers(-1, 300, size=B).astype(np.int32)
        c[: B // 8] = -1                      # the host engine's pad lanes
        ends = np.sort(rng.integers(0, nn + 1, size=(B, 2)), axis=1)
        ends[: 64] = (0, nn)
        ct = torch.from_numpy(c).to(dev)
        ft = torch.from_numpy(ends[:, 0].astype(np.int32)).to(dev)
        lt = torch.from_numpy(ends[:, 1].astype(np.int32)).to(dev)
        got = S.backward_step_pair(A, ct, ft, lt)
        want = S.backward_step_plain(A, ct, ft, lt)
        torch.cuda.synchronize()
        errs[f"backward_step[{name}]"] = max_abs_err(
            f"backward_step[{name}]", got, want)
        valid = (c >= 0) & (c < 261)
        check(not bool((got[1][torch.from_numpy(~valid).to(dev)]
                        != 0).any()),
              f"{name}: a pad or out-of-alphabet lane gave a range")
        got = S.backward_search_steps(A, nn, pt)
        want = S.backward_search_steps_plain(A, nn, pt)
        torch.cuda.synchronize()
        errs[f"backward_search_steps[{name}]"] = max_abs_err(
            f"backward_search_steps[{name}]", got, want)
        c_f, c_l = S.backward_search(A, nn, pt)
        ne = got[1] > got[0]
        check(torch.equal(got[0][ne], c_f[ne])
              and torch.equal(got[1][ne], c_l[ne])
              and bool((c_l[~ne] <= c_f[~ne]).all()),
              f"{name}: backward_search_steps' range differs from C's")
        parity_query_layer(ix, name, pt, rng, errs, r_forced)
    runs = {}
    for name in whole:
        ix = indexes[name]
        cpu = cpu_copy(ix)
        for q, fcap in (('("the "|"and "|"ing "|"ion ")', 2),
                        ("APPROX 1 ther", 4)):
            node, nfa = query_nfa(q)
            kw = dict(frontier_cap=fcap, results_cap=64, with_strings=True)
            got = RD.run_regexp_device(ix, nfa, node.approx, **kw)
            stats = dict(RD.last_stats)
            want = RD.run_regexp_device(cpu, nfa, node.approx, **kw)
            check(match_tuples(got) == match_tuples(want),
                  f"run_regexp_device on {name} ({q}) differs from its "
                  f"plain version")
            check(stats["retries"] >= 1, f"{name} {q}: no capacity retry")
            host = Q.run_regexp(ix, nfa, node.approx)
            check(match_tuples(got) == match_tuples(host),
                  f"{name} {q}: the device frontier differs from the host "
                  f"engine")
            runs[f"{name} {q}"] = {"matches": len(got), **stats}
    log(f"    query kernels equal their plain versions on {sorted(indexes)}"
        f"; whole device searches with capacity retries: {runs}")
    return runs


def shared_segment_ranges(ix, rng, k=256):
    """k (first, last) ranges whose two ends lie in one segment (drawn
    segments, the last one's pad rows included, and offsets; empty ones
    where the offsets meet), and k // 16 with first > last, int64 numpy."""
    from femto_tpu_torch.ops import rank as R

    seg, n_seg = R.seg_size(ix.arrays), ix.meta.n_seg
    s = rng.integers(0, n_seg, k)
    s[:4] = n_seg - 1
    a = s * seg + rng.integers(0, seg, k)
    b = s * seg + rng.integers(0, seg, k)
    a[4:8] = b[4:8]
    first, last = np.minimum(a, b), np.maximum(a, b)
    h = k // 16
    return (np.concatenate([first, last[:h]]),
            np.concatenate([last, first[:h]]))


def count_lanes(ix, rng, B):
    """B lanes (c, first, last) of kernel C's one-step entries, int32 on the
    index's device: symbols of the index's alphabet, -1 on an eighth of
    the lanes, 300 (outside the alphabet) and, on a remapped index,
    symbols absent from it on others; ranges whose ends share a segment
    (shared_segment_ranges, some reversed), end on side and continued
    segments (segment_kind_ranges), lie between row0 - 1, row0, row0 + 1,
    n_rows - 1 and n_rows (edge_ranges), the whole range and drawn
    ranges, repeated up to B."""
    import torch

    from femto_tpu_torch.ops import rank as R

    A, meta = ix.arrays, ix.meta
    parts = [shared_segment_ranges(ix, rng)]
    kinds = segment_kind_ranges(ix, rng)
    if kinds is not None:
        parts.append((kinds[0].numpy(), kinds[1].numpy()))
    e_f, e_l = edge_ranges(ix)
    parts.append((e_f.numpy(), e_l.numpy()))
    parts.append((np.array([meta.row0]), np.array([meta.n_rows])))
    ends = np.sort(rng.integers(0, meta.n_rows + 1, size=(B, 2)), axis=1)
    parts.append((ends[:, 0], ends[:, 1]))
    first = np.concatenate([p[0] for p in parts]).astype(np.int32)
    last = np.concatenate([p[1] for p in parts]).astype(np.int32)
    first, last = np.resize(first, B), np.resize(last, B)
    if R.is_remapped(A):
        amap = A.alpha_map.cpu().numpy()
        syms, absent = np.nonzero(amap >= 0)[0], np.nonzero(amap < 0)[0]
    else:
        syms, absent = np.arange(261), np.zeros(0, np.int64)
    c = syms[rng.integers(0, len(syms), B)].astype(np.int32)
    c[::8] = -1
    c[3::17] = 300
    if len(absent):
        c[5::13] = absent[rng.integers(0, len(absent), len(c[5::13]))]
    dev = A.C.device
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (c, first, last))


def parity_count_routes(cases, forced, rng, errs):
    """Phase 3's hold of kernel C on both routes (forced: c_forced's
    builds) and as built, all four entries against their plain versions
    bit for bit: cases {name: (index, int32[B, P] patterns)};
    backward_search and backward_search_steps from row0 to n_rows at the
    patterns' B and at 1 and 5 of them, backward_step (and on the row
    tiers backward_step_masked) on count_lanes' lanes at B = 1, 5 and
    4096.  Returns {name: {route: the calls that take it as built}}."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.ops import search_ops as S

    rec = {}
    for name, (ix, pt) in cases.items():
        A, meta = ix.arrays, ix.meta
        nr, r0 = meta.n_rows, meta.row0
        runs = {}
        for B in (pt.shape[0], 1, 5):
            p = pt[:B].contiguous()
            runs[f"backward_search(B={B})"] = (
                B, lambda p=p: S.backward_search(A, nr, p, r0),
                lambda p=p: S.backward_search_plain(A, nr, p, r0))
            runs[f"backward_search_steps(B={B})"] = (
                B, lambda p=p: S.backward_search_steps(A, nr, p, r0),
                lambda p=p: S.backward_search_steps_plain(A, nr, p, r0))
        for B in (4096, 1, 5):
            lanes = count_lanes(ix, rng, B)
            runs[f"backward_step(B={B})"] = (
                B, lambda ln=lanes: S.backward_step_pair(A, *ln),
                lambda ln=lanes: S.backward_step_plain(A, *ln))
            if R.is_row_tier(A):
                runs[f"backward_step_masked(B={B})"] = (
                    B, lambda ln=lanes: S.backward_step_masked(A, *ln),
                    lambda ln=lanes: S.backward_step_masked_plain(A, *ln))
        rec[name] = {}
        for key, (B, run_k, run_p) in runs.items():
            want = run_p()
            tag = f"{key.split('(')[0]}[{name}]({key.split('(')[1]}"
            errs[tag] = max_abs_err(tag, run_k(), want)
            for route, lib in forced.items():
                with kernels.variant("backward_search", lib):
                    got = run_k()
                torch.cuda.synchronize()
                errs[f"{tag}, {route} route"] = max_abs_err(
                    f"{tag}, {route} route", got, want)
            route = c_route(A, B, key.split("(")[0])
            rec[name][route] = rec[name].get(route, 0) + 1
    log(f"    C: both routes and the build's own equal the plain versions "
        f"on every entry: {rec}")
    return rec


# steps of each walk in phase 3's hold of kernel E's routes
PSI_STEPS = 64


def psi_edge_rows(A, rng, extra_segs=(), k=64):
    """Rows of phase 3's hold of kernel E on one index, int32 on its
    device: C[c] and C[c+1] - 1 of every present code; the rows whose
    step lands on the first and on the last field of a segment (segment
    0, the last one and k drawn ones), on offsets of the last segment, of
    `extra_segs` and of k drawn side and continued segments (the
    segment's first two and last two offsets and 16 drawn ones): LF of
    each such row (psi's inverse), on rows that hold a code; and the rows
    1 to 12 text positions before each document's end (LF steps back
    from its SEOF row), whose walks cross it."""
    import torch

    from femto_tpu_torch.ops import rank as R

    seg, n_seg, K = R.seg_size(A), R.n_segments(A), R.alpha_count(A)
    C = A.C.long()
    n = int(C[K])
    present = torch.nonzero(C[1:] > C[:-1]).flatten()
    starts = torch.cat([C[present], C[present + 1] - 1])
    s = np.concatenate([[0, n_seg - 1], rng.integers(0, n_seg, k)])
    xs = [s * seg, s * seg + seg - 1]
    segs = [n_seg - 1, *extra_segs]
    if R.is_row_tier(A):
        woff = A.seg_woff.cpu().numpy()
        for kind in (np.nonzero(woff > 0)[0], np.nonzero(woff < -1)[0]):
            if len(kind):
                segs += kind[rng.integers(0, len(kind), k)].tolist()
    offs = np.concatenate([[0, 1, seg - 2, seg - 1],
                           rng.integers(0, seg, 16)])
    xs += [t * seg + offs for t in np.unique(np.array(segs, np.int64))]
    x = torch.from_numpy(np.concatenate(xs).astype(np.int64)).to(C.device)
    x = torch.unique(x[(x >= 0) & (x < n)]).to(torch.int32)
    x = x[R.bwt_code_at(A, x) < K]
    rows = [starts, R.lf_step(A, x).long()]
    r = A.doc_seof_rows.to(torch.int32)
    for _ in range(12):
        r = R.lf_step(A, r)
        rows.append(r.long())
    return torch.cat(rows).to(torch.int32).contiguous()


def parity_psi_routes(cases, forced, rng, errs):
    """Phase 3's hold of kernel E on both routes (forced: e_forced's
    builds) and as built, against psi_walk_plain bit for bit, PSI_STEPS
    steps: cases {name: (index, extra segments)}; psi_edge_rows' rows, all
    of them, the first and the first 5.  Returns {name: {"rows": their
    number, route: the calls that take it as built}}."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    rec = {}
    for name, (ix, extra) in cases.items():
        A = ix.arrays
        rows = psi_edge_rows(A, rng, extra)
        rec[name] = {"rows": int(rows.numel())}
        for B in (rows.shape[0], 1, 5):
            r = rows[:B].contiguous()
            want = [S.psi_walk_plain(A, r, PSI_STEPS)]
            tag = f"psi_walk[{name}](B={B})"
            errs[tag] = max_abs_err(tag, [S.psi_walk(A, r, PSI_STEPS)], want)
            for route, lib in forced.items():
                with kernels.variant("psi_walk", lib):
                    got = [S.psi_walk(A, r, PSI_STEPS)]
                torch.cuda.synchronize()
                errs[f"{tag}, {route} route"] = max_abs_err(
                    f"{tag}, {route} route", got, want)
            route = e_route(A, B)
            rec[name][route] = rec[name].get(route, 0) + 1
    log(f"    E: both routes and the build's own equal the plain version: "
        f"{rec}")
    return rec


# rows a plain all-symbol rank takes at once (its lanes are rows x 261)
RANK_CHUNK = 128


def masked_occ_rows_in_chunks(arrays, rows, **kw):
    """masked_occ_rows_plain over RANK_CHUNK rows at a time (a row's
    answers are its own)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    return torch.cat([DO.masked_occ_rows_plain(arrays, rows[i: i + RANK_CHUNK],
                                               **kw)
                      for i in range(0, rows.numel(), RANK_CHUNK)], dim=1)


def rank_edge_rows(ix, rng, nseg_local=None, k=64):
    """Rows for the all-symbol rank's holds (int32 on the index's
    device): row0 and its neighbours, the ends of the first, second,
    middle and last segments (and of each shard's block, given
    nseg_local), rows of the last segment, n_rows, the segments' end, rows
    of side and continued segments (segment_kind_rows) and drawn rows."""
    import torch

    from femto_tpu_torch.ops import rank as R

    A, meta = ix.arrays, ix.meta
    seg, n_seg = R.seg_size(A), meta.n_seg
    end = n_seg * seg
    rows = [meta.row0 - 1, meta.row0, meta.row0 + 1, meta.n_rows - 1,
            meta.n_rows, meta.n_rows + 1, end - 1, end]
    for s_ in (1, 2, n_seg // 2, n_seg - 1):
        rows += [s_ * seg - 1, s_ * seg, s_ * seg + 1, (s_ + 1) * seg - 1]
    if nseg_local is not None:
        for b in range(nseg_local * seg, end, nseg_local * seg):
            rows += [b - 1, b, b + 1]
    rows += list(range((n_seg - 1) * seg, end, max(1, seg // 64)))
    rows += list(rng.integers(0, end, size=k))
    if R.is_row_tier(A):
        for r in segment_kind_rows(A, meta.n_rows, seg, rng, k).values():
            rows += r.tolist()
    r = np.unique(np.clip(np.asarray(rows, np.int64), 0, end))
    return torch.from_numpy(r.astype(np.int32)).to(A.C.device)


def parity_rank_rows(indexes, forced, rng, errs):
    """Phase 3's hold of the all-symbol rank (csrc/fm_common.cuh
    warp_rank_row) at edge rows (rank_edge_rows) of every parity index,
    through K18f's masked_occ_rows on the index as one shard (Dl 1) as
    built and on each route forced (forced: rank_forced's builds of
    csrc/dist_query.cu), against its plain version bit for bit.  {index:
    rows, the route as built}."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.ops import search_ops as S

    rec = {}
    for name, ix in indexes.items():
        A = ix.arrays
        n_seg, seg = ix.meta.n_seg, R.seg_size(A)
        rows = rank_edge_rows(ix, rng)
        kw = dict(Dl=1, nseg_local=n_seg, shard0=0,
                  n_rows_total=n_seg * seg)
        want = masked_occ_rows_in_chunks(A, rows, **kw)
        key = f"masked_occ_rows[{name}] (one shard, edge rows)"
        errs[key] = max_abs_err(key, [DO.masked_occ_rows(A, rows, **kw)],
                                [want])
        for route, lib in forced.items():
            with kernels.variant("dist_query", lib):
                got = DO.masked_occ_rows(A, rows, **kw)
            torch.cuda.synchronize()
            errs[f"{key}, {route} route"] = max_abs_err(
                f"{key}, {route} route", [got], [want])
        smem = kernels.size("masked_occ_rows_route", S.fm_view(A)[0],
                            rows.numel(), 1)
        rec[name] = {"rows": rows.numel(),
                     "route": "rows" if smem else "codes",
                     "block_bytes": smem}
        del want
    log(f"    the all-symbol rank (masked_occ_rows as one shard) equals its "
        f"plain version at edge rows on both routes: {rec}")
    return rec


def phase_parity(record, rng, route_builds):
    """Every kernel against its plain version on an 8 MiB corpus."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.search import pack_patterns
    from femto_tpu_torch.alphabet import pattern_to_alpha

    dev = torch.device("cuda")
    docs = small_docs(rng)
    prepared = tt.prepare_documents(docs)
    n, ndocs, seg = prepared.n, prepared.num_docs, 256
    n_seg = n // seg + 1
    text = text_tensor(prepared, dev)
    ds = torch.from_numpy(prepared.doc_starts.astype(np.int32)).to(dev)
    errs = {}

    parity_gather_edges(rng, errs)
    regimes = parity_sort_kernels(rng, docs, prepared, text, ds, errs)
    payload = BO.build_sa_payload(text, ds, n=n, mark_period=20, ndocs=ndocs)
    sa, pull = tt.suffix_array(text, payload=payload)
    parity_chunked(docs, prepared, sa, ds, errs)
    a_k = BO.occ_build(pull, n_seg=n_seg, seg=seg)
    a_p = BO.occ_build_plain(pull, n_seg=n_seg, seg=seg)
    torch.cuda.synchronize()
    errs["occ_build"] = max_abs_err("occ_build", a_k, a_p)
    for mp in (20, 0):
        pl = BO.build_sa_payload(text, ds, n=n, mark_period=mp, ndocs=ndocs)
        a_row = (pl[sa.long()] >> 9).to(torch.int32)  # the script's own
        kw = dict(n_seg=n_seg, seg=seg, mark_period=mp, ndocs=ndocs)
        b_k = BO.marks_build(sa, a_row, **kw)
        b_p = BO.marks_build_plain(sa, a_row, **kw)
        torch.cuda.synchronize()
        errs[f"marks_build(mark_period={mp})"] = max_abs_err(
            f"marks_build(mark_period={mp})", b_k, b_p)

    # A' and F alone: the identity columns (compact tier) and the text's
    # dense alphabet (packed tier)
    n_seg16 = -(-n_seg // 16) * 16
    for tag, arev in (("identity", torch.arange(261, dtype=torch.int32,
                                                  device=dev)),
                      ("dense", torch.unique(text).to(torch.int32))):
        amap = torch.full((261,), -1, dtype=torch.int32, device=dev)
        amap[arev.long()] = torch.arange(arev.shape[0], dtype=torch.int32,
                                         device=dev)
        kw = dict(n_seg=n_seg16, seg=seg)
        got = BO.occ_build_compact(pull, amap, arev, **kw)
        want = BO.occ_build_compact_plain(pull, arev, **kw)
        torch.cuda.synchronize()
        errs[f"occ_build_compact({tag})"] = max_abs_err(
            f"occ_build_compact({tag})", got, want)
        pw, bits = BO.pack_widths(arev.shape[0])
        f_k = BO.pack_build(got[0], amap, per_word=pw, bits=bits)
        f_p = BO.pack_build_plain(got[0], amap, per_word=pw, bits=bits)
        torch.cuda.synchronize()
        errs[f"pack_build({tag})"] = max_abs_err(f"pack_build({tag})",
                                                 [f_k], [f_p])

    # M and N alone, then the whole build of each tier on the card against
    # the one on the CPU; packed31 is the packed tier at the main path's
    # 31-symbol alphabet; the prose builds are held below
    prose = tt.prepare_documents(prose_docs(int(PARITY_PROSE_MIB * 2**20)))
    edges = parity_row_kernels(prepared, prose, docs, errs)
    small = tt.prepare_documents(docs[:32])
    builds = {
        "full": (prepared, seg, dict(locate="direct")),
        "compact": (prepared, seg, {}),
        "packed": (prepared, seg, {}),
        "packed31": (small, seg, {}),
        "vseg": (prepared, seg, {}),
        "vrle": (prepared, seg, {}),
        "prose_full": (prose, PROSE_SEG, dict(locate="direct")),
        "prose_vseg": (prose, PROSE_SEG, {}),
        "prose_vrle": (prose, PROSE_SEG, {}),
    }
    indexes = {}
    for name, (prep, bseg, extra) in builds.items():
        tier = name.split("_")[-1].rstrip("0123456789")
        ix = tt.build_index(prep, seg=bseg, mark_period=20, tier=tier,
                            device="cuda", **extra)
        ix_cpu = tt.build_index(prep, seg=bseg, mark_period=20, tier=tier,
                                device="cpu")
        for k, v in ix_cpu.arrays._asdict().items():
            w = getattr(ix.arrays, k)
            check((v is None) == (w is None), f"{name} field {k}")
            if v is not None:
                max_abs_err(f"build_index({name}) field {k}", [w.cpu()],
                            [v])
        check(dataclasses.asdict(ix.meta) == dataclasses.asdict(ix_cpu.meta),
              f"{name}: meta differs between card and CPU builds")
        indexes[name] = ix
    check(torch.equal(indexes["full"].sa_direct, sa), "sa_direct differs")
    check(indexes["packed31"].meta.alpha_used == 31,
          "the zipf corpus should have 31 symbols")
    check(indexes["vseg"].meta.alpha_used > 256,
          "the parity corpus should need u16 symbol lists")
    prose_ix = {k[6:]: indexes.pop(k) for k in list(indexes)
                if k.startswith("prose_")}

    pats = []
    for _ in range(4000):
        d = int(rng.integers(0, len(docs) - 1))
        L = int(rng.integers(1, 41))
        if len(docs[d]) > L:
            o = int(rng.integers(0, len(docs[d]) - L))
            pats.append(docs[d][o: o + L])
    pats += [b"", b"\x00\x01\x02absent\xff", docs[-2][:300], b"e" * 60]
    packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
    packed[B - 1, -3] = 300  # a code outside the alphabet
    pt = torch.from_numpy(packed).to(dev)
    rows = torch.cat([
        torch.from_numpy(rng.integers(0, n, size=32768).astype(np.int32)),
        torch.arange(0, 2048, dtype=torch.int32)]).to(dev)
    rows = torch.cat([rows, indexes["full"].arrays.doc_seof_rows])
    for name, ix in indexes.items():
        arrays, nn = ix.arrays, ix.meta.n
        ok_rows = rows if nn == n else rows[rows < nn]
        c_k = S.backward_search(arrays, nn, pt)
        c_p = S.backward_search_plain(arrays, nn, pt)
        d_k = S.locate_rows(arrays, 20, ok_rows)
        d_p = S.locate_rows_plain(arrays, 20, ok_rows)
        er = ok_rows[:512].contiguous()
        e_k = S.extract_backward(arrays, er, 300)
        e_p = S.extract_backward_plain(arrays, er, 300)
        p_k = S.psi_walk(arrays, er, 40)
        p_p = S.psi_walk_plain(arrays, er, 40)
        torch.cuda.synchronize()
        errs[f"backward_search[{name}]"] = max_abs_err(
            f"backward_search[{name}]", c_k, c_p)
        errs[f"lf_locate[{name}]"] = max_abs_err(f"lf_locate[{name}]",
                                                 [d_k], [d_p])
        errs[f"lf_extract[{name}]"] = max_abs_err(f"lf_extract[{name}]",
                                                  e_k, e_p)
        errs[f"psi_walk[{name}]"] = max_abs_err(f"psi_walk[{name}]",
                                                [p_k], [p_p])
        if nn == n:
            check(torch.equal(d_k, sa[ok_rows.long()]),
                  f"{name}: walk locate != suffix array")
            # psi walks forward through the text: chars[:, t] = text[sa + t]
            # up to and including the document's SEOF
            pos = sa[er.long()].long()[:, None] + torch.arange(40, device=dev)
            want = text[pos.clamp(max=n - 1)]
            seof = (want == 2).int()
            upto = (torch.cumsum(seof, dim=1) - seof) == 0
            check(torch.equal(p_k[upto], want[upto]),
                  f"{name}: psi walk != the text after each row")
            counts = (c_k[1] - c_k[0])[: B - 1].cpu().numpy()
            check((counts[:-5] >= 1).all(),
                  f"{name}: a sliced pattern was not found")
            for d in (0, len(docs) - 4, len(docs) - 3, len(docs) - 2,
                      len(docs) - 1):
                check(tt.extract_document(ix, d) == docs[d],
                      f"{name}: extract doc {d}")
    prose_rec = parity_prose_search(prose, prose_ix, rng, errs, edges)
    d_libs = route_libs(route_builds["lf_walk"], "lf_walk")
    d_routes = parity_extract_routes(
        {**indexes, **{f"prose_{k}": v for k, v in prose_ix.items()
                       if k != "full"}}, d_libs, rng, errs)
    # locate on the row tiers, also on prose builds at mark_period 3
    psa = prose_ix["full"].sa_direct
    d_locate = parity_locate_routes(
        {**{lay: (indexes[lay], sa) for lay in ROW_LAYOUTS},
         **{f"prose_{lay}": (prose_ix[lay], psa) for lay in ROW_LAYOUTS},
         **{f"prose_{lay}_mp3": (tt.build_index(
             prose, seg=PROSE_SEG, mark_period=3, tier=lay, device="cuda"),
             psa) for lay in ROW_LAYOUTS}}, d_libs, rng, errs)
    del psa
    r_forced = rank_forced(route_builds, "regex_frontier")
    query_runs = parity_query_kernels(
        {**indexes, **{f"prose_{k}": v for k, v in prose_ix.items()}}, pt,
        rng, errs, whole=LAYOUTS, r_forced=r_forced)
    # pad_shape builds (row0 > 0; remapped on vseg and vrle): kernel R's
    # layers and the all-symbol rank at the pad rows, on both routes
    pads = {f"pad_{tier}": tt.build_index(
        prepared, seg=seg, mark_period=20, tier=tier, device="cuda",
        pad_shape=(n + 5000, ndocs + 2)) for tier in ("full", "vseg", "vrle")}
    for name, ix in pads.items():
        check(ix.meta.row0 > 0, f"{name}: row0 is 0")
        parity_query_layer(ix, name, pt, rng, errs, r_forced)
    # kernel C on both routes: every layout, the prose's side and
    # continued segments, the pad_shape builds (row0 > 0); 64 columns, two
    # of the warp route's 32-column loads
    c_libs = c_forced(route_builds)
    pt64 = pt[:, -64:].contiguous()
    ppt = text_patterns(text_tensor(prose, dev), rng, 2048, 40)
    c_routes = parity_count_routes(
        {**{k: (v, pt64) for k, v in {**indexes, **pads}.items()},
         **{f"prose_{k}": (v, ppt) for k, v in prose_ix.items()}},
        c_libs, rng, errs)
    psi_routes = parity_psi_routes(
        {**{k: (v, ()) for k, v in {**indexes, **pads}.items()},
         **{f"prose_{k}": (v, prose_rec["edge_segments"] if k == "vrle"
                           else ()) for k, v in prose_ix.items()}},
        e_forced(route_builds), rng, errs)
    rank_rows = parity_rank_rows(
        {**indexes, **{f"prose_{k}": v for k, v in prose_ix.items()},
         **pads}, rank_forced(route_builds, "dist_query:rank"), rng, errs)
    del pads
    paged_lcp = parity_paged_lcp(indexes, prose_ix, prepared, docs, text, sa,
                                 rng, errs, d_libs, c_libs)
    del indexes, prose_ix
    sharded = parity_sharded(rng, docs, prepared, sa, errs,
                             route_builds["exchange"], prose,
                             route_builds["dist_query"],
                             rank_forced(route_builds, "dist_query:rank"))
    record["parity_8mib"] = {"n": n, "ndocs": ndocs, "max_abs_err": errs,
                             "sort_regimes": regimes, "prose": prose_rec,
                             "query_runs": query_runs,
                             "rank_rows": rank_rows,
                             "count_routes": c_routes,
                             "psi_routes": psi_routes,
                             "paged_lcp": paged_lcp, "sharded": sharded,
                             "extract_routes": d_routes,
                             "locate_routes": d_locate}
    log(f"[3] 8 MiB parity (n={n}): every kernel equals its plain version "
        f"bit for bit: {sorted(errs)}")


def direct_count(text, pat_codes):
    """Occurrences of a pattern by a scan of the text on the card: the
    candidate starts of its first symbol, filtered symbol by symbol."""
    import torch

    P = len(pat_codes)
    cand = torch.nonzero(text[: text.shape[0] - P + 1] == int(pat_codes[0]))
    cand = cand.flatten()
    for k in range(1, P):
        cand = cand[text[cand + k] == int(pat_codes[k])]
    return int(cand.shape[0])


def check_suffix_order(text, sa, rng):
    """sa is a permutation of 0..n-1, and on N_LOCATE random adjacent row
    pairs the upper row's suffix is the larger one over their first 64
    symbols (the text's end sorts first).  Returns the number of pairs
    that are equal over those 64."""
    import torch

    n = text.shape[0]
    seen = torch.zeros(n, dtype=torch.int32, device=text.device)
    seen.index_add_(0, sa.long(), torch.ones_like(seen))
    check(bool((seen == 1).all()), "sa is not a permutation of 0..n-1")
    del seen
    r = torch.from_numpy(rng.integers(0, n - 1, size=N_LOCATE)).to(sa.device)
    j = torch.arange(64, device=sa.device)
    pa = sa[r].long()[:, None] + j
    pb = sa[r + 1].long()[:, None] + j
    a = torch.where(pa < n, text[pa.clamp(max=n - 1)], -1)
    b = torch.where(pb < n, text[pb.clamp(max=n - 1)], -1)
    differ = a != b
    first = torch.argmax(differ.int(), dim=1)
    decided = differ.any(dim=1)
    rows = torch.arange(N_LOCATE, device=sa.device)
    ok = a[rows, first] < b[rows, first]
    check(bool((ok | ~decided).all()),
          "adjacent rows of sa are out of suffix order")
    return int((~decided).sum())


def phase_main(record, rng):
    """The port's main path at full size, through the user entry points,
    with the kernels' launch counts read around it."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch import suffix as TS
    from femto_tpu_torch.alphabet import pattern_to_alpha

    n_docs = (MAIN_MIB << 20) // DOC_SIZE
    t0 = time.perf_counter()
    docs = zipf_docs(rng, n_docs)
    prepared = tt.prepare_documents(docs)
    n = prepared.n
    # the twin corpus: document 1 a copy of document 0
    twin_docs = [docs[0] if d == 1 else doc for d, doc in enumerate(docs)]
    twin_prepared = tt.prepare_documents(twin_docs)
    t_data = time.perf_counter() - t0
    pd = rng.integers(0, n_docs, size=N_PATTERNS)
    po = rng.integers(0, DOC_SIZE - PATLEN - 2, size=N_PATTERNS)
    patterns = [docs[d][o: o + PATLEN] for d, o in zip(pd, po)]
    loc_rows = rng.integers(0, n, size=N_LOCATE).astype(np.int32)
    ext_docs = [int(d) for d in rng.choice(n_docs - 1, 7, replace=False)]
    ext_docs.append(n_docs - 1)
    log(f"[4] corpus: {MAIN_MIB} MiB zipf English, {n_docs} docs, n={n}, and "
        f"its twin with document 1 a copy of document 0 (made in "
        f"{t_data:.1f}s)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    index = tt.build_index(prepared, seg=256, mark_period=20,
                           locate="direct", device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    sort_stats = dict(TS.last_stats)
    build_launches = dict(kernels.launches)
    walk = dataclasses.replace(index, sa_direct=None)
    t0 = time.perf_counter()
    first, last = tt.count_ranges(walk, patterns)
    t_count = time.perf_counter() - t0
    offs_walk = tt.locate_rows_array(walk, loc_rows)
    offs_direct = tt.locate_rows_array(index, loc_rows)
    matches = []
    for p in patterns:
        if len(matches) >= 256:
            break
        matches += [(p, d, o) for d, o in tt.locate(walk, p)]
    extracted = {d: tt.extract_document(walk, d) for d in ext_docs}
    peak = torch.cuda.max_memory_allocated()  # the main corpus's build
    twin = tt.build_index(twin_prepared, seg=256, mark_period=20,
                          locate="direct", device="cuda")
    twin_stats = dict(TS.last_stats)
    twin_pattern = docs[0][1000: 1000 + 2 * PATLEN]
    twin_matches = sorted(tt.locate(twin, twin_pattern))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"    main path: build {t_build:.2f}s (first call), count "
        f"{t_count:.3f}s, peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    for what, stats in (("main corpus", sort_stats), ("twin corpus",
                                                      twin_stats)):
        log(f"    suffix sort, {what}: {stats['ext_rounds']} extension and "
            f"{stats['dbl_rounds']} doubling rounds, tied after each step "
            f"{stats['tied']} ({stats})")
    idle = [k for k in SORT_KERNELS if not build_launches[k]]
    log(f"    the main corpus's build alone launched {build_launches}; not "
        f"launched there: {idle}"
        + (f" (its {sort_stats['tied'][0]} ties after the first sort were "
           f"gone after {sort_stats['ext_rounds']} extension round(s), so "
           f"the doubling regime was not reached; the twin corpus's build "
           f"reaches it)" if idle else ""))

    counts = last - first
    check((counts >= 1).all(), "a pattern sliced from the text has count 0")
    text = text_tensor(prepared, torch.device("cuda"))
    undecided = check_suffix_order(text, index.sa_direct, rng)
    twin_text = text_tensor(twin_prepared, torch.device("cuda"))
    twin_undecided = check_suffix_order(twin_text, twin.sa_direct, rng)
    twin_sa = twin.sa_direct  # phase 4g's LCP of the twin
    del twin_text, twin
    check(twin_matches[:2] == [(0, 1000), (1, 1000)],
          f"twin corpus: a pattern of document 0 located at {twin_matches}")
    check(twin_stats["dbl_rounds"] >= 1,
          "the twin corpus's sort ran no doubling round")
    for i in rng.choice(N_PATTERNS, 32, replace=False):
        want = direct_count(text, pattern_to_alpha(patterns[i]))
        check(int(counts[i]) == want,
              f"count of pattern {i}: {int(counts[i])} != scan {want}")
    check(np.array_equal(offs_walk, offs_direct),
          "walk locate differs from sa_direct[rows]")
    check(len(matches) >= 256, "fewer than 256 matches located")
    for p, d, o in matches[:256]:
        check(docs[d][o: o + len(p)] == p, f"located match {d}:{o} wrong")
    for d, got in extracted.items():
        check(got == docs[d], f"extract_document({d}) differs")
    for name in PATH_KERNELS["full"]:
        check(launches[name] >= 1,
              f"kernel {name} was not launched on the main path")
    log(f"    checks: sa is a permutation in suffix order on {N_LOCATE} "
        f"adjacent row pairs ({undecided} equal over 64 symbols; the twin "
        f"corpus's too, {twin_undecided} equal, and its duplicate is "
        f"located in documents 0 and 1), counts >= "
        f"1, 32 sampled counts == text scan, walk == direct on {N_LOCATE} "
        f"rows, 256 matches in the text, {len(ext_docs)} documents "
        f"extracted exactly")
    record["main_path"] = {
        "mib": MAIN_MIB, "n": n, "ndocs": n_docs, "seg": 256,
        "mark_period": 20,
        "first_build_s": t_build, "peak_device_bytes": peak,
        "n_marks": index.meta.n_marks, "launches": launches,
        "launches_of_the_first_build": build_launches,
        "suffix_sort": sort_stats, "suffix_sort_twin": twin_stats,
    }
    return dict(prepared=prepared, twin_prepared=twin_prepared, docs=docs,
                index=index, walk=walk, twin_sa=twin_sa,
                text=text, patterns=patterns, loc_rows=loc_rows,
                ext_docs=ext_docs, launches=launches, first=first, last=last,
                offs_direct=offs_direct)


def phase_tiers(record, rng, st):
    """The second main path, on phase 4's corpus: the compact and packed
    tiers built on the card, the packed index through a .ftpu file and
    back, count / locate / extract on both held to the full tier, and
    extract_context_batch and range_docs on all three tiers held to the
    documents, with the kernels' launch counts read around this phase."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels

    prepared, docs, walk = st["prepared"], st["docs"], st["walk"]
    n = prepared.n
    twin_pattern = docs[0][1000: 1000 + 2 * PATLEN]
    sa = st["index"].sa_direct
    first, last = st["first"], st["last"]
    patterns, loc_rows, ext_docs = (st["patterns"], st["loc_rows"],
                                    st["ext_docs"])
    pick = rng.integers(0, 1 << 30, size=N_CONTEXT)
    ctx_rows = first[:N_CONTEXT] + pick % (last - first)[:N_CONTEXT]
    rd_docs = rng.integers(0, len(docs), size=N_RANGES)
    rd_offs = rng.integers(0, DOC_SIZE - 8, size=N_RANGES)
    rd_pats = [docs[d][o: o + 6] for d, o in zip(rd_docs, rd_offs)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    compact = tt.build_index(prepared, seg=256, mark_period=20,
                             tier="compact", device="cuda")
    packed = tt.build_index(prepared, seg=256, mark_period=20,
                            tier="packed", device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "packed.ftpu")
        t0 = time.perf_counter()
        packed.save_flat(path)
        t_save = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = tt.FMIndex.load(path, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    tiers = {"full": walk, "compact": compact, "packed": loaded}
    got = {}
    for name, ix in tiers.items():
        r = got[name] = {}
        if name != "full":
            r["ranges"] = tt.count_ranges(ix, patterns)
            r["offs"] = tt.locate_rows_array(ix, loc_rows)
            r["extracted"] = {d: tt.extract_document(ix, d)
                              for d in ext_docs}
        r["ctx"] = tt.extract_context_batch(ix, ctx_rows, *CTX)
        rf, rl = tt.count_ranges(ix, rd_pats)
        r["rd_ranges"] = (rf, rl)
        r["rd"] = [tt.range_docs(ix, int(f), int(l)) for f, l in zip(rf, rl)]
    peak = torch.cuda.max_memory_allocated()  # the main corpus's builds
    twin = tt.build_index(st["twin_prepared"], seg=256, mark_period=20,
                          tier="compact", device="cuda")
    twin_matches = sorted(tt.locate(twin, twin_pattern))
    del twin
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"[4b] compact + packed build {t_build:.2f}s (first calls); .ftpu "
        f"{file_bytes} B, save {t_save:.2f}s, load {t_load:.2f}s; peak "
        f"device memory {peak / 2**30:.2f} GiB; launches {launches}")

    check(twin_matches[:2] == [(0, 1000), (1, 1000)],
          f"twin corpus, compact: a pattern of document 0 located at "
          f"{twin_matches}")
    # the .ftpu round trip is exact
    for k, v in packed.arrays._asdict().items():
        w = getattr(loaded.arrays, k)
        check((v is None) == (w is None), f".ftpu field {k}")
        if v is not None:
            max_abs_err(f".ftpu field {k}", [w], [v])
    check(loaded.meta == packed.meta and loaded.infos == packed.infos,
          ".ftpu meta or infos differ")
    check(packed.meta.alpha_used == 31, "the zipf corpus has 31 symbols")
    # counts, locates and extracts of both tiers equal the full tier's
    for name in ("compact", "packed"):
        r = got[name]
        check(np.array_equal(r["ranges"][0], first)
              and np.array_equal(r["ranges"][1], last),
              f"{name}: count ranges differ from the full tier's")
        check(np.array_equal(r["offs"], st["offs_direct"]),
              f"{name}: walk locate differs from sa_direct[rows]")
        for d, b in r["extracted"].items():
            check(b == docs[d], f"{name}: extract_document({d}) differs")
    # contexts equal the documents' bytes around each match
    offs = sa[torch.from_numpy(ctx_rows).to(sa.device)].cpu()
    starts = prepared.doc_starts.astype(np.int64)
    before, plen, after = CTX
    for i, off in enumerate(offs.numpy().astype(np.int64)):
        d = int(np.searchsorted(starts, off, side="right")) - 1
        o = int(off - starts[d])
        want = docs[d][max(0, o - before): o + plen + after]
        for name in tiers:
            check(got[name]["ctx"][i] == want,
                  f"{name}: context of row {ctx_rows[i]} differs")
    # range_docs equal the doc ids of the located offsets
    rf, rl = got["full"]["rd_ranges"]
    for j, (f, l) in enumerate(zip(rf, rl)):
        offs = sa[int(f): int(l)].cpu().numpy().astype(np.int64)
        want = np.unique(np.searchsorted(starts, offs, side="right") - 1)
        for name in tiers:
            check(np.array_equal(got[name]["rd"][j], want),
                  f"{name}: range_docs of range {j} differs")
    for name in PATH_KERNELS["tiers"]:
        check(launches[name] >= 1,
              f"kernel {name} was not launched on the second main path")
    bpc = {name: index_bytes(ix.arrays) / n for name, ix in tiers.items()}
    log(f"    checks: .ftpu round trip exact; both tiers' ranges, {N_LOCATE} "
        f"walk offsets and {len(ext_docs)} extracts equal the full tier's; "
        f"{N_CONTEXT} contexts and {N_RANGES} range_docs equal the "
        f"documents' on all three tiers; the twin corpus's compact index "
        f"locates its duplicate in documents 0 and 1")
    log(f"    index bytes per character: {bpc} (prose blake2b "
        f"{_PROSE['blake2b']})")
    record["tiers_path"] = {
        "first_build_s_compact_and_packed": t_build, "ftpu_bytes": file_bytes,
        "ftpu_save_s": t_save, "ftpu_load_s": t_load,
        "peak_device_bytes": peak, "launches": launches,
        "bytes_per_char": bpc, "alpha_used": packed.meta.alpha_used,
        "n_seg": {name: ix.meta.n_seg for name, ix in tiers.items()},
    }
    return dict(compact=compact, packed=loaded, ctx_rows=ctx_rows,
                launches=launches)


def _serve_row_tiers(tiers, patterns, loc_rows, ext_docs, ctx_rows,
                     rd_pats):
    """count ranges, walk locate, extracts, contexts and range_docs of
    each index in tiers (name -> FMIndex)."""
    import femto_tpu_torch as tt

    got = {}
    for name, ix in tiers.items():
        r = got[name] = {}
        r["ranges"] = tt.count_ranges(ix, patterns)
        r["offs"] = tt.locate_rows_array(ix, loc_rows)
        r["extracted"] = {d: tt.extract_document(ix, d) for d in ext_docs}
        r["ctx"] = tt.extract_context_batch(ix, ctx_rows, *CTX)
        rf, rl = tt.count_ranges(ix, rd_pats)
        r["rd"] = [tt.range_docs(ix, int(f), int(l)) for f, l in zip(rf, rl)]
    return got


def _check_row_answers(what, got, ref, docs):
    """The row tiers' answers equal the reference tier's (and the
    extracts the documents)."""
    for name, r in got.items():
        if name == ref:
            continue
        w = got[ref]
        check(np.array_equal(r["ranges"][0], w["ranges"][0])
              and np.array_equal(r["ranges"][1], w["ranges"][1]),
              f"{what} {name}: count ranges differ from the {ref} tier's")
        check(np.array_equal(r["offs"], w["offs"]),
              f"{what} {name}: walk locate differs from the {ref} tier's")
        for d, b in r["extracted"].items():
            check(b == docs[d], f"{what} {name}: extract_document({d})")
        check(r["ctx"] == w["ctx"],
              f"{what} {name}: contexts differ from the {ref} tier's")
        check(all(np.array_equal(a, b) for a, b in zip(r["rd"], w["rd"])),
              f"{what} {name}: range_docs differ from the {ref} tier's")


def phase_rows(record, rng, st, st2):
    """The third main path (4c): the vseg and vrle tiers built on the card
    (a) from phase 4's 256 MiB zipf corpus and (b) from real prose at
    seg PROSE_SEG, each served through count, locate, extract, context
    and range_docs and held to the full tier; the prose vrle index
    through a .ftpu file and back.  The kernels' launch counts are read
    around this phase."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.search import pack_patterns

    prepared, docs = st["prepared"], st["docs"]
    n = prepared.n
    rd_docs = rng.integers(0, len(docs), size=N_RANGES)
    rd_offs = rng.integers(0, DOC_SIZE - 8, size=N_RANGES)
    rd_pats = [docs[d][o: o + 6] for d, o in zip(rd_docs, rd_offs)]
    # the prose: its bytes are made outside the counted region
    pdocs = prose_docs()
    pprep = tt.prepare_documents(pdocs)
    pn = pprep.n
    pp_d = rng.integers(0, len(pdocs) - 1, size=N_PATTERNS)
    pp_o = rng.integers(0, DOC_SIZE - PATLEN - 2, size=N_PATTERNS)
    ppats = [pdocs[d][o: o + PATLEN] for d, o in zip(pp_d, pp_o)]
    ploc = rng.integers(0, pn, size=N_LOCATE).astype(np.int32)
    pext = [0, len(pdocs) // 2, len(pdocs) - 1]
    prd = [pdocs[d][o: o + 6] for d, o in zip(
        rng.integers(0, len(pdocs) - 1, size=N_RANGES),
        rng.integers(0, DOC_SIZE - 8, size=N_RANGES))]
    log(f"[4c] prose corpus: {pn / 2**20:.4f} MiB in {len(pdocs)} documents "
        f"(seg {PROSE_SEG}, blake2b {_PROSE['blake2b']}), zipf corpus: "
        f"phase 4's")
    # the full tier's answers, the reference, before the counted region
    ctx_rows = st2["ctx_rows"]
    zref = _serve_row_tiers({"full": st["walk"]}, [], [], [], ctx_rows,
                            rd_pats)["full"]
    pfull = tt.build_index(pprep, seg=PROSE_SEG, mark_period=20,
                           locate="direct", device="cuda")
    pwalk = dataclasses.replace(pfull, sa_direct=None)
    pfirst, plast = tt.count_ranges(pwalk, ppats)
    pick = rng.integers(0, 1 << 30, size=N_CONTEXT)
    pctx = pfirst[:N_CONTEXT] + pick % np.maximum(
        (plast - pfirst)[:N_CONTEXT], 1)
    pgot = _serve_row_tiers({"full": pwalk}, ppats, ploc, pext, pctx, prd)

    peaks = {}

    def builds(corpus, prep, seg):
        """Each row tier of prep built once; each build's own peak device
        memory above what was allocated before it."""
        out = {}
        for tier in ROW_LAYOUTS:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out[tier] = tt.build_index(prep, seg=seg, mark_period=20,
                                       tier=tier, device="cuda")
            torch.cuda.synchronize()
            peaks[f"{corpus}_{tier}"] = (torch.cuda.max_memory_allocated()
                                         - before)
        return out

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    zrows = builds("zipf", prepared, 256)
    t_build = time.perf_counter() - t0
    first, last = st["first"], st["last"]
    zgot = _serve_row_tiers(zrows, st["patterns"], st["loc_rows"],
                            st["ext_docs"][:1], ctx_rows, rd_pats)
    t0 = time.perf_counter()
    prows = builds("prose", pprep, PROSE_SEG)
    t_pbuild = time.perf_counter() - t0
    pgot.update(_serve_row_tiers(prows, ppats, ploc, pext, pctx, prd))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prose_vrle.ftpu")
        prows["vrle"].save_flat(path)
        file_bytes = os.path.getsize(path)
        loaded = tt.FMIndex.load(path, device="cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"    builds: zipf vseg + vrle {t_build:.2f}s, prose vseg + vrle "
        f"{t_pbuild:.2f}s (first calls); each build's peak device memory "
        f"above what was allocated before it: "
        f"{ {k: f'{v / 2**30:.3f} GiB' for k, v in peaks.items()} }; "
        f"launches {launches}")
    # C and D on the 256 MiB row tiers against their plain versions, on a
    # share of phase 4's patterns and rows
    pz = st["patterns"][:2048]
    ptz, _ = pack_patterns([pattern_to_alpha(p) for p in pz],
                           pad_b=len(pz))
    ptz = torch.from_numpy(ptz).to(torch.device("cuda"))
    rz = torch.from_numpy(st["loc_rows"][:4096]).to(torch.device("cuda"))
    for lay, ix in zrows.items():
        A = ix.arrays
        max_abs_err(f"backward_search[{lay}](zipf 256 MiB)",
                    S.backward_search(A, n, ptz),
                    S.backward_search_plain(A, n, ptz))
        max_abs_err(f"lf_locate[{lay}](zipf 256 MiB)",
                    [S.locate_rows(A, 20, rz)],
                    [S.locate_rows_plain(A, 20, rz)])
    log(f"    zipf 256 MiB: backward_search and lf_locate on vseg and vrle "
        f"equal their plain versions ({len(pz)} patterns, {rz.numel()} "
        f"rows)")

    # (a) zipf: the full tier's answers (phase 4 / 4b)
    zgot["full"] = {"ranges": (first, last), "offs": st["offs_direct"],
                    "extracted": {}, "ctx": zref["ctx"], "rd": zref["rd"]}
    _check_row_answers("zipf", zgot, "full", docs)
    zmodes = {t: seg_modes(ix.arrays.seg_woff) for t, ix in zrows.items()}
    log(f"    zipf: both row tiers answer as the full tier; segments by "
        f"mode {zmodes}; vrle found "
        f"{'RLE rows' if zrows['vrle'].arrays.seg_rle.shape[0] > 1 else 'no RLE rows'}"
        f" (marker {tuple(zrows['vrle'].arrays.seg_rle.shape)})")
    # (b) prose: the full tier's answers, counts against a text scan
    _check_row_answers("prose", pgot, "full", pdocs)
    ptext = text_tensor(pprep, torch.device("cuda"))
    pcounts = plast - pfirst
    check((pcounts >= 1).all(), "prose: a pattern of the text has count 0")
    for i in rng.choice(N_PATTERNS, 32, replace=False):
        want = direct_count(ptext, pattern_to_alpha(ppats[i]))
        check(int(pcounts[i]) == want,
              f"prose count of pattern {i}: {int(pcounts[i])} != scan {want}")
    check(np.array_equal(pgot["full"]["offs"],
                         pfull.sa_direct[torch.from_numpy(ploc).to(
                             ptext.device).long()].cpu().numpy()),
          "prose: walk locate differs from sa_direct[rows]")
    del ptext
    for k, v in prows["vrle"].arrays._asdict().items():
        w = getattr(loaded.arrays, k)
        check((v is None) == (w is None), f"prose .ftpu field {k}")
        if v is not None:
            max_abs_err(f"prose .ftpu field {k}", [w], [v])
    check(loaded.meta == prows["vrle"].meta, "prose .ftpu meta differs")
    pmodes = {t: seg_modes(prows[t].arrays.seg_woff) for t in ROW_LAYOUTS}
    check(pmodes["vrle"]["rle"] > 0 and pmodes["vrle"]["continuation"] > 0,
          f"the prose vrle index has no RLE or no continuation segments: "
          f"{pmodes['vrle']}")
    for name in PATH_KERNELS["rows"]:
        check(launches[name] >= 1,
              f"kernel {name} was not launched on the third main path")
    bpc = {"zipf": {"full": index_bytes(st["walk"].arrays) / n,
                    "packed": index_bytes(st2["packed"].arrays) / n,
                    **{t: index_bytes(ix.arrays) / n
                       for t, ix in zrows.items()}},
           "prose": {"full": index_bytes(pfull.arrays) / pn,
                     **{t: index_bytes(ix.arrays) / pn
                        for t, ix in prows.items()}}}
    log(f"    prose: full, vseg and vrle answer alike ({N_PATTERNS} counts, "
        f"32 equal to a text scan, {N_LOCATE} locates, {len(pext)} "
        f"extracts, {N_CONTEXT} contexts, {N_RANGES} range_docs); .ftpu "
        f"round trip of vrle exact ({file_bytes} B); segments by mode "
        f"{pmodes}")
    log(f"    index bytes per character: {bpc}")
    record["rows_path"] = {
        "prose_mib": pn / 2**20, "prose_docs": len(pdocs),
        "prose_seconds": _PROSE.get("seconds"), "prose_seg": PROSE_SEG,
        "prose_blake2b": _PROSE.get("blake2b"),
        "first_build_s_zipf": t_build, "first_build_s_prose": t_pbuild,
        "peak_device_bytes_per_build": peaks, "launches": launches,
        "bytes_per_char": bpc, "modes_zipf": zmodes, "modes_prose": pmodes,
        "row_shapes_prose": {t: dict(zip(("n_seg", "total_words"),
                                         ix.arrays.bwt.shape))
                             for t, ix in prows.items()},
        "vrle_marker_zipf": list(zrows["vrle"].arrays.seg_rle.shape),
        "vrle_marker_prose": list(prows["vrle"].arrays.seg_rle.shape),
        "ftpu_bytes_prose_vrle": file_bytes,
    }
    return dict(zrows=zrows, prows=prows, pprep=pprep, ppats=ppats,
                ploc=ploc, pctx=pctx, pext=pext, launches=launches,
                pwalk=pwalk, pfull=pfull)


def scan_starts(docs, pattern, flags=0):
    """{doc: [offsets]} of the distinct match starts of a Python re in each
    document: a lookahead finditer meets every start once."""
    pat = re.compile(b"(?=" + pattern + b")", re.DOTALL | flags)
    out = {}
    for d, doc in enumerate(docs):
        offs = [m.start() for m in pat.finditer(doc)]
        if offs:
            out[d] = offs
    return out


def scan_boolean(node, docs):
    """The documents of a Boolean query over literal terms, from text
    scans of its terms (THEN / WITHIN: a start of the left term with a
    start of the right one within the distance after it, or either side
    for WITHIN; results.then_within's semantics)."""
    import bisect

    from femto_tpu_torch import query as Q
    from femto_tpu_torch.query.ast import as_literal
    from femto_tpu_torch.query.planning import streamline

    def offsets(n):
        lit = as_literal(streamline(n.regexp))
        check(lit is not None, "a Boolean scan needs literal terms")
        return scan_starts(docs, re.escape(lit))

    a, b = offsets(node.left), offsets(node.right)
    if isinstance(node, Q.QAnd):
        return sorted(set(a) & set(b))
    if isinstance(node, Q.QNot):
        return sorted(set(a) - set(b))
    lo = 0 if isinstance(node, Q.QThen) else -node.distance
    keep = []
    for d in sorted(set(a) & set(b)):
        bo = b[d]
        if any(bisect.bisect_right(bo, o + node.distance)
               > bisect.bisect_left(bo, max(o + lo, 0)) for o in a[d]):
            keep.append(d)
    return keep


def query_terms(node):
    from femto_tpu_torch import query as Q

    if isinstance(node, Q.QTerm):
        return [node]
    return query_terms(node.left) + query_terms(node.right)


def row_count(matches):
    from femto_tpu_torch.query.regexp import match_rows

    return sum(l - f for f, l in match_rows(matches))


def steps_patterns(patterns, dev):
    """The patterns with a NUL head, absent from both corpora: the range
    empties at the last step, so backward_search_steps reports the
    pattern's own range as the previous one and its length as matched."""
    import torch

    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.search import pack_patterns

    return torch.from_numpy(pack_patterns(
        [pattern_to_alpha(b"\x00" + p) for p in patterns],
        pad_b=len(patterns))[0]).to(dev)


def phase_query(record, rng, st, st2, st3, builds=None):
    """The fourth main path (4d): the query engine at full size.  (a)
    bench.py's two regex queries through run_regexp_device on phase 4's
    256 MiB zipf full, compact and packed indexes; (b) regex, approximate
    and Boolean queries through count_query, docs_query and find_strings
    on the prose vseg and vrle indexes; the too-few-matches report of
    backward_search_steps on all five.  The device answers are held to
    the host engine on the same index (after the fallback check: the
    device part must launch no backward_step), exact regexes to a text
    scan with Python re, Boolean document sets to scans of their terms.
    The kernels' launch counts are read around the device part (the
    "query" path) and around the host engine's run ("query_host").  Then
    kernel R's regex_fork's device ms summed over one pass of the regex
    and approximate queries, as built and on each rank route (given
    phase_build's builds)."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch import ops as O
    from femto_tpu_torch import query as Q
    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import sort_ops as SO
    from femto_tpu_torch.query import regexp_device as RD
    from femto_tpu_torch.query.engine import apply_icase, term_ranges

    dev = st["walk"].device
    zipf = {"full": st["walk"], "compact": st2["compact"],
            "packed": st2["packed"]}
    prows = st3["prows"]
    docs, pdocs = st["docs"], prose_docs()
    # the references, made outside the counted region
    t0 = time.perf_counter()
    zscan = scan_starts(docs, rb"(?:the |and |ing |ion )")
    pref = {}
    for name, (q, pyre, icase) in PROSE_QUERIES.items():
        node = Q.parse_query(q)
        if pyre is not None:
            pref[name] = scan_starts(pdocs, pyre,
                                     re.IGNORECASE if icase else 0)
        elif not isinstance(node, Q.QTerm):
            pref[name] = scan_boolean(node, pdocs)
    t_scan = time.perf_counter() - t0
    nz = len(st["patterns"]) // 8
    zpat, ppat = st["patterns"][:nz], st3["ppats"][:nz]
    zsteps, psteps = steps_patterns(zpat, dev), steps_patterns(ppat, dev)
    pf_ref = tt.count_ranges(prows["vseg"], ppat)
    log(f"[4d] query path: text scans of the references {t_scan:.1f}s "
        f"(zipf {MAIN_MIB} MiB, prose {len(pdocs)} documents)")

    # the sizes of the path's sorts as kernel H takes them (passed on
    # unchanged), and a copy of the keys of the largest sort of each route
    # and power of two of m, for phase 5 (h_route_rows)
    sort, sorts, largest = SO.radix_sort_pairs, [], {}

    def counted(keys, vals, bit_lo, bit_hi):
        m = keys.shape[0]
        sorts.append((m, bit_lo, bit_hi))
        route = h_route(m, bit_lo, bit_hi)
        bucket = (route, m.bit_length())
        if route is not None and m > largest.get(bucket, (0,))[0]:
            largest[bucket] = (m, keys.clone(), bit_lo, bit_hi)
        return sort(keys, vals, bit_lo, bit_hi)

    torch.cuda.synchronize()
    SO.radix_sort_pairs = counted
    kernels.reset_launches()
    out = {}
    answers = {}
    # (a) bench.py's regex queries on the zipf indexes
    for lay, ix in zipf.items():
        for name, (q, fcap) in ZIPF_QUERIES.items():
            node, nfa = query_nfa(q)

            def run():
                return RD.run_regexp_device(ix, nfa, node.approx,
                                            frontier_cap=fcap)
            ms = run()
            stats = dict(RD.last_stats)
            lat = wall_runs(run)
            answers[("zipf", lay, name)] = (ix, nfa, node, ms)
            out[f"zipf {lay} {name}"] = {
                "query": q, "latency_s": summary(lat), "ranges": len(ms),
                "rows": row_count(ms), **stats}
    # (b) the prose queries through the user entry points
    for tier in ROW_LAYOUTS:
        ix = prows[tier]
        for name, (q, _, icase) in PROSE_QUERIES.items():
            node = Q.parse_query(q)
            if icase:
                node = apply_icase(node)
            RD.last_stats.clear()
            count = Q.count_query(ix, q, icase=icase)
            stats = dict(RD.last_stats)
            got_docs = [d for d, _, _ in Q.docs_query(
                ix, q, with_offsets=False, icase=icase)]
            strings = (Q.find_strings(ix, q, icase=icase)
                       if isinstance(node, Q.QTerm) else None)
            terms = [(t, term_ranges(ix, t)) for t in query_terms(node)]
            lat = wall_runs(lambda: Q.count_query(ix, q, icase=icase))
            answers[("prose", tier, name)] = (ix, node, count, got_docs,
                                              strings, terms)
            out[f"prose {tier} {name}"] = {
                "query": q, "latency_s": summary(lat), "count": count,
                "docs": len(got_docs), "ranges": sum(len(r) for _, r in
                                                     terms), **stats}
    steps = {lay: O.backward_search_steps(ix.arrays, ix.meta.n_rows, zsteps)
             for lay, ix in zipf.items()}
    steps.update({lay: O.backward_search_steps(ix.arrays, ix.meta.n_rows,
                                               psteps)
                  for lay, ix in prows.items()})
    torch.cuda.synchronize()
    device_launches = dict(kernels.launches)
    SO.radix_sort_pairs = sort
    h_calls = h_call_sizes(sorts)
    check(h_calls["calls"] == device_launches["radix_sort_pairs"],
          f"the query path's sorts {h_calls['calls']} != H's launch count "
          f"{device_launches['radix_sort_pairs']}")
    fallback = {k: v for k, v in device_launches.items()
                if k.startswith("backward_step[") and v}
    check(not fallback, f"a query took the host engine's fallback: "
                        f"{fallback}")
    # the host engine on the same indexes, a path of its own: kernel C's
    # backward_step
    kernels.reset_launches()
    host_s = {}
    for key, val in answers.items():
        t0 = time.perf_counter()
        if key[0] == "zipf":
            ix, nfa, node, ms = val
            host = Q.run_regexp(ix, nfa, node.approx)
            check([(m.first, m.last, m.cost) for m in ms]
                  == [(m.first, m.last, m.cost) for m in host],
                  f"{key}: the device frontier differs from the host engine")
        else:
            ix, node, count, got_docs, strings, terms = val
            for term, ranges in terms:
                nfa = term_nfa(term)
                host = Q.run_regexp(ix, nfa, term.approx)
                check(ranges == [(m.first, m.last, m.cost) for m in host],
                      f"{key}: a term's ranges differ from the host engine")
                if strings is not None:
                    check(match_tuples(strings) == match_tuples(host),
                          f"{key}: find_strings differs from the host "
                          f"engine")
        host_s[" ".join(key)] = time.perf_counter() - t0
    torch.cuda.synchronize()
    host_launches = dict(kernels.launches)
    # the answers against the text
    for lay in zipf:
        ms = answers[("zipf", lay, "alternation")][3]
        check(row_count(ms) == sum(len(v) for v in zscan.values()),
              f"zipf {lay}: the alternation's rows differ from a text scan")
    for (corpus, tier, name), val in answers.items():
        if corpus != "prose":
            continue
        ix, node, count, got_docs, strings, terms = val
        ref = pref.get(name)
        if isinstance(ref, dict) and name.startswith("approx"):
            # every exact occurrence lies in the union of the match rows
            check(count >= sum(len(v) for v in ref.values())
                  and set(got_docs) >= set(ref),
                  f"prose {tier} {name}: the word's own occurrences are "
                  f"not all matched")
        elif isinstance(ref, dict):
            check(count == sum(len(v) for v in ref.values()),
                  f"prose {tier} {name}: count {count} != text scan")
            check(got_docs == sorted(ref),
                  f"prose {tier} {name}: documents differ from a text scan")
            pyre = PROSE_QUERIES[name][1]
            flags = re.IGNORECASE if PROSE_QUERIES[name][2] else 0
            check(all(re.fullmatch(pyre, m.match, re.DOTALL | flags)
                      for m in strings),
                  f"prose {tier} {name}: a found string does not match")
        else:
            check(got_docs == ref,
                  f"prose {tier} {name}: Boolean documents differ from a "
                  f"scan of the terms")
    for lay, (f, l, pf, pl, matched) in steps.items():
        ref_f, ref_l = ((st["first"][:nz], st["last"][:nz]) if lay in zipf
                        else pf_ref)
        check(bool((l <= f).all())
              and np.array_equal(pf.cpu().numpy(), ref_f)
              and np.array_equal(pl.cpu().numpy(), ref_l)
              and bool((matched == PATLEN).all()),
              f"{lay}: backward_search_steps' report differs from the "
              f"patterns' own ranges")
    for path, launches in (("query", device_launches),
                           ("query_host", host_launches)):
        for name in PATH_KERNELS[path]:
            check(launches[name] >= 1,
                  f"kernel {name} was not launched on the {path} path")
    for k, v in out.items():
        lat = v["latency_s"]
        log(f"    {k}: {v['query']!r} median {lat['median'] * 1e3:.3f} ms "
            f"(min {lat['min'] * 1e3:.3f}, max {lat['max'] * 1e3:.3f}); "
            f"layers {v.get('layers', '-')}, widest live frontier "
            f"{v.get('max_live', '-')}, ranges {v['ranges']}, syncs "
            f"{v.get('reads', '-')}, retries {v.get('retries', '-')}"
            + (f", count {v['count']}, docs {v['docs']}" if "count" in v
               else f", rows {v['rows']}"))
    log(f"    checks: every device answer equals the host engine's (host "
        f"seconds {host_s}); the zipf alternation's rows and the prose "
        f"exact regexes' counts and documents equal a text scan with "
        f"Python re, Boolean documents a scan of their terms; "
        f"backward_search_steps reports each NUL-headed pattern's own "
        f"range on all five layouts; no query took the host engine "
        f"(launches {device_launches}; the host engine's {host_launches})")
    log(f"    H's sorts on the query path: {h_calls}")
    rank_sums = "not measured"
    if builds is not None:
        runs = {}
        for key, val in answers.items():
            if key[0] == "zipf":
                ix, nfa, node, _ = val
                fcap = ZIPF_QUERIES[key[2]][1]
                runs[" ".join(key)] = (
                    lambda ix=ix, nfa=nfa, node=node, fcap=fcap: sorted(
                        (m.first, m.last, m.cost)
                        for m in RD.run_regexp_device(
                            ix, nfa, node.approx, frontier_cap=fcap)))
            elif PROSE_QUERIES[key[2]][1] is not None:
                q, _, icase = PROSE_QUERIES[key[2]]
                runs[" ".join(key)] = (
                    lambda ix=val[0], q=q, icase=icase: Q.count_query(
                        ix, q, icase=icase))
        rank_sums = route_sums(RO, "regex_fork", "regex_frontier",
                               rank_forced(builds, "regex_frontier"), runs)
    c_sums = "not measured"
    if builds is not None:
        c_sums = query_c_sums(c_forced(builds), answers, zipf, prows,
                              zsteps, psteps)
    record["query_path"] = {"queries": out, "host_engine_s": host_s,
                            "scan_s": t_scan, "launches": device_launches,
                            "host_launches": host_launches,
                            "h_calls": h_calls,
                            "regex_fork_sums": rank_sums,
                            "c_sums": c_sums}
    return dict(launches=device_launches, host_launches=host_launches,
                zipf=zipf, zsteps=zsteps, psteps=psteps, c_sums=c_sums,
                h_sorts={f"{route}, largest below 2^{b}": (k, lo, hi)
                         for (route, b), (_, k, lo, hi) in sorted(
                             largest.items())},
                zipf_answers={name: sorted((m.first, m.last, m.cost)
                                           for m in answers[
                                               ("zipf", "full", name)][3])
                              for name in ZIPF_QUERIES},
                prose_answers={(tier, name): (v[2], v[3]) for (
                    corpus, tier, name), v in answers.items()
                    if corpus == "prose"})


def query_c_sums(forced, answers, zipf, prows, zsteps, psteps):
    """Kernel C's device ms summed over phase 4d's calls as built and on
    each route forced (route_sums; forced: c_forced's builds): the query
    path's backward_search (the prose queries' literal terms, through
    count_query) and backward_search_steps (the too-few-matches report on
    all five layouts), and the query_host path's backward_step (the host
    engine over every query and term of phase 4d)."""
    from femto_tpu_torch import query as Q
    from femto_tpu_torch.ops import search_ops as S

    terms, host = {}, {}
    for key, val in answers.items():
        tag = " ".join(key)
        if key[0] == "zipf":
            ix, nfa, node, _ = val
            host[tag] = (lambda ix=ix, nfa=nfa, node=node: [
                (m.first, m.last, m.cost)
                for m in Q.run_regexp(ix, nfa, node.approx)])
            continue
        ix, node = val[0], val[1]
        q, _, icase = PROSE_QUERIES[key[2]]
        terms[tag] = (lambda ix=ix, q=q, icase=icase: Q.count_query(
            ix, q, icase=icase))
        host[tag] = (lambda ix=ix, node=node: [
            [(m.first, m.last, m.cost)
             for m in Q.run_regexp(ix, term_nfa(t), t.approx)]
            for t in query_terms(node)])
    steps = {lay: (lambda A=ix.arrays, n=ix.meta.n_rows, pt=pt: [
        t.tolist() for t in S.backward_search_steps(A, n, pt)])
        for group, pt in ((zipf, zsteps), (prows, psteps))
        for lay, ix in group.items()}
    return {"query": {
        "backward_search": route_sums(S, "backward_search",
                                      "backward_search", forced, terms),
        "backward_search_steps": route_sums(
            S, "backward_search_steps", "backward_search", forced, steps)},
        "query_host": {"backward_step": route_sums(
            S, "backward_step_pair", "backward_search", forced, host)}}


def interval_overlap(spans, others):
    """Microseconds of the intervals ``spans`` that lie under the union of
    the intervals ``others`` ((start, end) pairs)."""
    merged = []
    for a, b in sorted(others):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for a, b in spans:
        for c, d in merged:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def chunk_rows_sa(ix, rows):
    """sa[rows] of a chunk index: a located offset for each real row, the
    pad position n_rows - 1 - r for each pad row r < row0 (the pad
    suffixes lead, shortest first), -1 past n_rows."""
    import femto_tpu_torch as tt

    out = np.full(len(rows), -1, np.int64)
    real = (rows >= ix.meta.row0) & (rows < ix.meta.n_rows)
    padr = rows < ix.meta.row0
    out[real] = tt.locate_rows_array(ix, rows[real])
    out[padr] = ix.meta.n_rows - 1 - rows[padr]
    return out


def timed_row(name, path, launches, run_k, run_p, nbytes, card,
              library=None, extra=None, library_full=None, more=None):
    """Phase 5's row of one kernel on `path`, timed in its own phase: held
    to its plain version on the same inputs (plain_ms the time of that
    one comparison run), then the median of 3 CUDA-event timings, its
    bound from `nbytes` and, where a library call exists, kernel and
    library timed in turns (turn_fields), and with the library's whole
    function where given (full_fields).  ITEM_ROWS also get item_fields;
    `extra` and what `more()` returns are added to the row."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    got = run_k()
    a.record()
    want = run_p()
    b.record()
    torch.cuda.synchronize()
    err = max_abs_err(f"{name} ({path})", got, want)
    del got, want
    turns = {}
    if library:
        ms, lib_ms, turns = turn_fields(name, run_k, library)
    else:
        ms, lib_ms = cuda_ms(run_k), None
    r = {"name": name, "path": path, "route": "cuda",
         "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches, "max_abs_err": err,
         "ms": ms, "plain_ms": a.elapsed_time(b),
         "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
         "library_ms": lib_ms, "card": card, **turns}
    if library_full is not None:
        r.update(full_fields(name, run_k, library_full))
    if name in ITEM_ROWS:
        r.update(item_fields(name, run_k, library))
    r.update(extra or {})
    if more is not None:
        r.update(more())
    log(f"    {name}: {r['ms']:.4g} ms (bound {r['bound_ms']:.4g} ms, "
        f"plain {r['plain_ms']:.4g} ms, library {r['library_ms']}); "
        f"launches on the {path} path {r['launches']}"
        + "".join(f"; {k} {r[k]}" for k in (
            "turns_ms", "kernel_ahead_rounds", "d_route", "warp_route_ms",
            "thread_route_ms", "warp_ahead_rounds", "warp_queued_ms",
            "thread_queued_ms", "kernels_per_call",
            "kernel_device_ms", "queued_ms", "library_device_ms",
            "library_queued_ms", "library_full_ms",
            "library_full_turns_ms", "kernel_ahead_of_full_rounds",
            "library_full_queued_ms", "at_occ_site", "pack_route", "mm",
            "kernel_items_per_call")
            if k in r))
    return r


def chunked_kernel_rows(prepared, tail_text, tail_n, seg, launches, card):
    """Phase 5's rows of the chunked path's own kernels, at the shapes of
    phase 4e (P and Q on the first chunk, G with n_real on the padded
    tail chunk), each held to its plain version on the same inputs."""
    import torch

    from femto_tpu_torch import fmindex as TF
    from femto_tpu_torch import multi as TM
    from femto_tpu_torch import suffix as TS
    from femto_tpu_torch.alphabet import PreparedText
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import sort_ops as SO

    dev = tail_text.device
    rows = []

    def row(name, run_k, run_p, nbytes, library=None):
        rows.append(timed_row(name, "chunked", launches.get(name, 0), run_k,
                              run_p, nbytes, card, library))

    d1 = CHUNK_MAX // CHUNK_DOC
    sub = PreparedText(
        text=prepared.text[:CHUNK_MAX],
        doc_starts=prepared.doc_starts[: d1 + 1].copy(),
        infos=prepared.infos[:d1])
    n = sub.n
    esc = [torch.from_numpy(p).to(dev)
           for p in TF._escape_positions(sub, d1)]
    u8 = torch.from_numpy(TM._content_u8(sub.text, n)).to(dev)
    row("expand_u8", lambda: [BO.expand_u8(u8, n, *esc)],
        lambda: [BO.expand_u8_plain(u8, n, *esc)],
        n + sum(4 * p.shape[0] for p in esc) + 4 * n)
    text = BO.expand_u8(u8, n, *esc)
    del u8
    sa = TS.suffix_array(text)
    ds = torch.from_numpy(sub.doc_starts.astype(np.int32)).to(dev)
    n_seg = n // seg + 1
    tile = torch.full((n_seg * seg,), 2**31 - 1, dtype=torch.int32,
                      device=dev)
    tile[:n] = (torch.searchsorted(ds.long(), sa.long(), right=True) - 1
                ).to(torch.int32)
    tile = tile.reshape(n_seg, seg)
    row("doc_lists",
        lambda: list(BO.doc_lists(sa, ds, n_real=n, n_seg=n_seg, seg=seg)),
        lambda: BO.doc_lists_plain(sa, ds, n_real=n, n_seg=n_seg, seg=seg),
        4 * n + 4 * ds.shape[0] + 4 * n_seg * seg + 4 * n_seg,
        library=lambda: torch.sort(tile, dim=1))
    del tile
    vals, counts = BO.doc_lists(sa, ds, n_real=n, n_seg=n_seg, seg=seg)
    offsets = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts.long(), 0)
    total = int(offsets[-1])
    row("flatten_ragged",
        lambda: [BO.flatten_ragged(vals, counts, offsets)],
        lambda: [BO.flatten_ragged_plain(vals, counts, offsets)],
        4 * n_seg + 8 * (n_seg + 1) + 4 * total + 4 * total)
    del vals, counts, offsets, sa, text
    used = TS.text_alphabet(tail_text)
    bits, per = TS.key_widths(len(used))
    lut = torch.from_numpy(TS.alpha_lut(used)).to(dev)
    nt = tail_text.shape[0]
    row("sa_keys[n_real]",
        lambda: [SO.sa_keys(tail_text, lut, bits=bits, per=per,
                            n_real=tail_n)],
        lambda: [SO.sa_keys_plain(tail_text, lut, bits=bits, per=per,
                                  n_real=tail_n)],
        4 * tail_n + 4 * 512 + 8 * nt)
    return rows


def phase_chunked(record, rng):
    """Phase 4e, the chunked path at full size, run first on an empty
    card: build_chunked_prepared of 129 zipf documents of 2^24 symbols
    (n = 2,164,260,864) in chunks of at most 2^28 symbols, full tier, doc
    lists, the uint8 upload and prefetch; the needle, 32768 patterns and
    the located offsets checked, the padded tail chunk held to an unpadded
    build of its document, sampled doc lists of every chunk held to their
    plain version, a Boolean docs_query held to its terms' documents; the
    tail chunk's sort timed with and without n_real; the chunked kernels'
    rows for phase 5; one two-chunk build profiled for phase 6."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import fmindex as TF
    from femto_tpu_torch import kernels
    from femto_tpu_torch import multi as TM
    from femto_tpu_torch import suffix as TS
    from femto_tpu_torch.alphabet import PreparedText
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import search_ops as S

    dev = torch.device("cuda")
    seg, mp = 256, 20
    t0 = time.perf_counter()
    prepared = chunk_corpus(rng)
    n = prepared.n
    check(n == CHUNK_NDOCS * CHUNK_DOC and n > 2**31, "chunk corpus size")
    starts = (rng.integers(0, CHUNK_NDOCS, size=N_PATTERNS) * CHUNK_DOC
              + rng.integers(0, CHUNK_DOC - PATLEN - 1, size=N_PATTERNS))
    codes = prepared.text[starts[:, None] + np.arange(PATLEN)]
    patterns = [r.tobytes() for r in (codes - 5).astype(np.uint8)]
    t_data = time.perf_counter() - t0
    card = record["toolchain"]["card"]
    log(f"[4e] corpus: {CHUNK_NDOCS} zipf documents of {CHUNK_DOC} symbols, "
        f"n={n} (made in {t_data:.1f}s); card {card}")

    done = []
    real_build = TM.build_index

    def timed_build(*a, **k):
        # build_index returns once its doc lists are on the host, so the
        # gap between two returns is one chunk's staging and build
        ix = real_build(*a, **k)
        done.append(time.perf_counter())
        return ix

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    TM.build_index = timed_build
    try:
        t0 = time.perf_counter()
        mi = TM.build_chunked_prepared(prepared, max_chunk_symbols=CHUNK_MAX,
                                       seg=seg, mark_period=mp,
                                       device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    finally:
        TM.build_index = real_build
    peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    chunk_ms = (np.diff([t0] + done) * 1e3).tolist()
    nchunks = len(mi.indexes)
    check(nchunks == 9, f"expected 9 chunks, got {nchunks}")
    tail = mi.indexes[-1]
    check(tail.meta.row0 == CHUNK_MAX - CHUNK_DOC == 251658240
          and tail.meta.n_rows == CHUNK_MAX, f"tail chunk meta {tail.meta}")
    check(all(ix.meta.row0 == 0 for ix in mi.indexes[:-1]),
          "whole chunks should carry no pad rows")
    # the queries of the path
    t0 = time.perf_counter()
    needle_at = mi.locate(CHUNK_NEEDLE)
    needle_count = int(mi.count([CHUNK_NEEDLE])[0])
    counts = mi.count(patterns)
    t_count = time.perf_counter() - t0
    per_chunk = sum(tt.count(ix, patterns) for ix in mi.indexes)
    sample = [int(i) for i in rng.choice(N_PATTERNS, 16, replace=False)]
    located = {i: mi.locate(patterns[i], max_matches=8) for i in sample}
    # a 20-symbol string of document 64, likely found there alone
    t2 = prepared.text[64 * CHUNK_DOC + 2000: 64 * CHUNK_DOC + 2020]
    term2 = (t2 - 5).astype(np.uint8).tobytes()
    query = f"'{CHUNK_NEEDLE.decode()}' AND '{term2.decode()}'"
    got_docs = sorted(d for d, _, _ in mi.docs_query(query,
                                                     with_offsets=False))
    want_docs = sorted(set(mi.docs(CHUNK_NEEDLE)) & set(mi.docs(term2)))
    ctx = {}
    for i in sample[:4]:
        ix_i = mi.indexes[int(starts[i] // CHUNK_MAX)]
        f, l = tt.count_ranges(ix_i, [patterns[i]])
        ctx[i] = tt.extract_context_batch(
            ix_i, np.arange(f[0], l[0]), 0, PATLEN, 0)
    # the last CHUNK_TAIL_STEPS symbols of the tail chunk's document, by a
    # backward walk from its SEOF row
    tail_walk = S.extract_backward(tail.arrays, tail.arrays.doc_seof_rows[
        :1].contiguous(), CHUNK_TAIL_STEPS)[0]
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"    built {nchunks} chunks in {t_build:.2f}s "
        f"({n / 2**20 / t_build:.1f} MiB/s); ms per chunk (staging + "
        f"build) {[round(x, 1) for x in chunk_ms]}; peak device memory "
        f"{peak / 1e9:.3f} GB, {resident / 1e9:.3f} GB resident after; "
        f"count of {N_PATTERNS} patterns {t_count:.3f}s; launches "
        f"{launches}")

    # checks
    check(needle_at == [(0, 1000), (64, 1064), (128, 1128)]
          and needle_count == 3, f"needle: {needle_at}, {needle_count}")
    check((counts >= 1).all(), "a pattern cut from the text has count 0")
    check(np.array_equal(counts, per_chunk),
          "the MultiIndex count differs from the sum over the chunks")
    for i, locs in located.items():
        check(len(locs) >= 1, f"pattern {i} not located")
        for d, o in locs:
            s0 = d * CHUNK_DOC + o
            check(prepared.text[s0: s0 + PATLEN].tobytes()
                  == codes[i].tobytes(), f"located {d}:{o} is not pattern "
                                         f"{i}")
    for i, got in ctx.items():
        check(got and all(c == patterns[i] for c in got),
              f"the match rows of pattern {i} extract other bytes")
    check(got_docs == want_docs and 64 in got_docs,
          f"docs_query {query!r}: {got_docs} != {want_docs}")
    for name in PATH_KERNELS["chunked"]:
        check(launches[name] >= 1,
              f"kernel {name} was not launched on the chunked path")

    # sampled doc lists of every chunk against their plain version
    for c, ix in enumerate(mi.indexes):
        segs = np.unique(np.concatenate([
            [0, ix.meta.n_seg - 1],
            rng.integers(0, ix.meta.n_seg, size=N_CHUNK_SEGS)]))
        rows = (segs[:, None] * seg + np.arange(seg)).reshape(-1)
        sa_rows = torch.from_numpy(chunk_rows_sa(ix, rows).astype(np.int32))
        vals, cnt = BO.doc_lists_plain(sa_rows, ix.arrays.doc_starts.cpu(),
                                       n_real=ix.meta.n, n_seg=len(segs),
                                       seg=seg)
        o = ix.chunk_doc_offsets_np
        for j, sg in enumerate(segs):
            want = ix.chunk_docs_np[o[sg]: o[sg + 1]]
            check(np.array_equal(vals[j, : int(cnt[j])].numpy(), want),
                  f"chunk {c} segment {sg}: doc list differs")

    # the padded tail chunk against an unpadded build of its document
    d_tail = CHUNK_NDOCS - 1
    tail_prep = PreparedText(text=prepared.text[d_tail * CHUNK_DOC:],
                             doc_starts=np.array([0, CHUNK_DOC], np.int64),
                             infos=[prepared.infos[d_tail]])
    plain_tail = tt.build_index(tail_prep, seg=seg, mark_period=mp,
                                doc_chunks=True, device="cuda")
    row0 = tail.meta.row0
    tpats = [CHUNK_NEEDLE] + [
        (tail_prep.text[o: o + PATLEN] - 5).astype(np.uint8).tobytes()
        for o in rng.integers(0, CHUNK_DOC - PATLEN - 1, size=1024)]
    check(np.array_equal(tt.count(tail, tpats), tt.count(plain_tail, tpats)),
          "tail chunk: counts differ from the unpadded build")
    check(tt.locate(tail, CHUNK_NEEDLE) == tt.locate(plain_tail, CHUNK_NEEDLE)
          == [(0, 1128)], "tail chunk: the needle's locate differs")
    walks = [tail_walk, S.extract_backward(
        plain_tail.arrays, plain_tail.arrays.doc_seof_rows[:1].contiguous(),
        CHUNK_TAIL_STEPS)[0]]
    want_tail = torch.from_numpy(tail_prep.text[
        CHUNK_DOC - 1 - CHUNK_TAIL_STEPS: CHUNK_DOC - 1][::-1].astype(
        np.int32).copy())
    check(torch.equal(walks[0], walks[1])
          and torch.equal(walks[0][0].cpu(), want_tail),
          "tail chunk: the backward extract differs")
    f, l = tt.count_ranges(tail, tpats[:64])
    rd = [(int(a), int(b)) for a, b in zip(f, l) if b > a]
    rd += [(row0, row0 + 5 * seg + 17), (row0 + 3, tail.meta.n_rows)]
    for a, b in rd:
        check(np.array_equal(tt.range_docs(tail, a, b),
                             tt.range_docs(plain_tail, a - row0, b - row0)),
              f"tail chunk: range_docs({a}, {b}) differs")
    # the real rows [row0, n_rows) all lie past n here: the rows a bound
    # of n refused (ROADMAP Q3); their first and last 1024 and 2048 more
    nr = tail.meta.n_rows
    top = np.concatenate([np.arange(row0, row0 + 1024),
                          np.arange(nr - 1024, nr),
                          rng.integers(row0, nr, size=2048)])
    check(tt.extract_context_batch(tail, top, *CTX)
          == tt.extract_context_batch(plain_tail, top - row0, *CTX),
          "tail chunk: contexts over its real rows differ")
    log(f"    checks: needle {needle_at} (count {needle_count}), "
        f"{N_PATTERNS} patterns each >= 1 and == the sum over chunks, "
        f"{sum(map(len, located.values()))} located offsets in the text, "
        f"match rows' contexts, {query!r} -> {got_docs}, sampled doc lists "
        f"of all {nchunks} chunks, the tail chunk (row0 {row0}) against an "
        f"unpadded build: {len(tpats)} counts, locate, a "
        f"{CHUNK_TAIL_STEPS}-step extract, {len(rd)} range_docs, "
        f"{len(top)} contexts over rows in [row0, n_rows), all past n")
    del plain_tail, walks, tail_walk
    tail_n = tail.meta.n
    del mi, tail, ix

    # the tail chunk's suffix sort with and without n_real
    esc = [torch.from_numpy(p).to(dev)
           for p in TF._escape_positions(tail_prep, 16)]
    tail_text = BO.expand_u8(torch.from_numpy(TM._content_u8(
        tail_prep.text, CHUNK_MAX)).to(dev), tail_n, *esc)
    alpha = TS.text_alphabet(tail_text)
    sorts = {}
    for tag, nr in (("n_real", tail_n), ("no_n_real", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sa_t = TS.suffix_array(tail_text, alpha=alpha, n_real=nr)
        torch.cuda.synchronize()
        sorts[tag] = {"s": time.perf_counter() - t0,
                      "stats": dict(TS.last_stats)}
        sorts[tag]["sa"] = sa_t
        log(f"    tail chunk's sort {tag}: {sorts[tag]['s']:.3f}s, "
            f"{sorts[tag]['stats']}")
    check(torch.equal(sorts["n_real"].pop("sa"), sorts["no_n_real"].pop(
        "sa")), "the tail chunk's SA differs with and without n_real")
    rows5 = chunked_kernel_rows(prepared, tail_text, tail_n, seg, launches,
                                card)
    del tail_text

    # phase 6's two-chunk build, profiled
    two = PreparedText(text=prepared.text[: 2 * CHUNK_MAX],
                       doc_starts=prepared.doc_starts[
                           : 2 * (CHUNK_MAX // CHUNK_DOC) + 1].copy(),
                       infos=prepared.infos[: 2 * (CHUNK_MAX // CHUNK_DOC)])
    del prepared
    entry, prof = profile_step(
        "chunked_two_chunk_build",
        lambda: TM.build_chunked_prepared(two, max_chunk_symbols=CHUNK_MAX,
                                          seg=seg, mark_period=mp,
                                          device="cuda"),
        own_kernel_names())
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda
           and SPIN_KERNEL not in e.name]
    copies = [(e.time_range.start, e.time_range.end) for e in evs
              if "HtoD" in e.name and "Pinned" in e.name]
    kerns = [(e.time_range.start, e.time_range.end) for e in evs
             if "memcpy" not in e.name.lower()
             and "memset" not in e.name.lower()]
    copy_us = sum(b - a for a, b in copies)
    entry["pinned_upload_us"] = copy_us
    entry["pinned_upload_under_kernels_us"] = interval_overlap(copies, kerns)
    entry["pinned_uploads"] = len(copies)
    log(f"      pinned uploads: {len(copies)}, {copy_us:.1f} us, of which "
        f"{entry['pinned_upload_under_kernels_us']:.1f} us ran while a "
        f"kernel ran")
    record["chunked_path"] = {
        "n": n, "ndocs": CHUNK_NDOCS, "chunks": nchunks,
        "max_chunk_symbols": CHUNK_MAX, "seg": seg, "mark_period": mp,
        "tail_row0": row0, "card": card, "build_s": t_build,
        "mib_per_s": n / 2**20 / t_build, "chunk_ms": chunk_ms,
        "peak_device_bytes": peak, "resident_after_build_bytes": resident,
        "count_s": t_count, "launches": launches,
        "tail_sort": sorts, "query": query, "query_docs": got_docs,
    }
    return {"launches": launches, "kernel_rows": rows5,
            "profile": {"chunked_two_chunk_build": entry}}


# ---------------------------------------------------------------------------
# paged serving and the LCP analytics (K16, K17)
# ---------------------------------------------------------------------------


def paged_budget(path, share):
    """The budget that gives load_paged a cache of `share` of the rows of
    the .ftpu file at path: its resident arrays, the slot map and that
    share of the row bytes (femto_tpu's cache-size rule)."""
    from femto_tpu_torch import paged as TP
    from femto_tpu_torch.fmindex import FMIndex

    _, _, arrs = FMIndex.parse_flat(path)
    rows = arrs["bwt"]
    resident = sum(v.nbytes for k, v in arrs.items()
                   if k not in TP._HOST_ENTRIES)
    return resident + 4 * rows.shape[0] + int(rows.nbytes * share)


def half_cache(arrays, rng, errs, tag):
    """The index's arrays over a half-filled row cache: a random half of
    the segments written into random slots of a cache of n_seg // 2 + 1
    rows by apply_faults, then a quarter of them evicted for others (and
    one dropped entry), each update held to the plain version on a copy.
    Returns (paged arrays, bool[n_seg] of the mapped segments)."""
    import torch

    from femto_tpu_torch.ops import paged_ops as PO

    dev = arrays.bwt.device
    n_seg, W = arrays.bwt.shape
    rows = n_seg // 2 + 1
    perm = rng.permutation(n_seg)
    segs1 = perm[: rows - 1]
    slots1 = rng.permutation(rows - 1) + 1
    q = (rows - 1) // 4
    segs2 = perm[rows - 1: rows - 1 + q]
    cache = torch.zeros((rows, W), dtype=torch.int32, device=dev)
    cache = cache.view(torch.uint32)
    smap = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    c2, m2 = cache.clone(), smap.clone()
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(dev)

    def fetch(segs):
        return arrays.bwt.view(torch.int32)[i32(segs).long()].view(
            torch.uint32).contiguous()

    # the second update: q slots change tenants, and one pair drops
    steps = [(slots1, fetch(segs1), np.zeros(0, np.int32), segs1),
             (np.append(slots1[:q], rows),
              torch.cat([fetch(segs2), fetch(segs2[:1])]), segs1[:q],
              np.append(segs2, n_seg))]
    for k, (slots, fetched, evict, segs) in enumerate(steps):
        args = (i32(slots), fetched, i32(evict), i32(segs))
        PO.apply_faults(cache, smap, *args)
        PO.apply_faults_plain(c2, m2, *args)
        torch.cuda.synchronize()
        errs[f"apply_faults({tag}, update {k})"] = max_abs_err(
            f"apply_faults({tag})", [cache, smap], [c2, m2])
    mapped = np.zeros(n_seg, bool)
    mapped[np.concatenate([segs1[q:], segs2])] = True
    check(np.array_equal(smap.cpu().numpy() > 0, mapped),
          f"apply_faults({tag}): the slot map does not map the fetched "
          f"segments alone")
    return arrays._replace(bwt=cache, seg_slot=smap), mapped


def parity_paged_steps(name, ix, rng, errs, d_libs=None, c_libs=None):
    """K16's steps (C's masked step, D's lf_walk_step, resolve_marks and
    the one-step extract) on a half-filled cache with a random seg_slot:
    each kernel against its plain version there and against itself on
    the resident index (the indirection changes no answer); the masked
    step also on each of kernel C's routes (c_libs) and the one-step
    extract on each of kernel D's (d_libs), at B rows and at 1, and then
    a whole walk of lf_walk_step (paged_walk_parity, whose record it
    returns)."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    arrays = ix.arrays
    dev = arrays.bwt.device
    seg, n = ix.meta.seg, ix.meta.n
    paged, mapped = half_cache(arrays, rng, errs, name)
    B = 65536

    def mapped_rows(k):
        r = rng.integers(0, n, size=4 * k)
        return r[mapped[r // seg]][:k].astype(np.int32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    rows = t(mapped_rows(B))
    other = t(mapped_rows(B))
    first, last = torch.minimum(rows, other), torch.maximum(rows, other)
    syms = arrays.alpha_rev.cpu().numpy()
    c = syms[rng.integers(0, len(syms), B)].astype(np.int32)
    c[::7] = -1
    c[3::11] = 300               # outside the alphabet
    c = t(c)
    granks = t(rng.integers(0, max(ix.meta.n_marks, 1), B).astype(np.int32))
    steps = t(rng.integers(0, 21, B).astype(np.int32))
    done = t(rng.random(B) < 0.25)
    runs = {
        "backward_step_masked": (
            lambda A: S.backward_step_masked(A, c, first, last),
            lambda A: S.backward_step_masked_plain(A, c, first, last)),
        "lf_walk_step": (
            lambda A: S.lf_walk_step(A, rows, granks, steps, done, 7),
            lambda A: S.lf_walk_step_plain(A, rows, granks, steps, done, 7)),
        "resolve_marks": (
            lambda A: [S.resolve_marks(A, granks, steps)],
            lambda A: [S.resolve_marks_plain(A, granks, steps)]),
        "lf_extract(1 step)": (
            lambda A: S.extract_backward(A, rows, 1),
            lambda A: S.extract_backward_plain(A, rows, 1)),
    }
    for entry, (run_k, run_p) in runs.items():
        got, want, resident = run_k(paged), run_p(paged), run_k(arrays)
        torch.cuda.synchronize()
        errs[f"{entry}[{name}](paged)"] = max_abs_err(
            f"{entry}[{name}] on a half-filled cache", got, want)
        max_abs_err(f"{entry}[{name}]: paged against resident", got,
                    resident)
    for lanes in ((c, first, last), (c[:1].contiguous(), first[:1].contiguous(),
                                     last[:1].contiguous())):
        key = f"backward_step_masked[{name}](paged, B={lanes[0].shape[0]})"
        want = S.backward_step_masked_plain(paged, *lanes)
        for route, lib in (c_libs or {}).items():
            with kernels.variant("backward_search", lib):
                got = S.backward_step_masked(paged, *lanes)
            errs[f"{key}, {route} route"] = max_abs_err(
                f"{key}, {route} route", got, want)
    if d_libs is None:
        return None
    for rr in (rows, rows[:1].contiguous()):
        key = f"lf_extract(1 step)[{name}](paged, B={rr.shape[0]})"
        want = S.extract_backward_plain(paged, rr, 1)
        errs[key] = max_abs_err(key, S.extract_backward(paged, rr, 1),
                                want)
        d_both_routes(d_libs, lambda: S.extract_backward(paged, rr, 1), want,
                      key)
    return paged_walk_parity(name, ix, paged, mapped, rng, errs, d_libs)


def walk_faults(rows, done, seg, smap, slot_seg):
    """Map, before a step of a paged locate walk, the segments of the
    lanes not done (numpy rows and done flags), as PagedIndex faults them
    in: the segments of the done lanes that no lane left needs are
    evicted first (those lanes read no row), then each missing segment
    takes a free slot, or one whose segment no lane left needs.  Updates
    smap (int32[n_seg], 0: unmapped) and slot_seg (int64[cache_rows], -1:
    free; slot 0 the dummy) in place.  Returns (slots, segments) to copy
    and the number of done lanes' segments evicted."""
    need = np.unique(rows[~done] // seg)
    gone = np.setdiff1d(np.unique(rows[done] // seg), need)
    gone = gone[smap[gone] > 0]
    slot_seg[smap[gone]] = -1
    smap[gone] = 0
    miss = need[smap[need] == 0]
    free = np.nonzero(slot_seg[1:] < 0)[0] + 1
    if len(free) < len(miss):
        spare = np.nonzero((slot_seg >= 0) & ~np.isin(slot_seg, need))[0]
        take = spare[: len(miss) - len(free)]
        smap[slot_seg[take]] = 0
        slot_seg[take] = -1
        free = np.concatenate([free, take])
    slots = free[: len(miss)]
    slot_seg[slots] = miss
    smap[miss] = slots
    return slots, miss, len(gone)


def paged_walk_parity(name, ix, paged, mapped, rng, errs, d_libs):
    """A whole paged locate walk, step by step (i = 0 ... mark_period),
    on half_cache's half-filled cache (paged; mapped: bool[n_seg] of its
    mapped segments), from B rows of mapped segments (as many as half the
    cache serves, at most 4096) and from one, the cache updated before
    each step by walk_faults (done lanes' segments evicted); every step by
    lf_walk_step as built and on both of kernel D's routes (d_libs)
    against its plain version, bit for bit; the offsets after the walk
    against locate on the resident index."""
    import torch

    from femto_tpu_torch.ops import search_ops as S

    arrays = ix.arrays
    dev = arrays.bwt.device
    seg, n, mp = ix.meta.seg, ix.meta.n, ix.meta.mark_period
    cache, smap = paged.bwt.view(torch.int32), paged.seg_slot
    smap_np = smap.cpu().numpy().copy()
    slot_seg = np.full(cache.shape[0], -1, np.int64)
    slot_seg[smap_np[smap_np > 0]] = np.nonzero(smap_np > 0)[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    rec = {}
    for B in (min(4096, (cache.shape[0] - 1) // 2), 1):
        r = rng.integers(0, n, size=8 * B)
        rows = t(r[mapped[r // seg]][:B].astype(np.int32))
        start = rows
        granks = torch.zeros_like(rows)
        steps = torch.zeros_like(rows)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        faults = evicted = 0
        for i in range(mp + 1):
            slots, segs, gone = walk_faults(rows.cpu().numpy(),
                                            done.cpu().numpy(), seg,
                                            smap_np, slot_seg)
            if len(segs):
                cache[t(slots).long()] = arrays.bwt.view(torch.int32)[
                    t(segs).long()]
            smap.copy_(t(smap_np))
            faults += len(segs)
            evicted += gone
            state = (rows, granks, steps, done)
            want = S.lf_walk_step_plain(paged, *state, i)
            key = f"lf_walk_step[{name}](paged walk, B={B}, i={i})"
            errs[key] = max_abs_err(key, S.lf_walk_step(paged, *state, i),
                                    want)
            d_both_routes(d_libs, lambda: S.lf_walk_step(paged, *state, i),
                          want, key)
            rows, granks, steps, done = want
            if bool(done.all()):
                break
        check(bool(done.all()), f"lf_walk_step[{name}]: a paged walk of "
                                f"{mp + 1} steps left a lane without a mark")
        check(torch.equal(S.resolve_marks_plain(paged, granks, steps),
                          S.locate_rows(arrays, mp, start)),
              f"lf_walk_step[{name}]: the paged walk's offsets differ from "
              f"the resident locate")
        rec[B] = {"steps": i + 1, "faults": faults,
                  "done_segments_evicted": evicted,
                  "route": d_route(paged, B, "lf_walk_step")}
    check(any(v["done_segments_evicted"] for v in rec.values()),
          f"lf_walk_step[{name}]: no done lane's segment was evicted")
    return rec


def parity_paged_index(name, ix, docs, rng, errs):
    """A PagedIndex on the card against the same .ftpu file opened with
    device="cpu", at a cache of a quarter of the rows: equal answers,
    stats, slot maps, clock and cache after every call."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import paged as TP
    from femto_tpu_torch.query import regexp as QR
    from femto_tpu_torch.query.nfa import compile_nfa
    from femto_tpu_torch.query.parser import parse_query
    from femto_tpu_torch.query.planning import streamline

    pats = []
    while len(pats) < 512:
        d = int(rng.integers(0, len(docs)))
        if len(docs[d]) > PATLEN:
            o = int(rng.integers(0, len(docs[d]) - PATLEN))
            pats.append(docs[d][o: o + PATLEN])
    rows = rng.integers(0, ix.meta.n, size=1024).astype(np.int32)
    node = parse_query("th[aeiou]n")
    nfa = compile_nfa(streamline(node.regexp))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.ftpu")
        ix.save_flat(path)
        budget = paged_budget(path, 0.25)
        pgs = [TP.load_paged(path, budget, device=d) for d in ("cuda", "cpu")]
        calls = (
            ("count", lambda pg: np.stack(tt.count_ranges(pg, pats))),
            ("count, warm", lambda pg: np.stack(tt.count_ranges(pg, pats))),
            ("locate", lambda pg: tt.locate_rows_array(pg, rows)),
            ("run_regexp", lambda pg: np.asarray(
                sorted((m.first, m.last, m.cost)
                       for m in QR.run_regexp(pg, nfa, node.approx)),
                np.int64).reshape(-1, 3)),
        )
        for what, call in calls:
            got, want = (call(pg) for pg in pgs)
            torch.cuda.synchronize()
            card, cpu = pgs
            check(np.array_equal(got, want),
                  f"paged {name} {what}: the card's answer differs from "
                  f"the CPU's")
            check(card.stats == cpu.stats and card._clock == cpu._clock
                  and np.array_equal(card._slot_map_np, cpu._slot_map_np)
                  and np.array_equal(card._slot_seg, cpu._slot_seg),
                  f"paged {name} {what}: stats or slot maps differ "
                  f"({card.stats} vs {cpu.stats})")
            errs[f"PagedIndex({name}) {what}"] = max_abs_err(
                f"paged {name} {what}: cache and map",
                [card._cache.cpu(), card._slot_map.cpu()],
                [cpu._cache, cpu._slot_map])
        return dict(pgs[0].stats, cache_rows=pgs[0].cache_rows)


def host_lcp(text, i, j):
    """LCP of the suffix pairs (i, j) of a host text by a numpy byte
    compare in doubling windows (the end of the text a mismatch)."""
    n = len(text)
    h = np.zeros(len(i), np.int64)
    live = np.arange(len(i))
    W = 64
    while live.size:
        k = np.arange(W)
        a = i[live, None] + h[live, None] + k
        b = j[live, None] + h[live, None] + k
        x = np.where(a < n, text[np.minimum(a, n - 1)], -1)
        y = np.where(b < n, text[np.minimum(b, n - 1)], -2)
        ne = x != y
        ml = np.where(ne.any(axis=1), ne.argmax(axis=1), W)
        h[live] += ml
        live = live[ml == W]
        W = min(2 * W, 4096)
    return h


def host_kasai(text, sa):
    """The host Kasai pass lcp_array's size switch takes: the native
    ft_kasai, or _kasai_np where the native library does not build."""
    from femto_tpu_torch import lcp as TL

    t16 = np.ascontiguousarray(text, np.uint16)
    sa32 = np.ascontiguousarray(sa, np.int32)
    out = np.zeros(len(t16), np.int32)
    if TL.kasai_native(t16, sa32, out):
        return out, "ft_kasai"
    return TL._kasai_np(t16, sa32), "_kasai_np"


def parity_lcp(prepared, text, sa, errs):
    """Kernel S round by round against its plain versions: the windowed
    compare of every (suffix, SA predecessor) pair of the 8 MiB parity
    corpus and the compaction after it, W from 32 up to 4096 (its twin
    document's pairs share 64 KiB); compaction into more slots than lanes
    (the fill); then lcp_array against the host Kasai pass."""
    import torch

    from femto_tpu_torch import lcp as TL
    from femto_tpu_torch.ops import lcp_ops as L

    dev = text.device
    n = text.shape[0]
    i = sa
    j = torch.cat([sa[:1], sa[:-1]])
    act = torch.ones(n, dtype=torch.bool, device=dev)
    act[0] = False
    h = torch.zeros(n, dtype=torch.int32, device=dev)
    orig = torch.arange(n, dtype=torch.int32, device=dev)
    out_k = torch.zeros(n, dtype=torch.int32, device=dev)
    out_p = out_k.clone()
    W, windows = L.LCP_W_MIN, []
    err_r = err_c = 0
    while True:
        hk, ak = L.lcp_round(text, i, j, h, act, W)
        hp, ap = L.lcp_round_plain(text, i, j, h, act, W)
        torch.cuda.synchronize()
        err_r = max(err_r, max_abs_err(f"lcp_round(W={W})", [hk, ak],
                                       [hp, ap]))
        if not windows:  # more slots than lanes: the fill values
            o1, o2 = out_k.clone(), out_k.clone()
            extra = i.shape[0] + 1000
            got = L.lcp_compact(o1, i, j, hk, ak, orig, extra)
            want = L.lcp_compact_plain(o2, i, j, hk, ak, orig, extra)
            torch.cuda.synchronize()
            err_c = max(err_c, max_abs_err("lcp_compact(fill)",
                                           [o1, *got], [o2, *want]))
        windows.append(W)
        got = L.lcp_compact(out_k, i, j, hk, ak, orig, i.shape[0])
        want = L.lcp_compact_plain(out_p, i, j, hk, ak, orig, i.shape[0])
        torch.cuda.synchronize()
        err_c = max(err_c, max_abs_err(f"lcp_compact(W={W})",
                                       [out_k, *got], [out_p, *want]))
        m = int(got[4])
        if m == 0:
            break
        i, j, h, orig = (x[:m] for x in got[:4])
        act = torch.ones(m, dtype=torch.bool, device=dev)
        W = min(2 * W, L.LCP_W_MAX)
    errs["lcp_round"], errs["lcp_compact"] = err_r, err_c
    check(windows.count(L.LCP_W_MAX) >= 2,
          f"the parity corpus's LCP rounds never held W at 4096: {windows}")
    sa_np = sa.cpu().numpy()
    got = TL.lcp_array(prepared.text, sa_np, device=True,
                         torch_device="cuda")
    want, how = host_kasai(prepared.text, sa_np)
    check(np.array_equal(got, want), "lcp_array differs from host Kasai")
    check(np.array_equal(got, out_k.cpu().numpy()),
          "lcp_array differs from the round-by-round run")
    log(f"    kernel S: lcp_round and lcp_compact equal their plain "
        f"versions in each of {len(windows)} rounds (W {windows}); "
        f"lcp_array of n={n} equals host Kasai ({how}), largest LCP "
        f"{int(got.max())}")
    return {"windows": windows, "host_kasai": how,
            "max_lcp": int(got.max())}


def parity_paged_lcp(indexes, prose_ix, prepared, docs, text, sa, rng,
                     errs, d_libs, c_libs=None):
    """Phase 3's K16 and K17 checks (the one-step extract on both of
    kernel D's routes: d_libs; the masked step on both of kernel C's:
    c_libs)."""
    pdocs = prose_docs(int(PARITY_PROSE_MIB * 2**20))
    rec = {}
    for name, ix, dd in (("vseg", indexes["vseg"], docs),
                         ("vrle", indexes["vrle"], docs),
                         ("prose_vrle", prose_ix["vrle"], pdocs)):
        rec[f"{name} walk"] = parity_paged_steps(name, ix, rng, errs,
                                                 d_libs, c_libs)
        rec[name] = parity_paged_index(name, ix, dd, rng, errs)
    log(f"    K16: apply_faults, the masked step, lf_walk_step, "
        f"resolve_marks and the one-step extract equal their plain "
        f"versions on half-filled caches of the 8 MiB vseg and vrle and "
        f"the prose vrle index; PagedIndex on the card equals its CPU twin "
        f"(answers, stats, maps, cache): {rec}")
    rec["lcp"] = parity_lcp(prepared, text, sa, errs)
    return rec


def idle_gaps(prof, top=5):
    """The largest gaps (us) between the device's busy intervals of a
    profiled call, longest first, with where each starts."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda
                   and SPIN_KERNEL not in e.name)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = [(c - b, b - merged[0][0])
            for (_, b), (c, _) in zip(merged, merged[1:])]
    return [{"gap_us": g, "after_us": at}
            for g, at in sorted(gaps, reverse=True)[:top]]


def profile_with_gaps(name, fn):
    entry, prof = profile_step(name, fn, own_kernel_names())
    entry["largest_idle_gaps"] = idle_gaps(prof)
    log(f"      largest idle gaps (us, after us): "
        f"{[(round(g['gap_us'], 1), round(g['after_us'], 1)) for g in entry['largest_idle_gaps']]}")
    return entry


def phase_paged(record, rng, st, st3, st4, builds):
    """Phase 4f, paged serving (K16) at full size: phase 4c's zipf vrle
    (at a quarter and half of its rows) and vseg (a quarter) indexes and
    its prose vrle index (a quarter, seg 2048), each saved with save_flat
    and opened with load_paged, served cold (a fresh cache) and warm:
    count of phase 4's 32768 patterns, the same count over 32768 draws
    from 64 of them, locate of 65536 rows, phase 4d's prose queries
    through the engine (prose), and extract_document of one prose
    document of 8191 bytes (the prose in 8 KiB documents, seg 2048).
    Every answer equals the resident index's; a warm repeat adds no fault
    whenever the cold call's faults fit the cache.  Then the paged
    kernels' phase 5 rows (D's lf_walk_step also against its thread
    route: d_fields with builds' other-route library and latency probe)
    and one cold count profiled for phase 6."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch import paged as TP
    from femto_tpu_torch import query as Q
    from femto_tpu_torch.ops import paged_ops as PO
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.search import pack_patterns

    t_phase = time.perf_counter()
    card = record["toolchain"]["card"]
    dev = torch.device("cuda")
    zpats = st["patterns"]
    ppats = st3["ppats"]
    skew = {c: [p[int(k)] for k in rng.integers(0, N_SKEW, N_PATTERNS)]
            for c, p in (("zipf", zpats), ("prose", ppats))}
    pb = prose_bytes()
    xdocs = [pb[o: o + EXTRACT_DOC - 1]
             for o in range(0, len(pb), EXTRACT_DOC - 1)]
    xd = len(xdocs) // 2
    xix = tt.build_index(tt.prepare_documents(xdocs), seg=PROSE_SEG,
                         mark_period=20, tier="vrle", device="cuda")
    resident = {"zipf vrle": st3["zrows"]["vrle"],
                "zipf vseg": st3["zrows"]["vseg"],
                "prose vrle": st3["prows"]["vrle"], "prose8k vrle": xix}
    inputs = {"zipf": (zpats, st["loc_rows"]),
              "prose": (ppats, st3["ploc"])}
    queries = {name: (q, icase)
               for name, (q, _, icase) in PROSE_QUERIES.items()}
    tmp = tempfile.TemporaryDirectory()
    paths, ref, ref_ms = {}, {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def calls(corpus):
        pats, loc = inputs.get(corpus, (None, None))
        if corpus == "prose8k":
            return {"extract": lambda ix: tt.extract_document(ix, xd)}
        out = {"count": lambda ix: np.stack(tt.count_ranges(ix, pats)),
               "count_skewed": lambda ix: np.stack(
                   tt.count_ranges(ix, skew[corpus])),
               "locate": lambda ix: tt.locate_rows_array(ix, loc)}
        if corpus == "prose":
            for name, (q, icase) in queries.items():
                out[f"query {name}"] = (lambda ix, q=q, icase=icase: (
                    Q.count_query(ix, q, icase=icase),
                    [d for d, _, _ in Q.docs_query(
                        ix, q, with_offsets=False, icase=icase)]))
        return out

    # the resident answers and times, and the files, before the counted
    # region
    for key, ix in resident.items():
        paths[key] = os.path.join(tmp.name, key.replace(" ", "_") + ".ftpu")
        ix.save_flat(paths[key])
        corpus = key.split()[0]
        for what, fn in calls(corpus).items():
            fn(ix)
            ref[key, what], ref_ms[key, what] = timed(lambda: fn(ix))
    check(ref["prose8k vrle", "extract"] == xdocs[xd],
          "prose8k: the resident extract differs from the document")
    log(f"[4f] paged serving: {len(PAGED_CELLS)} cells and the prose8k "
        f"extract; files {({k: os.path.getsize(p) for k, p in paths.items()})} B")

    torch.cuda.synchronize()
    kernels.reset_launches()
    cells = {}
    for key, share in PAGED_CELLS + (("prose8k vrle", 0.25),):
        corpus = key.split()[0]
        budget = paged_budget(paths[key], share)
        pg = TP.load_paged(paths[key], budget, device="cuda")
        n_seg = pg.bwt_np.shape[0]
        cell = cells[f"{key} {share}"] = {
            "cache_rows": pg.cache_rows, "n_seg": n_seg,
            "row_bytes": 4 * pg.bwt_np.shape[1], "budget_bytes": budget,
            "calls": {}}
        for what, fn in calls(corpus).items():
            # cold: a fresh cache for each call
            pg = TP.load_paged(paths[key], budget, device="cuda")
            for pas in ("cold", "warm"):
                before = dict(pg.stats)
                f_s = pg.fault_seconds
                try:
                    got, ms = timed(lambda: fn(pg))
                except ValueError as e:
                    # femto_tpu's contract: a dispatch whose segments do
                    # not fit the cache is refused (a query layer wider
                    # than the cache); recorded, and held below
                    check("segments but the cache holds" in str(e)
                          and what.startswith("query"),
                          f"paged {key} {what}: {e}")
                    cell["calls"][f"{what} {pas}"] = {"refused": str(e)}
                    log(f"    {key} {share} {what} {pas}: refused: {e}")
                    break
                d = {k: pg.stats[k] - before[k] for k in pg.stats}
                fsec = pg.fault_seconds - f_s
                same = (np.array_equal(got, ref[key, what])
                        if isinstance(got, np.ndarray)
                        else got == ref[key, what])
                check(same, f"paged {key} {share} {what} ({pas}): the "
                            f"answer differs from the resident index's")
                r = cell["calls"][f"{what} {pas}"] = {
                    "ms": ms, **d, "fetched_mib": d["fetched_bytes"] / 2**20,
                    "fault_gb_per_s": (d["fetched_bytes"] / fsec / 1e9
                                       if fsec > 0 else None),
                    "resident_ms": ref_ms[key, what],
                    "x_resident": ms / ref_ms[key, what]}
                if what == "extract":
                    r["us_per_char"] = ms * 1e3 / len(got)
                if pas == "cold":
                    cold = d
                elif cold["faults"] <= pg.cache_rows - 1:
                    # the cold call from a fresh cache evicted nothing, so
                    # the warm repeat faults nothing
                    check(d["faults"] == 0,
                          f"paged {key} {share} {what}: the warm repeat "
                          f"faulted {d['faults']} rows")
                log(f"    {key} {share} {what} {pas}: {ms:.2f} ms "
                    f"({r['x_resident']:.1f}x resident), faults "
                    f"{d['faults']}, hits {d['hits']}, fetched "
                    f"{r['fetched_mib']:.2f} MiB, dispatches "
                    f"{d['dispatches']}, fault path "
                    f"{r['fault_gb_per_s']} GB/s"
                    + (f", {r['us_per_char']:.1f} us/char"
                       if "us_per_char" in r else ""))
        log(f"    {key} {share}: cache {pg.cache_rows} of {n_seg} rows")
        del pg
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    refused = [k for c in cells.values() for k, v in c["calls"].items()
               if "refused" in v]
    check(len([k for k in refused if "cold" in k]) <= len(queries) // 2,
          f"more than half the prose queries were refused: {refused}")
    for name in PATH_KERNELS["paged"]:
        check(launches[name] >= 1,
              f"kernel {name} was not launched on the paged path")
    log(f"    checks: every paged answer equals the resident index's; "
        f"warm repeats whose cold faults fit the cache fault nothing; "
        f"refused (layers wider than the cache): {refused}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # kernel C's masked step: its device ms over one count of each cell,
    # as built and on each route forced
    c_libs = c_forced(builds)
    runs = {}
    for key, share in PAGED_CELLS:
        pgc = TP.load_paged(paths[key], paged_budget(paths[key], share),
                            device="cuda")
        pats = inputs[key.split()[0]][0]
        runs[f"{key} {share} count"] = (lambda pgc=pgc, pats=pats: [
            a.tolist() for a in tt.count_ranges(pgc, pats)])
    c_sums = {"paged": {"backward_step_masked": route_sums(
        S, "backward_step_masked", "backward_search", c_libs, runs)}}
    del runs, pgc

    # phase 5's rows at the zipf cells' shapes (a quarter of the rows)
    log("[5] the paged path's kernels (zipf, a quarter of the rows):")
    rows5 = []
    d_libs = route_libs(builds["lf_walk"], "lf_walk")
    lat_ns = dependent_load_ns(builds["chase"])
    pv = {lay: TP.load_paged(paths[f"zipf {lay}"],
                             paged_budget(paths[f"zipf {lay}"], 0.25),
                             device="cuda") for lay in ROW_LAYOUTS}
    pg = pv["vrle"]
    n_seg, W = pg.bwt_np.shape
    m = min(65536, pg.cache_rows - 1)
    free = np.flatnonzero(pg._slot_map_np == 0)
    segs = np.sort(rng.choice(free, m, replace=False)).astype(np.int32)
    slots = (rng.permutation(pg.cache_rows - 1)[:m] + 1).astype(np.int32)
    fetched = torch.from_numpy(np.ascontiguousarray(pg.bwt_np[segs])).to(dev)
    t32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(dev)
    sl, sg, ev = t32(slots), t32(segs), t32(np.zeros(0, np.int32))
    ck, mk = pg._cache.clone(), pg._slot_map.clone()
    cp, mp_ = pg._cache.clone(), pg._slot_map.clone()

    def faults_k():
        PO.apply_faults(ck, mk, sl, fetched, ev, sg)
        return [ck, mk]

    def faults_p():
        PO.apply_faults_plain(cp, mp_, sl, fetched, ev, sg)
        return [cp, mp_]

    rows5.append(timed_row(
        "apply_faults", "paged", launches["apply_faults"], faults_k,
        faults_p, 8 * m * W + 12 * m, card,
        library=lambda: ck.view(torch.int32).index_copy_(
            0, sl.long(), fetched.view(torch.int32))))
    del ck, mk, cp, mp_, fetched
    # the count's last column from the ranges of the rest of each pattern
    pt = torch.from_numpy(pack_patterns(
        [pattern_to_alpha(p) for p in zpats], pad_b=len(zpats))[0]).to(dev)
    res = st3["zrows"]["vrle"]
    # a dispatch's lanes, as many as the cache serves at once
    lanes = min(pt.shape[0], (pg.cache_rows - 1) // 2)
    pt = pt[:lanes]
    loc = t32(st["loc_rows"][: pg.cache_rows - 1])
    for lay, pgl in pv.items():
        A_res = st3["zrows"][lay].arrays
        first, last = S.backward_search(A_res, res.meta.n_rows,
                                        pt[:, 1:].contiguous())
        c = pt[:, 0].contiguous()
        pgl._ensure_rows(torch.cat([first, last]).cpu().numpy())
        A = pgl.arrays
        rows5.append(timed_row(
            f"backward_step_masked[{lay}]", "paged",
            launches[f"backward_step_masked[{lay}]"],
            lambda: S.backward_step_masked(A, c, first, last),
            lambda: S.backward_step_masked_plain(A, c, first, last),
            bound_backward_step(A_res, c, first, last) * HBM_BYTES_PER_S
            / 1e3 + 8 * c.shape[0], card,
            extra=c_fields(c_libs, A, c.shape[0],
                           lambda: S.backward_step_masked(A, c, first, last),
                           f"backward_step_masked[{lay}] (paged)",
                           bound_backward_step(A_res, c, first, last,
                                               shared=False)
                           + 8 * c.shape[0] / HBM_BYTES_PER_S * 1e3)))
        # the walk's first step over the 65536 rows
        pgl._ensure_rows(loc.cpu().numpy())
        z = torch.zeros_like(loc)
        done = torch.zeros(loc.shape[0], dtype=torch.bool, device=dev)
        rows5.append(timed_row(
            f"lf_walk_step[{lay}]", "paged", launches[f"lf_walk_step[{lay}]"],
            lambda: S.lf_walk_step(A, loc, z, z, done, 0),
            lambda: S.lf_walk_step_plain(A, loc, z, z, done, 0),
            bound_walk_step(A_res, loc), card,
            extra=d_fields(d_libs, "lf_walk_step", A, loc.shape[0], 1,
                           lambda: S.lf_walk_step(A, loc, z, z, done, 0),
                           lat_ns)))
    granks = t32(rng.integers(0, res.meta.n_marks, loc.shape[0]))
    steps = t32(rng.integers(0, 21, loc.shape[0]))
    A = pv["vrle"].arrays
    rows5.append(timed_row(
        "resolve_marks", "paged", launches["resolve_marks"],
        lambda: [S.resolve_marks(A, granks, steps)],
        lambda: [S.resolve_marks_plain(A, granks, steps)],
        20 * loc.shape[0] + 20, card))
    # the prose8k extract's one-step launches and the queries' host-engine
    # step, on the prose indexes' quarter caches
    px = TP.load_paged(paths["prose8k vrle"],
                       paged_budget(paths["prose8k vrle"], 0.25),
                       device="cuda")
    xr = xix.arrays.doc_seof_rows[xd: xd + 1].contiguous()
    px._ensure_rows(xr.cpu().numpy())
    rows5.append(timed_row(
        "lf_extract[vrle]", "paged", launches["lf_extract[vrle]"],
        lambda: S.extract_backward(px.arrays, xr, 1),
        lambda: S.extract_backward_plain(px.arrays, xr, 1),
        bound_extract_rows(xix.arrays, xr), card))
    pp = TP.load_paged(paths["prose vrle"],
                       paged_budget(paths["prose vrle"], 0.25),
                       device="cuda")
    pres = st3["prows"]["vrle"]
    lanes = min(len(ppats), (pp.cache_rows - 1) // 2)
    ppt = torch.from_numpy(pack_patterns(
        [pattern_to_alpha(p) for p in ppats[:lanes]],
        pad_b=lanes)[0]).to(dev)
    pf, pl = S.backward_search(pres.arrays, pres.meta.n_rows,
                               ppt[:, 1:].contiguous())
    pc = ppt[:, 0].contiguous()
    pp._ensure_rows(torch.cat([pf, pl]).cpu().numpy())
    rows5.append(timed_row(
        "backward_step[vrle]", "paged", launches["backward_step[vrle]"],
        lambda: S.backward_step_pair(pp.arrays, pc, pf, pl),
        lambda: S.backward_step_plain(pp.arrays, pc, pf, pl),
        bound_backward_step(pres.arrays, pc, pf, pl) * HBM_BYTES_PER_S
        / 1e3 + 8 * lanes, card,
        extra=c_fields(c_libs, pp.arrays, lanes,
                       lambda: S.backward_step_pair(pp.arrays, pc, pf, pl),
                       "backward_step[vrle] (paged)",
                       bound_backward_step(pres.arrays, pc, pf, pl,
                                           shared=False)
                       + 8 * lanes / HBM_BYTES_PER_S * 1e3)))
    del pv, px, pp
    # phase 6: one cold count on zipf vrle at a quarter
    zq = paths["zipf vrle"]
    fresh = TP.load_paged(zq, paged_budget(zq, 0.25), device="cuda")
    prof = {"paged_cold_count_zipf_vrle_quarter": profile_with_gaps(
        "paged_cold_count_zipf_vrle_quarter",
        lambda: tt.count(fresh, zpats))}
    prof["paged_cold_count_zipf_vrle_quarter"]["stats"] = dict(fresh.stats)
    del fresh
    tmp.cleanup()
    record["paged_path"] = {"cells": cells, "launches": launches,
                            "refused": refused, "card": card,
                            "prose8k_doc": xd,
                            "prose8k_docs": len(xdocs),
                            "seconds": time.perf_counter() - t_phase}
    log(f"[4f] phase 4f took {record['paged_path']['seconds']:.1f}s")
    return {"launches": launches, "kernel_rows": rows5, "profile": prof,
            "c_sums": c_sums}


def bound_walk_step(arrays, rows):
    """Lanes in and out (13 bytes each way); per live lane the slot map
    entry and the mark word, and on a miss the code, C[c], a checkpoint
    and the counted prefix; on a hit the earlier mark words and the mark
    checkpoint (one step of bound_locate)."""
    from femto_tpu_torch.ops import rank as R

    seg = R.seg_size(arrays)
    code, ckpt, prefix, _ = _layout_bytes(arrays)
    _, bit, _ = R.lf_grank_step(arrays, rows)
    off = (rows % seg).long()
    total = 26 * rows.shape[0] + 8 * rows.shape[0]
    total += int((bit * (4 * (off // 32) + 4)).sum())
    total += int((~bit * (code + 4 + ckpt + prefix(rows.long() // seg, off))
                  ).sum())
    return total


def bound_extract_rows(arrays, rows):
    """One extract step from each row: a code, C[c], a checkpoint, the
    counted prefix, the symbol map and the slot map entry, rows in, the
    symbol and the row out."""
    from femto_tpu_torch.ops import rank as R

    seg = R.seg_size(arrays)
    code, ckpt, prefix, remap = _layout_bytes(arrays)
    return int((code + 4 + ckpt + remap + 4 + 12
                + prefix(rows.long() // seg, rows.long() % seg)).sum())


def lcp_bounds(text, i, j, h, valid, W, h_out, act):
    """Bytes of one lcp_round (each valid lane's symbols up to and
    including its first mismatch on both sides, its lane state in and
    out) and of the compaction after it (the lanes read once, the live
    ones written once, each resolved lane's answer)."""
    import torch

    ml = (h_out - h).long()
    sym = torch.where(act, ml, torch.clamp(ml + 1, max=W))
    nv = int(valid.sum())
    rnd = 8 * int((sym * valid).sum()) + 18 * nv + 10 * (valid.numel() - nv)
    live = int(act.sum())
    cmp = 17 * act.numel() + 16 * live + 4 * (act.numel() - live)
    return rnd, cmp


def phase_lcp(record, rng, st, st3):
    """Phase 4g, the LCP analytics (K17) at full size: lcp_array of phase
    4's corpus (n = 2^28) and of its twin from the port's own suffix
    arrays on the card, each held to a host byte compare at 65536 sampled
    ranks with lcp[0] == 0; on the prose, unique_lengths and
    suffix_similarity from the card's LCP against host Kasai's.  Then
    kernel S's phase 5 rows at the first round's shape and one lcp_array
    profiled for phase 6."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch import lcp as TL
    from femto_tpu_torch.ops import lcp_ops as L

    t_phase = time.perf_counter()
    card = record["toolchain"]["card"]
    dev = torch.device("cuda")
    corpora = {"zipf": (st["text"], st["index"].sa_direct,
                        st["prepared"].text),
               "twin": (text_tensor(st["twin_prepared"], dev),
                        st["twin_sa"], st["twin_prepared"].text)}
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = {}
    for name, (text, sa, _) in corpora.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcp = TL.lcp_array(text, sa, device=True, torch_device="cuda")
        s = time.perf_counter() - t0
        out[name] = {"lcp": lcp, "s": s, **TL.last_stats}
    pfull, pprep = st3["pfull"], st3["pprep"]
    psa = pfull.sa_direct
    t0 = time.perf_counter()
    plcp = TL.lcp_array(pprep.text, psa, device=True,
                           torch_device="cuda")
    ps = time.perf_counter() - t0
    pstats = dict(TL.last_stats)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    rec = {}
    for name, (text, sa, host_text) in corpora.items():
        o = out[name]
        lcp = o["lcp"]
        n = len(host_text)
        sa_np = sa.cpu().numpy()
        r = rng.integers(1, n, N_LCP_SAMPLES)
        want = host_lcp(host_text, sa_np[r].astype(np.int64),
                        sa_np[r - 1].astype(np.int64))
        check(lcp.shape == (n,) and lcp[0] == 0,
              f"lcp {name}: shape or lcp[0]")
        check(np.array_equal(lcp[r], want),
              f"lcp {name}: differs from a host byte compare at sampled "
              f"ranks")
        rec[name] = {"n": n, "s": o["s"], "mib_per_s": n / 2**20 / o["s"],
                     "rounds": o["rounds"], "windows": o["windows"],
                     "live": o["live"], "max_lcp": int(lcp.max())}
        log(f"[4g] lcp_array {name} (n={n}): {o['s'] * 1e3:.1f} ms, "
            f"{rec[name]['mib_per_s']:.1f} MiB/s, {o['rounds']} rounds "
            f"(W {o['windows']}), live lanes after each {o['live']}, "
            f"largest LCP {rec[name]['max_lcp']}; {N_LCP_SAMPLES} sampled "
            f"ranks equal a host byte compare")
    check(rec["twin"]["max_lcp"] >= DOC_SIZE - 2,
          "the twin corpus's duplicate document left no long LCP")
    psa_np = psa.cpu().numpy()
    host, how = host_kasai(pprep.text, psa_np)
    check(np.array_equal(plcp, host), "prose: lcp_array differs from host "
                                      "Kasai")
    ul = TL.unique_lengths(pprep, psa_np, plcp)
    check(np.array_equal(ul, TL.unique_lengths(pprep, psa_np, host)),
          "prose: unique_lengths differ")
    sim = TL.suffix_similarity(pprep, psa_np, plcp,
                               min_lcp=SIMILARITY_MIN_LCP)
    check(sim == TL.suffix_similarity(pprep, psa_np, host,
                                      min_lcp=SIMILARITY_MIN_LCP) and sim,
          "prose: suffix_similarity differs (or is empty)")
    rec["prose"] = {"n": pprep.n, "s": ps, "mib_per_s": pprep.n / 2**20 / ps,
                    "rounds": pstats["rounds"], "live": pstats["live"],
                    "host_kasai": how, "max_lcp": int(plcp.max()),
                    "unique_positions": int((ul > 0).sum()),
                    "similar_pairs": len(sim)}
    log(f"[4g] prose (n={pprep.n}): lcp_array {ps * 1e3:.1f} ms "
        f"({rec['prose']['mib_per_s']:.1f} MiB/s, {pstats['rounds']} rounds, "
        f"live {pstats['live']}) equals host Kasai ({how}); unique_lengths "
        f"and suffix_similarity (min_lcp {SIMILARITY_MIN_LCP}, "
        f"{len(sim)} pairs) equal; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for name in PATH_KERNELS["lcp"]:
        check(launches[name] >= 1,
              f"kernel {name} was not launched on the lcp path")
    # phase 5: kernel S at the first round's shape (2^28 lanes, W 32)
    log("[5] the lcp path's kernels (zipf, the first round):")
    text, sa, _ = corpora["zipf"]
    n = text.shape[0]
    j = torch.cat([sa[:1], sa[:-1]])
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[0] = False
    h0 = torch.zeros(n, dtype=torch.int32, device=dev)
    h1, act = L.lcp_round(text, sa, j, h0, valid, L.LCP_W_MIN)
    rnd, cmp = lcp_bounds(text, sa, j, h0, valid, L.LCP_W_MIN, h1, act)
    rows5 = [timed_row(
        "lcp_round", "lcp", launches["lcp_round"],
        lambda: list(L.lcp_round(text, sa, j, h0, valid, L.LCP_W_MIN)),
        lambda: list(L.lcp_round_plain(text, sa, j, h0, valid,
                                       L.LCP_W_MIN)), rnd, card)]
    orig = torch.arange(n, dtype=torch.int32, device=dev)
    outs = [torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(2)]
    rows5.append(timed_row(
        "lcp_compact", "lcp", launches["lcp_compact"],
        lambda: [outs[0], *L.lcp_compact(outs[0], sa, j, h1, act, orig, n)],
        lambda: [outs[1], *L.lcp_compact_plain(outs[1], sa, j, h1, act,
                                               orig, n)], cmp, card))
    del j, valid, h0, h1, act, orig, outs
    # phase 6: one lcp_array at 2^28
    prof = {"lcp_array_zipf": profile_with_gaps(
        "lcp_array_zipf", lambda: TL.lcp_array(text, sa, device=True,
                                              torch_device="cuda"))}
    record["lcp_path"] = {**rec, "launches": launches, "card": card,
                          "seconds": time.perf_counter() - t_phase}
    log(f"[4g] phase 4g took {record['lcp_path']['seconds']:.1f}s")
    return {"launches": launches, "kernel_rows": rows5, "profile": prof}


# ---------------------------------------------------------------------------
# the sharded index (K18a-K18f): phase 3's parity, phase 4h, phase 5's rows
# ---------------------------------------------------------------------------


class _Captured(Exception):
    """Stops a build at the call that captured_call waits for."""


def captured_call(name, pick, build, mod=None):
    """The arguments of the first call of <mod>.<name> (mod: ops/dist_ops
    unless given) in build() for which pick(args, kwargs) holds (pick
    None: the first call), as (positional, keyword) with the defaults
    filled in.  The build stops there, before the kernel runs: the inputs
    are as the path made them, and nothing else of the build stays
    alive."""
    import inspect

    if mod is None:
        from femto_tpu_torch.ops import dist_ops as mod
    fn = getattr(mod, name)
    got = []

    def hook(*a, **kw):
        if pick is None or pick(a, kw):
            got.append(inspect.signature(fn).bind(*a, **kw))
            raise _Captured
        return fn(*a, **kw)

    setattr(mod, name, hook)
    try:
        build()
    except _Captured:
        pass
    finally:
        setattr(mod, name, fn)
    check(bool(got), f"the path made no call of {name}")
    got[0].apply_defaults()
    return list(got[0].args), dict(got[0].kwargs)


def _copied(x):
    """x with every tensor in it (in lists, tuples and dicts) cloned."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_copied(v) for v in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return x


def first_calls(entries, builds):
    """The arguments of one call of each <mod>.<name> of entries (mod,
    name, size) in the builds, run in order (each to its end) until every
    entry has been called: the first call, or where size is given the
    call with the largest size(positional) (the first of equals).
    {name: (positional, keyword)} with the defaults filled in, copied at
    the call (the build goes on and may reuse its buffers)."""
    import inspect

    fns = {(mod, name): getattr(mod, name) for mod, name, _ in entries}
    got, best = {}, {}

    def hook(mod, name, size):
        fn = fns[mod, name]

        def call(*a, **kw):
            b = inspect.signature(fn).bind(*a, **kw)
            b.apply_defaults()
            k = 0 if size is None else size(list(b.args))
            if name not in got or (size is not None and k > best[name]):
                got[name] = (_copied(list(b.args)), _copied(dict(b.kwargs)))
                best[name] = k
            return fn(*a, **kw)
        return call

    for mod, name, size in entries:
        setattr(mod, name, hook(mod, name, size))
    try:
        for build in builds:
            if len(got) == len(entries) and all(
                    size is None for _, _, size in entries):
                break
            build()
    finally:
        for (mod, name), fn in fns.items():
            setattr(mod, name, fn)
    missing = sorted({name for _, name, _ in entries} - set(got))
    check(not missing, f"the builds made no call of {missing}")
    return got


def _records_in(v, base, R, m, blocks):
    """The records of local shards d (global positions base[d] .. base[d]
    + min(v[d], R)) that fall in the blocks of m of the shards blocks(d)
    (global indexes): those that rebalance_local or rebalance_place
    moves."""
    n = 0
    for j, (vj, bj) in enumerate(zip(v.tolist(), base.tolist())):
        for k in blocks(j):
            n += max(0, min(bj + min(vj, R), (k + 1) * m) - max(bj, k * m))
    return n


def _owner_targets(idx, valid, recs, outs, base_mul, shard0):
    """owner_place's writes as flat indexes into outs[c].view(-1), and the
    values each column writes there."""
    import torch

    Dl, M = outs[0].shape
    rep = idx.dim() == 1
    ii = idx.long()[None].expand(Dl, -1) if rep else idx.long()
    j = torch.arange(Dl, device=idx.device)[:, None]
    loc = ii - (shard0 + j) * base_mul
    ok = (loc >= 0) & (loc < M)
    if valid is not None:
        ok &= (valid[None] if rep else valid).bool()
    return (loc + j * M)[ok], [(r[None].expand(Dl, -1) if rep else r)[ok]
                               for r in recs]


# the K18 build kernels of phase 5's rows, each with the call of it in a
# full-tier sharded build that its row takes (a test of the call's
# arguments; None: the first call).  add_base, which the path does not
# call, takes add_mesh_base's call at the occ site with the base given
# (sharded_cases).
SHARDED_CALLS = (
    ("seed_keys", None), ("payload_block", None), ("splitter_bucket", None),
    ("bucket_pack", None),
    ("rebalance_local", None),
    ("mesh_flags", None), ("mesh_scan", None), ("compact_rows", None),
    ("fetch_owned", None), ("owner_place", None),
    ("mesh_exclusive", lambda a, kw: kw.get("op", "sum") == "sum"),
    ("add_mesh_base", lambda a, kw: kw.get("want_c", False)))


def library_prefix(g, shard0, Dl, want_c):
    """The library's whole mesh prefix of gathered int32[D, A] (op sum):
    an inclusive cumsum over the shards, the shift to an exclusive base
    and C's scan of the column sums: (base int32[Dl, A], C or None)."""
    import torch

    inc = torch.cumsum(g, 0, dtype=torch.int32)
    base = inc[shard0: shard0 + Dl] - g[shard0: shard0 + Dl]
    C = None
    if want_c:
        C = torch.zeros(g.shape[1] + 1, dtype=torch.int32, device=g.device)
        torch.cumsum(inc[-1], 0, dtype=torch.int32, out=C[1:])
    return base, C


def sharded_case(name, a, kw, occ=None):
    """One K18 build kernel on its captured arguments a, kw (add_base: of
    add_mesh_base's call): {"run_k", "run_p", "nbytes" (bytes
    moved), "library" (a library call or None), "library_full" (the
    library's whole function where "library" computes less, or None),
    "more" (a call that returns more timed fields, or None), "extra" (the
    row's fixed fields)}.  The in-place kernels (owner_place, add_base,
    add_mesh_base) write into copies of their outputs, one for the
    kernel, one for the plain version and one for the library call.
    mesh_exclusive is also timed at `occ`, the occ site's add_mesh_base
    arguments (its call before the redesign)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    if name == "rebalance_place":
        # a DistMesh process's buffer for a neighbour: the seed sort's
        # records at the offset, +1 or -1, that moves more of them
        cols, v, base = a

        def moved(off):
            return _records_in(v, base, cols[0].shape[1], kw["m"],
                               lambda j: [kw["shard0"] + j + off])
        kw = {"m": kw["m"], "off": max((1, -1), key=moved),
              "shard0": kw["shard0"]}
    if name == "add_base":
        # the occ site's x with the base its prefix gives
        x, g = a
        base = DO.mesh_exclusive_plain(g, shard0=kw["shard0"],
                                       Dl=x.shape[0], op="sum",
                                       want_c=False)[0]
        a, kw = [x, base], {}
    fk, fp = getattr(DO, name), getattr(DO, name + "_plain")

    def both():
        return (lambda: _flat([fk(*a, **kw)]),
                lambda: _flat([fp(*a, **kw)]))

    def size(xs):
        return sum(4 * x.numel() for x in xs if x is not None)

    case = {"library_full": None, "more": None, "extra": {}}
    if name in ("owner_place", "add_base", "add_mesh_base"):
        outs = a[3] if name == "owner_place" else [a[0]]
        mine = {who: [o.clone() for o in outs]
                for who in ("kernel", "plain", "library")}

        def run(f, who):
            # owner_place writes each target once, so a repeat leaves its
            # outputs as they were; add_base and add_mesh_base are held to
            # their plain versions after one call each (timed_row's first)
            if name == "owner_place":
                f(*a[:3], mine[who], **kw)
                return mine[who]
            return mine[who] + _flat([f(mine[who][0], *a[1:], **kw)])

        if name == "owner_place":
            flat, vals = _owner_targets(*a, **kw)
            nbytes = 5 * a[0].numel() + 8 * sum(v.numel() for v in vals)

            def lib():
                # the bare scatter of the targets found above
                for o, v in zip(mine["library"], vals):
                    o.view(-1).index_put_((flat,), v)

            def lib_full():
                # the whole function: the targets, then the scatter
                f, vs = _owner_targets(*a[:3], mine["library"], **kw)
                for o, v in zip(mine["library"], vs):
                    o.view(-1).index_put_((f,), v)
            case["library_full"] = lib_full
            case["extra"].update(
                library="index_put_ of the targets found outside the call "
                        "(the bare scatter)",
                library_full="_owner_targets and index_put_")
        elif name == "add_base":
            nbytes = 8 * a[0].numel() + 4 * a[1].numel()
            case["extra"]["x"] = list(a[0].shape)

            def lib():
                mine["library"][0].add_(a[1][:, None, :])
        else:
            x, g = a
            Dl, _, A = x.shape
            nbytes = (8 * x.numel() + size([g])
                      + 4 * (A + 1) * kw["want_c"]
                      + 4 * Dl * A * kw["want_base"])

            def lib():
                # the library's pair: the whole prefix, then add_
                base, C = library_prefix(g, kw["shard0"], Dl, kw["want_c"])
                mine["library"][0].add_(base[:, None, :])
                return base, C
            case["extra"]["x"] = list(x.shape)
        return {**case, "run_k": lambda: run(fk, "kernel"),
                "run_p": lambda: run(fp, "plain"), "nbytes": nbytes,
                "library": lib}
    run_k, run_p = both()
    lib = None
    if name == "seed_keys":
        nbytes = size([a[0]]) + 4 * kw["nkeys"] * a[0].shape[0] * kw["m"]
    elif name == "payload_block":
        nbytes = 2 * size([a[0]]) + size([a[2]])
    elif name == "splitter_bucket":
        nbytes = size(a[0]) + size([a[0][0]]) + size(a[1])
    elif name == "bucket_pack":
        dest, cols = a
        valid = kw["valid"]
        Dl, mm = dest.shape
        slots = Dl * kw["D"] * kw["cap"]
        nbytes = (size([dest, *cols]) + (4 * len(cols) + 1) * slots
                  + (valid.numel() if valid is not None else 0))
        case["extra"].update(k18a_shape(dest, cols, kw))
        # what one allocation of every output would hold past the last
        # column's send, over one allocation a column (parallel/bins.py)
        case["extra"]["one_allocation_extra_bytes"] = (
            (4 * (len(cols) - 1) + 1) * slots)

        def lib():
            return _sort_scatter(dest, cols, valid, kw["D"])
    elif name in ("rebalance_local", "rebalance_place"):
        cols, v, base = a
        Dl, R = cols[0].shape
        if name == "rebalance_local":
            W = kw["W"]
            moved = _records_in(v, base, R, kw["m"], lambda j: range(
                kw["shard0"] + max(j - W, 0),
                kw["shard0"] + min(j + W, Dl - 1) + 1))
            out = 4 * len(cols)  # a place's bytes: the columns
        else:
            moved = _records_in(v, base, R, kw["m"],
                                lambda j: [kw["shard0"] + j + kw["off"]])
            out = 4 * len(cols) + 1  # and the flag
        # the moved records read once, every place written once, v, base
        # (and far)
        nbytes = 4 * len(cols) * moved + out * Dl * kw["m"] + 12 * Dl
        case["extra"].update(Dl=Dl, R=R, m=kw["m"], ncols=len(cols),
                             records_moved=moved)
    elif name == "mesh_flags":
        nbytes = size(a[0]) + a[0][0].numel() + size(a[1])
        case["extra"].update(keys=list(a[0][0].shape), nk=len(a[0]),
                             shard0=kw["shard0"], first=kw["first"])
        case["more"] = lambda: parent_fields(name, "dist_rounds", run_k)
    elif name == "mesh_scan":
        # the flags read once, the flagged slots where given, out and last
        # written once (the rule of the row before the redesign too)
        flags = a[0]
        slots = kw["slots"]
        nbytes = (5 * flags.numel() + 4 * flags.shape[0]
                  + (4 * int(flags.count_nonzero()) if slots is not None
                     else 0))
        case["extra"].update(
            flags=list(flags.shape), mode=kw["mode"],
            slots=slots is not None, old_bound_ms=bound_ms(
                5 * flags.numel() + size([slots]) + 4 * flags.shape[0]))
        if kw["mode"] == "sum" and slots is None:
            def lib():
                return torch.cumsum(flags, 1, dtype=torch.int32)
    elif name == "compact_rows":
        # the flags and the kept slots' columns read once, each place of
        # every column written once; old_bound_ms: the row's rule before
        # the redesign, which also read the rank mesh_scan wrote
        flags, off, cols = a
        M = kw["M"]
        took = sum(min(c, max(0, M - o)) for c, o in zip(
            flags.sum(dim=1, dtype=torch.int64).tolist(), off.tolist()))
        moved = (4 * took * sum(c is not None for c in cols)
                 + 4 * len(cols) * flags.shape[0] * M)
        nbytes = flags.numel() + moved
        case["extra"].update(flags=list(flags.shape), ncols=len(cols),
                             M=M, kept=took,
                             old_bound_ms=bound_ms(5 * flags.numel()
                                                   + moved))
    elif name == "fetch_owned":
        src, idx, valid = a
        nv = idx.numel() if valid is None else int(valid.sum())
        nbytes = (5 * idx.numel() + 4 * kw["T"] * nv
                  + 4 * src.shape[0] * kw["T"] * idx.numel())
    elif name == "mesh_exclusive":
        g = a[0]
        nbytes = (size([g]) + 4 * kw["Dl"] * g.shape[1]
                  + 4 * (g.shape[1] + 1) * kw["want_c"])

        def lib():
            return torch.cumsum(g, 0)

        case["library_full"] = lambda: library_prefix(
            g, kw["shard0"], kw["Dl"], kw["want_c"])
        case["extra"].update(gathered=list(g.shape), op=kw["op"],
                             want_c=kw["want_c"])
        if occ is not None:
            case["more"] = lambda: {"at_occ_site": prefix_at_occ_site(
                occ[0][1], occ[1]["shard0"], occ[0][0].shape[0])}
    else:
        raise ValueError(f"no phase 5 case for {name}")
    return {**case, "run_k": run_k, "run_p": run_p, "nbytes": nbytes,
            "library": lib}


def prefix_at_occ_site(g, shard0, Dl):
    """mesh_exclusive (op sum, with C) on the occ site's gathered totals,
    its call there before the redesign: held to its plain version, then
    in turns with torch.cumsum(g, 0) and with the library's whole
    prefix."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    def run_k():
        return _flat([DO.mesh_exclusive(g, shard0=shard0, Dl=Dl,
                                        want_c=True)])

    max_abs_err("mesh_exclusive (the occ site)", run_k(), _flat(
        [DO.mesh_exclusive_plain(g, shard0=shard0, Dl=Dl, op="sum",
                                 want_c=True)]))
    ms, lib_ms, turns = turn_fields("mesh_exclusive", run_k,
                                    lambda: torch.cumsum(g, 0))
    return {"gathered": list(g.shape), "want_c": True, "ms": ms,
            "library_ms": lib_ms, **turns,
            **full_fields("mesh_exclusive", run_k,
                          lambda: library_prefix(g, shard0, Dl, True))}


def sharded_cases(mesh, prepared, seg, mark_period, occ_site=False):
    """Each K18 build kernel of SHARDED_CALLS at the inputs that a
    full-tier sharded build of `prepared` on `mesh` gives it: the build
    runs up to the kernel's call and stops there (captured_call; with
    `occ_site`, mesh_exclusive's case also gets the occ site's call).
    Yields each kernel's sharded_case with its "name", one kernel at a
    time; a kernel's inputs are dropped before the next build."""
    from femto_tpu_torch.parallel import build_index_sharded

    def build():
        build_index_sharded(prepared, mesh, seg=seg, mark_period=mark_period)

    for name, pick in SHARDED_CALLS:
        occ = (captured_call("add_mesh_base",
                             lambda a, kw: kw.get("want_c", False), build)
               if occ_site and name == "mesh_exclusive" else None)
        a, kw = captured_call(name, pick, build)
        for row in [name] + [k for k, v in NO_CALLER.items() if v == name]:
            case = sharded_case(row, a, kw, occ=occ)
            yield {"name": row, "nbytes": case["nbytes"],
                   "extra": case["extra"],
                   **{k: (lambda k=k, case=case: case[k]())
                      if case[k] else None
                      for k in ("run_k", "run_p", "library",
                                "library_full", "more")}}
            # the consumer may still hold the lambdas: empty what they
            # reach
            case.clear()
        del occ, a, kw


# kernels M, N and P of the sharded row-tier builds (K18g): phase 5 times
# each at its first call in 4h's builds (first_calls)
SHARDED_ROW_KERNELS = ("seg_syms", "vseg_rows", "side_rows",
                       "vrle_slot_count", "vrle_pack", "cont_flatten",
                       "doc_lists", "flatten_ragged")


def row_case(name, a, kw):
    """(run_k, run_p, bytes moved, library call or None) of kernel M, N or
    P on captured arguments: what the kernel reads of its inputs, once
    (as bound_row_kernels counts it: the BWT of the segments it packs, the
    words a continuation copies), and its outputs once.  P's doc_lists
    against torch.sort of its rows' documents."""
    import torch

    from femto_tpu_torch.ops import build_ops as BO

    fk, fp = getattr(BO, name), getattr(BO, name + "_plain")

    def run_k():
        return _flat([fk(*a, **kw)])

    def run_p():
        return _flat([fp(*a, **kw)])

    out = sum(t.numel() * t.element_size() for t in run_k())
    lib = None
    if name == "seg_syms":
        reads = 4 * a[0].numel()
    elif name == "vseg_rows":
        bwt, amap, syms, nsym, woff, mbits, mckpt, occ_rel = a
        n_seg, seg = bwt.shape
        w = woff.long()
        reads = (2 * int((w == 0).sum()) * seg
                 + 4 * int((w < 0).sum()) * kw["code_words"]
                 + 4 * amap.numel() + 4 * n_seg * kw["s_store"]
                 + nsym.numel() + 4 * n_seg
                 + sum(t.numel() * t.element_size()
                       for t in (mbits, mckpt, occ_rel)))
    elif name == "side_rows":
        bwt, amap, ovf = a
        reads = 2 * ovf.numel() * bwt.shape[1] + 4 * amap.numel() \
            + 4 * ovf.numel()
    elif name == "vrle_slot_count":
        bwt, amap, syms, nsym = a
        reads = 2 * bwt.numel() + 4 * amap.numel() + 4 * syms.numel() \
            + nsym.numel()
    elif name == "vrle_pack":
        bwt, amap, syms, nsym, woff = a
        n_seg, seg = bwt.shape
        n_rle = int((woff < 0).sum())
        reads = (2 * n_rle * seg + 4 * amap.numel()
                 + 4 * n_rle * syms.shape[1] + nsym.numel() + 4 * n_seg)
    elif name == "cont_flatten":
        _, cidx, cwords, _ = a
        reads = 4 * int(cwords.sum()) + 12 * cidx.numel()
    elif name == "doc_lists":
        sa, ds = a
        reads = 4 * sa.numel() + 4 * ds.numel()
        n_seg, seg = kw["n_seg"], kw["seg"]
        doc = torch.searchsorted(ds.long(), sa.long(), right=True) - 1
        tile = torch.full((n_seg * seg,), 2**31 - 1, dtype=torch.int32,
                          device=sa.device)
        tile[: sa.numel()] = torch.where(
            (sa >= 0) & (sa < kw["n_real"]), doc, 2**31 - 1).to(torch.int32)
        tile = tile.view(n_seg, seg)

        def lib():
            return torch.sort(tile, dim=1)
    elif name == "flatten_ragged":
        _, counts, offsets = a
        reads = 4 * counts.numel() + 8 * offsets.numel() \
            + 4 * int(offsets[-1])
    else:
        raise ValueError(f"no phase 5 case for {name}")
    return run_k, run_p, reads + out, lib


def sharded_build_calls():
    """first_calls' entries of the per-shard kernels that the sharded
    path shares with the single-device builds: A, B (as shard_marks), G,
    H and L in a full-tier build (H and L at their largest calls: the
    local sort of a shard's received records), A' and F in a compact
    one."""
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import sort_ops as SO

    return [(BO, "occ_build", None), (DO, "shard_marks", None),
            (SO, "sym_hist", None),
            (SO, "radix_sort_pairs", lambda a: a[0].numel()),
            (SO, "gather_rows", lambda a: a[1].numel()),
            (SO, "gather_cols", lambda a: a[1].numel() * len(a[0])),
            (BO, "occ_build_compact", None), (BO, "pack_build", None)]


def build_case(name, a, kw):
    """(row name, run_k, run_p, bytes moved, library call or None) of a
    kernel of sharded_build_calls on captured arguments, its bytes as the
    single-device rows count them (bound_occ_build, bound_sort_kernels
    and the rest) at these inputs."""
    import torch

    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import sort_ops as SO

    mod = DO if name == "shard_marks" else (
        SO if name in ("sym_hist", "radix_sort_pairs", "gather_rows",
                       "gather_cols")
        else BO)
    fk, fp = getattr(mod, name), getattr(mod, name + "_plain")
    pa, pkw = a, kw
    if name == "occ_build_compact":
        # its plain version takes no symbol map
        pa = [a[0], a[2]]
    elif name == "gather_cols":
        # the plain version writes into outputs of its own and returns none
        pa = [a[0], a[1], [o.clone() for o in a[2]]]
        fp = lambda s_, i_, o_: (  # noqa: E731
            SO.gather_cols_plain(s_, i_, o_), list(o_))[1]

    def run_k():
        return _flat([fk(*a, **kw)])

    def run_p():
        return _flat([fp(*pa, **pkw)])

    lib = None
    if name == "occ_build":
        pull = a[0]
        n, n_seg, seg = pull.numel(), kw["n_seg"], kw["seg"]
        nbytes = (8 * n + 2 * n_seg * seg + 4 * n + 4 * 261 * n_seg
                  + 4 * 262)
        seg_sym = (torch.arange(n, device=pull.device) // seg) * 261 \
            + (pull & 511)

        def lib():
            return torch.bincount(seg_sym, minlength=n_seg * 261)
    elif name == "occ_build_compact":
        pull, _, arev = a
        n, n_seg, seg = pull.numel(), kw["n_seg"], kw["seg"]
        out = run_k()
        nbytes = 8 * n + 4 * 261 + sum(t.numel() * t.element_size()
                                       for t in out)
        seg_sym = (torch.arange(n, device=pull.device) // seg) * 261 \
            + (pull & 511)
        del out

        def lib():
            return torch.bincount(seg_sym, minlength=n_seg * 261)
    elif name == "pack_build":
        bwt = a[0]
        out = run_k()[0]
        nbytes = 2 * bwt.numel() + 4 * 261 + out.numel() * out.element_size()
        del out
    elif name == "shard_marks":
        sa = a[0]
        name = "marks_build"
        mb, mc, mv, cnt, _ = fk(*a, **kw)
        nbytes = (4 * sa.numel() + 4 * int(cnt[0]) + 4 * mb.numel()
                  + 4 * mc.numel() + 4 * mv.numel() + 4 * kw["ndocs"])
        del mb, mc, mv, cnt
    elif name == "sym_hist":
        text = a[0]
        nbytes = 4 * text.numel() + 4 * 513

        def lib():
            return torch.bincount(text, minlength=512)
    elif name == "radix_sort_pairs":
        keys = a[0]
        nbytes = 24 * keys.numel()

        def lib():
            return torch.sort(keys, stable=True)
    elif name == "gather_rows":
        src, idx = a
        nbytes = gather_bytes([src], idx)[0]

        def lib():
            return torch.index_select(src, 0, idx)
    elif name == "gather_cols":
        srcs, idx = a[0], a[1]
        nbytes = gather_bytes(srcs, idx)[0]
    else:
        raise ValueError(f"no phase 5 case for {name}")
    return name, run_k, run_p, nbytes, lib


def sharded_layer_calls(ix, mesh, q, fcap):
    """The widest layer of the sharded search of q on ix
    (sharded_regexp_matches from frontier cap fcap, its retries included):
    (depth, n_live, {entry: (positional, keyword)}) of that layer's calls
    of K18f masked_occ_rows, R regex_fork_ranked, H radix_sort_pairs and R
    regex_merge, each captured at its call there (captured_call: the
    search runs again and stops before the kernel)."""
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import sort_ops as SO
    from femto_tpu_torch.parallel import sharded_regexp_matches

    node, nfa = query_nfa(q)
    seen = []
    sharded_regexp_matches(ix, mesh, nfa, node.approx, frontier_cap=fcap,
                           on_layer=lambda d, n_live, *_: seen.append(
                               (d, n_live)))
    # a layer each: one masked_occ_rows, fork, sort and merge; the run
    # that answered starts at the last depth 0
    start = max(i for i, (d, _) in enumerate(seen) if d == 0)
    k = max(range(start, len(seen)), key=lambda i: seen[i][1])
    calls = {}
    for name, mod in (("masked_occ_rows", DO), ("regex_fork_ranked", RO),
                      ("radix_sort_pairs", SO), ("regex_merge", RO)):
        count = [0]

        def pick(a, kw, count=count):
            count[0] += 1
            return count[0] == k + 1

        calls[name] = captured_call(
            name, pick, lambda: sharded_regexp_matches(
                ix, mesh, nfa, node.approx, frontier_cap=fcap), mod)
    return seen[k][0], seen[k][1], calls


def _flat(xs):
    """The tensors of nested lists and tuples, in order (None dropped)."""
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out += _flat(x)
        elif x is not None:
            out.append(x)
    return out


def _sort_scatter(dest, cols, valid=None, D=None):
    """bucket_pack's yardstick: one library sort of the destinations (the
    lanes whose valid flag is 0 sent to D first, where flags are given)
    and a scatter of every column through its order."""
    import torch

    if valid is not None:
        dest = torch.where(valid.bool(), dest, D)
    order = torch.sort(dest.view(-1), stable=True)[1]
    return [torch.empty_like(c).view(-1).index_copy_(0, order, c.view(-1))
            for c in cols]


def sharded_prefix_bytes(arrays, nseg_local):
    """_layout_bytes' (checkpoint bytes, row-prefix bytes as a function of
    (view segment, off)) of a LocalMesh's sharded index: a row tier's
    prefix is read in each segment's own shard (per-shard side tables and
    continuation stores)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import rank as R

    _, ckpt, prefix, _ = _layout_bytes(arrays)
    if not R.is_row_tier(arrays):
        return ckpt, prefix
    Dl = arrays.bwt.shape[0] // nseg_local
    subs = [_row_prefix_bytes(DO._row_shard(arrays, d, nseg_local))
            for d in range(Dl)]

    def sharded(s, off):
        s = s.long()
        out = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
        for d in range(Dl):
            sel = torch.div(s, nseg_local, rounding_mode="floor") == d
            if bool(sel.any()):
                out[sel] = subs[d](s[sel] - d * nseg_local, off[sel]).long()
        return out
    return ckpt, sharded


def sharded_query_cases(index, mesh, rng, B):
    """K18f's inputs for one sharded index at B lanes: routed requests
    (each shard's rows inside its own block, codes from the index's
    alphabet) and replicated ones."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import rank as R

    D = mesh.D
    dev = mesh.device
    meta = index.meta
    nseg_local = meta.n_seg // D
    rps = nseg_local * meta.seg
    A = index.arrays
    K = R.alpha_count(A)
    rows_r = torch.from_numpy((rng.integers(0, rps, size=(D, B))
                               + np.arange(D)[:, None] * rps).astype(
        np.int32)).to(dev)
    cd_r = torch.from_numpy(rng.integers(0, K, size=(D, B)).astype(
        np.int32)).to(dev)
    val_r = torch.ones((D, B), dtype=torch.uint8, device=dev)
    rows_b = rows_r.reshape(-1)[:B].contiguous()
    cd_b = cd_r.reshape(-1)[:B].contiguous()
    kw = dict(nseg_local=nseg_local, shard0=0)
    nrt = D * rps
    ckpt, prefix = sharded_prefix_bytes(A, nseg_local)

    def lane_bytes(r):
        rl = r.reshape(-1).long()
        return int((ckpt + 4 + prefix(rl // meta.seg, rl % meta.seg)).sum())

    return {
        "owner_occ": (
            lambda: [DO.owner_occ(A, rows_r, cd_r, val_r, n_rows_total=nrt,
                                  **kw)],
            lambda: [DO.owner_occ_plain(A, rows_r, cd_r, val_r,
                                        n_rows_total=nrt, **kw)],
            13 * D * B + lane_bytes(rows_r)),
        "masked_occ": (
            lambda: [DO.masked_occ(A, cd_b, rows_b, Dl=D, n_rows_total=nrt,
                                   **kw)],
            lambda: [DO.masked_occ_plain(A, cd_b, rows_b, Dl=D,
                                         n_rows_total=nrt, **kw)],
            8 * B + 4 * D * B + lane_bytes(rows_b)),
        "owner_lf": (
            lambda: [DO.owner_lf(A, rows_r, val_r, **kw)],
            lambda: [DO.owner_lf_plain(A, rows_r, val_r, **kw)],
            9 * D * B + lane_bytes(rows_r) + 8 * D * B),
        "masked_lf": (
            lambda: [DO.masked_lf(A, rows_b, Dl=D, **kw)],
            lambda: [DO.masked_lf_plain(A, rows_b, Dl=D, **kw)],
            4 * B + 4 * D * B + lane_bytes(rows_b) + 8 * B),
    }


# phase 3's rebalance shapes (parity_rebalance_edges): a mesh of REB_D
# shards, blocks of m places (one m not a multiple of a kernel block's 1024
# places), REB_COLS columns, and each case's received counts as fractions
# of m (base their exclusive prefix, at most REB_D * m in all) with its
# window W: uneven blocks; an empty shard, with places left unfilled; and
# at W = 1 a far owner (shard 0's records reach shard 2)
REB_D = 4
REB_MS = (1000, 1 << 20)
REB_COLS = 5
REB_CASES = {"uneven": ((0.5, 1.75, 1.0, 0.75), 3),
             "empty_unfilled": ((1.5, 0.0, 1.25, 1.0), 3),
             "far_owner": ((2.5, 0.5, 0.5, 0.5), 1)}


def parity_rebalance_edges(rng):
    """K18b's rebalance on the card against its plain versions on the same
    card tensors, bit for bit, at every case of REB_CASES and m of REB_MS
    (R three records past the largest count): rebalance_local at Dl =
    REB_D (a LocalMesh) and at Dl = 1 with each shard0 in 0..REB_D - 1
    (one DistMesh process's view), and at Dl = 1 rebalance_place at every
    offset of the window; far set exactly where the case has a far owner.
    {key: max abs err}."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    errs = {}
    dev = torch.device("cuda")
    D = REB_D

    def hold(tag, fk, fp, **kw):
        got, want = _flat([fk(**kw)]), _flat([fp(**kw)])
        torch.cuda.synchronize()
        errs[tag] = max_abs_err(tag, got, want)
        return want

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    for m in REB_MS:
        for case, (fracs, W) in REB_CASES.items():
            vn = (np.asarray(fracs) * m).astype(np.int64)
            R = int(vn.max()) + 3
            cols = [i32(rng.integers(-2**31, 2**31 - 1, size=(D, R)))
                    for _ in range(REB_COLS)]
            v, base = i32(vn), i32(np.cumsum(vn) - vn)
            tag = f"rebalance({case}, m={m}, W={W}"
            far = hold(f"{tag}, Dl {D})", DO.rebalance_local,
                       DO.rebalance_local_plain, cols=cols, v=v, base=base,
                       m=m, W=W, shard0=0)[-1]
            check(bool(far.any()) == (case == "far_owner"),
                  f"{tag}): far {far.tolist()}")
            for p in range(D):
                one = dict(cols=[c[p: p + 1] for c in cols], v=v[p: p + 1],
                           base=base[p: p + 1], m=m, shard0=p)
                hold(f"{tag}, Dl 1, shard0 {p})", DO.rebalance_local,
                     DO.rebalance_local_plain, W=W, **one)
                for off in range(-W, W + 1):
                    if off:
                        hold(f"{tag}, Dl 1, shard0 {p}, offset {off})",
                             DO.rebalance_place, DO.rebalance_place_plain,
                             off=off, **one)
            del cols
    log(f"    K18b rebalance: the local placement (Dl {D} and Dl 1 at each "
        f"shard0) and every offset's buffers equal the plain versions at "
        f"{list(REB_CASES)}, m {REB_MS}")
    return errs


# phase 3's mesh_flags shapes (parity_mesh_flags_edges): m around its
# 16 elements a thread, and 2^24 + 3 (the rows' starts off 16 bytes but
# the first)
FLAG_MS = (1, 15, 16, 17, 1000, (1 << 24) + 3)


def parity_mesh_flags_edges(rng):
    """mesh_flags on the card against mesh_flags_plain on the same card
    tensors, bit for bit: every key count 1 to 6 and `first` both ways at
    each FLAG_MS (nk 1, 2 and 6 at 2^24 + 3), at Dl 4 from shard0 0 and
    from shard0 4 (a DistMesh's view of shards 4 to 7), and at Dl 1 from
    shard0 2; the keys 16-byte aligned and 4 bytes past it, drawn from 3
    values (ties within a row and across each shard boundary: prev is the
    row before's last key, and the first row's prev is equal to its first
    key where the draw says so).  Returns {"mesh_flags[edges]": 0} for
    phase 3's errs (a difference raises)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**31)))
    n_cases = 0
    t0 = time.perf_counter()
    for m in FLAG_MS:
        for Dl, shard0 in ((4, 0), (4, 4), (1, 2)):
            for shift in (0, 1):
                nks = range(1, 7) if m < 1 << 20 else (1, 2, 6)
                for nk in nks:
                    keys, prev = [], []
                    for _ in range(nk):
                        buf = torch.randint(0, 3, (Dl * m + shift,),
                                            generator=gen, device=dev,
                                            dtype=torch.int32)
                        k = buf[shift:].view(Dl, m)
                        keys.append(k)
                        # the shard before's last key: row d - 1's last,
                        # the first row's drawn from the same 3 values
                        p = torch.cat([torch.randint(
                            0, 3, (1,), generator=gen, device=dev,
                            dtype=torch.int32), k[:-1, -1]])
                        prev.append(p.contiguous())
                    for first in (True, False):
                        kw = dict(shard0=shard0, first=first)
                        max_abs_err(
                            f"mesh_flags (nk {nk}, m {m}, Dl {Dl}, shard0 "
                            f"{shard0}, keys {4 * shift} B past 16, first "
                            f"{first})", [DO.mesh_flags(keys, prev, **kw)],
                            [DO.mesh_flags_plain(keys, prev, **kw)])
                        n_cases += 1
                    del keys, prev
    log(f"    mesh_flags: {n_cases} edge cases (nk 1-6, m {list(FLAG_MS)}, "
        f"Dl 4 from shard0 0 and 4, Dl 1 from shard0 2, keys 0 and 4 B "
        f"past 16) equal the plain version in "
        f"{time.perf_counter() - t0:.1f}s")
    return {"mesh_flags[edges]": 0}


# phase 3's mesh_scan and compact_rows shapes (parity_scan_compact_edges):
# m below, at and past one tile of each kernel (scan_ms: csrc/
# dist_rounds.cu's own tiles), not a multiple of 16, one past 2^20; each
# at Dl 4 (shard0 0) and Dl 1 (shard0 2), the flags also 1 and 4 bytes
# past a 16-byte boundary (the tiles follow the flags' alignment; 1 byte
# puts mesh_scan's out off its 16-byte stores); and SCAN_BIG_M at Dl 4,
# whose 4 x 1025 and 4 x 2049 tiles outnumber the blocks the card holds
# at once, so that tiles wait in the look-back
SCAN_BIG_M = (1 << 24) + 3


def scan_ms():
    """Phase 3's m of mesh_scan and compact_rows (SCAN_BIG_M apart)."""
    from femto_tpu_torch import kernels

    ms = {100, (1 << 20) + 1}
    for which in (0, 1):
        tile = kernels.size("scan_tile", which)
        ms |= {tile - 1, tile, tile + 1, tile + 17}
    return sorted(ms)


SCAN_PATTERNS = ("none", "all", "first", "last", "random", "runs")


def scan_flags(pattern, Dl, m, rng):
    """uint8[Dl, m] flags of one of SCAN_PATTERNS: none, every slot, one
    at a shard's first or last slot, 30% at random, runs of 37 slots
    (bytes 1 and 255) as dist_sort's bucketed buffers keep them."""
    f = np.zeros((Dl, m), np.uint8)
    if pattern == "all":
        f[:] = 1
    elif pattern == "first":
        f[Dl // 2, 0] = 1
    elif pattern == "last":
        f[Dl // 2, m - 1] = 1
    elif pattern == "random":
        f[:] = rng.random((Dl, m)) < 0.3
    elif pattern == "runs":
        p = np.arange(m)
        f[:] = np.where((p // 37) % 3 == 0, np.where(p % 2, 255, 1), 0)
    return f


def parity_scan_compact_edges(rng):
    """mesh_scan (sum; max; max with slots) and compact_rows on the card
    against their plain versions on the same card tensors, bit for bit:
    every SCAN_PATTERNS x scan_ms() at Dl 4 and Dl 1 (shard0 2), the flags
    16-byte aligned and 1 and 4 bytes past it; compact_rows at off the
    counts' exclusive prefix (M 3 past the total) and at off pushing the
    counts past M (M half the total), 1 to 9 columns with the slot's
    global index (None) among them; and both at SCAN_BIG_M, Dl 4.
    Returns {"<entry>[edges]": 0} for phase 3's errs (a difference
    raises)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**31)))
    cases = {"mesh_scan": 0, "compact_rows": 0}
    t0 = time.perf_counter()

    def i32(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    def hold(entry, tag, fk, fp, **kw):
        max_abs_err(f"{entry} ({tag})", _flat([fk(**kw)]), _flat([fp(**kw)]))
        cases[entry] += 1

    def one(f, shard0, shift, k):
        Dl, m = f.shape
        buf = torch.empty(f.size + shift, dtype=torch.uint8, device=dev)
        buf[shift:] = torch.from_numpy(f.reshape(-1)).to(dev)
        flags = buf[shift:].view(Dl, m)
        tag = f"Dl {Dl}, m {m}, shard0 {shard0}, {shift} B past 16"
        slots = torch.randint(0, 2**31 - 1, (Dl, m), generator=gen,
                              device=dev, dtype=torch.int32)
        for mode, sl in (("sum", None), ("max", None), ("max", slots)):
            hold("mesh_scan", f"{mode}{' slots' if sl is not None else ''},"
                 f" {tag}", DO.mesh_scan, DO.mesh_scan_plain, flags=flags,
                 mode=mode, shard0=shard0, slots=sl)
        cnt = (f != 0).sum(axis=1)
        total = int(cnt.sum())
        ncols = 1 + k % 9
        cols = [None if c % 3 == 1 else i32(Dl, m) for c in range(ncols)]
        fills = rng.integers(-2**31, 2**31 - 1, size=ncols).tolist()
        for how in ("prefix", "past"):
            if how == "prefix":
                off, M = np.cumsum(cnt) - cnt, total + 3
            else:
                M = max(1, total // 2)
                off = rng.integers(0, M, size=Dl)
            hold("compact_rows", f"{ncols} columns, off {how}, M {M}, {tag}",
                 DO.compact_rows, DO.compact_rows_plain, flags=flags,
                 off=torch.from_numpy(off.astype(np.int32)).to(dev),
                 cols=cols, M=M, fills=fills, shard0=shard0)

    k = 0
    for m in scan_ms():
        for Dl, shard0 in ((4, 0), (1, 2)):
            for pattern in SCAN_PATTERNS:
                for shift in (0, 1, 4):
                    one(scan_flags(pattern, Dl, m, rng), shard0, shift, k)
                    k += 1
    for pattern in ("random", "runs"):
        one(scan_flags(pattern, 4, SCAN_BIG_M, rng), 0, 0, 2)
    torch.cuda.synchronize()
    log(f"    mesh_scan and compact_rows at edge shapes: {cases} cases "
        f"equal their plain versions ({time.perf_counter() - t0:.1f}s)")
    return {f"{e}[edges]": 0 for e in cases}


def kernel_local_bytes(log_, kinds):
    """{kernel: the largest of its stack frame, spill stores and spill
    loads} of the kernels whose mangled names hold one of `kinds`, in
    ptxas' -v output of one source."""
    out = {}
    for part in log_.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'(\S+)'", part)
        if name and any(k in name.group(1) for k in kinds):
            nums = [int(v) for v in re.findall(
                r"(\d+) bytes (?:stack frame|lmem|spill stores|spill loads)",
                part)]
            check(bool(nums), f"no ptxas record for {name.group(1)}")
            out[name.group(1)] = max(nums)
    return out


# The parent tree (--parent DIR: the parent commit unpacked by git
# archive): a source of DIR built beside this tree's, its entries bound
# with this tree's argument types (a redesign keeps every extern "C"
# signature), so that the same wrapper runs either build
# (kernels.variant); phase 5 times kernel E's and mesh_flags' rows
# against it at their own calls.  None: not given (those fields say "not
# measured").
PARENT = None
_PARENT_LIBS = {}


def parent_lib(src):
    """The parent's csrc/<src>.cu built with this tree's flags (once a
    run), its entries (ENTRIES of that source) bound."""
    import ctypes

    from femto_tpu_torch import kernels

    if src not in _PARENT_LIBS:
        so = os.path.join(kernels.BUILD_DIR, f"lib{src}.parent.so")
        out = subprocess.run(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so,
             os.path.join(PARENT, "femto_tpu_torch", "csrc", src + ".cu")],
            capture_output=True, text=True)
        check(out.returncode == 0, f"nvcc failed for the parent's "
                                   f"{src}.cu:\n{out.stdout}")
        lib = ctypes.CDLL(so)
        for entry, (s, argtypes) in kernels.ENTRIES.items():
            if s == src:
                fn = getattr(lib, "femto_" + entry)
                fn.argtypes = argtypes + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _PARENT_LIBS[src] = lib
    return _PARENT_LIBS[src]


def parent_fields(name, src, run):
    """A row's call, run(), through this tree's csrc/<src>.cu and the
    parent's (PARENT; kernels.variant around the same wrapper, so that
    both pay the swap): held bit for bit, then 5 rounds in turns (this
    tree, the parent, the parent, this tree)."""
    from femto_tpu_torch import kernels

    if PARENT is None:
        return {"parent_ms": "not measured (no --parent)"}

    def mine():
        with kernels.variant(src, None):
            return run()

    def parent():
        with kernels.variant(src, parent_lib(src)):
            return run()

    max_abs_err(f"{name}: against the parent's build", _flat([mine()]),
                _flat([parent()]))
    ms, p_ms, fours = in_turns(mine, parent, 5)
    out = {"parent_ms": p_ms, "ms_in_turns_with_parent": ms,
           "parent_turns_ms": fours,
           "ahead_of_parent_rounds": sum(k1 + k2 < l1 + l2
                                         for k1, l1, l2, k2 in fours)}
    log(f"    {name}: {ms:.4g} ms, the parent's {p_ms:.4g}, first in "
        f"{out['ahead_of_parent_rounds']} of 5")
    return out


# K18f owner_lf's requests a shard in phase 3's hold of its routes
OWNER_LF_R = 4096


def owner_lf_requests(ix, D, rng, R=OWNER_LF_R):
    """K18f owner_lf's requests over a sharded row-tier index of D
    shards: R slots a shard, of in-text rows (from row0 on) of that
    shard's block -- its last segment's rows, rows of its side and of its
    continued run-length segments, the rest at random -- with about one
    slot in 8 invalid (a row of the next shard, which the warp route does
    not read): (rows int32[D, R], valid uint8[D, R]) on the index's
    device."""
    import torch

    seg, n_rows, row0 = ix.meta.seg, ix.meta.n_rows, ix.meta.row0
    nsl = ix.meta.n_seg // D
    rps = nsl * seg
    woff = ix.arrays.seg_woff.cpu().numpy()
    rows = np.empty((D, R), np.int64)
    for d in range(D):
        lo, hi = max(d * rps, row0), min((d + 1) * rps, n_rows)
        segs = np.arange(d * nsl, (d + 1) * nsl)
        parts = [np.arange(max(hi - seg, lo), hi)]
        for kind in (woff[segs] > 0, woff[segs] < -1):
            pick = segs[kind]
            if len(pick):
                r = (pick[rng.integers(0, len(pick), 256)] * seg
                     + rng.integers(0, seg, 256))
                parts.append(r[(r >= lo) & (r < hi)])
        parts.append(rng.integers(lo, hi, R))
        rows[d] = np.concatenate(parts)[:R]
    valid = rng.random((D, R)) >= 0.125
    rows = np.where(valid, rows, (rows + rps) % (D * rps))
    dev = ix.arrays.bwt.device
    return (torch.from_numpy(rows.astype(np.int32)).to(dev),
            torch.from_numpy(valid.astype(np.uint8)).to(dev))


def owner_lf_route(arrays, Dl, R):
    """The route K18f owner_lf takes for Dl x R requests (csrc/
    dist_query.cu's own choice): ("warp" or "thread", the warp route's
    shared memory a block in bytes)."""
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    smem = kernels.size("owner_lf_route", S.fm_view(arrays)[0], R, Dl)
    return ("warp" if smem else "thread"), smem


def owner_lf_route_fields(libs, arrays, Dl, R, run, name):
    """Phase 5's fields of K18f owner_lf's two routes on one call, run()
    (Dl x R requests): the call as built and sent down the other route by
    a build of csrc/dist_query.cu (libs: route_libs' of D_ALTERNATIVES),
    held to each other bit for bit and timed in turns (route_pair), and
    the other route's own device item (item_fields; the route as built's
    is the row's, ITEM_ROWS)."""
    from femto_tpu_torch import kernels

    route, smem = owner_lf_route(arrays, Dl, R)
    other = D_ALTERNATIVES[route][0]

    def instead():
        with kernels.variant("dist_query", libs[route]):
            return run()

    row = route_pair("dist_query", libs[route], run, run(), name, route,
                     other)
    row["block_bytes"] = smem
    # the route as built: the row's kernel_device_ms (ITEM_ROWS)
    row["other_item_ms"] = item_fields(name, instead,
                                       None)["kernel_device_ms"]
    log_route_row(f"{name} at Dl {Dl} x R {R}", row)
    log(f"      the {other} route's own item: {row['other_item_ms']} ms")
    return {"owner_lf_routes": row}


def parity_owner_lf_routes(mesh, corpora, libs, rng, errs):
    """Phase 3's hold of K18f owner_lf on both routes on the sharded row
    tiers (Dl = mesh.D): each corpus (name: (prepared, seg)) built at
    mark_period 20 and 3, OWNER_LF_R requests a shard (owner_lf_requests:
    marked and unmarked rows, side and continued segments where the index
    has them, each shard's last segment, invalid slots), the wrapper as
    built and each route forced (the builds of csrc/dist_query.cu with
    D_ALTERNATIVES' flags, through the same wrapper) against the plain
    version, bit for bit.  {case: route as built, its block's bytes, the
    answers marked and unmarked, the segments by mode}."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.parallel import build_index_sharded

    rec = {}
    for cname, (prep, seg) in corpora.items():
        for period in (20, 3):
            for tier in ROW_LAYOUTS:
                ix = build_index_sharded(prep, mesh, seg=seg,
                                         mark_period=period, tier=tier)
                A = ix.arrays
                rows, valid = owner_lf_requests(ix, mesh.D, rng)
                kw = dict(nseg_local=ix.meta.n_seg // mesh.D, shard0=0)
                want = DO.owner_lf_plain(A, rows, valid, **kw)
                key = f"owner_lf[{tier}]({cname} seg {seg}, period {period})"
                errs[key] = max_abs_err(key, [DO.owner_lf(A, rows, valid,
                                                          **kw)], [want])
                for route, lib in libs.items():
                    with kernels.variant("dist_query", lib):
                        got = DO.owner_lf(A, rows, valid, **kw)
                    other = f"{key}, {D_ALTERNATIVES[route][0]} route"
                    errs[other] = max_abs_err(other, [got], [want])
                torch.cuda.synchronize()
                ans = want[valid.bool()]
                marked, unmarked = int((ans >= 0).sum()), int((ans < 0).sum())
                check(marked > 0 and unmarked > 0,
                      f"{key}: {marked} marked and {unmarked} unmarked "
                      f"answers")
                route, smem = owner_lf_route(A, *rows.shape)
                rec[key] = {"route": route, "block_bytes": smem,
                            "marked": marked, "unmarked": unmarked,
                            "modes": seg_modes(A.seg_woff)}
                del ix, A, rows, valid, want, ans
    log(f"    K18f owner_lf: both routes equal the plain version on the "
        f"sharded row tiers: {rec}")
    return rec


# phase 3's edge shapes of K18b's prefix and add (parity_k18b_edges): the
# columns, the rows a shard and the (local shards, first shard) of a mesh
# of K18B_D shards
K18B_D = 8
K18B_COLUMNS = (1, 3, 256, 1024)
K18B_ROWS = (0, 1, 5, 1 << 18)
K18B_MESHES = ((1, 0), (1, 3), (4, 0), (4, 3))


def parity_k18b_edges(rng):
    """mesh_exclusive, add_base and add_mesh_base on the card against
    their plain versions on the same card tensors, bit for bit, at every
    K18B_COLUMNS x K18B_ROWS x K18B_MESHES shape (rows * A not a multiple
    of 4 at A = 1, 3 and rows 1, 5), x 16-B aligned and 4 B past it (the
    kernel's scalar head), rows drawn over all of int32 (the sums wrap);
    mesh_exclusive with op "sum" and "max" (negative rows: a base of 0)
    and C on and off, add_mesh_base with the base and C each on and off.
    Returns {"<entry>[edges]": 0} for phase 3's errs (a difference
    raises)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**31)))
    cases = {"mesh_exclusive": 0, "add_base": 0, "add_mesh_base": 0}
    t0 = time.perf_counter()

    def same(entry, got, want, outs):
        check(len(got) == len(want) == outs, f"{entry}: outputs differ")
        max_abs_err(f"{entry} (edges)", got, want)
        cases[entry] += 1

    for A in K18B_COLUMNS:
        for Dl, shard0 in K18B_MESHES:
            g = torch.from_numpy(rng.integers(
                -2**31, 2**31, size=(K18B_D, A)).astype(np.int32)).to(dev)
            for op in ("sum", "max"):
                for want_c in (False, True):
                    kw = dict(shard0=shard0, Dl=Dl, op=op, want_c=want_c)
                    same("mesh_exclusive", _flat(DO.mesh_exclusive(g, **kw)),
                         _flat(DO.mesh_exclusive_plain(g, **kw)), 1 + want_c)
            base = DO.mesh_exclusive_plain(g, shard0=shard0, Dl=Dl, op="sum",
                                           want_c=False)[0]
            for rows in K18B_ROWS:
                for off in (0, 1):
                    # x at the buffer's start (16-B aligned) or 4 B past it
                    buf = torch.empty(off + Dl * rows * A, dtype=torch.int32,
                                      device=dev)
                    buf.random_(generator=gen)
                    buf.sub_(2**30).mul_(2)

                    def copy():
                        c = buf.clone()
                        return c[off:].view(Dl, rows, A)

                    xk, xp = copy(), copy()
                    DO.add_base(xk, base)
                    DO.add_base_plain(xp, base)
                    same("add_base", [xk], [xp], 1)
                    for want_base in (False, True):
                        for want_c in (False, True):
                            kw = dict(shard0=shard0, want_base=want_base,
                                      want_c=want_c)
                            xk, xp = copy(), copy()
                            same("add_mesh_base",
                                 [xk] + _flat(DO.add_mesh_base(xk, g, **kw)),
                                 [xp] + _flat(DO.add_mesh_base_plain(
                                     xp, g, **kw)),
                                 1 + want_base + want_c)
                    del buf, xk, xp
    torch.cuda.synchronize()
    log(f"    K18b at edge shapes: {cases} cases equal their plain versions "
        f"({time.perf_counter() - t0:.1f}s)")
    return {f"{k}[edges]": 0 for k in cases}


def k18a_one_block_max():
    """The most records a shard for which bucket_pack takes its one-block
    route (csrc/exchange.cu's own limit, by bisection)."""
    from femto_tpu_torch import kernels

    lo, hi = 0, 2**31 - 1
    if kernels.size("bucket_pack_tile", hi) == 0:
        return hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if kernels.size("bucket_pack_tile", mid) == 0:
            lo = mid
        else:
            hi = mid
    return lo


def parity_bucket_pack_edges(rng):
    """K18a's bucket_pack on the card against its plain version, bit for
    bit (the columns, the flags, over), at edge shapes: records a shard at
    0, 1, the one-block limit and one past it, a multiple of the tile and
    one either side, and nine tiles and more; D + 1 from 2 to 128
    buckets; cap below, at and above the largest bucket; a bucket whose
    run spans many tiles; every record dropped; destinations outside [0,
    D]; 1 and 4 shards; 1 to 8 columns; with and without valid flags.
    Checks that the limit and one past it take different routes and that
    a cap below the largest bucket reports an overflow.  {"bucket_pack[
    <case>]": max abs err}."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import dist_ops as DO

    dev = torch.device("cuda")
    limit = k18a_one_block_max()
    tile = kernels.size("bucket_pack_tile", limit + 1)
    check(k18a_route(limit) == "one_block" and k18a_route(limit + 1)
          == "tiles" and tile > 0, f"bucket_pack's routes at its limit "
                                   f"{limit}: {k18a_route(limit)}, "
                                   f"{k18a_route(limit + 1)}")
    # a build that packs every call in one block (route rows') has no limit
    # that fits the card: its edge cases take three tiles' records instead
    limit, own_limit = min(limit, 3 * tile), limit
    # (tag, shards, records a shard, D, columns, destinations, cap, valid)
    cases = [
        ("mm0", 4, 0, 4, 1, "uniform", "above", False),
        ("mm1", 4, 1, 4, 2, "uniform", "above", False),
        ("limit", 4, limit, 4, 3, "uniform", "at", True),
        ("limit+1", 4, limit + 1, 4, 3, "uniform", "at", False),
        ("tiles-1", 1, 3 * tile - 1, 7, 1, "uniform", "below", True),
        ("tiles", 4, 3 * tile, 1, 8, "uniform", "above", False),
        ("tiles+1, 128 buckets", 4, 3 * tile + 1, 127, 4, "uniform",
         "above", True),
        ("one block, 128 buckets", 4, min(limit, 3000), 127, 5, "uniform",
         "below", False),
        ("a run over 9 tiles", 4, 9 * tile + 5, 4, 2, "one_bucket", "above",
         False),
        ("a run over 9 tiles, capped", 1, 9 * tile + 5, 4, 2, "one_bucket",
         "below", True),
        ("one block, one run", 1, limit, 2, 8, "one_bucket", "at", True),
        ("all dropped", 4, limit + 1, 4, 1, "dropped", "above", False),
        ("outside [0, D]", 4, 2 * tile, 4, 2, "outside", "at", False),
        ("outside [0, D], one block", 4, max(1, limit // 2), 4, 2,
         "outside", "at", True),
    ]
    errs = {}
    for tag, Dl, mm, D, ncols, kind, capk, with_valid in cases:
        if kind == "uniform":
            dest = rng.integers(0, D + 1, size=(Dl, mm))
        elif kind == "one_bucket":
            dest = np.where(rng.random((Dl, mm)) < 0.95, min(2, D - 1),
                            rng.integers(0, D + 1, size=(Dl, mm)))
        elif kind == "dropped":
            dest = np.where(rng.random((Dl, mm)) < 0.5, D, -1)
        else:
            dest = rng.integers(-3, D + 4, size=(Dl, mm))
        valid = (rng.random((Dl, mm)) < 0.8) if with_valid else None
        keep = (dest >= 0) & (dest < D)
        if valid is not None:
            keep &= valid
        largest = max([int(np.bincount(dest[j][keep[j]], minlength=D).max())
                       for j in range(Dl)] + [0])
        cap = {"below": max(1, largest // 2), "at": max(1, largest),
               "above": largest + 7}[capk]
        dt = torch.from_numpy(dest.astype(np.int32)).to(dev)
        vt = (torch.from_numpy(valid.astype(np.uint8)).to(dev)
              if valid is not None else None)
        cols = [torch.from_numpy(rng.integers(-2**31, 2**31, size=(Dl, mm),
                                              dtype=np.int64).astype(
            np.int32)).to(dev) for _ in range(ncols)]
        got = DO.bucket_pack(dt, cols, D=D, cap=cap, valid=vt)
        want = DO.bucket_pack_plain(dt, cols, D=D, cap=cap, valid=vt)
        torch.cuda.synchronize()
        errs[f"bucket_pack[{tag}]"] = max_abs_err(
            f"bucket_pack ({tag}: Dl {Dl}, mm {mm}, D {D}, cap {cap}, "
            f"{ncols} columns)", _flat(got), _flat(want))
        if capk == "below" and largest > 1:
            check(int(got[2].max()) > 0,
                  f"bucket_pack ({tag}): no overflow reported")
        del got, want, dt, vt, cols
    log(f"    bucket_pack at {len(cases)} edge shapes (one-block limit "
        f"{own_limit} records a shard, tiles of {tile}): bit-equal")
    return errs


def parity_masked_occ_rows(ix, mesh, rng, errs, tag, forced=None):
    """K18f's masked_occ_rows on a sharded index at edge rows
    (rank_edge_rows with each shard's block ends), as built and on each
    rank route forced (forced: rank_forced's builds of
    csrc/dist_query.cu), against its plain version bit for bit."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import rank as R

    A = ix.arrays
    nseg_local = ix.meta.n_seg // mesh.D
    rows = rank_edge_rows(ix, rng, nseg_local)
    kw = dict(Dl=mesh.Dl, nseg_local=nseg_local, shard0=mesh.shard0,
              n_rows_total=mesh.D * nseg_local * R.seg_size(A))
    want = masked_occ_rows_in_chunks(A, rows, **kw)
    key = f"masked_occ_rows[{tag}] (edge rows)"
    errs[key] = max_abs_err(key, [DO.masked_occ_rows(A, rows, **kw)], [want])
    for route, lib in (forced or {}).items():
        with kernels.variant("dist_query", lib):
            got = DO.masked_occ_rows(A, rows, **kw)
        torch.cuda.synchronize()
        errs[f"{key}, {route} route"] = max_abs_err(
            f"{key}, {route} route", [got], [want])


def parity_sharded(rng, docs, prepared, sa, errs, k18a_builds=None,
                   prose=None, lf_builds=None, rank_builds=None):
    """Phase 3's K18 checks on the 8 MiB corpus at D = SHARD_D on a
    LocalMesh: each K18 kernel against its plain version on the card at a
    sharded build's own inputs, bucket_pack also with a forced overflow
    and a pair-concentrated dest, the rebalance at crafted counts
    (parity_rebalance_edges); K18f on the full, compact and packed
    sharded indexes, and owner_lf's two routes on the row tiers of this
    corpus and of the prose (parity_owner_lf_routes, with lf_builds: the
    other-route builds of csrc/dist_query.cu), masked_occ_rows at edge
    rows on every tier, on both rank routes (rank_builds: rank_forced's
    builds of csrc/dist_query.cu); the whole full-tier sharded build on the card against
    the same build on the CPU (every FMArrays block, meta and
    LAST_BUILD_STATS), dist_suffix_array's SA against the single-device
    suffix array, and count and locate of both schemes against the
    single-device index."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.parallel import (LocalMesh, build_index_sharded,
                                          dist_suffix_array,
                                          pad_text_for_mesh,
                                          sharded_backward_search,
                                          sharded_locate)
    from femto_tpu_torch.parallel import dist_build as DB
    from femto_tpu_torch.parallel.distributed import put_global

    t0 = time.perf_counter()
    D = SHARD_D
    card, cpu = LocalMesh(D, "cuda"), LocalMesh(D, "cpu")
    for case in sharded_cases(card, prepared, 256, 20):
        name = case["name"]
        got, want = case["run_k"](), case["run_p"]()
        torch.cuda.synchronize()
        check(len(got) == len(want), f"{name} (sharded): outputs differ")
        errs[f"{name}[sharded]"] = max_abs_err(f"{name} (sharded)", got,
                                               want)
        del got, want, case
    # K18b's prefix and add, K18a's bucket_pack at edge shapes (each of its
    # routes, where the other-route builds are given)
    errs.update(parity_k18b_edges(rng))
    errs.update(parity_bucket_pack_edges(rng))
    errs.update(parity_rebalance_edges(rng))
    errs.update(parity_scan_compact_edges(rng))
    errs.update(parity_mesh_flags_edges(rng))
    if k18a_builds is not None:
        for route, lib in route_libs(k18a_builds, "exchange").items():
            with kernels.variant("exchange", lib):
                errs.update({f"{k}[not {route}]": e for k, e in
                             parity_bucket_pack_edges(rng).items()})
    # the whole build: card against CPU (full tier), then every tier's
    # answers against the single-device index
    n = prepared.n
    ix = build_index_sharded(prepared, card, seg=256, mark_period=20)
    card_stats = dict(DB.LAST_BUILD_STATS)
    ix_cpu = build_index_sharded(prepared, cpu, seg=256, mark_period=20)
    check(card_stats == DB.LAST_BUILD_STATS,
          f"sharded build stats: card {card_stats} != CPU "
          f"{DB.LAST_BUILD_STATS}")
    for k, v in ix_cpu.arrays._asdict().items():
        w = getattr(ix.arrays, k)
        check((v is None) == (w is None), f"sharded field {k}")
        if v is not None:
            max_abs_err(f"build_index_sharded field {k}", [w.cpu()], [v])
    check(dataclasses.asdict(ix.meta) == dataclasses.asdict(ix_cpu.meta),
          "sharded meta differs between card and CPU builds")
    del ix_cpu
    tp, n_pad = pad_text_for_mesh(prepared.text, D, 256)
    ssa, _, _, of = dist_suffix_array(put_global(tp, card), card, n=n)
    check(int(of) <= 0 and torch.equal(ssa.reshape(-1)[n_pad - n:], sa),
          "dist_suffix_array's real rows differ from the suffix array")
    del ssa
    single = tt.build_index(prepared, seg=256, mark_period=20, device="cuda")
    pats = []
    while len(pats) < 1024:
        d = docs[int(rng.integers(0, len(docs)))]
        if len(d) > 8:
            o = int(rng.integers(0, len(d) - 8))
            pats.append(d[o: o + 8])
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.search import pack_patterns
    packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
    sf, sl = tt.count_ranges(single, pats)
    rows = rng.integers(0, n, size=4096).astype(np.int32)
    want_loc = tt.locate_rows_array(single, rows)
    rec = {"stats": card_stats}
    for tier in SHARD_TIERS:
        tix = ix if tier == "full" else build_index_sharded(
            prepared, card, seg=256, mark_period=20, tier=tier)
        row0 = tix.meta.row0
        for routed in (True, False):
            f, l = sharded_backward_search(tix, card, packed, routed=routed)
            check(np.array_equal(f.cpu().numpy() - row0, np.asarray(sf))
                  and np.array_equal(l.cpu().numpy() - row0, np.asarray(sl)),
                  f"sharded {tier} count (routed={routed}) differs from the "
                  f"single-device index")
            got = sharded_locate(tix, card, rows + row0, routed=routed)
            check(np.array_equal(got.cpu().numpy(), want_loc),
                  f"sharded {tier} locate (routed={routed}) differs")
        for name, (run_k, run_p, _) in sharded_query_cases(
                tix, card, rng, 8192).items():
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            errs[f"{name}[{tier}]"] = max_abs_err(f"{name} ({tier})", got,
                                                  want)
        parity_masked_occ_rows(tix, card, rng, errs, tier, rank_builds)
    del ix, single
    rec["owner_lf_routes"] = (parity_owner_lf_routes(
        card, {"zipf": (prepared, 256), "prose": (prose, PROSE_SEG)},
        route_libs(lf_builds, "dist_query"), rng, errs)
        if lf_builds is not None else "not run")
    rec["rows"] = parity_sharded_rows(card, cpu, prepared, rng, errs,
                                      rank_builds)
    rec["seconds"] = time.perf_counter() - t0
    log(f"    K18: every sharded kernel equals its plain version at D={D}; "
        f"the sharded builds on the card equal the CPU's (full, vseg and "
        f"vrle); SA, counts, locate and an "
        f"APPROX 1 search equal the single-device index's "
        f"({rec['seconds']:.1f}s, stats {card_stats}; row tiers "
        f"{rec['rows']})")
    return rec


def same_sharded_index(what, got, want):
    """Every FMArrays block, meta and the doc lists of two sharded
    indexes, bit for bit (got on the card, want on the CPU)."""
    for k, v in want.arrays._asdict().items():
        w = getattr(got.arrays, k)
        check((v is None) == (w is None), f"{what} field {k}")
        if v is not None:
            max_abs_err(f"{what} field {k}", [w.cpu()], [v])
    check(dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta),
          f"{what}: meta differs between card and CPU builds")
    for k in ("chunk_doc_offsets_np", "chunk_docs_np"):
        a, b = getattr(got, k), getattr(want, k)
        check((a is None) == (b is None)
              and (a is None or np.array_equal(a, b)),
              f"{what}: {k} differs between card and CPU builds")


def cpu_row_builds(prepared, mesh, kws):
    """{tier: (index, LAST_BUILD_STATS)} of the builds of `prepared` on
    the CPU mesh with the keywords kws[tier], all from the CPU's own
    suffix sort: the row tiers pad alike, so the sort runs once and the
    later builds take copies of its output (dist_build._dist_sa memoised
    on its padded text, cap factor and seed)."""
    import torch

    from femto_tpu_torch.parallel import build_index_sharded
    from femto_tpu_torch.parallel import dist_build as DB

    orig, memo = DB._dist_sa, {}

    def once(text, mesh_, **kw):
        key = (tuple(text.shape), kw["cap_factor"], kw["seed"])
        if key not in memo:
            memo[key] = (text.clone(), orig(text, mesh_, **kw))
        check(torch.equal(memo[key][0], text),
              "the row tiers' padded texts differ")
        return tuple(t.clone() for t in memo[key][1])

    DB._dist_sa = once
    out = {}
    try:
        for tier, kw in kws.items():
            ix = build_index_sharded(prepared, mesh, **kw)
            out[tier] = (ix, dict(DB.LAST_BUILD_STATS))
    finally:
        DB._dist_sa = orig
    return out


def parity_sharded_rows(card, cpu, prepared, rng, errs, rank_builds=None):
    """Phase 3's K18g / K18h checks on the 8 MiB corpus: the sharded vseg
    and vrle builds (vrle with doc lists) on the card against the CPU
    mesh's (its own sort; every FMArrays block, meta, the doc lists and
    LAST_BUILD_STATS), K18f's row-tier entries against their plain
    versions at the build's own shapes (masked_occ_rows also at edge rows
    on both rank routes: rank_builds), and on each a sharded APPROX 1
    search held to the single-device index of the tier, with K18f's
    masked_occ_rows (both rank routes) and kernel R's regex_fork_ranked
    held to their plain versions at the search's widest layer."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.parallel import (build_index_sharded,
                                          sharded_regexp_matches)
    from femto_tpu_torch.parallel import dist_build as DB
    from femto_tpu_torch.query import regexp_device as RD

    q, fcap = ZIPF_QUERIES["approx1"]
    node, nfa = query_nfa(q)
    kws = {tier: dict(seg=256, mark_period=20, tier=tier,
                      doc_chunks=tier == "vrle") for tier in ROW_LAYOUTS}
    cpu_ix = cpu_row_builds(prepared, cpu, kws)
    out = {}
    for tier in ROW_LAYOUTS:
        ix = build_index_sharded(prepared, card, **kws[tier])
        stats = dict(DB.LAST_BUILD_STATS)
        want_ix, want_stats = cpu_ix.pop(tier)
        same_sharded_index(f"build_index_sharded[{tier}]", ix, want_ix)
        check(stats == want_stats, f"sharded {tier} build stats: card "
                                   f"{stats} != CPU {want_stats}")
        del want_ix
        for name, (run_k, run_p, _) in sharded_query_cases(
                ix, card, rng, 8192).items():
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            errs[f"{name}[{tier}]"] = max_abs_err(f"{name} ({tier})", got,
                                                  want)
        parity_masked_occ_rows(ix, card, rng, errs, tier, rank_builds)
        single = tt.build_index(prepared, seg=256, mark_period=20,
                                tier=tier, device="cuda")
        got = sharded_regexp_matches(ix, card, nfa, node.approx)
        want = RD.run_regexp_device(single, nfa, node.approx)
        shift = ix.meta.row0 - single.meta.row0
        check(match_tuples(got) == sorted(
            (m.first + shift, m.last + shift, m.cost, b"") for m in want),
            f"sharded {tier} {q!r} differs from the single-device index's")
        depth, n_live, calls = sharded_layer_calls(ix, card, q, fcap)
        for name, fk, fp in (
                ("masked_occ_rows", DO.masked_occ_rows,
                 masked_occ_rows_in_chunks),
                ("regex_fork_ranked", RO.regex_fork_ranked,
                 RO.regex_fork_ranked_plain)):
            a, kw = calls[name]
            k, p = fk(*a, **kw), fp(*a, **kw)
            torch.cuda.synchronize()
            errs[f"{name}[{tier}] layer"] = max_abs_err(
                f"{name} ({tier}, layer {depth}, {n_live} live)", _flat([k]),
                _flat([p]))
            if name == "masked_occ_rows":
                for route, lib in (rank_builds or {}).items():
                    with kernels.variant("dist_query", lib):
                        k = fk(*a, **kw)
                    torch.cuda.synchronize()
                    errs[f"{name}[{tier}] layer, {route} route"] = \
                        max_abs_err(f"{name} ({tier}, layer {depth}), "
                                    f"{route} route", [k], [p])
        out[tier] = {"modes": seg_modes(ix.arrays.seg_woff),
                     "matches": len(got), "widest": n_live, "stats": stats}
        del ix, single, calls
    return out


def nccl_pass(prepared, patterns, rng):
    """The DistMesh code path on NCCL at world size 1 (one card): one
    process group in this process, bins.exchange and a sharded build and
    count of the patterns, each equal to LocalMesh(1)'s."""
    import torch
    import torch.distributed as dist

    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.parallel import (DistMesh, LocalMesh, bins,
                                          build_index_sharded,
                                          sharded_backward_search,
                                          sharded_docs_query,
                                          sharded_regexp_matches)
    from femto_tpu_torch.search import pack_patterns

    t0 = time.perf_counter()
    # NCCL allocates outside PyTorch's cache: hand the cached blocks back
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            dm, lm = DistMesh("cuda"), LocalMesh(1, "cuda")
            check(dist.get_backend() == "nccl", "the group is not on NCCL")
            mm = 1 << 20
            dest = torch.zeros((1, mm), dtype=torch.int32, device=dm.device)
            recs = [torch.from_numpy(rng.integers(0, 1 << 30, size=(1, mm))
                                     .astype(np.int32)).to(dm.device)
                    for _ in range(2)]
            got = bins.exchange(dm, dest, recs, mm)
            want = bins.exchange(lm, dest, recs, mm)
            max_abs_err("bins.exchange (NCCL)", _flat(got), _flat(want))
            packed, B = pack_patterns([pattern_to_alpha(p)
                                       for p in patterns])
            node, nfa = query_nfa(ZIPF_QUERIES["approx1"][0])
            answers, queries = [], []
            for mesh in (dm, lm):
                ix = build_index_sharded(prepared, mesh, seg=256,
                                         mark_period=20)
                answers.append([*sharded_backward_search(ix, mesh, packed),
                                *sharded_backward_search(ix, mesh, packed,
                                                         routed=False)])
                queries.append((
                    match_tuples(sharded_regexp_matches(
                        ix, mesh, nfa, node.approx,
                        frontier_cap=ZIPF_QUERIES["approx1"][1])),
                    sharded_docs_query(ix, mesh, NCCL_DOCS_QUERY)))
                del ix
            max_abs_err("sharded count (NCCL)", answers[0], answers[1])
            check(queries[0] == queries[1] and queries[0][0]
                  and queries[0][1],
                  "the sharded regex or docs query on NCCL differs from "
                  "LocalMesh(1)'s")
        finally:
            dist.destroy_process_group()
    s = time.perf_counter() - t0
    log(f"[4h] DistMesh on NCCL at world size 1: bins.exchange of {mm} "
        f"records, the sharded count of {len(patterns)} patterns (routed "
        f"and psum, n={prepared.n}), the sharded "
        f"{ZIPF_QUERIES['approx1'][0]!r} ({len(queries[0][0])} matches) and "
        f"docs query {NCCL_DOCS_QUERY!r} ({len(queries[0][1])} documents) "
        f"equal LocalMesh(1)'s ({s:.1f}s)")
    return {"n": prepared.n, "patterns": len(patterns), "seconds": s}


def add_launches(acc, launches):
    """acc += launches, entry by entry (a path read in several parts)."""
    for k, v in launches.items():
        acc[k] = acc.get(k, 0) + v


def check_doc_lists(ix, mesh, rng, n, doc_starts):
    """N_DOC_LIST_SEGS sampled segments of a sharded index's doc lists
    against the documents of their rows' sharded locates (pad rows, at
    offsets from n on, hold none)."""
    from femto_tpu_torch.parallel import sharded_locate

    seg = ix.meta.seg
    segs = np.sort(rng.choice(ix.meta.n_seg, N_DOC_LIST_SEGS, replace=False))
    rows = (segs[:, None] * seg + np.arange(seg)[None]).reshape(-1)
    offs = sharded_locate(ix, mesh, rows.astype(np.int32)).cpu().numpy()
    offs = offs.reshape(len(segs), seg)
    co, cd = ix.chunk_doc_offsets_np, ix.chunk_docs_np
    check(co.shape[0] == ix.meta.n_seg + 1 and cd.shape[0] == co[-1],
          "sharded doc lists: offsets and lists disagree")
    for k, sg in enumerate(segs):
        o = offs[k]
        o = o[(o >= 0) & (o < n)]
        want = np.unique(np.searchsorted(doc_starts, o, side="right") - 1)
        check(np.array_equal(cd[co[sg]: co[sg + 1]], want),
              f"sharded doc list of segment {sg} differs from its rows' "
              f"documents")
    return int(cd.shape[0])


def phase_sharded(record, rng, st, builds=None):
    """Phase 4h, the sharded index on a LocalMesh of SHARD_D shards on one
    card at full size: phase 4's corpus built in all five tiers (vrle with
    doc lists), each held to phase 4's single-device index (the SA of the
    real rows, the count of its 32768 patterns with ranges shifted by
    row0, locate of its 65536 rows, routed and psum; phase 4c holds its
    vseg and vrle indexes to the same answers), 256 segments of the doc
    lists held to their rows' documents; build MiB/s, LAST_BUILD_STATS,
    peak device memory, count steps/s and locate rows/s; bench.py's two
    regexes through the sharded engine on the full, packed, vseg and vrle
    indexes (the "sharded_query" path, held to phase 4d's answers after
    it); the twin corpus once (the replicated doubling tail at full
    size); the DistMesh pass on NCCL; then phase 5's rows at these shapes
    (K18f on every tier, the K18 build kernels, M, N and P at their first
    calls in this path's row-tier builds, masked_occ_rows of the
    sharded_query path on full and packed) and one sharded full and vrle
    build and one
    sharded APPROX 1 query profiled for phase 6."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.parallel import (LocalMesh, build_index_sharded,
                                          dist_suffix_array,
                                          pad_text_for_mesh,
                                          sharded_backward_search,
                                          sharded_locate,
                                          sharded_regexp_matches)
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.parallel import dist_build as DB
    from femto_tpu_torch.parallel.distributed import put_global
    from femto_tpu_torch.query import regexp_device as RD
    from femto_tpu_torch.search import pack_patterns

    t_phase = time.perf_counter()
    card = record["toolchain"]["card"]
    D = SHARD_D
    mesh = LocalMesh(D, "cuda")
    prepared = st["prepared"]
    n = prepared.n
    mib = n / 2**20
    patterns, loc_rows = st["patterns"], st["loc_rows"]
    packed, B = pack_patterns([pattern_to_alpha(p) for p in patterns])
    want_first = np.asarray(st["first"])
    want_last = np.asarray(st["last"])
    want_loc = np.asarray(st["offs_direct"])
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    launches, q_launches = {}, {}
    rec, indexes, zipf_regex = {}, {}, {}
    for tier in SHARD_LAYOUTS:
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ix = build_index_sharded(prepared, mesh, seg=256, mark_period=20,
                                 tier=tier, doc_chunks=tier == "vrle")
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stats = dict(DB.LAST_BUILD_STATS)
        row0 = ix.meta.row0
        r = {"build_s": s, "build_mib_per_s": mib / s, "stats": stats,
             "peak_device_bytes": peak,
             "peak_above_phase4_bytes": peak - base_bytes,
             "n_pad": ix.meta.n_rows, "row0": row0}
        if tier in ROW_LAYOUTS:
            r["modes"] = seg_modes(ix.arrays.seg_woff)
        for routed in (True, False):
            tag = "routed" if routed else "psum"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f, l = sharded_backward_search(ix, mesh, packed, routed=routed)
            torch.cuda.synchronize()
            tc = time.perf_counter() - t0
            check(np.array_equal(f.cpu().numpy() - row0, want_first)
                  and np.array_equal(l.cpu().numpy() - row0, want_last),
                  f"sharded {tier} count ({tag}) differs from phase 4's")
            t0 = time.perf_counter()
            offs = sharded_locate(ix, mesh, loc_rows + row0, routed=routed)
            torch.cuda.synchronize()
            tl = time.perf_counter() - t0
            check(np.array_equal(offs.cpu().numpy(), want_loc),
                  f"sharded {tier} locate ({tag}) differs from phase 4's")
            r[f"count_{tag}_steps_per_s"] = len(patterns) * PATLEN / tc
            r[f"locate_{tag}_rows_per_s"] = len(loc_rows) / tl
        if ix.chunk_docs_np is not None:
            r["doc_list_entries"] = check_doc_lists(
                ix, mesh, rng, n, prepared.doc_starts)
        torch.cuda.synchronize()
        add_launches(launches, kernels.launches)
        # bench.py's regexes through the sharded engine
        kernels.reset_launches()
        for name, (q, fcap) in ZIPF_QUERIES.items():
            node, nfa = query_nfa(q)

            def run():
                return sharded_regexp_matches(ix, mesh, nfa, node.approx,
                                              frontier_cap=fcap)
            ms = run()
            qstats = dict(RD.last_stats)
            lat = wall_runs(run)
            zipf_regex[tier, name] = sorted(
                (m.first - row0, m.last - row0, m.cost) for m in ms)
            r[f"query_{name}"] = {"query": q, "latency_s": summary(lat),
                                  "ranges": len(ms), **qstats}
        torch.cuda.synchronize()
        add_launches(q_launches, kernels.launches)
        rec[tier] = r
        indexes[tier] = ix
        del ix
        log(f"[4h] sharded {tier} (D={D}, n={n}, n_pad={r['n_pad']}): build "
            f"{s:.2f}s = {r['build_mib_per_s']:.1f} MiB/s, peak device "
            f"memory {peak / 2**30:.2f} GiB ({(peak - base_bytes) / 2**30:.2f}"
            f" GiB above phase 4's), stats {stats}; count "
            f"{r['count_routed_steps_per_s']:.4g} / "
            f"{r['count_psum_steps_per_s']:.4g} steps/s (routed / psum), "
            f"locate {r['locate_routed_rows_per_s']:.4g} / "
            f"{r['locate_psum_rows_per_s']:.4g} rows/s; every answer equals "
            f"phase 4's index"
            + (f"; segments by mode {r['modes']}" if "modes" in r else "")
            + (f"; {N_DOC_LIST_SEGS} sampled doc lists equal their rows' "
               f"documents ({r['doc_list_entries']} entries)"
               if "doc_list_entries" in r else "")
            + "".join(f"; {k[6:]} {v['query']!r} median "
                      f"{v['latency_s']['median'] * 1e3:.3f} ms, layers "
                      f"{v['layers']}, widest {v['max_live']}, retries "
                      f"{v['retries']}" for k, v in r.items()
                      if k.startswith("query_")))
    for name in ZIPF_QUERIES:
        for tier in ("compact", "packed", "vseg", "vrle"):
            check(zipf_regex[tier, name] == zipf_regex["full", name],
                  f"sharded {tier} {name} differs from the sharded full "
                  f"index's")
    # the prose at seg PROSE_SEG: side-table and continued segments (the
    # zipf corpus has neither); phase 4h's query part serves them
    pprep = tt.prepare_documents(prose_docs())
    prose = {}
    for tier in ROW_LAYOUTS:
        kernels.reset_launches()
        t0 = time.perf_counter()
        prose[tier] = build_index_sharded(pprep, mesh, seg=PROSE_SEG,
                                          mark_period=20, tier=tier)
        torch.cuda.synchronize()
        add_launches(launches, kernels.launches)
        modes = seg_modes(prose[tier].arrays.seg_woff)
        rec[f"prose_{tier}"] = {"build_s": time.perf_counter() - t0,
                                "modes": modes}
        log(f"[4h] sharded prose {tier} (D={D}, seg {PROSE_SEG}, "
            f"{pprep.n / 2**20:.4f} MiB, blake2b {_PROSE['blake2b']}): "
            f"build {rec[f'prose_{tier}']['build_s']:.2f}s, segments by "
            f"mode {modes}")
    check(rec["prose_vrle"]["modes"]["continuation"] > 0,
          "the sharded prose vrle index has no continued segments")
    kernels.reset_launches()
    tp, n_pad = pad_text_for_mesh(prepared.text, D, 256)
    sa, _, _, of = dist_suffix_array(put_global(tp, mesh), mesh, n=n)
    del tp
    check(int(of) <= 0 and torch.equal(sa.reshape(-1)[n_pad - n:],
                                       st["index"].sa_direct),
          "sharded SA of the real rows differs from phase 4's")
    del sa
    t0 = time.perf_counter()
    twin = build_index_sharded(st["twin_prepared"], mesh, seg=256,
                               mark_period=20)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    twin_stats = dict(DB.LAST_BUILD_STATS)
    check(twin_stats["path"] == "doubling" or twin_stats["tail_rounds"] > 0,
          f"the twin corpus reached no doubling round: {twin_stats}")
    tpat = st["docs"][0][1000: 1000 + 2 * PATLEN]
    tp_packed, _ = pack_patterns([pattern_to_alpha(tpat)])
    f, l = sharded_backward_search(twin, mesh, tp_packed)
    check(int(l[0] - f[0]) >= 2, "twin corpus: the duplicate document's "
                                 "pattern is found fewer than twice")
    del twin
    torch.cuda.synchronize()
    add_launches(launches, kernels.launches)
    log(f"[4h] SA of the real rows equals phase 4's; twin corpus: build "
        f"{twin_s:.2f}s, stats {twin_stats}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; the sharded "
        f"engine's {  {k: v for k, v in q_launches.items() if v} }")
    for name in PATH_KERNELS["sharded"]:
        check(launches.get(name, 0) >= 1,
              f"kernel {name} was not launched on the sharded path")
    small = tt.prepare_documents(st["docs"][:64])
    nccl = nccl_pass(small, patterns[:N_NCCL_PATTERNS], rng)
    # phase 5: K18f on each layout at the count's and locate's lane counts,
    # then the build kernels at this corpus's shapes
    log("[5] the sharded path's kernels (D=4 on phase 4's corpus):")
    rows5 = []
    lf_libs = (route_libs(builds["dist_query"], "dist_query")
               if builds is not None else None)
    B5 = 2 * len(patterns) // D
    for tier, ix in indexes.items():
        for name, (run_k, run_p, nbytes) in sharded_query_cases(
                ix, mesh, rng, B5).items():
            key = f"{name}[{tier}]"
            more = None
            if name == "owner_lf" and tier in ROW_LAYOUTS and lf_libs:
                # both routes at the locate's lane counts (seg 256: the
                # thread route by the limit)
                more = (lambda ix=ix, run_k=run_k, key=key:
                        owner_lf_route_fields(lf_libs, ix.arrays, D, B5,
                                              run_k, key))
            rows5.append(timed_row(key, "sharded", launches[key], run_k,
                                   run_p, nbytes, card, more=more))
    # the sharded_query path's masked_occ_rows on the zipf full, compact
    # and packed indexes (bench.py's regexes above; the row tiers' rows are at the
    # prose's widest layer, in the query part), on both rank routes
    rank = (rank_forced(builds, "dist_query:rank") if builds is not None
            else None)
    for tier in ("full", "compact", "packed"):
        rows, shape = sharded_layer_rows(
            indexes[tier], mesh, *ZIPF_QUERIES["approx1"], tier,
            ["masked_occ_rows"], q_launches, card, rank)
        rows5 += rows
        log(f"    the sharded zipf {tier} widest layer: {shape}")
    # phase 6: one sharded APPROX 1 query (zipf vrle)
    node, nfa = query_nfa(ZIPF_QUERIES["approx1"][0])
    vix = indexes["vrle"]
    prof = {"sharded_query_approx1_vrle": profile_with_gaps(
        "sharded_query_approx1_vrle", lambda: sharded_regexp_matches(
            vix, mesh, nfa, node.approx,
            frontier_cap=ZIPF_QUERIES["approx1"][1]))}
    del indexes, ix, vix
    for case in sharded_cases(mesh, prepared, 256, 20, occ_site=True):
        name = case["name"]
        rows5.append(timed_row(
            name, "sharded", launches[name],
            case["run_k"], case["run_p"], case["nbytes"], card,
            library=case["library"],
            extra=case["extra"], library_full=case["library_full"],
            more=case["more"]))
        del case
    # M, N and P at their first calls in this path's builds: zipf vseg,
    # zipf vrle with doc lists, then the prose (side-table and continued
    # segments, which zipf lacks)
    builds = [
        lambda: build_index_sharded(prepared, mesh, seg=256, mark_period=20,
                                    tier="vseg"),
        lambda: build_index_sharded(prepared, mesh, seg=256, mark_period=20,
                                    tier="vrle", doc_chunks=True),
        lambda: build_index_sharded(pprep, mesh, seg=PROSE_SEG,
                                    mark_period=20, tier="vseg"),
        lambda: build_index_sharded(pprep, mesh, seg=PROSE_SEG,
                                    mark_period=20, tier="vrle")]
    calls = first_calls([(BO, k, None) for k in SHARDED_ROW_KERNELS],
                        builds)
    for name in SHARDED_ROW_KERNELS:
        a, kw = calls.pop(name)
        run_k, run_p, nbytes, lib = row_case(name, a, kw)
        log(f"    {name} at its first call: inputs "
            f"{[tuple(t.shape) for t in _flat(a) if torch.is_tensor(t)]}")
        rows5.append(timed_row(name, "sharded", launches[name], run_k, run_p,
                               nbytes, card, library=lib))
        del a, kw, run_k, run_p, lib
    # A, A', F, B, G, H and L as the sharded builds run them (a full and a
    # compact build)
    calls = first_calls(sharded_build_calls(), [
        lambda: build_index_sharded(prepared, mesh, seg=256, mark_period=20),
        lambda: build_index_sharded(prepared, mesh, seg=256, mark_period=20,
                                    tier="compact")])
    for _, entry, _ in sharded_build_calls():
        a, kw = calls.pop(entry)
        name, run_k, run_p, nbytes, lib = build_case(entry, a, kw)
        log(f"    {name} at its call in a sharded build: inputs "
            f"{[tuple(t.shape) for t in _flat(a) if torch.is_tensor(t)]}")
        more = None
        if name == "gather_rows":
            more = (lambda a=a: {"sector_bound_ms": bound_ms(
                gather_bytes([a[0]], a[1])[1])})
        elif name == "gather_cols":
            more = (lambda a=a, run_k=run_k: {
                "sector_bound_ms": bound_ms(gather_bytes(a[0], a[1])[1]),
                **per_column_fields(a, run_k)})
        rows5.append(timed_row(name, "sharded", launches[name], run_k, run_p,
                               nbytes, card, library=lib,
                               extra=h_fields(a[0], a[2], a[3])
                               if name == "radix_sort_pairs" else None,
                               more=more))
        del a, kw, run_k, run_p, lib, more
    # phase 6: one sharded full and one sharded vrle build, each with the
    # launches of its last profiled call
    for tier in ("full", "vrle"):
        counts = {}
        l_calls = {}
        sorts = []
        scans = []   # the columns of each compact_rows call, 0 a mesh_scan

        def build():
            kernels.reset_launches()
            l_calls.clear()
            sorts.clear()
            scans.clear()
            sort, scan, compact = DB.dist_sort, DO.mesh_scan, DO.compact_rows
            DB.dist_sort = lambda *a, **k: sorts.append(1) or sort(*a, **k)
            DO.mesh_scan = lambda *a, **k: scans.append(0) or scan(*a, **k)
            DO.compact_rows = (lambda flags, off, cols, **k: scans.append(
                len(cols)) or compact(flags, off, cols, **k))
            try:
                with l_call_sizes(l_calls):
                    build_index_sharded(prepared, mesh, seg=256,
                                        mark_period=20, tier=tier)
            finally:
                DB.dist_sort = sort
                DO.mesh_scan, DO.compact_rows = scan, compact
            counts.clear()
            counts.update({k: v for k, v in kernels.launches.items() if v})

        entry = prof[f"sharded_build_{tier}"] = profile_with_gaps(
            f"sharded_build_{tier}", build)
        entry["launches"] = dict(counts)
        # kernel L in the build: its device ms, its launches, and the
        # launches one gather_rows a column would have made
        l_ms = [ms for k, ms in entry.get("by_port_kernel_ms", {}).items()
                if k.startswith("gather_cols")]
        entry["L"] = {
            "ms": sum(l_ms) if l_ms else "not measured",
            "launches": {k: counts.get(k, 0)
                         for k in ("gather_rows", "gather_cols")},
            "launches_one_a_column": sum(
                c * k[2] for k, c in l_calls.items()),
            "calls_by_shape": {f"{k[0]} m={k[1]} cols={k[2]} "
                               f"{k[3]} B": c
                               for k, c in sorted(l_calls.items())}}
        log(f"[6] sharded {tier} build: L {entry['L']}")
        # the rebalance: one launch a sort on the LocalMesh, and the torch
        # fills, rolls and wheres left in the build
        check(counts.get("rebalance_local", 0) == len(sorts)
              and not counts.get("rebalance_place"),
              f"sharded {tier} build: {counts.get('rebalance_local', 0)} / "
              f"{counts.get('rebalance_place', 0)} rebalance launches "
              f"(local / offset) for {len(sorts)} dist_sort calls")
        entry["rebalance"] = {
            "sorts": len(sorts),
            "launches": counts.get("rebalance_local", 0),
            "ms": entry.get("by_port_kernel_ms", {}).get(
                "rebalance_kernel", "not measured"),
            "torch_items": torch_items_by_kind(entry)}
        log(f"[6] sharded {tier} build: rebalance {entry['rebalance']}")
        entry["scan_compact"] = scan_compact_launches(entry, counts, scans)
        log(f"[6] sharded {tier} build: mesh_scan and compact_rows "
            f"{entry['scan_compact']}")
        log(f"[6] sharded {tier} build launched "
            + ", ".join(f"{k} {counts.get(k, 0)}"
                        for k in ("bucket_pack", "mesh_exclusive",
                                  "add_mesh_base", "add_base",
                                  "rebalance_local")))
    # one call each of mesh_scan and compact_rows alone (their first in a
    # full build): one kernel and the scratch's memset, no fill
    prof["sharded_build_full"]["scan_compact_calls"] = {
        name: one_call_items(name, *captured_call(name, None, lambda: (
            build_index_sharded(prepared, mesh, seg=256, mark_period=20))))
        for name in ("mesh_scan", "compact_rows")}
    record["sharded_path"] = {
        "D": D, "mib": MAIN_MIB, "n": n, "tiers": rec,
        "twin_stats": twin_stats,
        "twin_build_s": twin_s, "nccl": nccl, "launches": launches,
        "query_launches": q_launches, "card": card,
        "seconds": time.perf_counter() - t_phase}
    log(f"[4h] phase 4h took {record['sharded_path']['seconds']:.1f}s")
    return {"launches": launches, "query_launches": q_launches,
            "zipf_regex": zipf_regex, "prose": prose, "kernel_rows": rows5,
            "profile": prof}


# phase 6's PyTorch device items of a sharded build by kind (the name a
# kernel of that kind carries): what the per-offset rebalance's buffers
# cost as fills, rolls and wheres, beside the copies
TORCH_ITEM_KINDS = {"fill": "FillFunctor", "roll": "roll_cuda_kernel",
                    "where": "where_kernel_impl",
                    "copy": "direct_copy_kernel"}


def torch_items_by_kind(entry):
    """{kind: {"ms", "calls"}} of a profiled step's items outside the
    port's kernels (profile_step's outside_port_kernels) by
    TORCH_ITEM_KINDS."""
    items = entry.get("outside_port_kernels", [])
    return {kind: {"ms": sum(o["ms"] for o in items if tag in o["op"]),
                   "calls": sum(o["calls"] for o in items
                                if tag in o["op"])}
            for kind, tag in TORCH_ITEM_KINDS.items()}


def scan_compact_launches(entry, counts, scans):
    """Phase 6's check of mesh_scan and compact_rows in a profiled sharded
    build (scans: 0 for each mesh_scan call, each compact_rows call's
    column count): one launch a mesh_scan call and a compact_rows call of
    up to COMPACT_COLS columns, by the launch counts and, where the
    profile saw every H kernel, by the profiler's items of their tile
    kernels; their device ms and the build's fills."""
    from femto_tpu_torch.ops import dist_ops as DO

    n_scan = scans.count(0)
    cols = [c for c in scans if c]
    want = {"mesh_scan": n_scan,
            "compact_rows": sum(-(-c // DO.COMPACT_COLS) for c in cols)}
    got = {k: counts.get(k, 0) for k in want}
    check(got == want, f"mesh_scan / compact_rows launches {got} for "
                       f"{n_scan} scans and compactions of {cols} columns")
    calls = entry.get("by_port_kernel_calls", {})
    seen = {k: calls.get(k + "_tile", 0) for k in want}
    complete = entry.get("H", {}).get("complete", False)
    if complete:
        check(seen == want, f"the profiler saw {seen} tile kernels of "
                            f"mesh_scan / compact_rows for {want} launches")
    ms = entry.get("by_port_kernel_ms", {})
    return {"mesh_scan_calls": n_scan, "compact_rows_columns": cols,
            "launches": got,
            "profiled_kernels": seen if complete else
            "not measured (the profile missed kernels)",
            "ms": {k: ms.get(k + "_tile", "not measured") for k in want},
            "torch_items": torch_items_by_kind(entry)}


def one_call_items(name, a, kw, tries=3):
    """The device items of one call of dist_ops.<name>(*a, **kw) under
    torch.profiler (after a warm-up call): {item: calls}.  mesh_scan and
    compact_rows must show one tile kernel (compact_rows: one a
    COMPACT_COLS columns), memsets and nothing else: no fill of their
    outputs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from femto_tpu_torch.ops import dist_ops as DO

    fn = getattr(DO, name)
    fn(*a, **kw)
    torch.cuda.synchronize()
    want = (1 if name == "mesh_scan"
            else -(-len(a[2]) // DO.COMPACT_COLS))
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_warm_up()
            fn(*a, **kw)
            torch.cuda.synchronize()
        items = {}
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and SPIN_KERNEL not in e.key):
                items[e.key[:120]] = items.get(e.key[:120], 0) + e.count
        tile = sum(c for k, c in items.items() if name + "_tile" in k)
        if tile:
            break
    other = [k for k in items if name + "_tile" not in k
             and "memset" not in k.lower()]
    check(tile == want and not other,
          f"one {name} call ran {tile} tile kernels (want {want}) and "
          f"{other} besides its memsets")
    log(f"[6] one {name} call: {items}")
    return {"items": items, "tile_kernels": tile}


# lanes a plain row-tier decode takes at once in phase 5's rows at the
# query shapes (its slot views are lanes x slots wide)
PLAIN_LANES = 1 << 16


def bound_masked_occ(arrays, codes, lanes, kw):
    """masked_occ's lanes in, Dl results a lane out, and per lane of a
    present code below the rows' end the owner's checkpoint and prefix."""
    from femto_tpu_torch.ops import rank as R

    ckpt, prefix = sharded_prefix_bytes(arrays, kw["nseg_local"])
    seg = R.seg_size(arrays)
    ok = (codes >= 0) & (lanes < kw["n_rows_total"])
    r = lanes[ok].long()
    total = (8 + 4 * kw["Dl"]) * lanes.numel()
    for i in range(0, r.numel(), PLAIN_LANES):
        c = r[i: i + PLAIN_LANES]
        total += int((ckpt + prefix(c // seg, c % seg)).sum())
    return total


def masked_occ_in_chunks(arrays, codes, lanes, **kw):
    """masked_occ_plain over PLAIN_LANES lanes at a time (a lane's answer
    is its own)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO

    return torch.cat([DO.masked_occ_plain(arrays, codes[i: i + PLAIN_LANES],
                                          lanes[i: i + PLAIN_LANES], **kw)
                      for i in range(0, lanes.numel(), PLAIN_LANES)], dim=1)


def owner_case(name, a, kw):
    """(run_k, run_p, bytes moved, None) of K18f's owner_occ or owner_lf on
    captured arguments: the lanes in and out, and per valid lane the
    owner's checkpoint and row prefix (and for LF two marks' words)."""
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import rank as R

    arrays, rows = a[0], a[1]
    valid = a[3] if name == "owner_occ" else a[2]
    nl = kw["nseg_local"]
    ckpt, prefix = sharded_prefix_bytes(arrays, nl)
    seg = R.seg_size(arrays)
    r = rows[valid.bool()].long()
    lanes = (int((ckpt + 4 + prefix(r // seg - kw["shard0"] * nl, r % seg))
                 .sum()) if r.numel() else 0)
    nbytes = (13 if name == "owner_occ" else 17) * rows.numel() + lanes
    fk, fp = getattr(DO, name), getattr(DO, name + "_plain")
    # the routed locate passes owner_lf its view of the index (the lean
    # call); the plain version takes none
    kwp = {k: v for k, v in kw.items() if k != "view"}
    return (lambda: [fk(*a, **kw)], lambda: [fp(*a, **kwp)], nbytes, None)


def rank_rows_bytes(arrays, rows, nseg_local=None):
    """Bytes of ranking each row once for every code (warp_rank_row):
    per row inside the segments its checkpoint row (K entries: int32, or
    uint16 + the L1 int32), the counted prefix (_layout_bytes' prefix, in
    the row's own shard given nseg_local) and on the row tiers the symbol
    list; C once where a row lies past the segments."""
    import torch

    from femto_tpu_torch.ops import rank as R

    A = arrays
    K, seg = R.alpha_count(A), R.seg_size(A)
    if nseg_local is None:
        _, _, prefix, _ = _layout_bytes(A)
        end = R.n_segments(A) * seg
    else:
        _, prefix = sharded_prefix_bytes(A, nseg_local)
        end = (A.bwt.shape[0] // nseg_local) * nseg_local * seg
    code = 4 if R.layout(A) == "full" else 6
    lst = 0
    if R.is_row_tier(A):
        g = R.VsegGeom(A)
        lst = g.S * (2 if g.wide else 1)
    r = rows.long()
    inside = r[r < end]
    total = 4 * (K + 1) if bool((r >= end).any()) else 0
    for i in range(0, inside.numel(), PLAIN_LANES):
        c = inside[i: i + PLAIN_LANES]
        total += int((K * code + lst + prefix(c // seg, c % seg)).sum())
    return total


def bound_masked_occ_rows(arrays, rows, kw):
    """masked_occ_rows' rows in, Dl x 261 answers a row out, and each
    owned row ranked once (rank_rows_bytes in its shard's view)."""
    from femto_tpu_torch.ops import rank as R

    owned = rows[rows < kw["n_rows_total"]]
    total = 4 * rows.numel() + 4 * kw["Dl"] * 261 * rows.numel()
    total += rank_rows_bytes(arrays, owned, kw["nseg_local"])
    if bool((rows >= kw["n_rows_total"]).any()):
        total += 4 * (R.alpha_count(arrays) + 1)
    return total


def bound_fork_ranked(n_live, nd, E):
    """Each live entry's cost row, the forks' ranges and the NFA in; every
    fork's key and cost row out."""
    from femto_tpu_torch.ops import regex_ops as RO

    return (4 * n_live * nd.S + 8 * E + 4 * (nd.S + 1)
            + 4 * (1 + RO.MASK_WORDS) * nd.T + E * (8 + 4 * nd.S))


def sharded_layer_rows(ix, mesh, q, fcap, lay, entries, launches, card,
                       rank=None):
    """Phase 5's sharded_query rows of `entries` (of sharded_layer_calls)
    at the widest layer of q on the sharded index ix of layout lay, each
    held to its plain version on the captured inputs, masked_occ_rows
    with the bound of masked_occ over its expanded lanes (the lane
    route's) beside its own and, given rank (rank_forced's builds of
    csrc/dist_query.cu), its two routes in turns: (rows, the layer's
    shape)."""
    import torch

    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import sort_ops as SO

    depth, n_live, calls = sharded_layer_calls(ix, mesh, q, fcap)
    shape = {"query": q, "depth": depth, "n_live": n_live}
    rows = []
    for name in entries:
        a, kw = calls[name]
        key, lib, more = name, None, None
        if name == "masked_occ_rows":
            key = f"masked_occ_rows[{lay}]"
            arrays, rows_ = a
            run_k = (lambda: [DO.masked_occ_rows(*a, **kw)])
            run_p = (lambda: [masked_occ_rows_in_chunks(*a, **kw)])
            nbytes = bound_masked_occ_rows(arrays, rows_, kw)
            cd = R.map_char(arrays, torch.arange(261, dtype=torch.int32,
                                                 device=rows_.device))
            lane_ms = bound_ms(bound_masked_occ(
                arrays, cd.repeat(rows_.numel()),
                rows_.repeat_interleave(261), kw))
            shape["rows"] = rows_.numel()
            shape["lanes"] = 261 * rows_.numel()

            def more(run_k=run_k, key=key, lane_ms=lane_ms):
                out = {"lane_bound_ms": lane_ms}
                if rank is not None:
                    out.update(rank_route_fields("dist_query", rank, run_k,
                                                 key))
                return out
        elif name == "regex_fork_ranked":
            nf, _, _, nl_, nd, _ = a[:6]
            run_k = (lambda: RO.regex_fork_ranked(*a, **kw))
            run_p = (lambda: RO.regex_fork_ranked_plain(*a, **kw))
            nbytes = bound_fork_ranked(nl_, nd, nf.numel())
            shape.update(S=nd.S, T=nd.T, forks=nf.numel())
        elif name == "radix_sort_pairs":
            keys = a[0]
            run_k = (lambda: SO.radix_sort_pairs(*a))
            run_p = (lambda: SO.radix_sort_pairs_plain(*a))
            nbytes = 20 * keys.numel()

            def lib():
                return torch.sort(keys, stable=True)
        elif name == "regex_merge":
            head, bufs = a[:6], a[6:]
            mine = {who: [b.clone() for b in bufs]
                    for who in ("kernel", "plain", "bound")}
            RO.regex_merge_plain(*head, *mine["bound"])

            def merge(fn, who):
                fn(*head, *mine[who])
                return mine[who]

            run_k = (lambda: merge(RO.regex_merge, "kernel"))
            run_p = (lambda: merge(RO.regex_merge_plain, "plain"))
            nbytes = regex_merge_bytes(head[0], mine["bound"][4], head[3],
                                       head[4])
        else:
            raise ValueError(f"no sharded layer row for {name}")
        rows.append(timed_row(key, "sharded_query", launches[key], run_k,
                              run_p, nbytes, card, library=lib,
                              extra=h_fields(a[0], a[2], a[3])
                              if name == "radix_sort_pairs" else None,
                              more=more))
    return rows, shape


def phase_sharded_query(record, rng, st4, st8, builds=None):
    """Phase 4h's query part, after phase 4d: bench.py's regexes on the
    sharded zipf indexes (run in 4h) held to phase 4d's answers; on 4h's
    sharded prose vseg and vrle indexes (seg PROSE_SEG), PROSE_QUERIES
    through sharded_count_query and sharded_docs_query held to phase 4d's
    single-device answers, ms per query and layers (the "sharded_query"
    path, with 4h's regex launches), K18f masked_occ_rows' device ms
    summed over the regex and approximate queries' calls on each rank
    route; phase 5's rows of K18f masked_occ_rows (both rank routes in
    turns), R regex_fork_ranked, H and R regex_merge at the widest layer of APPROX
    2 parameter on the sharded prose indexes, and of the routed exchanges
    and owner answers at a docs query's first calls; a checkpointed
    dist_suffix_array of a 2^24-symbol zipf corpus that keeps its seed
    file, and one that resumes from it."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.parallel import (LocalMesh, sharded_count_query,
                                          sharded_docs_query)
    from femto_tpu_torch.query import regexp_device as RD

    t_phase = time.perf_counter()
    card = record["toolchain"]["card"]
    D = SHARD_D
    mesh = LocalMesh(D, "cuda")
    for (tier, name), got in st8["zipf_regex"].items():
        check(got == st4["zipf_answers"][name],
              f"sharded {tier} {name} differs from phase 4d's answer")
    indexes = st8.pop("prose")
    kernels.reset_launches()
    out = {}
    k18a = {}  # the path's bucket_pack calls (k18a_calls)
    for tier, ix in indexes.items():
        for name, (q, _, icase) in PROSE_QUERIES.items():
            RD.last_stats.clear()
            with k18a_calls(k18a):
                count = sharded_count_query(ix, mesh, q, icase=icase)
                stats = dict(RD.last_stats)
                got_docs = [d for d, _, _ in sharded_docs_query(
                    ix, mesh, q, with_offsets=False, icase=icase)]
            want_count, want_docs = st4["prose_answers"][tier, name]
            check(count == want_count and got_docs == want_docs,
                  f"sharded prose {tier} {name}: count {count} / "
                  f"{len(got_docs)} docs != the single-device {want_count} "
                  f"/ {len(want_docs)}")
            lat = wall_runs(lambda: sharded_count_query(ix, mesh, q,
                                                        icase=icase))
            out[f"{tier} {name}"] = {"query": q, "latency_s": summary(lat),
                                     "count": count, "docs": len(got_docs),
                                     **stats}
            log(f"    sharded prose {tier} {name} {q!r}: median "
                f"{statistics.median(lat) * 1e3:.3f} ms, layers "
                f"{stats.get('layers', '-')}, widest "
                f"{stats.get('max_live', '-')}, count {count}, docs "
                f"{len(got_docs)}; equal to phase 4d's")
    torch.cuda.synchronize()
    q_launches = dict(st8["query_launches"])
    add_launches(q_launches, kernels.launches)
    for name in PATH_KERNELS["sharded_query"]:
        check(q_launches.get(name, 0) >= 1,
              f"kernel {name} was not launched on the sharded_query path")
    # masked_occ_rows' device ms summed over one pass of the regex and
    # approximate prose queries, as built and on each rank route
    rank = (rank_forced(builds, "dist_query:rank") if builds is not None
            else None)
    rank_sums = "not measured"
    if rank is not None:
        from femto_tpu_torch.ops import dist_ops as DO
        rank_sums = route_sums(DO, "masked_occ_rows", "dist_query", rank, {
            f"{tier} {name}": (lambda ix=ix, q=q, icase=icase:
                               sharded_count_query(ix, mesh, q, icase=icase))
            for tier, ix in indexes.items()
            for name, (q, pyre, icase) in PROSE_QUERIES.items()
            if pyre is not None})
    # phase 5: K18f's masked_occ_rows (both row tiers), R's given-ranges
    # fork, H and R's merge (vrle) at the widest layer of APPROX 2
    # parameter on the sharded prose indexes, each at its call there
    q = PROSE_QUERIES["approx2"][0]
    rows5, layer = [], {}
    for tier, ix in indexes.items():
        entries = ["masked_occ_rows"] + (
            ["regex_fork_ranked", "radix_sort_pairs", "regex_merge"]
            if tier == "vrle" else [])
        rows, layer[tier] = sharded_layer_rows(ix, mesh, q, 256, tier,
                                               entries, q_launches, card,
                                               rank)
        rows5 += rows
        log(f"    the sharded prose {tier} {q!r} widest layer: "
            f"{layer[tier]}")
    # the routed exchanges and owner answers at a docs query's shapes:
    # each kernel's first call in the query, stopped there; owner_lf on
    # both routes (the warp route as built at seg PROSE_SEG)
    bq = PROSE_QUERIES["and"][0]
    lf_libs = (route_libs(builds["dist_query"], "dist_query")
               if builds is not None else None)
    for tier, tix in indexes.items():
        def docs(tix=tix):
            sharded_docs_query(tix, mesh, bq)
        with k18a_calls(k18a):
            docs()  # with offsets: the routed locate's exchanges too
        names = ["owner_occ", "owner_lf"] + (
            ["bucket_pack", "owner_place"] if tier == "vrle" else [])
        for name in names:
            a, kw = captured_call(name, None, docs)
            key = name if name in ("bucket_pack", "owner_place") \
                else f"{name}[{tier}]"
            case = {"library_full": None, "extra": {}}
            if name in ("bucket_pack", "owner_place"):
                case = sharded_case(name, a, kw)
                run_k, run_p, nbytes, lib = (case["run_k"], case["run_p"],
                                             case["nbytes"], case["library"])
            else:
                run_k, run_p, nbytes, lib = owner_case(name, a, kw)
            more = None
            if name == "owner_lf" and lf_libs:
                more = (lambda a=a, run_k=run_k, key=key:
                        owner_lf_route_fields(lf_libs, a[0], *a[1].shape,
                                              run_k, key))
            rows5.append(timed_row(key, "sharded_query", q_launches[key],
                                   run_k, run_p, nbytes, card, library=lib,
                                   library_full=case["library_full"],
                                   extra=case["extra"], more=more))
    del indexes, ix, tix
    # bucket_pack's two routes on this path's own calls
    routes = (k18a_route_rows(builds["exchange"], k18a)
              if builds is not None
              else "not measured")
    del k18a
    ckpt = checkpoint_pass(mesh)
    record["sharded_query_path"] = {
        "queries": out, "launches": q_launches, "widest_layer": layer,
        "masked_occ_rows_sums": rank_sums,
        "k18a_routes": routes, "checkpoint": ckpt, "card": card,
        "seconds": time.perf_counter() - t_phase}
    log(f"[4h] the sharded query part took "
        f"{record['sharded_query_path']['seconds']:.1f}s")
    return {"launches": q_launches, "kernel_rows": rows5, "profile": {}}


def checkpoint_pass(mesh):
    """dist_suffix_array of a CKPT_DOCS-document zipf corpus (2^24
    symbols) with a checkpoint directory, its seed file kept
    (_ckpt_clear held back), then again from that file: "resumed" set and
    the same SA; the save's ms, the files' bytes and both runs' seconds."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.parallel import dist_suffix_array, pad_text_for_mesh
    from femto_tpu_torch.parallel import dist_build as DB
    from femto_tpu_torch.parallel.distributed import put_global

    prep = tt.prepare_documents(zipf_docs(np.random.default_rng(7),
                                          CKPT_DOCS))
    tp, n_pad = pad_text_for_mesh(prep.text, mesh.D, 256)
    text = put_global(tp, mesh)
    kw = dict(n=prep.n, doc_starts=torch.from_numpy(
        prep.doc_starts.astype(np.int32)).to(mesh.device), mark_period=20)
    save_ms = []
    orig_save, orig_clear = DB._ckpt_save, DB._ckpt_clear

    def timed_save(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_save(*a, **k)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    with tempfile.TemporaryDirectory() as ck:
        DB._ckpt_save = timed_save
        DB._ckpt_clear = lambda *a, **k: None
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sa1 = dist_suffix_array(text, mesh, checkpoint_dir=ck, **kw)[0]
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        finally:
            DB._ckpt_save, DB._ckpt_clear = orig_save, orig_clear
        files = {f: os.path.getsize(os.path.join(ck, f))
                 for f in os.listdir(ck)}
        t0 = time.perf_counter()
        sa2 = dist_suffix_array(text, mesh, checkpoint_dir=ck, **kw)[0]
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        stats = dict(DB.LAST_BUILD_STATS)
        left = os.listdir(ck)
    check(stats.get("resumed") and torch.equal(sa1, sa2) and not left
          and len(save_ms) == 1,
          f"the checkpointed build did not resume to the same SA: {stats}, "
          f"files left {left}, saves {save_ms}")
    rec = {"n": prep.n, "n_pad": n_pad, "files": files, "save_ms": save_ms,
           "first_s": first_s, "resumed_s": resumed_s, "stats": stats}
    log(f"[4h] checkpoint / resume (D={mesh.D}, n={prep.n}, n_pad={n_pad}):"
        f" the seed file {files} saved in {save_ms[0]:.1f} ms, the first "
        f"build {first_s:.2f}s; the resumed build {resumed_s:.2f}s, "
        f"stats {stats}, the same SA, the file cleared")
    return rec


def sort_kernel_rows(record, kernel_row, text, ds, sa, sa_direct, rows, *,
                     n, ndocs, mark_period):
    """Kernels G-L at the main path's shapes: the state after the first
    sort of the main corpus, one extension and one doubling round over its
    tied slots, the payload and the two gathers (each in 5 rounds in
    turns with index_select, the call, its own item and its device work
    apart; L's host us by part)."""
    import torch

    from femto_tpu_torch import suffix as TS
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import sort_ops as SO

    dev = text.device
    used = TS.text_alphabet(text)
    bits, per = TS.key_widths(len(used))
    lut = torch.from_numpy(TS.alpha_lut(used)).to(dev)
    key0 = SO.sa_keys(text, lut, bits=bits, per=per)
    skey, sa0 = SO.radix_sort_pairs(key0, None, 0, per * bits)
    flags = SO.group_flags(skey)
    slots, base, m, _ = SO.tied_compact(flags)
    check(m > 0, "the main corpus should leave ties after the first sort")
    rank = SO.rank_init(sa0, slots, base)
    base_bits = (n - 1).bit_length()
    e = min(per, (63 - base_bits) // bits)
    ext = dict(shift=e * bits, base=base, key0=key0, w=per,
               drop=(per - e) * bits)
    dbl = dict(shift=n.bit_length(), rank=rank, h=per)
    bounds = {k: bound_ms(v)
              for k, v in bound_sort_kernels(n, ndocs, m).items()}
    record["sort_shapes"] = {"n": n, "K": len(used), "bits": bits,
                             "per": per, "e": e, "tied_after_first_sort": m}
    log(f"    suffix sort kernels at n={n}, K={len(used)} ({per} codes of "
        f"{bits} bits), {m} tied slots after the first sort")

    kernel_row("sym_hist", lambda: [SO.sym_hist(text)],
               lambda: [SO.sym_hist_plain(text)], bounds["sym_hist"],
               library=lambda: torch.bincount(text, minlength=512))
    kernel_row("sa_keys",
               lambda: [SO.sa_keys(text, lut, bits=bits, per=per)],
               lambda: [SO.sa_keys_plain(text, lut, bits=bits, per=per)],
               bounds["sa_keys"])
    # H on the main path's keys, sorted twice: both runs equal bit for bit
    again = SO.radix_sort_pairs(key0, None, 0, per * bits)
    max_abs_err("radix_sort_pairs(first sort, main path, again)",
                [skey, sa0], again)
    del again
    kernel_row("radix_sort_pairs",
               lambda: SO.radix_sort_pairs(key0, None, 0, per * bits),
               lambda: SO.radix_sort_pairs_plain(key0, None, 0, per * bits),
               # the first sort reads no values (they are 0..m-1): 20 B a
               # pair; a sort given values moves 24 B a pair (bound_ms_24B)
               bound_ms(20 * key0.shape[0]),
               library=lambda: torch.sort(key0, stable=True),
               paths=("full", "tiers", "rows", "chunked", "sharded"),
               extra={**h_fields(key0, 0, per * bits),
                      "bound_ms_24B": bounds["radix_sort_pairs"]})
    kernel_row("group_flags", lambda: [SO.group_flags(skey)],
               lambda: [SO.group_flags_plain(skey)], bounds["group_flags"])
    del skey
    kernel_row("tied_compact", lambda: SO.tied_compact(flags)[:2],
               lambda: SO.tied_compact_plain(flags)[:2],
               bounds["tied_compact"])
    del flags
    kernel_row("rank_init", lambda: [SO.rank_init(sa0, slots, base)],
               lambda: [SO.rank_init_plain(sa0, slots, base)],
               bounds["rank_init"])
    # one extension and one doubling round's keys from the same state
    for mode, kw in (("extension", ext), ("doubling", dbl)):
        kernel_row(f"round_keys[{mode}]",
                   lambda: SO.round_keys(sa0, slots, **kw),
                   lambda: SO.round_keys_plain(sa0, slots, **kw),
                   bounds[f"round_keys[{mode}]"])
    # the doubling round's write-back, into copies of the state
    pos, key = SO.round_keys(sa0, slots, **dbl)
    skey, spos = SO.radix_sort_pairs(key, pos, 0,
                                     dbl["shift"] + base_bits)
    base_all = SO.tied_compact(SO.group_flags(skey), slots, want_all=True)[3]
    state = {who: (sa0.clone(), rank.clone()) for who in ("kernel", "plain")}

    def commit(fn, who):
        fn(*state[who], slots, spos, base_all)
        return list(state[who])

    def commit_plain(sa_, rank_, *rest):
        SO.round_commit_plain(sa_, rank_, *rest, skey=skey,
                              shift=dbl["shift"], base=base)

    kernel_row("round_commit", lambda: commit(SO.round_commit, "kernel"),
               lambda: commit(commit_plain, "plain"), bounds["round_commit"])
    del key0, rank, state, skey, spos, base_all, sa0
    kw = dict(n=n, mark_period=mark_period, ndocs=ndocs)
    kernel_row("sa_payload", lambda: [BO.build_sa_payload(text, ds, **kw)],
               lambda: [BO.sa_payload_plain(text, ds, **kw)],
               bounds["sa_payload"])
    # L at its two shapes: the pull of the payload (the row) and the
    # direct locate tier's 65536 rows
    payload = BO.build_sa_payload(text, ds, **kw)
    kernel_row("gather_rows", lambda: [SO.gather_rows(payload, sa)],
               lambda: [SO.gather_rows_plain(payload, sa)],
               bounds["gather_rows"],
               library=lambda: torch.index_select(payload, 0, sa),
               extra={"sector_bound_ms": bound_ms((4 + SECTOR + 8) * n),
                      **item_fields(
                          "gather_rows", lambda: SO.gather_rows(payload, sa),
                          lambda: torch.index_select(payload, 0, sa))})
    del payload
    max_abs_err("gather_rows(direct tier)",
                [SO.gather_rows(sa_direct, rows)],
                [SO.gather_rows_plain(sa_direct, rows)])
    B = rows.shape[0]
    run_k = lambda: SO.gather_rows(sa_direct, rows)  # noqa: E731
    lib = lambda: torch.index_select(sa_direct, 0, rows)  # noqa: E731
    ms, lib_ms, turns = turn_fields("gather_rows", run_k, lib)
    nbytes, sector_bytes = gather_bytes([sa_direct], rows)
    direct = {"rows": B, "ms": ms, "bound_ms": bound_ms(nbytes),
              "sector_bound_ms": bound_ms(sector_bytes),
              "library_ms": lib_ms, **turns,
              **item_fields("gather_rows", run_k, lib),
              "host_us_by_part": l_host_parts(sa_direct, rows)}
    record["gather_rows_direct_tier"] = direct
    log(f"    gather_rows at the direct tier's shape: {direct}")


def row_kernel_rows(kernel_row, st3, d_libs, lat_ns, c_libs, e_libs):
    """Kernels M and N at the shapes the prose builds give them (M on the
    vseg build, N on the vrle one), and C, D and E on the prose vseg and
    vrle indexes (run-length, continued, fixed and side segments); C's
    count and D's extract and locate also on both routes (c_fields,
    d_fields)."""
    import torch

    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.search import pack_patterns

    pprep = st3["pprep"]
    for tier, names in (("vseg", ("seg_syms", "vseg_rows", "side_rows")),
                        ("vrle", ("vrle_slot_count", "vrle_pack",
                                  "cont_flatten"))):
        rs = row_stage(pprep, PROSE_SEG, tier)
        bounds = bound_row_kernels(rs)
        for name in names:
            check(name in rs["runs"], f"{name} does not run on the prose "
                                      f"{tier} build")
            run_k, run_p = rs["runs"][name]
            kernel_row(name, run_k, run_p, bounds[name])
        del rs
    dev = torch.device("cuda")
    n, mp = pprep.n, 20
    pt = torch.from_numpy(pack_patterns(
        [pattern_to_alpha(p) for p in st3["ppats"]],
        pad_b=len(st3["ppats"]))[0]).to(dev)
    rt = torch.from_numpy(st3["ploc"]).to(dev)
    ct = torch.from_numpy(st3["pctx"].astype(np.int32)).to(dev)
    sa = st3["pfull"].sa_direct
    isa = torch.empty(n, dtype=torch.int64, device=dev)
    isa[sa.long()] = torch.arange(n, device=dev)
    fwd = CTX[1] + CTX[2]
    d0 = st3["pext"][1]
    seof = int(pprep.doc_starts[d0 + 1]) - 1
    steps = min(EXTRACT_STEPS, int(pprep.doc_starts[d0 + 1]
                                   - pprep.doc_starts[d0]) - 1)
    for lay in ROW_LAYOUTS:
        A = st3["prows"][lay].arrays
        kernel_row(f"backward_search[{lay}]",
                   lambda: S.backward_search(A, n, pt),
                   lambda: S.backward_search_plain(A, n, pt),
                   bound_backward_search(A, pt, n, 0),
                   extra=c_fields(c_libs, A, pt.shape[0],
                                  lambda: S.backward_search(A, n, pt),
                                  f"backward_search[{lay}]",
                                  bound_backward_search(A, pt, n, 0,
                                                        shared=False)))
        kernel_row(f"lf_locate[{lay}]",
                   lambda: [S.locate_rows(A, mp, rt)],
                   lambda: [S.locate_rows_plain(A, mp, rt)],
                   bound_locate(A, mp, rt),
                   extra=d_fields(d_libs, "lf_locate", A, rt.shape[0],
                                  locate_checks(A, mp, rt),
                                  lambda: [S.locate_rows(A, mp, rt)],
                                  lat_ns))
        er = A.doc_seof_rows[d0: d0 + 1].contiguous()
        kernel_row(f"lf_extract[{lay}]",
                   lambda: S.extract_backward(A, er, steps),
                   lambda: S.extract_backward_plain(A, er, steps),
                   bound_extract(A, isa, seof, steps),
                   extra=d_fields(d_libs, "lf_extract", A, 1, steps,
                                  lambda: S.extract_backward(A, er, steps),
                                  lat_ns))
        kernel_row(f"psi_walk[{lay}]",
                   lambda: [S.psi_walk(A, ct, fwd)],
                   lambda: [S.psi_walk_plain(A, ct, fwd)],
                   bound_psi(A, ct, fwd),
                   extra=e_fields(e_libs, A, ct.shape[0], fwd,
                                  lambda: [S.psi_walk(A, ct, fwd)],
                                  f"psi_walk[{lay}]", lat_ns))


def bound_backward_step(arrays, c, first, last, shared=True):
    """Lanes in and ranges out (20 bytes a lane); per valid lane the
    symbol map, C[c] and, for first and last, one checkpoint and the
    bytes of segment prefix counted (a shared segment's once where
    `shared`: _step_bytes)."""
    return (20 * c.shape[0] + _step_bytes(arrays, c, first, last, c >= 0,
                                          shared)) / HBM_BYTES_PER_S * 1e3


def bound_regex_fork(arrays, first, last, costs, n_live, nd, cfg):
    """Each live entry's range and cost row in; the NFA once; every
    fork's key and cost row out; per fork that its entry reaches (the
    plain version's reach), its FM step's bytes as backward_step's."""
    import torch

    from femto_tpu_torch.ops import regex_ops as RO

    A, S_ = 261, nd.S
    cl = costs[:n_live]
    reach = ((cl[:, nd.src] < cfg.cost_bound)[:, :, None]
             & nd.mask[None]).any(dim=1)
    if cfg.cost_bound > 1:
        any_live = (cl.min(dim=1).values + min(cfg.subst, cfg.insert)
                    < cfg.cost_bound)
        reach |= any_live[:, None] & (torch.arange(A, device=cl.device)
                                      >= 5)[None, :]
    c = torch.arange(A, dtype=torch.int32, device=cl.device).repeat(n_live)
    # each fork's two ends counted apart, as femto::occ reads them (its
    # row route has a bound of its own: bound_regex_fork_rows)
    step = _step_bytes(arrays, c, first[:n_live].repeat_interleave(A),
                       last[:n_live].repeat_interleave(A),
                       reach.reshape(-1), shared=False)
    total = (n_live * (8 + 4 * S_) + 4 * (S_ + 1)
             + 4 * (1 + RO.MASK_WORDS) * nd.T
             + A * n_live * (8 + 4 * S_) + step)
    return total / HBM_BYTES_PER_S * 1e3


def regex_merge_bytes(skeys, state, nd, cfg):
    """The live forks' keys, rows and cost rows in (and the first dead
    key); the kept runs' frontier rows and the hits' result rows out."""
    live = int((skeys != cfg.dead).sum())
    n_keep = int(state[2])
    n_hits = int(state[0]) - int(state[4])
    return (live * (8 + 4 + 4 * nd.S) + 8 + n_keep * (8 + 4 * nd.S)
            + 16 * n_hits + 2 * 4 * 8)


def bound_regex_merge(skeys, state, nd, cfg):
    return bound_ms(regex_merge_bytes(skeys, state, nd, cfg))


def widest_frontier(ix, q, fcap, by_forks=False, at_depth=None):
    """The device search of q on ix (run_regexp_device from frontier cap
    fcap, its retries included), with the frontier before the widest layer
    of the run that answered (by_forks: the layer whose entries reach the
    most forks, reached_counts; at_depth: the layer at that depth):
    (nfa arrays, layer settings, depth, n_live, [first, last, costs])."""
    from femto_tpu_torch.query import regexp_device as RD

    node, nfa = query_nfa(q)
    box = {}

    def snap(depth, n_live, nd, cfg, bufs):
        if depth == 0:  # a run starts (again, after a retry)
            box.clear()
        size = n_live
        if at_depth is not None:
            size = 1 if depth == at_depth else 0
        elif by_forks:
            size = reached_counts(ix.arrays, bufs[2], n_live, nd,
                                  cfg)["mean"] * n_live
        if size > box.get("size", 0):
            box.update(size=size, n_live=n_live, depth=depth, nd=nd,
                       cfg=cfg, fr=[b.clone() for b in bufs[:3]])

    RD.run_regexp_device(ix, nfa, node.approx, frontier_cap=fcap,
                         on_layer=snap)
    return box["nd"], box["cfg"], box["depth"], box["n_live"], box["fr"]


def hold_layer(ix, q, fcap):
    """regex_fork, H and regex_merge at the widest layer of q on ix, each
    held bit for bit against its plain version on the same inputs (raises
    unless equal) and timed: the shape, the errors and the kernels' ms."""
    import torch

    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import sort_ops as SO

    nd, cfg, depth, n_live, (first, last, costs) = widest_frontier(ix, q,
                                                                   fcap)
    A, sub, bits = ix.arrays, depth > 0, 2 * cfg.half_bits
    keys, fcosts = RO.regex_fork(A, first, last, costs, n_live, nd, cfg, sub)
    # the plain version over slices of FORK_CHUNK entries (an entry's
    # forks depend on its own range and costs alone): at once, its row
    # decodes over every fork's lanes would not fit beside the indexes
    want = [RO.regex_fork_plain(A, first[i:], last[i:], costs[i:],
                                min(FORK_CHUNK, n_live - i), nd, cfg, sub)
            for i in range(0, n_live, FORK_CHUNK)]
    errs = {}
    errs["regex_fork"] = max_abs_err(
        f"regex_fork {q}", (keys, fcosts),
        [torch.cat(parts) for parts in zip(*want)])
    del want
    skeys, sidx = SO.radix_sort_pairs(keys, None, 0, bits)
    errs["radix_sort_pairs"] = max_abs_err(
        f"radix_sort_pairs {q}", (skeys, sidx),
        SO.radix_sort_pairs_plain(keys, None, 0, bits))
    bufs = {who: [b.clone() for b in (first, last, costs)]
            + [torch.zeros((4, 1 << 16), dtype=torch.int32,
                           device=first.device),
               torch.zeros(8, dtype=torch.int32, device=first.device)]
            for who in ("kernel", "plain")}
    RO.regex_merge(skeys, sidx, fcosts, nd, cfg, depth, *bufs["kernel"])
    RO.regex_merge_plain(skeys, sidx, fcosts, nd, cfg, depth,
                         *bufs["plain"])
    errs["regex_merge"] = max_abs_err(f"regex_merge {q}", bufs["kernel"],
                                      bufs["plain"])
    return {
        "query": q, "depth": depth, "n_live": n_live, "S": nd.S, "T": nd.T,
        "forks": keys.shape[0], "sort_bits": bits, "max_abs_err": errs,
        "regex_fork_ms": cuda_ms(lambda: RO.regex_fork(
            A, first, last, costs, n_live, nd, cfg, sub)),
        "radix_sort_pairs_ms": cuda_ms(lambda: SO.radix_sort_pairs(
            keys, None, 0, bits)),
        "regex_merge_ms": cuda_ms(lambda: RO.regex_merge(
            skeys, sidx, fcosts, nd, cfg, depth, *bufs["kernel"])),
    }


def bound_regex_fork_rows(arrays, first, last, costs, n_live, nd, cfg):
    """bound_regex_fork with each entry's first and last rows ranked once
    for every code (rank_rows_bytes) in place of every reached fork's two
    FM steps."""
    import torch

    from femto_tpu_torch.ops import regex_ops as RO

    A, S_ = 261, nd.S
    rows = torch.cat([first[:n_live], last[:n_live]])
    total = (n_live * (8 + 4 * S_) + 4 * (S_ + 1)
             + 4 * (1 + RO.MASK_WORDS) * nd.T
             + A * n_live * (8 + 4 * S_) + rank_rows_bytes(arrays, rows))
    return total / HBM_BYTES_PER_S * 1e3


def reached_counts(arrays, costs, n_live, nd, cfg):
    """The codes each live entry's forks rank (the symbols regex_fork's
    reach holds, from the plain version's rule, that the index maps to a
    code: the count its rank rule reads): min, mean and max over the
    entries."""
    import torch

    from femto_tpu_torch.ops import rank as R

    cl = costs[:n_live]
    reach = ((cl[:, nd.src] < cfg.cost_bound)[:, :, None]
             & nd.mask[None]).any(dim=1)
    if cfg.cost_bound > 1:
        any_live = (cl.min(dim=1).values + min(cfg.subst, cfg.insert)
                    < cfg.cost_bound)
        reach |= any_live[:, None] & (torch.arange(261, device=cl.device)
                                      >= 5)[None, :]
    coded = R.map_char(arrays, torch.arange(261, dtype=torch.int32,
                                            device=cl.device)) >= 0
    n = (reach & coded[None, :]).sum(dim=1).float()
    return {"min": int(n.min()), "mean": float(n.mean()),
            "max": int(n.max())}


# the layers phase 5 times kernel R's two rank routes at, beside APPROX 1
# ther's widest: an exact alternation's widest (a symbol reached an
# entry) and a class's layer of the most reached forks (26 an entry)
RANK_PROBE_QUERIES = {
    "exact": ZIPF_QUERIES["alternation"],
    "class": ("[a-z]{3}ing", 256),
}


def fork_route_probe(ix, q, fcap, forced, by_forks=False, at_depth=None):
    """Kernel R's regex_fork at the widest layer of q on ix (by_forks,
    at_depth: widest_frontier's) on both rank routes (rank_route_fields)
    with the layer's shape, the codes its entries rank, the route rule's
    least count and the call as built."""
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import search_ops as S

    nd, cfg, depth, n_live, (first, last, costs) = widest_frontier(
        ix, q, fcap, by_forks, at_depth)
    A, sub = ix.arrays, depth > 0

    def run():
        return RO.regex_fork(A, first, last, costs, n_live, nd, cfg, sub)

    out = {"query": q, "depth": depth, "n_live": n_live, "S": nd.S,
           "reached": reached_counts(A, costs, n_live, nd, cfg),
           "row_min": kernels.size("regex_fork_row_min",
                                   S.fm_view(A)[0], nd.S),
           "as_built_ms": cuda_ms(run)}
    out.update(rank_route_fields("regex_frontier", forced, run,
                                 f"regex_fork {q!r}")["rank_routes"])
    return out


def query_kernel_rows(kernel_row, st, st3, st4, h_builds, r_forced,
                      c_libs):
    """Kernel C's step entries and kernel R at the query path's shapes:
    the widest layer of APPROX 1 ther (frontier cap 1024) on each of the
    zipf full, compact and packed and the prose vseg and vrle indexes
    (regex_fork; backward_step over the same forks' lanes, as the host
    engine steps them), backward_search_steps over the path's NUL-headed
    patterns, and, on zipf full, H and regex_merge after that layer's
    forks, H beside torch.sort on the same keys, and H's routes against
    each other on the query path's sorts (h_route_rows, given
    phase_build's builds of radix_sort.cu).  regex_fork's rows carry its
    two rank routes in turns and the row route's bound (r_forced:
    rank_forced's builds of regex_frontier.cu), C's rows its two routes
    in turns and the bound before the shared row (c_libs: c_forced's
    builds, c_fields), and the rank routes are also
    timed at the widest layers of RANK_PROBE_QUERIES on every layout
    (fork_route_probe).  Then fork, H and merge held to their plain
    versions at the widest layers of APPROX 2 parameter and 0{1,64}1 on
    prose vrle."""
    import torch

    from femto_tpu_torch.ops import regex_ops as RO
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.ops import sort_ops as SO

    indexes = {**st4["zipf"], **st3["prows"]}
    shapes = {}
    for lay, ix in indexes.items():
        A, n = ix.arrays, ix.meta.n_rows
        nd, cfg, depth, n_live, (first, last, costs) = widest_frontier(
            ix, ZIPF_QUERIES["approx1"][0], ZIPF_QUERIES["approx1"][1])
        shapes[lay] = {"depth": depth, "n_live": n_live, "S": nd.S,
                       "T": nd.T}
        sub = depth > 0

        def fork():
            return RO.regex_fork(A, first, last, costs, n_live, nd, cfg, sub)

        extra = {"row_bound_ms": bound_regex_fork_rows(
            A, first, last, costs, n_live, nd, cfg),
            "reached": reached_counts(A, costs, n_live, nd, cfg)}
        if r_forced is not None:
            extra.update(rank_route_fields("regex_frontier", r_forced, fork,
                                           f"regex_fork[{lay}]"))
            shapes[lay]["rank_probes"] = {
                kind: fork_route_probe(ix, q, fcap, r_forced,
                                       by_forks=kind == "class")
                for kind, (q, fcap) in RANK_PROBE_QUERIES.items()}
        kernel_row(f"regex_fork[{lay}]", fork,
                   lambda: RO.regex_fork_plain(A, first, last, costs,
                                               n_live, nd, cfg, sub),
                   bound_regex_fork(A, first, last, costs, n_live, nd, cfg),
                   extra=extra)
        c = torch.arange(261, dtype=torch.int32,
                         device=first.device).repeat(n_live)
        f = first[:n_live].repeat_interleave(261)
        l = last[:n_live].repeat_interleave(261)
        kernel_row(f"backward_step[{lay}]",
                   lambda: S.backward_step_pair(A, c, f, l),
                   lambda: S.backward_step_plain(A, c, f, l),
                   bound_backward_step(A, c, f, l),
                   extra=c_fields(c_libs, A, c.shape[0],
                                  lambda: S.backward_step_pair(A, c, f, l),
                                  f"backward_step[{lay}]",
                                  bound_backward_step(A, c, f, l,
                                                      shared=False)))
        pt = st4["zsteps"] if lay in st4["zipf"] else st4["psteps"]
        kernel_row(f"backward_search_steps[{lay}]",
                   lambda: S.backward_search_steps(A, n, pt),
                   lambda: S.backward_search_steps_plain(A, n, pt),
                   bound_backward_search(A, pt, n, 0, steps=True),
                   extra=c_fields(c_libs, A, pt.shape[0],
                                  lambda: S.backward_search_steps(A, n, pt),
                                  f"backward_search_steps[{lay}]",
                                  bound_backward_search(A, pt, n, 0,
                                                        steps=True,
                                                        shared=False)))
        if lay != "full":
            continue
        keys, fcosts = RO.regex_fork(A, first, last, costs, n_live, nd, cfg,
                                     sub)
        bits = 2 * cfg.half_bits
        E = keys.shape[0]
        kernel_row("radix_sort_pairs",
                   lambda: SO.radix_sort_pairs(keys, None, 0, bits),
                   lambda: SO.radix_sort_pairs_plain(keys, None, 0, bits),
                   bound_ms(20 * E), paths=("query", "sharded_query"),
                   library=lambda: torch.sort(keys, stable=True),
                   extra=h_fields(keys, 0, bits))
        if h_builds is not None:
            # H's routes against each other on this layer's sort and the
            # query path's largest of each route and power of two of m
            shapes["h_routes"] = h_route_rows(h_builds, {
                "APPROX 1 ther's widest zipf layer": (keys, 0, bits),
                **st4["h_sorts"]})
        skeys, sidx = SO.radix_sort_pairs(keys, None, 0, bits)
        bufs = {who: [b.clone() for b in (first, last, costs)]
                + [torch.zeros((4, 1 << 16), dtype=torch.int32,
                               device=first.device),
                   torch.zeros(8, dtype=torch.int32, device=first.device)]
                for who in ("kernel", "plain", "bound")}
        RO.regex_merge_plain(skeys, sidx, fcosts, nd, cfg, depth,
                             *bufs["bound"])

        def merge(fn, who):
            fn(skeys, sidx, fcosts, nd, cfg, depth, *bufs[who])
            return bufs[who]

        kernel_row("regex_merge", lambda: merge(RO.regex_merge, "kernel"),
                   lambda: merge(RO.regex_merge_plain, "plain"),
                   bound_regex_merge(skeys, bufs["bound"][4], nd, cfg))
        shapes[lay].update(forks=E, sort_bits=bits)
    log(f"    query kernels at APPROX 1 ther's widest layer: {shapes}")
    # the path's widest layers and largest NFA, on prose vrle: held to
    # the plain versions bit for bit, timed apart from the rows above
    ix = st3["prows"]["vrle"]
    for name in ("approx2", "repeat64"):
        q = PROSE_QUERIES[name][0]
        shapes[f"prose vrle {name}"] = held = hold_layer(ix, q, 256)
        log(f"    prose vrle {q!r} at its widest layer, each kernel equal "
            f"to its plain version: {held}")
    return shapes


def phase_numbers(record, st, st2, st3, st4, own, builds):
    """End-to-end rates (medians of 3) and each kernel at the main paths'
    shapes against its bound, its plain version and a library call;
    kernel D's extract and locate rows also against its thread route and
    a latency floor (the card's dependent-load latency), and the row
    tiers' walk locate rates also on the thread route."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.search import pack_patterns
    from femto_tpu_torch.suffix import suffix_array

    prepared, index, walk = st["prepared"], st["index"], st["walk"]
    text = st["text"]
    n, ndocs = prepared.n, prepared.num_docs
    mib = n / 2**20
    seg, mp = 256, 20
    n_seg = n // seg + 1
    dev = text.device
    ds = torch.from_numpy(prepared.doc_starts.astype(np.int32)).to(dev)
    rates = {}

    build = wall_runs(lambda: tt.build_index(prepared, seg=seg,
                                             mark_period=mp, device="cuda"))
    rates["build_mib_per_s"] = summary([mib / t for t in build])
    # the twin corpus (one document twice): rank_init and doubling rounds too
    rates["build_twin_mib_per_s"] = summary(
        [mib / t for t in wall_runs(lambda: tt.build_index(
            st["twin_prepared"], seg=seg, mark_period=mp, device="cuda"))])
    box = {}

    def sort():
        payload = BO.build_sa_payload(text, ds, n=n, mark_period=mp,
                                      ndocs=ndocs)
        box["sa"], box["pull"] = suffix_array(text, payload=payload)

    def package():
        box["arrays"] = BO.build_fm_arrays_device(
            text, box["sa"], ds, n=n, seg=seg, mark_period=mp, ndocs=ndocs,
            pull=box["pull"])

    rates["sort_mib_per_s"] = summary([mib / t for t in wall_runs(sort)])
    rates["packaging_mib_per_s"] = summary(
        [mib / t for t in wall_runs(package)])
    patterns = st["patterns"]
    steps = len(patterns) * PATLEN
    rates["count_steps_per_s"] = summary(
        [steps / t for t in wall_runs(lambda: tt.count(walk, patterns))])
    rows = st["loc_rows"]
    rates["locate_walk_rows_per_s"] = summary(
        [len(rows) / t
         for t in wall_runs(lambda: tt.locate_rows_array(walk, rows))])
    rates["locate_direct_rows_per_s"] = summary(
        [len(rows) / t
         for t in wall_runs(lambda: tt.locate_rows_array(index, rows))])
    d0 = st["ext_docs"][0]
    rates["extract_chars_per_s"] = summary(
        [(DOC_SIZE - 1) / t
         for t in wall_runs(lambda: tt.extract_document(walk, d0))])
    packed = st2["packed"]
    ctx_rows = st2["ctx_rows"]
    rates["build_packed_mib_per_s"] = summary(
        [mib / t for t in wall_runs(lambda: tt.build_index(
            prepared, seg=seg, mark_period=mp, tier="packed",
            device="cuda"))])
    rates["count_packed_steps_per_s"] = summary(
        [steps / t for t in wall_runs(lambda: tt.count(packed, patterns))])
    rates["locate_walk_packed_rows_per_s"] = summary(
        [len(rows) / t
         for t in wall_runs(lambda: tt.locate_rows_array(packed, rows))])
    for name, ix in (("full", walk), ("packed", packed)):
        rates[f"context_{name}_rows_per_s"] = summary(
            [len(ctx_rows) / t for t in wall_runs(
                lambda: tt.extract_context_batch(ix, ctx_rows, *CTX))])
    # the row tiers on both corpora (phase 4c); their walk locate also on
    # kernel D's thread route (the design before its warp route there)
    thread_d = route_libs(builds["lf_walk"], "lf_walk")["warp"]

    def locate_rates(key, ix, loc):
        def thread():
            with kernels.variant("lf_walk", thread_d):
                tt.locate_rows_array(ix, loc)

        rates[key] = summary([len(loc) / t for t in wall_runs(
            lambda: tt.locate_rows_array(ix, loc))])
        if R.is_row_tier(ix.arrays):
            rates[key.replace("_rows_per_s", "_thread_route_rows_per_s")] = \
                summary([len(loc) / t for t in wall_runs(thread)])

    pprep, prows, pwalk = st3["pprep"], st3["prows"], st3["pwalk"]
    pmib = pprep.n / 2**20
    psteps = len(st3["ppats"]) * PATLEN
    for tier in ROW_LAYOUTS:
        ix = st3["zrows"][tier]
        rates[f"build_{tier}_mib_per_s"] = summary(
            [mib / t for t in wall_runs(lambda: tt.build_index(
                prepared, seg=seg, mark_period=mp, tier=tier,
                device="cuda"))])
        rates[f"count_{tier}_steps_per_s"] = summary(
            [steps / t for t in wall_runs(lambda: tt.count(ix, patterns))])
        locate_rates(f"locate_walk_{tier}_rows_per_s", ix, rows)
        rates[f"context_{tier}_rows_per_s"] = summary(
            [len(ctx_rows) / t for t in wall_runs(
                lambda: tt.extract_context_batch(ix, ctx_rows, *CTX))])
    for tier in ("full",) + ROW_LAYOUTS:
        ix = pwalk if tier == "full" else prows[tier]
        rates[f"prose_build_{tier}_mib_per_s"] = summary(
            [pmib / t for t in wall_runs(lambda: tt.build_index(
                pprep, seg=PROSE_SEG, mark_period=mp, tier=tier,
                device="cuda"))])
        rates[f"prose_count_{tier}_steps_per_s"] = summary(
            [psteps / t
             for t in wall_runs(lambda: tt.count(ix, st3["ppats"]))])
        locate_rates(f"prose_locate_walk_{tier}_rows_per_s", ix,
                     st3["ploc"])
        rates[f"prose_context_{tier}_rows_per_s"] = summary(
            [len(st3["pctx"]) / t for t in wall_runs(
                lambda: tt.extract_context_batch(ix, st3["pctx"], *CTX))])
    record["rates"] = rates
    for k, v in rates.items():
        on = f", prose blake2b {_PROSE['blake2b']}" if "prose" in k else ""
        log(f"[5] {k}: {v['median']:.6g} (min {v['min']:.6g}, max "
            f"{v['max']:.6g}, {v['runs']} runs{on})")
    # kernel C's device ms over the count rates' calls, as built and on
    # each route forced
    count_ix = {"zipf full": walk, "zipf packed": packed,
                **{f"zipf {t}": st3["zrows"][t] for t in ROW_LAYOUTS},
                "prose full": pwalk,
                **{f"prose {t}": prows[t] for t in ROW_LAYOUTS}}
    c_libs = c_forced(builds)
    record["c_route_sums"] = {"count_rates": route_sums(
        S, "backward_search", "backward_search", c_libs,
        {k: (lambda ix=ix, p=(st3["ppats"] if k.startswith("prose")
                              else patterns): tt.count(ix, p).tolist())
         for k, ix in count_ix.items()})}
    for o in (st4, own[1]):
        if isinstance(o.get("c_sums"), dict):
            record["c_route_sums"].update(o["c_sums"])

    # kernels at the main path's shapes
    arrays = walk.arrays
    sa, pull = box["sa"], box["pull"]
    a_row = BO.occ_build(pull, n_seg=n_seg, seg=seg)[1]
    kern = []
    path_launches = {"full": st["launches"], "tiers": st2["launches"],
                     "rows": st3["launches"], "query": st4["launches"],
                     "query_host": st4["host_launches"],
                     "chunked": own[0]["launches"],
                     "sharded": own[3]["launches"],
                     "sharded_query": own[4]["launches"]}

    # the chunked, paged, lcp and sharded paths' kernels, timed in phases
    # 4e to 4h at their own shapes
    own_rows = {(r["name"], r["path"]) for o in own for r in o["kernel_rows"]}

    def kernel_row(name, run_k, run_p, bound_ms, library=None, paths=None,
                   extra=None):
        """One kernel against its plain version at these shapes; plain_ms
        is the time of that one comparison run.  One row per main path
        that launched the kernel (of `paths`, where given: a kernel timed
        at two paths' shapes), with that path's own count, but for a path
        whose own phase timed the kernel at its own shapes.  A kernel and
        its library call are timed in turns (turn_fields); `extra` is
        added to each row."""
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        got = run_k()
        a.record()
        want = run_p()
        b.record()
        torch.cuda.synchronize()
        err = max_abs_err(name, got, want)
        del got, want
        plain_ms = a.elapsed_time(b)
        more = {}
        if library is not None:
            ms, lib_ms, more = turn_fields(name, run_k, library)
        else:
            ms, lib_ms = cuda_ms(run_k), None
        more.update(extra or {})
        src, replaces = KERNELS[name]
        per_path = {p: c.get(name, 0) for p, c in path_launches.items()
                    if (c.get(name, 0) or name in PATH_KERNELS[p])
                    and (paths is None or p in paths)
                    and (name, p) not in own_rows}
        for path, launches in per_path.items():
            kern.append({
                "name": name, "path": path, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": lib_ms, "card": record["toolchain"]["card"],
                **more,
            })
        log(f"    {name}: {ms:.4g} ms (bound {bound_ms:.4g} ms, plain "
            f"{plain_ms:.4g} ms, library {lib_ms}); launches {per_path}"
            + (f"; {more}" if more else ""))

    seg_sym = (torch.arange(n, device=dev) // seg) * 261 + (pull & 511)
    kernel_row(
        "occ_build",
        lambda: BO.occ_build(pull, n_seg=n_seg, seg=seg),
        lambda: BO.occ_build_plain(pull, n_seg=n_seg, seg=seg),
        bound_occ_build(n, n_seg, seg),
        library=lambda: torch.bincount(seg_sym, minlength=n_seg * 261))
    # A' and F as the packed build runs them (31 used columns)
    pa = packed.arrays
    K = pa.C.shape[0] - 1
    n_seg16 = packed.meta.n_seg
    kw16 = dict(n_seg=n_seg16, seg=seg)
    kernel_row(
        "occ_build_compact",
        lambda: BO.occ_build_compact(pull, pa.alpha_map, pa.alpha_rev,
                                     **kw16),
        lambda: BO.occ_build_compact_plain(pull, pa.alpha_rev, **kw16),
        bound_occ_build_compact(n, n_seg16, seg, K, 16),
        library=lambda: torch.bincount(seg_sym, minlength=n_seg16 * 261))
    del seg_sym
    bwt16 = BO.occ_build_compact(pull, pa.alpha_map, pa.alpha_rev, **kw16)[0]
    pw, bits = BO.pack_widths(K)
    kernel_row(
        "pack_build",
        lambda: [BO.pack_build(bwt16, pa.alpha_map, per_word=pw, bits=bits)],
        lambda: [BO.pack_build_plain(bwt16, pa.alpha_map, per_word=pw,
                                     bits=bits)],
        bound_pack_build(n_seg16, seg, pa.bwt.shape[1]))
    del bwt16
    kw = dict(n_seg=n_seg, seg=seg, mark_period=mp, ndocs=ndocs)
    kernel_row(
        "marks_build",
        lambda: BO.marks_build(sa, a_row, **kw),
        lambda: BO.marks_build_plain(sa, a_row, **kw),
        bound_marks_build(n, n_seg, seg, index.meta.n_marks,
                          arrays.mark_vals.shape[0], ndocs))
    del a_row
    rt = torch.from_numpy(rows).to(dev)
    sort_kernel_rows(record, kernel_row, text, ds, sa, index.sa_direct, rt,
                     n=n, ndocs=ndocs, mark_period=mp)
    lat_ns = record["dependent_load_ns"] = dependent_load_ns(builds["chase"])
    log(f"    dependent global-load latency: {lat_ns:.4g} ns "
        f"({CHASE_STEPS} loads over {CHASE_WORDS * 4 >> 20} MiB)")
    d_libs = route_libs(builds["lf_walk"], "lf_walk")
    e_libs = e_forced(builds)
    pt = torch.from_numpy(pack_patterns(
        [pattern_to_alpha(p) for p in patterns],
        pad_b=len(patterns))[0]).to(dev)
    isa = torch.empty(n, dtype=torch.int64, device=dev)
    isa[index.sa_direct.long()] = torch.arange(n, device=dev)
    ct = torch.from_numpy(ctx_rows.astype(np.int32)).to(dev)
    fwd = CTX[1] + CTX[2]
    for lay, ix in (("full", walk), ("compact", st2["compact"]),
                    ("packed", packed)):
        A = ix.arrays
        kernel_row(
            f"backward_search[{lay}]",
            lambda: S.backward_search(A, n, pt),
            lambda: S.backward_search_plain(A, n, pt),
            bound_backward_search(A, pt, n, 0),
            extra=c_fields(c_libs, A, pt.shape[0],
                           lambda: S.backward_search(A, n, pt),
                           f"backward_search[{lay}]",
                           bound_backward_search(A, pt, n, 0,
                                                 shared=False)))
        kernel_row(
            f"lf_locate[{lay}]",
            lambda: [S.locate_rows(A, mp, rt)],
            lambda: [S.locate_rows_plain(A, mp, rt)],
            bound_locate(A, mp, rt))
        er = A.doc_seof_rows[d0: d0 + 1].contiguous()
        kernel_row(
            f"lf_extract[{lay}]",
            lambda: S.extract_backward(A, er, EXTRACT_STEPS),
            lambda: S.extract_backward_plain(A, er, EXTRACT_STEPS),
            bound_extract(A, isa, int(prepared.doc_starts[d0 + 1]) - 1,
                          EXTRACT_STEPS),
            extra=d_fields(d_libs, "lf_extract", A, 1, EXTRACT_STEPS,
                           lambda: S.extract_backward(A, er, EXTRACT_STEPS),
                           lat_ns))
        kernel_row(
            f"psi_walk[{lay}]",
            lambda: [S.psi_walk(A, ct, fwd)],
            lambda: [S.psi_walk_plain(A, ct, fwd)],
            bound_psi(A, ct, fwd),
            extra=e_fields(e_libs, A, ct.shape[0], fwd,
                           lambda: [S.psi_walk(A, ct, fwd)],
                           f"psi_walk[{lay}]", lat_ns))
    del isa
    row_kernel_rows(kernel_row, st3, d_libs, lat_ns, c_libs, e_libs)
    # the context batch's backward walk (packed, 4096 rows x 32 steps) on
    # both of D's routes, and both routes on each layout at its limit and
    # twice it (vseg and vrle, which have none: at 2^18 walks), enough to
    # show that the limits of csrc/lf_walk.cu still hold (chip_d_routes.py
    # times a wider range)
    ca, ckw = captured_call(
        "extract_backward", None,
        lambda: tt.extract_context_batch(packed, ctx_rows, *CTX), mod=S)
    record["context_backward_walk"] = d_fields(
        d_libs, "lf_extract", ca[0], ca[1].shape[0], ca[2],
        lambda: S.extract_backward(*ca, **ckw), lat_ns)
    log(f"    context batch's backward walk: "
        f"{record['context_backward_walk']}")
    del ca, ckw
    def limits(lay, A):
        cross = d_crossover(A)
        return ((1 << 18,) if cross is None or cross > 1 << 19
                else (cross, 2 * cross))

    record["extract_routes"] = d_route_probe(
        d_libs, [("full", walk.arrays, n),
                 ("compact", st2["compact"].arrays, n),
                 ("packed", packed.arrays, n),
                 ("vseg", prows["vseg"].arrays, pprep.n),
                 ("vrle", prows["vrle"].arrays, pprep.n)],
        np.random.default_rng(5), limits)
    record["query_shapes"] = query_kernel_rows(
        kernel_row, st, st3, st4, builds["radix_sort"],
        rank_forced(builds, "regex_frontier"), c_libs)
    rows = kern + [r for o in own for r in o["kernel_rows"]]
    have = {(r["name"], r["path"]) for r in rows}
    missing = sorted((name, path) for path, counts in path_launches.items()
                     for name, c in counts.items()
                     if c and (name, path) not in have)
    check(not missing, f"kernels launched on a path with no phase 5 row: "
                       f"{missing}")
    routes = sorted({r["route"] for r in rows} - {"cuda", "triton"})
    check(not routes, f"kernel rows with a route other than cuda or "
                      f"triton: {routes}")
    record["kernels"] = rows


def own_kernel_names():
    """Names of the port's own __global__ kernels, from the CUDA sources."""
    from femto_tpu_torch import kernels

    return sorted({
        m for src in kernels.SOURCES
        for m in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                            r"\([^)]*\)\s+)?(\w+)", open(
            os.path.join(kernels.CSRC, src + ".cu")).read())})


def profile_step(name, fn, own_kernels, tries=3):
    """One call of fn under torch.profiler: (record entry, profiler).  The
    entry has the wall and device ms, the busy share and the top device
    items; a build's or query's device items must hold no library sort or
    scan, and what lies outside the port's kernels and copies is named.
    Kernel H's items are summed by kernel (H_KERNELS) beside the kernels
    that the step's sorts launch (csrc/radix_sort.cu's count for each
    sort's m and bits).  Late in a long process the profiler has dropped
    a session's first kernels (a build's first sort): each session starts
    with profiler_warm_up, a step whose H calls still fall short is
    profiled again, up to `tries` calls, and the entry says how many it
    took and whether the last one saw every H kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import sort_ops as SO

    sort = SO.radix_sort_pairs
    sorts = []

    def counted(keys, vals, bit_lo, bit_hi):
        sorts.append((keys.shape[0], bit_lo, bit_hi))
        return sort(keys, vals, bit_lo, bit_hi)

    for attempt in range(1, tries + 1):
        sorts.clear()
        torch.cuda.synchronize()
        SO.radix_sort_pairs = counted
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                profiler_warm_up()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            SO.radix_sort_pairs = sort
        # device-side events only (kernels, copies): aten ops would count
        # their kernels a second time
        ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and SPIN_KERNEL not in e.key),
                     key=lambda o: -o[1])
        want = sum(kernels.size("radix_sort_kernels", *a) for a in sorts)
        h_calls = sum(c for k, _, c in ops if any(h in k for h in H_KERNELS))
        if not sorts or h_calls == want:
            break
        log(f"[6] {name}: the profiler saw {h_calls} of the {want} H "
            f"kernels (try {attempt} of {tries})")
    dev_ms = sum(o[1] for o in ops)
    out = {
        "wall_ms": wall_ms,
        "device_ms": dev_ms if ops else "not measured",
        "busy_share": dev_ms / wall_ms if ops else "not measured",
        "top": [{"op": k[:120], "ms": ms, "calls": c}
                for k, ms, c in ops[:8]],
        "profiled_calls": attempt,
    }
    log(f"[6] {name}: wall {wall_ms:.3f} ms, device {out['device_ms']} ms, "
        f"busy share {out['busy_share']}")
    for o in out["top"][:4]:
        log(f"      {o['ms']:.3f} ms x{o['calls']} {o['op'][:90]}")
    if sorts:
        by = {h: {"ms": sum(ms for k, ms, _ in ops if h in k),
                  "calls": sum(c for k, _, c in ops if h in k)}
              for h in H_KERNELS}
        out["H"] = {"sorts": len(sorts), "kernels_expected": want,
                    "kernel_calls": h_calls, "complete": h_calls == want,
                    "ms": sum(v["ms"] for v in by.values()),
                    "by_kernel": by}
        log(f"      H: {len(sorts)} sorts, {out['H']['ms']:.3f} ms, "
            f"{h_calls} of {want} kernels seen; {by}")
    if ("build" in name or name.startswith("query")) and ops:
        # nothing fell back: no library sort or scan among the build's
        # device items, and what lies outside the port's own kernels and
        # copies is named
        library = [k for k, _, _ in ops
                   if any(s in k for s in LIBRARY_SORT_NAMES)]
        check(not library, f"{name} ran a library sort or scan on the "
                           f"card: {library}")
        outside = [(k, ms, c) for k, ms, c in ops
                   if not any(own in k for own in own_kernels)
                   and "memcpy" not in k.lower()
                   and "memset" not in k.lower()]
        out["outside_port_kernels_ms"] = sum(o[1] for o in outside)
        out["outside_port_kernels"] = [
            {"op": k[:160], "ms": ms, "calls": c} for k, ms, c in outside]
        out["by_port_kernel_ms"] = {
            own: sum(ms for k, ms, _ in ops if own in k)
            for own in own_kernels if any(own in k for k, _, _ in ops)}
        out["by_port_kernel_calls"] = {
            own: sum(c for k, _, c in ops if own in k)
            for own in out["by_port_kernel_ms"]}
        log(f"      no library sort or scan; outside the port's kernels "
            f"and copies: {out['outside_port_kernels_ms']:.3f} ms")
        for k, ms, c in outside:
            log(f"        {ms:.3f} ms x{c} {k[:100]}")
        log(f"      by port kernel: {out['by_port_kernel_ms']}")
    return out, prof


def phase_profile(record, st, st2, st3, st4, own):
    """Device time by kernel (torch.profiler, CUPTI) and the device's busy
    share over one call of each main-path step, for PERF.md's breakdown;
    "not measured" where the profiler reports no device time.  The
    two-chunk build of phase 4e was profiled there (st5)."""
    import femto_tpu_torch as tt
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.query import regexp_device as RD

    own_kernels = own_kernel_names()
    prepared, walk = st["prepared"], st["walk"]
    steps = {
        "build": lambda: tt.build_index(prepared, seg=256, mark_period=20,
                                        device="cuda"),
        "twin_build": lambda: tt.build_index(
            st["twin_prepared"], seg=256, mark_period=20, device="cuda"),
        "count": lambda: tt.count(walk, st["patterns"]),
        "locate_walk": lambda: tt.locate_rows_array(walk, st["loc_rows"]),
        "extract": lambda: tt.extract_document(walk, st["ext_docs"][0]),
        "packed_build": lambda: tt.build_index(
            prepared, seg=256, mark_period=20, tier="packed", device="cuda"),
        "packed_count": lambda: tt.count(st2["packed"], st["patterns"]),
        "packed_locate_walk": lambda: tt.locate_rows_array(st2["packed"],
                                                           st["loc_rows"]),
        "packed_context": lambda: tt.extract_context_batch(
            st2["packed"], st2["ctx_rows"], *CTX),
        "vseg_build": lambda: tt.build_index(
            prepared, seg=256, mark_period=20, tier="vseg", device="cuda"),
        "vrle_build": lambda: tt.build_index(
            prepared, seg=256, mark_period=20, tier="vrle", device="cuda"),
        "prose_vrle_build": lambda: tt.build_index(
            st3["pprep"], seg=PROSE_SEG, mark_period=20, tier="vrle",
            device="cuda"),
        "prose_vrle_count": lambda: tt.count(st3["prows"]["vrle"],
                                             st3["ppats"]),
        "prose_vrle_locate_walk": lambda: tt.locate_rows_array(
            st3["prows"]["vrle"], st3["ploc"]),
        "prose_vrle_context": lambda: tt.extract_context_batch(
            st3["prows"]["vrle"], st3["pctx"], *CTX),
    }
    # one APPROX 1 ther query on the zipf full and the prose vrle index
    node, nfa = query_nfa(ZIPF_QUERIES["approx1"][0])
    for name, ix in (("query_approx1_zipf_full", walk),
                     ("query_approx1_prose_vrle", st3["prows"]["vrle"])):
        steps[name] = (lambda ix=ix: RD.run_regexp_device(
            ix, nfa, node.approx, frontier_cap=ZIPF_QUERIES["approx1"][1]))
    out = {}
    for name, fn in steps.items():
        out[name] = profile_step(name, fn, own_kernels)[0]
        if name.endswith("count"):
            # kernel C's own device ms from CUDA events around its calls
            # (the profiler has seen no device item of a count)
            ev = route_sums(S, "backward_search", "backward_search", {},
                            {name: fn})["as_built"]
            out[name]["c_device_ms_events"] = ev["ms"]
            out[name]["c_calls"] = ev["calls"]
            if out[name]["device_ms"] == "not measured":
                out[name].update(
                    device_ms=ev["ms"], busy_share=ev["ms"]
                    / out[name]["wall_ms"], device_ms_source=(
                        "CUDA events around kernel C's calls, each queued "
                        "behind a spin kernel; copies not included"))
            log(f"      {name}: kernel C {ev['ms']:.4g} ms over "
                f"{ev['calls']} calls (CUDA events)")
        if name.endswith("context"):
            # kernel E's own device ms from CUDA events around its call
            # (the profiler has dropped the context's device items)
            ev = route_sums(S, "psi_walk", "psi_walk", {},
                            {name: fn})["as_built"]
            out[name]["e_device_ms_events"] = ev["ms"]
            out[name]["e_calls"] = ev["calls"]
            log(f"      {name}: kernel E {ev['ms']:.4g} ms over "
                f"{ev['calls']} calls (CUDA events)")
        if name.startswith("query"):
            layers = RD.last_stats["layers"]
            dev_ms = out[name]["device_ms"]
            out[name].update(
                layers=layers, reads=RD.last_stats["reads"],
                host_ms_per_layer=(out[name]["wall_ms"] - dev_ms) / layers
                if dev_ms != "not measured" else "not measured")
            log(f"      {layers} layers, host ms per layer "
                f"{out[name]['host_ms_per_layer']}")
    for o in own:
        out.update(o["profile"])
    record["profile"] = out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--parent", default=None,
                    help="root of the parent tree (unpacked by git "
                         "archive): phase 5 times its kernel E and "
                         "mesh_flags at this tree's calls")
    args = ap.parse_args(argv)
    global PARENT
    PARENT = args.parent and os.path.abspath(args.parent)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    record = {"seed": args.seed}
    rng = np.random.default_rng(args.seed)
    seconds = record["phase_seconds"] = {}

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(record, *args)
        seconds[fn.__name__] = time.perf_counter() - t
        log(f"    {fn.__name__} took {seconds[fn.__name__]:.1f}s")
        return out

    try:
        phase(phase_toolchain)
        builds = phase(phase_build)
        phase(phase_parity, rng, builds)
        # the chunked path first, while the card holds nothing else
        st5 = phase(phase_chunked, rng)
        st = phase(phase_main, rng)
        # the sharded path next, while the card holds phase 4's index only
        st8 = phase(phase_sharded, rng, st, builds)
        st2 = phase(phase_tiers, rng, st)
        st3 = phase(phase_rows, rng, st, st2)
        st4 = phase(phase_query, rng, st, st2, st3, builds)
        # the sharded query engine, held to phase 4d's answers
        st9 = phase(phase_sharded_query, rng, st4, st8, builds)
        st6 = phase(phase_paged, rng, st, st3, st4, builds)
        st7 = phase(phase_lcp, rng, st, st3)
        own = (st5, st6, st7, st8, st9)
        phase(phase_numbers, st, st2, st3, st4, own, builds)
        phase(phase_profile, st, st2, st3, st4, own)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"total {record['seconds']:.1f}s")
    print(json.dumps({"kernels": record["kernels"]}))
    print(record["toolchain"]["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
