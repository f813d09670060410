// Kernel R: one layer of the device regex frontier (K15), in three entries.
//
//   regex_fork   every fork (entry f, symbol a) of the n_live live entries:
//                whether a is reachable from f's cost vector, the FM step
//                of f's range by a, and the fork's new cost vector;
//   regex_fork_ranked  the same with each fork's new range given (two
//                int32 [n_live * 261] arrays), for the sharded frontier
//                (K18h: femto_tpu/parallel/dist_query.py _regexp_body
//                572 over backward_step_pair_sharded 99), whose ranks are
//                summed over the mesh's shards (K18f masked_occ + psum)
//                before the fork, since no kernel sums across processes;
//   regex_merge  after the forks are sorted by (first, last) (kernel H),
//                min-merge each run of equal ranges, record the runs that
//                accept into the results and compact the runs into the
//                next frontier.
//
// Replaces the body of femto_tpu/query/regexp_device.py _frontier_loop
// (98): steps 1-3 (142-186: reach as a [F, T] x [T, A] product, the F*A
// rank pairs, the [F, A, T] contributions and a segment_min over T, the
// deletion rounds) and steps 4b-6 (197-240: run marks, a cumsum of run
// ids, a segment_min over runs, two cumsums of slots, scatters with
// mode="drop").  The TPU evaluated every fork of every one of F entries;
// here a layer covers only the n_live entries the last merge kept (the
// host reads that count, 4 bytes a layer), a fork that no live transition
// reaches costs one row of NO_COST writes, and only reached forks rank.
//
// regex_fork: one block per entry, one warp per reached fork.  The entry's
// costs and its reach bits (9 words of the 261-symbol masks, OR-ed over
// the transitions whose source is live) sit in shared memory.  The ranks
// take one of two routes by the number of codes the entry's forks would
// rank (fm_common.cuh row_rank_min): the row route, where warps
// 0 and 1 rank the rows of first and last for every code at once
// (warp_rank_row: one decode of each row) into two int32[K] rows in shared
// memory that every fork then reads, wherever the entry ranks a code; or
// the fork route (the design before it, which a build with
// -DFEMTO_R_ROW_RANK=0 forces), where lanes 0 and 1 of a fork's warp rank
// its first and last (femto::occ: one decode of each row a fork).  Then
// lanes own states: a state's new cost is the
// min over its incoming transitions (CSR by destination, so no atomics)
// of the source's cost (mask hit) or that plus subst (miss, approximate,
// depth > 0), then insertion, the clamp to NO_COST at cost_bound, and
// del_rounds Jacobi rounds of deletion relaxation between two buffers of
// S ints per warp: shared memory while 17 * S ints fit in 46 KiB, else
// the fork's own output row and a global scratch row (any S, never cut).
// Costs stay int32 through the clamp (NO_COST + subst passes 255).
//
// regex_merge: three kernels over tiles of 1024 sorted forks.  A tile
// whose first key is dead is all dead (dead keys sort last) and exits.
// count: run starts (keep) and their accept cost (min over the run's
// rows and the accepting states, NO_COST where a state does not accept),
// per-tile keep and hit counts; scan: one block scans the tile counts
// and updates the state (res_count, overflow, n_live, status); write:
// slots from the scans, the run's min cost row into the next frontier
// (F cap) and accepting runs into the results (R cap).  Slot order is
// the sorted order, femto_tpu's.
//
// Bound on the H100: bytes.  The fork must read each live entry's range
// and costs and write n_live * 261 keys and cost rows, and each reached
// fork reads the row prefixes of two ranks (chip_smoke.py
// bound_regex_fork), or, ranked by rows, each entry's two rows once
// (bound_regex_fork_rows); the merge must read the sorted keys, payload
// and the cost rows of the live forks and write the next frontier and the
// hits.
#include "fm_common.cuh"

namespace {

constexpr int kNoCost = 0xFF;           // query/regexp.py NO_COST
constexpr int kIntMax = 0x7fffffff;     // segment_min's identity
constexpr int kCharOffset = 5;          // alphabet.CHARACTER_OFFSET
constexpr int kMaskWords = (femto::kAlpha + 31) / 32;
constexpr int kForkThreads = 256;
constexpr int kForkWarps = kForkThreads / 32;
constexpr int kSmemLimit = 46 * 1024;  // dynamic part, under 48 KiB
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 4;
constexpr int kMergeTile = kMergeThreads * kMergeItems;
constexpr int kScanThreads = 1024;

__host__ __device__ constexpr int fork_smem_bytes(int S) {
  return (1 + 2 * kForkWarps) * S * 4;
}

struct ForkArgs {
  const int* first;
  const int* last;
  const int* costs;          // int32[>= n_live, S]
  int S;
  int T;
  const int* in_off;         // int32[S + 1]: transitions into each state
  const int* in_src;         // int32[T], grouped by destination
  const unsigned* in_mask;   // uint32[T, kMaskWords]
  int bound;
  int subst;
  int del;
  int ins;
  int del_rounds;
  int allow_subst;
  int half_bits;
  long long* keys;           // int64[n_live * 261]
  int* fcosts;               // int32[n_live * 261, S]
  int* scratch;              // int32[n_live * kForkWarps, S] or null
  const int* rfirst;         // int32[n_live * 261]: the forks' ranges
  const int* rlast;          //   (regex_fork_ranked), else null
  int rank_off;              // the row route's words in dynamic shared
                             // memory from here (two int32[kAlpha] rank
                             // rows, two warps' scratch), -1: fork route
  int scratch_words;         // rank_scratch_words: a warp's scratch
};

__device__ __forceinline__ long long dead_key(int half_bits) {
  return (1LL << (2 * half_bits)) - 1;
}

// kRanked: the forks' ranges come from a.rfirst / a.rlast and ix is not
// read (regex_fork_ranked); else the row route or lanes 0 and 1 of each
// fork's warp rank them (regex_fork).
template <int L, bool kRanked>
__global__ void __launch_bounds__(kForkThreads)
    regex_fork_kernel(femto::FmView ix, ForkArgs a) {
  extern __shared__ int sh[];
  __shared__ unsigned reach[kMaskWords];
  __shared__ int min_cost;
  const int f = blockIdx.x;
  const int S = a.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool in_smem = fork_smem_bytes(S) <= kSmemLimit;
  const int* cg = a.costs + static_cast<long long>(f) * S;
  const int* cf = cg;
  if (in_smem) {
    for (int s = tid; s < S; s += kForkThreads) sh[s] = cg[s];
    cf = sh;
  }
  if (tid < kMaskWords) reach[tid] = 0u;
  if (tid == 0) min_cost = kIntMax;
  __syncthreads();
  const bool approx = a.bound > 1;
  for (int t = tid; t < a.T; t += kForkThreads) {
    if (cf[__ldg(a.in_src + t)] < a.bound) {
      for (int w = 0; w < kMaskWords; ++w) {
        const unsigned m = __ldg(a.in_mask + t * kMaskWords + w);
        if (m) atomicOr(&reach[w], m);
      }
    }
  }
  if (approx) {
    int m = kIntMax;
    for (int s = tid; s < S; s += kForkThreads) m = min(m, cf[s]);
    atomicMin(&min_cost, m);
  }
  __syncthreads();
  const bool any_live =
      approx && min_cost + min(a.subst, a.ins) < a.bound;
  const int first = kRanked ? 0 : a.first[f];
  const int last = kRanked ? 0 : a.last[f];
  // the row route: the codes the entry's forks would rank (reached
  // symbols the index maps to a code; a block count, uniform in the block)
  // against the rule's least count; warps 0 and 1 rank first and last
  bool by_rows = false;
  int* rank_f = nullptr;
  int* rank_l = nullptr;
  if constexpr (!kRanked) {
    if (a.rank_off >= 0) {
      auto ranked = [&](int c) {
        return c < femto::kAlpha &&
               (((reach[c >> 5] >> (c & 31)) & 1u) ||
                (any_live && c >= kCharOffset)) &&
               femto::map_char(ix, c) >= 0;
      };
      static_assert(2 * kForkThreads >= femto::kAlpha, "two passes");
      const int reached = __syncthreads_count(ranked(tid)) +
                          __syncthreads_count(ranked(tid + kForkThreads));
      by_rows = reached >= femto::row_rank_min();
      rank_f = sh + a.rank_off;
      rank_l = rank_f + femto::kAlpha;
      if (by_rows) {
        if (warp < 2) {
          unsigned* scratch = reinterpret_cast<unsigned*>(
              rank_l + femto::kAlpha) + warp * a.scratch_words;
          femto::warp_rank_row<L>(ix, warp ? last : first, lane, scratch,
                                  warp ? rank_l : rank_f);
        }
        __syncthreads();
      }
    }
  }
  const long long dead = dead_key(a.half_bits);
  int* buf0 = in_smem ? sh + S + warp * 2 * S : nullptr;
  for (int c = warp; c < femto::kAlpha; c += kForkWarps) {
    const long long row = static_cast<long long>(f) * femto::kAlpha + c;
    int* out = a.fcosts + row * S;
    const bool reached = ((reach[c >> 5] >> (c & 31)) & 1u) ||
                         (any_live && c >= kCharOffset);
    int nf = 0, nl = 0;
    bool alive = false;
    int* A = nullptr;
    if (reached) {
      if constexpr (kRanked) {
        nf = __ldg(a.rfirst + row);
        nl = __ldg(a.rlast + row);
      } else {
        const int cd = femto::map_char(ix, c);  // uniform in the warp
        if (cd >= 0 && by_rows) {
          const int base = __ldg(ix.C + cd);
          nf = base + rank_f[cd];
          nl = base + rank_l[cd];
        } else if (cd >= 0) {
          int o = 0;
          if (lane < 2)
            o = __ldg(ix.C + cd) + femto::occ<L>(ix, cd, lane ? last : first);
          nf = __shfl_sync(0xffffffffu, o, 0);
          nl = __shfl_sync(0xffffffffu, o, 1);
        }
      }
      if (nl > nf) {
        A = in_smem ? buf0 : out;
        int* B = in_smem ? buf0 + S
                         : a.scratch + (static_cast<long long>(f) *
                                            kForkWarps + warp) * S;
        const unsigned bit = 1u << (c & 31);
        const int word = c >> 5;
        for (int s = lane; s < S; s += 32) {
          int v = kIntMax;
          const int t1 = __ldg(a.in_off + s + 1);
          for (int t = __ldg(a.in_off + s); t < t1; ++t) {
            // femto_tpu's contributions: exact where the mask holds a,
            // else NO_COST; approximate: min with base + subst off the
            // mask (depth > 0), else with NO_COST
            const int base = cf[__ldg(a.in_src + t)];
            const bool hit = __ldg(a.in_mask + t * kMaskWords + word) & bit;
            int x = hit ? base : kNoCost;
            if (approx)
              x = min(x, !hit && a.allow_subst ? base + a.subst : kNoCost);
            v = min(v, x);
          }
          if (approx) v = min(v, cf[s] + a.ins);
          A[s] = v >= a.bound ? kNoCost : v;
        }
        __syncwarp();
        for (int r = 0; r < a.del_rounds; ++r) {
          for (int s = lane; s < S; s += 32) {
            int u = A[s];
            const int t1 = __ldg(a.in_off + s + 1);
            for (int t = __ldg(a.in_off + s); t < t1; ++t)
              u = min(u, A[__ldg(a.in_src + t)] + a.del);
            B[s] = u >= a.bound ? kNoCost : u;
          }
          __syncwarp();
          int* tmp = A;
          A = B;
          B = tmp;
        }
        bool any = false;
        for (int s = lane; s < S; s += 32) any |= A[s] < a.bound;
        alive = __any_sync(0xffffffffu, any);
      }
    }
    for (int s = lane; s < S; s += 32) out[s] = alive ? A[s] : kNoCost;
    if (lane == 0)
      a.keys[row] = alive ? (static_cast<long long>(nf) << a.half_bits) | nl
                          : dead;
    __syncwarp();
  }
}

struct MergeArgs {
  const long long* keys;  // int64[E], sorted
  const int* idx;         // int32[E]: each sorted fork's row in fcosts
  const int* fcosts;      // int32[E, S]
  long long E;
  int S;
  const int* accept;      // int32[S], 0 or 1
  int bound;
  int half_bits;
  int F;
  int R;
  int depth;
  int* first;             // int32[F]: the next frontier, written in place
  int* last;
  int* costs;             // int32[F, S]
  int* res;               // int32[4, R]: first, last, cost, length
  int* state;             // int32[8]
  int* tile_counts;       // int32[2 * ntiles]: keep, hit
  int* acc;               // int32[E]: a run start's accept cost
};

__device__ __forceinline__ bool run_start(const MergeArgs& a, long long i,
                                          long long dead, long long* k) {
  *k = a.keys[i];
  return *k != dead && (i == 0 || a.keys[i - 1] != *k);
}

// min over the accepting states of the run's min-merged costs, NO_COST
// for each state that does not accept
__device__ int run_accept_cost(const MergeArgs& a, long long i, long long k) {
  int acc = kIntMax;
  for (int s = 0; s < a.S; ++s) {
    if (!a.accept[s]) {
      acc = min(acc, kNoCost);
      continue;
    }
    for (long long j = i; j < a.E && a.keys[j] == k; ++j)
      acc = min(acc, a.fcosts[static_cast<long long>(a.idx[j]) * a.S + s]);
  }
  return acc;
}

__global__ void __launch_bounds__(kMergeThreads)
    merge_count_kernel(MergeArgs a) {
  __shared__ int warp_vals[32];
  const long long base = static_cast<long long>(blockIdx.x) * kMergeTile;
  const long long dead = dead_key(a.half_bits);
  if (a.keys[base] == dead) {  // the tile and all after it are dead
    if (threadIdx.x == 0) {
      a.tile_counts[2 * blockIdx.x] = 0;
      a.tile_counts[2 * blockIdx.x + 1] = 0;
    }
    return;
  }
  int nk = 0, nh = 0;
  for (int j = 0; j < kMergeItems; ++j) {
    const long long i = base + threadIdx.x * kMergeItems + j;
    long long k;
    if (i < a.E && run_start(a, i, dead, &k)) {
      const int acc = run_accept_cost(a, i, k);
      a.acc[i] = acc;
      ++nk;
      nh += acc < a.bound;
    }
  }
  int tk, th;
  femto::block_exclusive_sum<kMergeThreads>(nk, warp_vals, &tk);
  femto::block_exclusive_sum<kMergeThreads>(nh, warp_vals, &th);
  if (threadIdx.x == 0) {
    a.tile_counts[2 * blockIdx.x] = tk;
    a.tile_counts[2 * blockIdx.x + 1] = th;
  }
}

// One block: exclusive scans of the tiles' keep and hit counts, in place,
// and the layer's state: state[0] res_count, [1] overflow, [2] n_live,
// [3] status (n_keep, -1 on overflow), [4] res_count before this layer.
__global__ void __launch_bounds__(kScanThreads)
    merge_scan_kernel(int* __restrict__ tc, long long ntiles,
                      int* __restrict__ state, int F, int R) {
  __shared__ int warp_vals[32];
  const long long chunk = (ntiles + kScanThreads - 1) / kScanThreads;
  const long long b = threadIdx.x * chunk;
  const long long e = min(b + chunk, ntiles);
  int sk = 0, sh = 0;
  for (long long i = b; i < e; ++i) {
    sk += tc[2 * i];
    sh += tc[2 * i + 1];
  }
  int tk, th;
  int rk = femto::block_exclusive_sum<kScanThreads>(sk, warp_vals, &tk);
  int rh = femto::block_exclusive_sum<kScanThreads>(sh, warp_vals, &th);
  for (long long i = b; i < e; ++i) {
    const int vk = tc[2 * i], vh = tc[2 * i + 1];
    tc[2 * i] = rk;
    tc[2 * i + 1] = rh;
    rk += vk;
    rh += vh;
  }
  if (threadIdx.x == 0) {
    const int rc = state[0];
    const int ovf = state[1] || static_cast<long long>(rc) + th > R || tk > F;
    state[4] = rc;
    state[0] = min(rc + th, R);
    state[1] = ovf;
    state[2] = min(tk, F);
    state[3] = ovf ? -1 : tk;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    merge_write_kernel(MergeArgs a) {
  __shared__ int warp_vals[32];
  const long long base = static_cast<long long>(blockIdx.x) * kMergeTile;
  const long long dead = dead_key(a.half_bits);
  if (a.keys[base] == dead) return;
  const long long hmask = (1LL << a.half_bits) - 1;
  bool keep[kMergeItems], hit[kMergeItems];
  long long key[kMergeItems];
  int nk = 0, nh = 0;
  for (int j = 0; j < kMergeItems; ++j) {
    const long long i = base + threadIdx.x * kMergeItems + j;
    keep[j] = i < a.E && run_start(a, i, dead, &key[j]);
    hit[j] = keep[j] && a.acc[i] < a.bound;
    nk += keep[j];
    nh += hit[j];
  }
  int tk, th;
  int sk = a.tile_counts[2 * blockIdx.x] +
           femto::block_exclusive_sum<kMergeThreads>(nk, warp_vals, &tk);
  int sr = a.state[4] + a.tile_counts[2 * blockIdx.x + 1] +
           femto::block_exclusive_sum<kMergeThreads>(nh, warp_vals, &th);
  for (int j = 0; j < kMergeItems; ++j) {
    if (!keep[j]) continue;
    const long long i = base + threadIdx.x * kMergeItems + j;
    const int nf = static_cast<int>(key[j] >> a.half_bits);
    const int nl = static_cast<int>(key[j] & hmask);
    if (sk < a.F) {
      a.first[sk] = nf;
      a.last[sk] = nl;
      int* row = a.costs + static_cast<long long>(sk) * a.S;
      for (int s = 0; s < a.S; ++s) {
        int m = kIntMax;
        for (long long q = i; q < a.E && a.keys[q] == key[j]; ++q)
          m = min(m, a.fcosts[static_cast<long long>(a.idx[q]) * a.S + s]);
        row[s] = m;
      }
    }
    ++sk;
    if (hit[j]) {
      if (sr < a.R) {
        a.res[sr] = nf;
        a.res[a.R + sr] = nl;
        a.res[2 * a.R + sr] = a.acc[i];
        a.res[3 * a.R + sr] = a.depth + 1;
      }
      ++sr;
    }
  }
}

}  // namespace

// Int32 elements of regex_fork's scratch for n_live entries of S states:
// kForkWarps rows of S per entry when a block's cost rows do not fit in
// shared memory, else 0.
extern "C" long long femto_regex_fork_scratch(int n_live, int S) {
  return fork_smem_bytes(S) <= kSmemLimit
             ? 0
             : static_cast<long long>(n_live) * kForkWarps * S;
}

// The row route's dynamic shared memory for a view, in words past the
// cost rows' (two rank rows, two warps' scratch), or 0 where the view's
// blocks take the fork route alone (row_rank_min past every count, or a
// block past the SM's 227 KiB with cost_words of cost rows, less the
// kernel's static part).
static int fork_rank_words(const femto::FmView& ix, int cost_words) {
  if (femto::row_rank_min() > femto::kAlpha) return 0;
  const int words = 2 * femto::kAlpha + 2 * femto::rank_scratch_words(ix);
  return 4ll * (cost_words + words) <= 226 * 1024 ? words : 0;
}

// The fewest codes an entry of regex_fork on the view must rank for its
// block to rank by rows (fm_common.cuh row_rank_min), 0x7fffffff where it
// never does (for S states).
extern "C" long long femto_regex_fork_row_min(const femto::FmView* ix,
                                              int S) {
  const int cost_words = fork_smem_bytes(S) <= kSmemLimit
                             ? fork_smem_bytes(S) / 4 : 0;
  return fork_rank_words(*ix, cost_words) > 0
             ? femto::row_rank_min()
             : 0x7fffffff;
}

// Int32 elements of regex_merge's tile counts for E forks.
extern "C" long long femto_regex_merge_tiles(long long E) {
  return 2 * ((E + kMergeTile - 1) / kMergeTile);
}

// One layer's forks of entries [0, n_live) of (first, last, costs):
// keys int64[n_live * 261] ((first << half_bits) | last of a live fork,
// 2^(2 half_bits) - 1 for a dead one) and fcosts int32[n_live * 261, S]
// (NO_COST rows for dead forks).  scratch: femto_regex_fork_scratch
// int32 elements, null when that is 0.
extern "C" int femto_regex_fork(const femto::FmView* ix, const void* first,
                                const void* last, const void* costs,
                                int n_live, int S, int T, const void* in_off,
                                const void* in_src, const void* in_mask,
                                int bound, int subst, int del, int ins,
                                int del_rounds, int allow_subst,
                                int half_bits, void* keys, void* fcosts,
                                void* scratch, void* stream) {
  if (n_live <= 0) return static_cast<int>(cudaGetLastError());
  const bool in_smem = fork_smem_bytes(S) <= kSmemLimit;
  if (!in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cost_words = in_smem ? fork_smem_bytes(S) / 4 : 0;
  const int rank_words = fork_rank_words(*ix, cost_words);
  ForkArgs a{static_cast<const int*>(first), static_cast<const int*>(last),
             static_cast<const int*>(costs), S, T,
             static_cast<const int*>(in_off), static_cast<const int*>(in_src),
             static_cast<const unsigned*>(in_mask), bound, subst, del, ins,
             del_rounds, allow_subst, half_bits,
             static_cast<long long*>(keys), static_cast<int*>(fcosts),
             static_cast<int*>(scratch), nullptr, nullptr,
             rank_words > 0 ? cost_words : -1,
             femto::rank_scratch_words(*ix)};
  const int smem = 4 * (cost_words + rank_words);
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(regex_fork_kernel<L, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    regex_fork_kernel<L, false><<<n_live, kForkThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(*ix,
                                                                       a);
  });
}

// regex_fork with the forks' new ranges given: rfirst, rlast int32
// [n_live * 261] (fork f * 261 + a: the range of entry f's range stepped
// by symbol a, (0, 0) where a is absent), as the sharded frontier sums
// them over the mesh; the rest as femto_regex_fork.
extern "C" int femto_regex_fork_ranked(const void* costs, const void* rfirst,
                                       const void* rlast, int n_live, int S,
                                       int T, const void* in_off,
                                       const void* in_src,
                                       const void* in_mask, int bound,
                                       int subst, int del, int ins,
                                       int del_rounds, int allow_subst,
                                       int half_bits, void* keys,
                                       void* fcosts, void* scratch,
                                       void* stream) {
  if (n_live <= 0) return static_cast<int>(cudaGetLastError());
  const bool in_smem = fork_smem_bytes(S) <= kSmemLimit;
  if (!in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  ForkArgs a{nullptr, nullptr, static_cast<const int*>(costs), S, T,
             static_cast<const int*>(in_off), static_cast<const int*>(in_src),
             static_cast<const unsigned*>(in_mask), bound, subst, del, ins,
             del_rounds, allow_subst, half_bits,
             static_cast<long long*>(keys), static_cast<int*>(fcosts),
             static_cast<int*>(scratch), static_cast<const int*>(rfirst),
             static_cast<const int*>(rlast), -1, 0};
  const femto::FmView none{};
  const int smem = in_smem ? fork_smem_bytes(S) : 0;
  regex_fork_kernel<femto::kFull, true>
      <<<n_live, kForkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          none, a);
  return static_cast<int>(cudaGetLastError());
}

// The merge of E sorted forks (keys, idx from kernel H over regex_fork's
// keys) into the next frontier (first, last, costs; F rows, rows past the
// kept count untouched) and the results res int32[4, R], with the state
// int32[8] updated.  Scratch: tile_counts (femto_regex_merge_tiles int32
// elements), acc int32[E].
extern "C" int femto_regex_merge(const void* keys, const void* idx,
                                 const void* fcosts, long long E, int S,
                                 const void* accept, int bound, int half_bits,
                                 int F, int R, int depth, void* first,
                                 void* last, void* costs, void* res,
                                 void* state, void* tile_counts, void* acc,
                                 void* stream) {
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MergeArgs a{static_cast<const long long*>(keys),
              static_cast<const int*>(idx),
              static_cast<const int*>(fcosts), E, S,
              static_cast<const int*>(accept), bound, half_bits, F, R, depth,
              static_cast<int*>(first), static_cast<int*>(last),
              static_cast<int*>(costs), static_cast<int*>(res),
              static_cast<int*>(state), static_cast<int*>(tile_counts),
              static_cast<int*>(acc)};
  const long long ntiles = (E + kMergeTile - 1) / kMergeTile;
  merge_count_kernel<<<static_cast<unsigned>(ntiles), kMergeThreads, 0, st>>>(
      a);
  merge_scan_kernel<<<1, kScanThreads, 0, st>>>(a.tile_counts, ntiles,
                                                a.state, F, R);
  merge_write_kernel<<<static_cast<unsigned>(ntiles), kMergeThreads, 0, st>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
