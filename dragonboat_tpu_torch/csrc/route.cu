// route.cu — the on-device router between inner steps of a super-step, by
// hand for Hopper.
//
// Replaces dragonboat_tpu/ops/kernel.py:route_step_output (_route_columns,
// _route_scatter, _split_plan) and, for logical shards, the splice/replay/
// slice of _shard_route. On the TPU these ops live inside the super-step's
// one XLA program; in eager PyTorch they would be a few hundred small
// launches per inner step. The plain PyTorch version is
// dragonboat_tpu_torch/ops/kernel.py:route_step_output_reference; these
// kernels give the same inbox and RoutePlan bit for bit.
//
// Two kernels:
//   route_columns_kernel — one thread per candidate of a lane block, in the
//     kind-major layout (rep, vote, hb, tn: P per lane; resp: K; rir: R).
//     It writes the candidate's column of the (C, M) i32 slab, C = 11 + 2E
//     (dest, the ten scalar Inbox fields, E entry terms read off the
//     sender's ring, E entry cc flags), and zeroes the candidate's RoutePlan
//     bit. The slab is the exchange format of the sharded path; the
//     unsharded router reads it as a gather of one shard.
//   route_scatter_kernel — the first K arrivals per destination lane, in
//     global candidate order, deterministically: each block owns a range of
//     destination lanes, scans the dest row of the gathered (n, C, M) slab,
//     and inserts every candidate addressed to its range into a K-deep
//     sorted list per lane in shared memory by cascading atomicMin of the
//     global candidate index (each slot keeps the minimum of what reaches
//     it and passes the larger value on, so slot j ends with the (j+1)-th
//     smallest index whatever the arrival order). Then one thread per
//     (lane, slot) writes the scalar Inbox fields from the chosen
//     candidate's column (MSG.NONE and zeros for an empty slot) and sets
//     the chosen candidate's RoutePlan bit, and one thread per (lane, slot,
//     entry) copies the entry planes. A shard writes only its own inbox rows and
//     its own candidates' plan bits; every shard replays the scatter for
//     all lanes, as the reference does, so all agree on arrival order.
//     Global candidate index <-> (kind, source shard, local offset) is
//     arithmetic; the spliced global layout is never materialised.
//
// Bound: bytes. The columns kernel writes the whole slab (dominated by the
// 2E entry rows, most of them zero), and the scatter reads the dest row of
// every shard's slab once per block plus the columns of the accepted
// candidates, and writes the inbox. Accesses are coalesced along the
// candidate axis (a warp writes 32 neighbouring columns of one slab row).
// The scatter is latency-bound, not byte-bound: a block owns only 64 lanes
// so the scan spreads over many SMs, each thread keeps 4 dest loads in
// flight, and the strided entry reads are spread over all threads. The
// scan of the dest row by every block is redundant work that a later
// version can cut with a per-lane candidate index.
//
// JAX semantics kept by hand: i32 adds wrap (done in uint32_t and cast
// back), floor modulo for ring slots, an arithmetic shift of the i32
// ready ctx, bools through the i32 slab as 0/1 read back as != 0.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RT_DEV __device__ __forceinline__
#else
#define RT_DEV static inline
#endif

#define RT_EMPTY 2147483647

enum { RT_NONE = -1, RT_REPLICATE = 12, RT_REPLICATE_RESP = 13,
       RT_REQUEST_VOTE = 14, RT_REQUEST_VOTE_RESP = 15, RT_HEARTBEAT = 17,
       RT_HEARTBEAT_RESP = 18, RT_READ_INDEX_RESP = 20, RT_TIMEOUT_NOW = 24,
       RT_REQUEST_PREVOTE = 26, RT_REQUEST_PREVOTE_RESP = 27 };
enum { RT_PRE_CANDIDATE = 5 };
enum { RT_S_REPLICATE = 1, RT_S_HEARTBEAT = 2, RT_S_VOTE_REQ = 4,
       RT_S_TIMEOUT_NOW = 8 };

// Everything route_columns_kernel reads and writes for one lane block.
// ops/cuda.py mirrors it field for field in a ctypes.Structure.
struct RouteColumnsParams {
  // post-step state
  const int32_t* self_slot;  // [G]
  const int32_t* log_term;   // [G, W]
  const uint8_t* log_is_cc;  // [G, W]
  // StepOutput planes
  const int32_t* send_flags;       // [G, P]
  const int32_t* send_prev_index;  // [G, P]
  const int32_t* send_prev_term;   // [G, P]
  const int32_t* send_n_entries;   // [G, P]
  const int32_t* send_commit;      // [G, P]
  const int32_t* send_hb_commit;   // [G, P]
  const int32_t* send_hint;        // [G, P]
  const int32_t* send_hint2;       // [G, P]
  const int32_t* vote_last_index;  // [G]
  const int32_t* vote_last_term;   // [G]
  const int32_t* resp_type;        // [G, K]
  const int32_t* resp_to;          // [G, K]
  const int32_t* resp_term;        // [G, K]
  const int32_t* resp_log_index;   // [G, K]
  const uint8_t* resp_reject;      // [G, K]
  const int32_t* resp_hint;        // [G, K]
  const int32_t* resp_hint2;       // [G, K]
  const int32_t* ready_ctx;        // [G, R]
  const int32_t* ready_ctx2;       // [G, R]
  const int32_t* ready_index;      // [G, R]
  const int32_t* ready_count;      // [G]
  const int32_t* o_term;           // [G]
  const int32_t* o_role;           // [G]
  const int32_t* lease_round;      // [G]
  // routing tables (global lane indexes)
  const int32_t* route;   // [G, P]
  const int32_t* rdelta;  // [G, P]
  // outputs
  int32_t* slab;      // [C, M]
  uint8_t* plan_rep;  // [G, P]
  uint8_t* plan_vote;
  uint8_t* plan_hb;
  uint8_t* plan_tn;
  uint8_t* plan_resp;  // [G, K]
  uint8_t* plan_rir;   // [G, R]
  int32_t G, P, K, R, E, W, M;  // G: lanes of this block, M = G*(4P+K+R)
};

// Everything route_scatter_kernel reads and writes for one shard.
struct RouteScatterParams {
  const int32_t* gathered;  // [n, C, M]: every shard's slab, shard-major
  // this shard's next Inbox (Gl rows)
  int32_t* mtype;
  int32_t* from_slot;
  int32_t* term;
  int32_t* log_index;
  int32_t* log_term;
  int32_t* commit;
  uint8_t* reject;
  int32_t* hint;
  int32_t* hint_high;
  int32_t* n_entries;
  int32_t* entry_terms;  // [Gl, K, E]
  uint8_t* entry_cc;     // [Gl, K, E]
  // this shard's RoutePlan of the step
  uint8_t* plan_rep;
  uint8_t* plan_vote;
  uint8_t* plan_hb;
  uint8_t* plan_tn;
  uint8_t* plan_resp;
  uint8_t* plan_rir;
  int32_t n, Gl, P, K, R, E, M, my;
};

RT_DEV int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
RT_DEV int rt_fmod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}
RT_DEV int rt_clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
RT_DEV int rt_max0(int x) { return x > 0 ? x : 0; }

// Candidates per lane row of kind k (rep, vote, hb, tn, resp, rir).
RT_DEV int seg_of(int k, int P, int K, int R) {
  return k < 4 ? P : (k == 4 ? K : R);
}

// Split index c of a kind-major layout over `lanes` lane rows into
// (kind, lane, slot); returns the kind.
RT_DEV int split_index(int c, int lanes, int P, int K, int R, int* lane, int* slot) {
  int k = 0, base = 0;
  while (k < 5 && c >= base + lanes * seg_of(k, P, K, R)) {
    base += lanes * seg_of(k, P, K, R);
    ++k;
  }
  const int seg = seg_of(k, P, K, R);
  *lane = (c - base) / seg;
  *slot = (c - base) % seg;
  return k;
}

// Start of kind k in a kind-major layout over `lanes` lane rows.
RT_DEV int kind_base(int k, int lanes, int P, int K, int R) {
  int base = 0;
  for (int i = 0; i < k; ++i) base += lanes * seg_of(i, P, K, R);
  return base;
}

RT_DEV uint8_t* plan_plane(uint8_t* rep, uint8_t* vote, uint8_t* hb, uint8_t* tn,
                           uint8_t* resp, uint8_t* rir, int k) {
  switch (k) {
    case 0: return rep;
    case 1: return vote;
    case 2: return hb;
    case 3: return tn;
    case 4: return resp;
    default: return rir;
  }
}

// One candidate column of the slab (the reference's _route_columns for
// candidate c of this block).
RT_DEV void route_candidate(const RouteColumnsParams& S, int c) {
  const int G = S.G, P = S.P, K = S.K, R = S.R, E = S.E, W = S.W;
  const size_t M = (size_t)S.M;
  int g, j;
  const int kind = split_index(c, G, P, K, R, &g, &j);
  const int self = S.self_slot[g];
  const int term = S.o_term[g];
  // mtype, from, term, log_index, log_term, commit, reject, hint,
  // hint_high, n_entries
  int f[10] = {0, self, 0, 0, 0, 0, 0, 0, 0, 0};
  bool want = false;
  int to = -1;
  int rep_n = 0, rep_prev = 0;  // entries of a wanted Replicate
  if (kind < 4) {
    const size_t gp = (size_t)g * P + j;
    const int fl = S.send_flags[gp], rd = S.rdelta[gp];
    to = S.route[gp];
    const bool has = to >= 0;
    f[2] = term;
    if (kind == 0) {
      want = (fl & RT_S_REPLICATE) && has;
      f[0] = RT_REPLICATE;
      f[3] = add32(S.send_prev_index[gp], rd);
      f[4] = S.send_prev_term[gp];
      f[5] = rt_max0(add32(S.send_commit[gp], rd));
      f[9] = S.send_n_entries[gp];
      rep_prev = S.send_prev_index[gp];
      rep_n = want ? f[9] : 0;
    } else if (kind == 1) {
      // a PRE_CANDIDATE lane's requests are REQUEST_PREVOTE at term + 1
      want = (fl & RT_S_VOTE_REQ) && has;
      const bool pre = S.o_role[g] == RT_PRE_CANDIDATE;
      f[0] = pre ? RT_REQUEST_PREVOTE : RT_REQUEST_VOTE;
      f[2] = pre ? add32(term, 1) : term;
      f[3] = add32(S.vote_last_index[g], rd);
      f[4] = S.vote_last_term[g];
      f[7] = S.send_hint[gp];
    } else if (kind == 2) {
      // log_index carries the lease round tag, untranslated
      want = (fl & RT_S_HEARTBEAT) && has;
      f[0] = RT_HEARTBEAT;
      f[3] = S.lease_round[g];
      f[5] = rt_max0(add32(S.send_hb_commit[gp], rd));
      f[7] = S.send_hint[gp];
      f[8] = S.send_hint2[gp];
    } else {
      want = (fl & RT_S_TIMEOUT_NOW) && has;
      f[0] = RT_TIMEOUT_NOW;
    }
  } else if (kind == 4) {
    const size_t gk = (size_t)g * K + j;
    const int rtype = S.resp_type[gk], rto = S.resp_to[gk];
    const size_t gq = (size_t)g * P + rt_clip(rto, 0, P - 1);
    const int rd = S.rdelta[gq];
    to = S.route[gq];
    const bool is_r = rtype == RT_REPLICATE_RESP, is_hb = rtype == RT_HEARTBEAT_RESP;
    const bool rej = S.resp_reject[gk] != 0;
    const int hint = S.resp_hint[gk];
    // a below-window REPLICATE_RESP reject stays host-side
    const bool below = is_r && rej && add32(hint, rd) < 0;
    want = rtype != RT_NONE && to >= 0 && rto != self && !below;
    f[0] = rtype;
    f[2] = S.resp_term[gk];
    f[3] = is_r ? add32(S.resp_log_index[gk], rd) : (is_hb ? S.resp_log_index[gk] : 0);
    f[6] = rej && (is_r || rtype == RT_REQUEST_VOTE_RESP ||
                   rtype == RT_REQUEST_PREVOTE_RESP);
    f[7] = is_r ? rt_max0(add32(hint, rd)) : (is_hb ? hint : 0);
    f[8] = is_hb ? S.resp_hint2[gk] : 0;
  } else {
    const size_t gr = (size_t)g * R + j;
    const int32_t ctx = S.ready_ctx[gr];
    const bool live = j < S.ready_count[g] && ctx != 0;
    const int origin = (ctx >> 24) - 1;  // arithmetic shift of the i32 ctx
    const size_t gq = (size_t)g * P + rt_clip(origin, 0, P - 1);
    to = S.route[gq];
    want = live && origin >= 0 && origin != self && to >= 0;
    f[0] = RT_READ_INDEX_RESP;
    f[2] = term;
    f[3] = add32(S.ready_index[gr], S.rdelta[gq]);
    f[7] = ctx;
    f[8] = S.ready_ctx2[gr];
  }
  int32_t* col = S.slab + c;
  col[0] = want ? to : -1;
  for (int r = 0; r < 10; ++r) col[(size_t)(1 + r) * M] = f[r];
  const int32_t* ring = S.log_term + (size_t)g * W;
  const uint8_t* ring_cc = S.log_is_cc + (size_t)g * W;
  const int first = add32(rep_prev, 1);
  for (int e = 0; e < E; ++e) {
    int t = 0, cc = 0;
    if (e < rep_n) {
      const int w = rt_fmod(add32(first, e), W);
      t = ring[w];
      cc = ring_cc[w] != 0;
    }
    col[(size_t)(11 + e) * M] = t;
    col[(size_t)(11 + E + e) * M] = cc;
  }
  const int base = kind_base(kind, G, P, K, R);
  plan_plane(S.plan_rep, S.plan_vote, S.plan_hb, S.plan_tn, S.plan_resp, S.plan_rir,
             kind)[c - base] = 0;
}

// Global candidate index of the candidate at local offset o of shard s's
// slab (the position it has in the unsharded kind-major layout).
RT_DEV int global_index(const RouteScatterParams& S, int s, int o) {
  const int G = S.n * S.Gl;
  int gl, j;
  const int k = split_index(o, S.Gl, S.P, S.K, S.R, &gl, &j);
  return kind_base(k, G, S.P, S.K, S.R) + (s * S.Gl + gl) * seg_of(k, S.P, S.K, S.R) + j;
}

#ifdef __CUDACC__
#define RT_ATOMIC_MIN(p, v) atomicMin((p), (v))
#else
RT_DEV int rt_atomic_min(int* p, int v) {
  int old = *p;
  if (v < old) *p = v;
  return old;
}
#define RT_ATOMIC_MIN(p, v) rt_atomic_min((p), (v))
#endif

// The dest word of gathered position i (shard i / M, local offset i % M).
RT_DEV int dest_at(const RouteScatterParams& S, int i) {
  const int C = 11 + 2 * S.E;
  const int s = i / S.M, o = i - s * S.M;
  return S.gathered[(size_t)s * C * S.M + o];
}

// Phase 1 of the scatter for gathered position i with dest word d: if d
// lies in [d0, d0 + D), insert i's global index into that lane's K-deep
// list.
RT_DEV void scatter_insert(const RouteScatterParams& S, int* slots, int d0, int D,
                           int i, int d) {
  const int G = S.n * S.Gl, K = S.K;
  if (d < d0 || d >= d0 + D || d >= G) return;  // also drops d < 0
  const int s = i / S.M;
  int c = global_index(S, s, i - s * S.M);
  int* lane = slots + (size_t)(d - d0) * K;
  for (int j = 0; j < K; ++j) {
    const int old = RT_ATOMIC_MIN(lane + j, c);
    if (old == RT_EMPTY) return;  // c took an empty slot
    if (old > c) c = old;         // c took slot j; carry the displaced one
  }
}

#define RT_NOT_MINE (-2)
#define RT_NO_CANDIDATE (-1)

// Phase 2 of the scatter for (lane d0 + q / K, slot q % K): set the chosen
// candidate's plan bit if it is this shard's, and write the scalar fields
// of the slot if the lane is this shard's. Returns where the chosen
// candidate's column starts in `gathered` (RT_NO_CANDIDATE for an empty
// slot, RT_NOT_MINE for another shard's lane) for the entry copy.
RT_DEV long long scatter_write(const RouteScatterParams& S, const int* slots, int d0, int q) {
  const int K = S.K, E = S.E, C = 11 + 2 * E, Gl = S.Gl, G = S.n * Gl;
  const int d = d0 + q / K, j = q % K;
  if (d >= G) return RT_NOT_MINE;
  const int c = slots[q];
  long long at = RT_NO_CANDIDATE;
  if (c != RT_EMPTY) {
    int g, slot;
    const int k = split_index(c, G, S.P, S.K, S.R, &g, &slot);
    const int s = g / Gl, gl = g - s * Gl;
    const int seg = seg_of(k, S.P, S.K, S.R);
    at = (long long)s * C * S.M + kind_base(k, Gl, S.P, S.K, S.R) + gl * seg + slot;
    if (s == S.my)
      plan_plane(S.plan_rep, S.plan_vote, S.plan_hb, S.plan_tn, S.plan_resp,
                 S.plan_rir, k)[gl * seg + slot] = 1;
  }
  if (d / Gl != S.my) return RT_NOT_MINE;
  const size_t M = (size_t)S.M;
  const size_t row = (size_t)(d - S.my * Gl) * K + j;
  const int32_t* col = at >= 0 ? S.gathered + at : nullptr;
  int v[10] = {RT_NONE, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (col)
    for (int r = 0; r < 10; ++r) v[r] = col[(size_t)(1 + r) * M];
  S.mtype[row] = v[0];
  S.from_slot[row] = v[1];
  S.term[row] = v[2];
  S.log_index[row] = v[3];
  S.log_term[row] = v[4];
  S.commit[row] = v[5];
  S.reject[row] = v[6] != 0;
  S.hint[row] = v[7];
  S.hint_high[row] = v[8];
  S.n_entries[row] = v[9];
  return at;
}

// Phase 3 for entry x = q * E + e of the block's slots: copy entry e of the
// chosen candidate (zeros for an empty slot) into this shard's inbox.
RT_DEV void scatter_entry(const RouteScatterParams& S, const long long* cols, int d0, int x) {
  const int E = S.E, K = S.K;
  const int q = x / E, e = x - q * E;
  const long long at = cols[q];
  if (at == RT_NOT_MINE) return;
  const size_t row = (size_t)(d0 + q / K - S.my * S.Gl) * K + q % K;
  const int32_t* col = at >= 0 ? S.gathered + at : nullptr;
  S.entry_terms[row * E + e] = col ? col[(size_t)(11 + e) * S.M] : 0;
  S.entry_cc[row * E + e] = col ? col[(size_t)(11 + E + e) * S.M] != 0 : 0;
}

// destination lanes per scatter block: small ranges spread the scatter
// over many SMs; every block scans all dest words, RT_SCAN_UNROLL loads in
// flight per thread
#define RT_LANES_PER_BLOCK 64
#define RT_SCAN_UNROLL 4

#ifdef __CUDACC__
__global__ void __launch_bounds__(256) route_columns_kernel(const RouteColumnsParams S) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < S.M) route_candidate(S, c);
}

__global__ void __launch_bounds__(1024) route_scatter_kernel(const RouteScatterParams S) {
  extern __shared__ long long smem[];
  const int D = RT_LANES_PER_BLOCK, T = blockDim.x, DK = D * S.K;
  long long* cols = smem;              // D*K column offsets
  int* slots = (int*)(smem + DK);      // D*K candidate lists
  const int d0 = blockIdx.x * D;
  for (int q = threadIdx.x; q < DK; q += T) slots[q] = RT_EMPTY;
  __syncthreads();
  const int total = S.n * S.M;
  for (int i0 = threadIdx.x; i0 < total; i0 += RT_SCAN_UNROLL * T) {
    int d[RT_SCAN_UNROLL];
#pragma unroll
    for (int u = 0; u < RT_SCAN_UNROLL; ++u) {
      const int i = i0 + u * T;
      d[u] = i < total ? dest_at(S, i) : -1;
    }
#pragma unroll
    for (int u = 0; u < RT_SCAN_UNROLL; ++u) scatter_insert(S, slots, d0, D, i0 + u * T, d[u]);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < DK; q += T) cols[q] = scatter_write(S, slots, d0, q);
  __syncthreads();
  for (int x = threadIdx.x; x < DK * S.E; x += T) scatter_entry(S, cols, d0, x);
}

extern "C" int route_columns_launch(const RouteColumnsParams* p, void* stream) {
  if (p->M <= 0) return 0;
  const int threads = 256;
  route_columns_kernel<<<(p->M + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int route_scatter_launch(const RouteScatterParams* p, void* stream) {
  const int G = p->n * p->Gl;
  if (G <= 0) return 0;
  const int blocks = (G + RT_LANES_PER_BLOCK - 1) / RT_LANES_PER_BLOCK;
  const size_t shm = (size_t)RT_LANES_PER_BLOCK * p->K * (sizeof(long long) + sizeof(int));
  route_scatter_kernel<<<blocks, 1024, shm, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int route_columns_params_size() { return (int)sizeof(RouteColumnsParams); }
extern "C" int route_scatter_params_size() { return (int)sizeof(RouteScatterParams); }
#endif
