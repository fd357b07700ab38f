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
// Three kernels, launched in stream order:
//   route_columns_kernel — one thread per candidate of a lane block, in the
//     kind-major layout (rep, vote, hb, tn: P per lane; resp: K; rir: R).
//     It writes the candidate's column of the (C, M) i32 slab, C = 11 + 2E
//     (dest, the ten scalar Inbox fields, E entry terms read off the
//     sender's ring, E entry cc flags), and zeroes the candidate's RoutePlan
//     bit. The slab is the exchange format of the sharded path; the
//     unsharded router reads it as a gather of one shard. Entry rows past a
//     candidate's n_entries are zero, as in the reference (e_live).
//   route_index_kernel — the first pass of the scatter: one thread per
//     gathered candidate position reads its dest word once (coalesced) and,
//     if the dest is a lane, inserts the candidate's global index into that
//     lane's K-deep list in a (G, K) i32 scratch in global memory, by
//     cascading atomicMin: each slot keeps the minimum of what reaches it
//     and passes the larger value on, so slot j ends with the (j+1)-th
//     smallest index whatever the arrival order, which is the reference's
//     stable-sort order. A free slot holds RT_EMPTY.
//   route_scatter_kernel — the second pass: RT_SLOT_THREADS threads per
//     (lane, slot) read the slot's candidate, set its RoutePlan bit if it is
//     this shard's, write the ten scalar Inbox fields of the slot if the
//     lane is this shard's (MSG.NONE and zeros for an empty slot), copy the
//     first clip(n_entries, 0, E) entry terms and cc flags and write zeros
//     past them without reading them, and put RT_EMPTY back in the slot, so
//     the scratch is ready for the next insert with no launch to clear it.
//   Every shard replays the insert over every shard's candidates, as the
//   reference does, so all agree on arrival order; a shard writes only its
//   own inbox rows and its own candidates' plan bits. Global candidate
//   index <-> (kind, source shard, local offset) is arithmetic; the spliced
//   global layout is never materialised.
//
// Bound: bytes. The columns kernel writes the whole slab (dominated by the
// 2E entry rows, most of them zero). The scatter must read the dest row of
// every shard's slab once plus the columns of the accepted candidates, and
// write the inbox: 0.00207 ms at config 6's shape (3072 lanes, 73,728
// candidates, ~4,096 accepted). The insert pass reads the dest row once,
// coalesced, and issues one to K atomics per addressed candidate; the write
// pass reads 10 + 2 * n_entries words of each accepted column (one sector
// each: a column runs down the slab) and writes the inbox in runs, four
// entry terms and eight cc flags to a store where E is a multiple of 8.
//
// What the scatter cost before (one block of 1024 threads per 64
// destination lanes, every block scanning every dest word of every shard,
// 48 scans of 295 KB at G = 3072, and every entry row of each accepted
// column read): 0.0524 ms per call at config 6's shape, unsharded, on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6); 44-50%
// of a super-step's device time. The two passes: 0.0093 ms per call (insert
// 0.0027, write 0.0065), same card and limit (compare_kernels.py).
//
// JAX semantics kept by hand: i32 adds wrap (done in uint32_t and cast
// back), floor modulo for ring slots, an arithmetic shift of the i32
// ready ctx, bools through the i32 slab as 0/1 read back as != 0.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

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

// Everything the two scatter passes read and write for one shard.
struct RouteScatterParams {
  const int32_t* gathered;  // [n, C, M]: every shard's slab, shard-major
  int32_t* slots;           // [n * Gl, K]: per-lane candidate lists (scratch)
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

// Insert pass, for gathered position i (shard i / M, local offset i % M):
// if its dest word names a lane, insert its global index into that lane's
// K-deep list.
RT_DEV void scatter_insert(const RouteScatterParams& S, int i) {
  const int G = S.n * S.Gl, K = S.K, C = 11 + 2 * S.E;
  const int s = i / S.M, o = i - s * S.M;
  const int d = S.gathered[(size_t)s * C * S.M + o];
  if (d < 0 || d >= G) return;
  int c = global_index(S, s, o);
  int* lane = S.slots + (size_t)d * K;
  for (int j = 0; j < K; ++j) {
    const int old = RT_ATOMIC_MIN(lane + j, c);
    if (old == RT_EMPTY) return;  // c took an empty slot
    if (old > c) c = old;         // c took slot j; carry the displaced one
  }
}

// 16 bytes (4 words) and 8 bytes at an address aligned to them
RT_DEV void rt_store16(int32_t* p, const int32_t* v) {
#ifdef __CUDA_ARCH__
  *(int4*)p = make_int4(v[0], v[1], v[2], v[3]);
#else
  memcpy(p, v, 16);
#endif
}
RT_DEV void rt_store8(uint8_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  *(uint64_t*)p = v;
#else
  memcpy(p, &v, 8);
#endif
}

// Field r (Inbox order, 0..9) of inbox row `row`.
RT_DEV void put_field(const RouteScatterParams& S, int r, size_t row, int32_t v) {
  switch (r) {
    case 0: S.mtype[row] = v; break;
    case 1: S.from_slot[row] = v; break;
    case 2: S.term[row] = v; break;
    case 3: S.log_index[row] = v; break;
    case 4: S.log_term[row] = v; break;
    case 5: S.commit[row] = v; break;
    case 6: S.reject[row] = v != 0; break;
    case 7: S.hint[row] = v; break;
    case 8: S.hint_high[row] = v; break;
    default: S.n_entries[row] = v; break;
  }
}

// Write pass, thread t of the ts threads of (lane q / K, slot q % K), whose
// list holds candidate c (RT_EMPTY for none): thread 0 sets the plan bit of
// a candidate of this shard; on this shard's lanes, thread t writes scalar
// fields t, t + ts, ... and entries t, t + ts, ... of the slot.
RT_DEV void scatter_write(const RouteScatterParams& S, int c, int q, int t, int ts) {
  const int K = S.K, E = S.E, C = 11 + 2 * E, Gl = S.Gl, G = S.n * Gl;
  const int d = q / K, j = q - d * K;
  const size_t M = (size_t)S.M;
  const int32_t* col = nullptr;
  if (c != RT_EMPTY) {
    int g, slot;
    const int k = split_index(c, G, S.P, S.K, S.R, &g, &slot);
    const int s = g / Gl, gl = g - s * Gl;
    const int at = gl * seg_of(k, S.P, S.K, S.R) + slot;
    col = S.gathered + (size_t)s * C * M + kind_base(k, Gl, S.P, S.K, S.R) + at;
    if (t == 0 && s == S.my)
      plan_plane(S.plan_rep, S.plan_vote, S.plan_hb, S.plan_tn, S.plan_resp,
                 S.plan_rir, k)[at] = 1;
  }
  if (d / Gl != S.my) return;
  const size_t row = (size_t)(d - S.my * Gl) * K + j;
  for (int r = t; r < 10; r += ts)
    put_field(S, r, row, col ? col[(1 + r) * M] : (r == 0 ? RT_NONE : 0));
  // entries past n_entries are zero in the slab: write them unread. Four
  // terms and eight cc flags to a store where the slot's rows are aligned
  // to them (E a multiple of 8), else one to a store.
  const int live = col ? rt_clip(col[10 * M], 0, E) : 0;
  int32_t* terms = S.entry_terms + row * E;
  uint8_t* cc = S.entry_cc + row * E;
  if ((E & 7) == 0 && (((uintptr_t)terms | (uintptr_t)cc) & 15) == 0) {
    for (int e = 4 * t; e < E; e += 4 * ts) {
      int32_t v[4];
      for (int k = 0; k < 4; ++k) v[k] = e + k < live ? col[(11 + e + k) * M] : 0;
      rt_store16(terms + e, v);
    }
    for (int e = 8 * t; e < E; e += 8 * ts) {
      uint64_t v = 0;
      for (int k = 0; k < 8; ++k)
        if (e + k < live && col[(11 + E + e + k) * M] != 0) v |= (uint64_t)1 << (8 * k);
      rt_store8(cc + e, v);
    }
    return;
  }
  for (int e = t; e < E; e += ts) {
    const bool on = e < live;
    terms[e] = on ? col[(11 + e) * M] : 0;
    cc[e] = on ? col[(11 + E + e) * M] != 0 : 0;
  }
}

// Threads per (lane, slot) in the write pass: a warp covers 4 slots; a
// group writes a slot's 10 fields, then its entry rows 128 bytes of terms
// and 64 bytes of cc flags at a time.
#define RT_SLOT_THREADS 8

#ifdef __CUDACC__
__global__ void __launch_bounds__(256) route_columns_kernel(const RouteColumnsParams S) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < S.M) route_candidate(S, c);
}

__global__ void __launch_bounds__(256) route_index_kernel(const RouteScatterParams S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < S.n * S.M) scatter_insert(S, i);
}

__global__ void __launch_bounds__(256) route_scatter_kernel(const RouteScatterParams S) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = x / RT_SLOT_THREADS, t = x - q * RT_SLOT_THREADS;
  const int total = S.n * S.Gl * S.K;
  const int c = q < total ? S.slots[q] : RT_EMPTY;
  __syncwarp();  // the slot's threads share a warp: all have read it
  if (q >= total) return;
  if (t == 0) S.slots[q] = RT_EMPTY;
  scatter_write(S, c, q, t, RT_SLOT_THREADS);
}

extern "C" int route_columns_launch(const RouteColumnsParams* p, void* stream) {
  if (p->M <= 0) return 0;
  const int threads = 256;
  route_columns_kernel<<<(p->M + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int route_index_launch(const RouteScatterParams* p, void* stream) {
  const int total = p->n * p->M;
  if (total <= 0) return 0;
  route_index_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int route_scatter_launch(const RouteScatterParams* p, void* stream) {
  const long long threads = (long long)p->n * p->Gl * p->K * RT_SLOT_THREADS;
  if (threads <= 0) return 0;
  route_scatter_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int route_columns_params_size() { return (int)sizeof(RouteColumnsParams); }
extern "C" int route_scatter_params_size() { return (int)sizeof(RouteScatterParams); }
#endif
