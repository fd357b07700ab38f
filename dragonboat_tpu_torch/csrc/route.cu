// route.cu — the on-device router between inner steps of a super-step, by
// hand for Hopper.
//
// Replaces dragonboat_tpu/ops/kernel.py:route_step_output (_route_columns,
// _route_scatter, _split_plan) and, for logical shards, the pack, splice,
// replay and slice of _shard_route. On the TPU these ops live inside the
// super-step's one XLA program; in eager PyTorch they would be a few hundred
// small launches per inner step. The plain PyTorch version is
// dragonboat_tpu_torch/ops/kernel.py:route_step_output_reference; these
// kernels give the same inbox and RoutePlan bit for bit.
//
// The candidate record. The reference packs a lane block's Ml candidates
// into an (11 + 2E, Ml) i32 slab (dest, the ten scalar Inbox fields, E entry
// terms, E entry cc flags) and exchanges that. Its 2E entry rows are zero
// for every kind but Replicate (no_ents_gp / no_cc_gp), for an unwanted
// Replicate and past a Replicate's n_entries (e_live = e < n_entries &
// rep_want), so the port exchanges a record that leaves those words out,
// one flat i32 buffer of L = 11 * Ml + Gl * P * Xe words:
//   header  [11][Ml]: the slab's first 11 rows, unchanged, for every
//           candidate in the kind-major order (rep, vote, hb, tn: P per
//           lane; resp: K; rir: R);
//   entries [Gl * P][Xe], Xe = E + ceil(E / 4): one run per Replicate
//           candidate (its index in the Replicate block, gl * P + j): E
//           entry terms, then the E cc flags as bytes, four to a word
//           (flag e is bits 8 * (e % 4) of word E + e / 4), each 0 or 1.
//           The words are zero past clip(n_entries, 0, E) and all zero for
//           an unwanted Replicate, as the reference's slab rows are.
// The record is a lossless projection of the slab (ops/kernel.py:
// _pack_record, and _widen_record back); at config 6 (G = 3072, P = 4,
// E = 64) it is 7.18 MB against the slab's 41.0 MB.
//
// Three kernels, launched in stream order:
//   route_columns_kernel — one launch per lane block writes its record and
//     zeroes its RoutePlan bits, in two ranges of blocks. Entry blocks:
//     RT_ENTRY_THREADS threads per Replicate candidate; thread t reads ring
//     words t*4 .. t*4+3 of the sender's run [prev + 1, prev + 1 + n), so
//     neighbouring threads read neighbouring words, each with its own floor
//     modulo, and writes the four terms with one 16-byte store and their
//     cc flags as one packed word; past n, and for an unwanted candidate, it
//     writes zeros without reading the ring. Header blocks: one thread per
//     candidate, each kind on its own range of blocks (no per-thread kind
//     search), the 11 header rows written coalesced.
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
//     lane is this shard's (MSG.NONE and zeros for an empty slot), copy a
//     Replicate's first clip(n_entries, 0, E) entry terms and cc flags from
//     its run, 16 bytes at a time, and write zeros past them without
//     reading them, and put RT_EMPTY back in the slot, so the scratch is
//     ready for the next insert with no launch to clear it.
//   Every shard replays the insert over every shard's candidates, as the
//   reference does, so all agree on arrival order; a shard writes only its
//   own inbox rows and its own candidates' plan bits. Global candidate
//   index <-> (kind, source shard, local offset) is arithmetic; the spliced
//   global layout is never materialised.
//
// Bound: bytes. The columns kernel must read the StepOutput planes it uses
// (~1.0 MB at config 6) and 5 B per live ring entry, and write the record
// and the plan bits: ~0.0026 ms at config 6's shape over 3.35 TB/s. Before
// the record it wrote the whole slab, one thread per candidate writing its
// 139-word column (mostly zeros), each Replicate reading its ring run a
// word at a time: 0.0293 ms at config 6 on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py, PERF.md section 6), against 0.01267 ms for the
// slab's bytes. The scatter must read the dest row of every shard's record
// once, the 10 header words and the live entry words of each accepted
// candidate, and write the inbox: ~0.002 ms at config 6's shape. Its write
// pass was 0.0063-0.0065 ms per call on the slab (same card and limit).
//
// JAX semantics kept by hand: i32 adds wrap (done in uint32_t and cast
// back), floor modulo for ring slots, an arithmetic shift of the i32
// ready ctx, bools through the i32 record as 0/1 read back as != 0.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RT_DEV __device__ __forceinline__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_DEV static inline
#define RT_HD static inline
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
  int32_t* record;    // [record_words(M, G, P, E)]
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
  const int32_t* gathered;  // [n, L]: every shard's record, shard-major
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

// Words of one Replicate's entry run in the record: E terms, then the E cc
// flags four to a word.
RT_DEV int entry_words(int E) { return E + (E + 3) / 4; }

// Words of the record of a lane block of G lanes and M candidates.
RT_DEV size_t record_words(int M, int G, int P, int E) {
  return (size_t)11 * M + (size_t)G * P * entry_words(E);
}

// Candidates per lane row of kind k (rep, vote, hb, tn, resp, rir).
RT_HD int seg_of(int k, int P, int K, int R) {
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

// 16 bytes (4 words) and 8 bytes at an address aligned to them
RT_DEV void rt_store16(int32_t* p, const int32_t* v) {
#ifdef __CUDA_ARCH__
  *(int4*)p = make_int4(v[0], v[1], v[2], v[3]);
#else
  memcpy(p, v, 16);
#endif
}
RT_DEV void rt_load16(const int32_t* p, int32_t* v) {
#ifdef __CUDA_ARCH__
  const int4 x = *(const int4*)p;
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
#else
  memcpy(v, p, 16);
#endif
}
RT_DEV void rt_store8(uint8_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  *(uint64_t*)p = v;
#else
  memcpy(p, &v, 8);
#endif
}
RT_DEV bool rt_aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Header column of candidate i of kind k (the reference's _route_columns
// for that candidate); `base` is where kind k starts in the block.
RT_DEV void route_header(const RouteColumnsParams& S, int k, int base, int i) {
  const int P = S.P, K = S.K, R = S.R;
  const size_t M = (size_t)S.M;
  const int seg = seg_of(k, P, K, R);
  const int g = i / seg, j = i - g * seg;
  const int self = S.self_slot[g];
  const int term = S.o_term[g];
  // mtype, from, term, log_index, log_term, commit, reject, hint,
  // hint_high, n_entries
  int f[10] = {0, self, 0, 0, 0, 0, 0, 0, 0, 0};
  bool want = false;
  int to = -1;
  if (k < 4) {
    const size_t gp = (size_t)g * P + j;
    const int fl = S.send_flags[gp], rd = S.rdelta[gp];
    to = S.route[gp];
    const bool has = to >= 0;
    f[2] = term;
    if (k == 0) {
      want = (fl & RT_S_REPLICATE) && has;
      f[0] = RT_REPLICATE;
      f[3] = add32(S.send_prev_index[gp], rd);
      f[4] = S.send_prev_term[gp];
      f[5] = rt_max0(add32(S.send_commit[gp], rd));
      f[9] = S.send_n_entries[gp];
    } else if (k == 1) {
      // a PRE_CANDIDATE lane's requests are REQUEST_PREVOTE at term + 1
      want = (fl & RT_S_VOTE_REQ) && has;
      const bool pre = S.o_role[g] == RT_PRE_CANDIDATE;
      f[0] = pre ? RT_REQUEST_PREVOTE : RT_REQUEST_VOTE;
      f[2] = pre ? add32(term, 1) : term;
      f[3] = add32(S.vote_last_index[g], rd);
      f[4] = S.vote_last_term[g];
      f[7] = S.send_hint[gp];
    } else if (k == 2) {
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
  } else if (k == 4) {
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
  int32_t* col = S.record + base + i;
  col[0] = want ? to : -1;
  for (int r = 0; r < 10; ++r) col[(size_t)(1 + r) * M] = f[r];
  plan_plane(S.plan_rep, S.plan_vote, S.plan_hb, S.plan_tn, S.plan_resp, S.plan_rir,
             k)[i] = 0;
}

// Entry run of Replicate candidate r (= g * P + j), thread t of ts: entries
// 4t .. 4t+3, 4(t+ts) .. and so on, their terms and their cc word.
RT_DEV void route_entries(const RouteColumnsParams& S, int r, int t, int ts) {
  const int E = S.E, W = S.W, g = r / S.P;
  const bool want = (S.send_flags[r] & RT_S_REPLICATE) && S.route[r] >= 0;
  const int live = want ? rt_clip(S.send_n_entries[r], 0, E) : 0;
  const int first = add32(S.send_prev_index[r], 1);
  const int32_t* ring = S.log_term + (size_t)g * W;
  const uint8_t* ring_cc = S.log_is_cc + (size_t)g * W;
  int32_t* run = S.record + (size_t)11 * S.M + (size_t)r * entry_words(E);
  for (int e = 4 * t; e < E; e += 4 * ts) {
    int32_t v[4] = {0, 0, 0, 0};
    uint32_t cc = 0;
    for (int k = 0; k < 4; ++k) {
      if (e + k < live) {
        const int w = rt_fmod(add32(first, e + k), W);
        v[k] = ring[w];
        cc |= (uint32_t)(ring_cc[w] != 0) << (8 * k);
      }
    }
    if (e + 4 <= E && rt_aligned16(run + e)) {
      rt_store16(run + e, v);
    } else {
      for (int k = 0; k < 4 && e + k < E; ++k) run[e + k] = v[k];
    }
    run[E + e / 4] = (int32_t)cc;
  }
}

// Threads per Replicate entry run in the columns kernel: at E = 64 each
// writes 4 terms (one 16-byte store) and one cc word.
#define RT_ENTRY_THREADS 16

// Blocks of bt threads in one columns launch: the entry runs first, then
// each kind's header columns on a range of its own.
RT_HD int columns_blocks(const RouteColumnsParams& S, int bt) {
  int blocks = (S.G * S.P * RT_ENTRY_THREADS + bt - 1) / bt;
  for (int k = 0; k < 6; ++k) blocks += (S.G * seg_of(k, S.P, S.K, S.R) + bt - 1) / bt;
  return blocks;
}

// Thread `tid` of block b of a columns launch of bt-thread blocks.
RT_DEV void columns_thread(const RouteColumnsParams& S, int b, int tid, int bt) {
  const int runs = S.G * S.P;
  const int eb = (runs * RT_ENTRY_THREADS + bt - 1) / bt;
  if (b < eb) {
    const int x = b * bt + tid, r = x / RT_ENTRY_THREADS;
    if (r < runs) route_entries(S, r, x - r * RT_ENTRY_THREADS, RT_ENTRY_THREADS);
    return;
  }
  b -= eb;
  int base = 0;
  for (int k = 0; k < 6; ++k) {
    const int n = S.G * seg_of(k, S.P, S.K, S.R), nb = (n + bt - 1) / bt;
    if (b < nb) {
      const int i = b * bt + tid;
      if (i < n) route_header(S, k, base, i);
      return;
    }
    b -= nb;
    base += n;
  }
}

// Global candidate index of the candidate at local offset o of shard s's
// record (the position it has in the unsharded kind-major layout).
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
  const int G = S.n * S.Gl, K = S.K;
  const int s = i / S.M, o = i - s * S.M;
  const int d = S.gathered[s * record_words(S.M, S.Gl, S.P, S.E) + o];
  if (d < 0 || d >= G) return;
  int c = global_index(S, s, o);
  int* lane = S.slots + (size_t)d * K;
  for (int j = 0; j < K; ++j) {
    const int old = RT_ATOMIC_MIN(lane + j, c);
    if (old == RT_EMPTY) return;  // c took an empty slot
    if (old > c) c = old;         // c took slot j; carry the displaced one
  }
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
// fields t, t + ts, ... and entries t, t + ts, ... of the slot (four terms
// and eight cc flags at a time where E is a multiple of 8).
RT_DEV void scatter_write(const RouteScatterParams& S, int c, int q, int t, int ts) {
  const int K = S.K, E = S.E, Gl = S.Gl, G = S.n * Gl;
  const int d = q / K, j = q - d * K;
  const size_t M = (size_t)S.M;
  const int32_t* head = nullptr;  // the candidate's header column
  const int32_t* run = nullptr;   // its entry run, for a Replicate
  if (c != RT_EMPTY) {
    int g, slot;
    const int k = split_index(c, G, S.P, S.K, S.R, &g, &slot);
    const int s = g / Gl, gl = g - s * Gl;
    const int at = gl * seg_of(k, S.P, S.K, S.R) + slot;
    const int32_t* rec = S.gathered + s * record_words(S.M, Gl, S.P, E);
    head = rec + kind_base(k, Gl, S.P, S.K, S.R) + at;
    if (k == 0) run = rec + 11 * M + (size_t)at * entry_words(E);
    if (t == 0 && s == S.my)
      plan_plane(S.plan_rep, S.plan_vote, S.plan_hb, S.plan_tn, S.plan_resp,
                 S.plan_rir, k)[at] = 1;
  }
  if (d / Gl != S.my) return;
  const size_t row = (size_t)(d - S.my * Gl) * K + j;
  for (int r = t; r < 10; r += ts)
    put_field(S, r, row, head ? head[(1 + r) * M] : (r == 0 ? RT_NONE : 0));
  // other kinds carry no entries, and a run is zero past n_entries: write
  // zeros there without reading the record
  const int live = run ? rt_clip(head[10 * M], 0, E) : 0;
  int32_t* terms = S.entry_terms + row * E;
  uint8_t* cc = S.entry_cc + row * E;
  if ((E & 7) == 0 && rt_aligned16(terms) && rt_aligned16(cc)) {
    for (int e = 4 * t; e < E; e += 4 * ts) {
      int32_t v[4] = {0, 0, 0, 0};
      if (e < live) {
        if (rt_aligned16(run + e)) {
          rt_load16(run + e, v);
        } else {
          for (int k = 0; k < 4; ++k) v[k] = run[e + k];
        }
        for (int k = 0; k < 4; ++k)
          if (e + k >= live) v[k] = 0;
      }
      rt_store16(terms + e, v);
    }
    for (int e = 8 * t; e < E; e += 8 * ts) {
      uint64_t v = 0;
      if (e < live) {
        v = (uint32_t)run[E + e / 4] | (uint64_t)(uint32_t)run[E + e / 4 + 1] << 32;
        if (live - e < 8) v &= ((uint64_t)1 << (8 * (live - e))) - 1;
      }
      rt_store8(cc + e, v);
    }
    return;
  }
  for (int e = t; e < E; e += ts) {
    const bool on = e < live;
    terms[e] = on ? run[e] : 0;
    cc[e] = on ? ((uint32_t)run[E + e / 4] >> (8 * (e & 3)) & 0xFF) != 0 : 0;
  }
}

// Threads per (lane, slot) in the write pass: a warp covers 4 slots; a
// group writes a slot's 10 fields, then its entry rows 128 bytes of terms
// and 64 bytes of cc flags at a time.
#define RT_SLOT_THREADS 8

#ifdef __CUDACC__
#define RT_COLS_THREADS 256

__global__ void __launch_bounds__(RT_COLS_THREADS) route_columns_kernel(const RouteColumnsParams S) {
  columns_thread(S, blockIdx.x, threadIdx.x, RT_COLS_THREADS);
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
  route_columns_kernel<<<columns_blocks(*p, RT_COLS_THREADS), RT_COLS_THREADS, 0,
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
