// step_batch.cu — one Raft protocol step for every lane, by hand for Hopper.
//
// Replaces dragonboat_tpu/ops/kernel.py:step_batch (the jitted jnp program
// that XLA fuses on the TPU; in eager PyTorch it would be thousands of tiny
// launches per step). The plain PyTorch version is
// dragonboat_tpu_torch/ops/kernel.py:step_batch_reference; this kernel
// gives the same result bit for bit on every state field and output plane.
//
// What bounds it on this card: memory traffic, and the latency of one
// lane's serial chain. The step reads the inbox and the state once, writes
// the state and the outputs once, and touches only the ring slots it
// appends to or looks up; its byte bound is 0.0274 ms at 50k lanes
// (kernel_bench shape) and under a microsecond at 1024 and 3072 lanes,
// below a launch's own latency. The protocol is branchy scalar work per
// lane, so every lane is one thread, and its time is a chain of dependent
// accesses.
//
// What it cost before (the first version: one thread per lane, 128 per
// block, the lane's P- and R-sized rows in a 656-byte local-memory frame,
// every [G, X] plane read and written at a stride of one row across a
// warp): 0.0510 ms at 1024 lanes, 0.0344 ms at 3072, 0.3161 ms at 50k, on
// an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6).
// This design: 0.0143 ms at 1024 and 3072 lanes, 0.076 ms at 50k, same
// card and limit (compare_kernels.py); 128 registers, no stack frame.
//
// Design:
//   - A block holds STEP_LANES consecutive lanes, one thread each, so the
//     1024 lanes of the main path spread over 32 SMs and the lanes of a
//     block are one warp.
//   - Every per-lane row that the protocol indexes at run time (the 11
//     per-peer state rows, the 4 ReadIndex rows, the per-peer send
//     accumulators, the per-peer and per-slot outputs, the inbox's scalar
//     slot planes) lives in a shared-memory frame laid out
//     [plane][slot][lane-in-block]: a warp touching slot p of its 32 lanes
//     hits 32 consecutive words, and a runtime index costs a shared access
//     instead of a local-memory round trip. The lane reaches its rows only
//     through the Lane accessors below (frame base + slot * STEP_LANES).
//   - The block's lanes occupy one contiguous span of every [G, X] plane.
//     The block copies each span it reads into the frame with asynchronous
//     copies (cp.async, all in flight at once, i32 planes transposed on the
//     way, u8 planes as they lie in 16-byte words), and writes each output
//     and state span back with coalesced stores, an element's words of all
//     planes read out of the frame before any is stored. The inbox's slot
//     rows are reused for the responses once their message has been read.
//     The scalar [G] planes are already coalesced and stay direct.
//   - Helper warps stage and write back beside the lanes' warp: 8 warps
//     while the grid has at most one block per SM, past that as many as
//     leave an SM the resident blocks of one warp per block (2 at 50k lanes
//     of P=8: the frame, not the registers, limits an SM to 8 blocks).
//   - The log ring [G, W] stays in global memory. A leader's appends (its
//     no-op, proposals without a config change) are runs at one term with
//     cc flags 0: they stay pending in the lane's registers (reads of the
//     ring see them through the tail's term) and, after the barrier, the
//     block writes each lane's run with a warp per lane, coalesced. Other
//     ring writes (Replicate, a proposal with a config change) and the
//     config-change scans write the pending run first, in the lane.
//   - The frame is (11P + 7R + 9K + 12) * 4 + (7P + K) bytes per lane:
//     27,648 bytes per block at the widest shape (P=8, R=4, K=8), 16,384 at
//     config 2's (P=4, R=4, K=4).
//   - The per-lane code also compiles as host C++ (DB_DEV), with the frame
//     in a host buffer and the block's threads taking turns:
//     tests/test_torch_kernel_host.py runs it block by block at two block
//     sizes and holds it against step_batch_reference.
//
// What holds it back now (per-phase clock stamps of a scratch build, not
// kept): at 1024-3072 lanes one warp's serial chain through the handlers
// (shared-memory and ring latencies, the messages' branches taken one
// after another across the warp); at 50k lanes the staging and the
// write-back, which move the block's spans while only 8 blocks fit an SM,
// and the ring appends.
//
// Operation-saving rewrites that keep the result equal to the reference:
//   - ring-slot scatters write only indices lo..hi (the reference does an
//     O(W) gather + select per message);
//   - the uncommitted / to-apply config-change scans read the live window
//     only;
//   - the quorum order statistic is a rank selection over <= 8 values with
//     INT_MAX fill;
//   - popcount is __popc of the u32 bit pattern.
// JAX semantics kept by hand: floor modulo, u32 wraparound with logical
// shifts, INT_MIN for an out-of-range gather, all-False out-of-range
// one_hot rows, 1 << n == 0 for n outside [0, 31], clip(x, lo, hi) ==
// min(max(x, lo), hi), and bool planes stored as exactly 0 or 1.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DB_DEV __device__ __forceinline__
#define DB_MEM __device__ __forceinline__
#define DB_HD __host__ __device__ __forceinline__
#else
#define DB_DEV static inline
#define DB_MEM inline
#define DB_HD static inline
#endif

#define PMAX 8
#define RMAX 4
#define DB_INT_MAX 2147483647
#define DB_INT_MIN (-2147483647 - 1)

// Lanes (= threads) per block: one warp, so the 1024 lanes of the main
// path cover 32 of the 132 SMs, and the frame (at most 27,648 bytes)
// leaves room for 8 blocks per SM at the widest shape.
#define STEP_LANES 32
// Warps per block when the grid is no larger than the card's SM count (the
// main path's 1024 and 3072 lanes): staging and write-back are shared by 8
// warps instead of done by the lanes' one.
#define STEP_STAGE_WARPS 8

enum { F_FOLLOWER = 0, F_CANDIDATE = 1, F_LEADER = 2, F_OBSERVER = 3,
       F_WITNESS = 4, F_PRE_CANDIDATE = 5 };
enum { RS_RETRY = 0, RS_WAIT = 1, RS_REPLICATE = 2, RS_SNAPSHOT = 3 };
enum { M_NONE = -1, M_ELECTION = 1, M_NOOP = 4, M_PROPOSE = 7,
       M_SNAPSHOT_STATUS = 8, M_UNREACHABLE = 9, M_REPLICATE = 12,
       M_REPLICATE_RESP = 13, M_REQUEST_VOTE = 14, M_REQUEST_VOTE_RESP = 15,
       M_INSTALL_SNAPSHOT = 16, M_HEARTBEAT = 17, M_HEARTBEAT_RESP = 18,
       M_READ_INDEX = 19, M_READ_INDEX_RESP = 20, M_LEADER_TRANSFER = 23,
       M_TIMEOUT_NOW = 24, M_REQUEST_PREVOTE = 26,
       M_REQUEST_PREVOTE_RESP = 27 };
enum { S_REPLICATE = 1, S_HEARTBEAT = 2, S_VOTE_REQ = 4, S_TIMEOUT_NOW = 8,
       S_NEED_SNAPSHOT = 16 };

// Every tensor of one step, passed by value as the kernel's parameter
// (~940 bytes, under the 4 KB limit). ops/cuda.py fills a ctypes.Structure
// with the same fields in the same order.
struct StepParams {
  // RaftTensors, in the field order of ops/state.py (updated in place)
  uint8_t* active;
  int32_t* self_slot;
  uint8_t* member;
  uint8_t* voting;
  uint8_t* observer;
  uint8_t* witness;
  int32_t* term;
  int32_t* vote;
  int32_t* role;
  int32_t* leader;
  int32_t* tick_count;
  int32_t* election_tick;
  int32_t* heartbeat_tick;
  int32_t* rand_timeout;
  int32_t* election_timeout;
  int32_t* heartbeat_timeout;
  uint8_t* check_quorum;
  uint8_t* prevote_on;
  uint8_t* lease_on;
  int32_t* lease_margin;
  int32_t* lease_until;
  int32_t* hb_round_tick;
  int32_t* hb_ack_bits;
  uint8_t* clock_ok;
  int32_t* first_index;
  int32_t* marker_term;
  int32_t* last_index;
  int32_t* committed;
  int32_t* processed;
  int32_t* applied;
  int32_t* unsaved_from;
  int32_t* log_term;
  uint8_t* log_is_cc;
  int32_t* match;
  int32_t* next;
  int32_t* rstate;
  uint8_t* ract;
  int32_t* snap_sent;
  uint8_t* vresp;
  uint8_t* vgrant;
  int32_t* transfer_to;
  uint8_t* transfer_flag;
  uint8_t* pending_cc;
  uint8_t* quiesce_on;
  int32_t* quiesce_threshold;
  uint8_t* quiesced;
  int32_t* idle_ticks;
  int32_t* ri_ctx;
  int32_t* ri_ctx2;
  int32_t* ri_index;
  int32_t* ri_acks;
  int32_t* ri_count;
  uint32_t* seed;
  // Inbox, then ticks
  const int32_t* in_mtype;
  const int32_t* in_from_slot;
  const int32_t* in_term;
  const int32_t* in_log_index;
  const int32_t* in_log_term;
  const int32_t* in_commit;
  const uint8_t* in_reject;
  const int32_t* in_hint;
  const int32_t* in_hint_high;
  const int32_t* in_n_entries;
  const int32_t* in_entry_terms;
  const uint8_t* in_entry_cc;
  const int32_t* ticks;
  // StepOutput
  int32_t* o_send_flags;
  int32_t* o_send_prev_index;
  int32_t* o_send_prev_term;
  int32_t* o_send_n_entries;
  int32_t* o_send_commit;
  int32_t* o_send_hb_commit;
  int32_t* o_send_hint;
  int32_t* o_send_hint2;
  int32_t* o_vote_last_index;
  int32_t* o_vote_last_term;
  int32_t* o_resp_type;
  int32_t* o_resp_to;
  int32_t* o_resp_term;
  int32_t* o_resp_log_index;
  uint8_t* o_resp_reject;
  int32_t* o_resp_hint;
  int32_t* o_resp_hint2;
  int32_t* o_save_from;
  int32_t* o_save_to;
  int32_t* o_apply_from;
  int32_t* o_apply_to;
  int32_t* o_commit_index;
  uint8_t* o_hard_changed;
  int32_t* o_ready_ctx;
  int32_t* o_ready_ctx2;
  int32_t* o_ready_index;
  int32_t* o_ready_count;
  int32_t* o_dropped_propose;
  uint8_t* o_dropped_cc;
  int32_t* o_fwd_leader;
  int32_t* o_noop_appended;
  int32_t* o_noop_term;
  uint8_t* o_log_full;
  int32_t* o_prop_base;
  int32_t* o_rep_base;
  int32_t* o_leader;
  int32_t* o_term;
  int32_t* o_vote;
  int32_t* o_role;
  int32_t* o_match;
  int32_t* o_rstate;
  int32_t* o_last_index;
  uint8_t* o_quiesced;
  int32_t* o_lease_round;
  int32_t* o_lease_served;
  int32_t* o_lease_fallback;
  uint8_t* o_lease_ok;
  uint32_t* o_counters;
  int32_t G, P, W, K, E, R;
};

// ------------------------------------------------------------- the frame
//
// The block's shared-memory frame: i32 row-planes, then u8 planes.
// Slot x of i32 plane group j of lane l lives at row (base(j) + x), column
// l; a row is one word per lane of the block, so a warp touching one slot
// of its lanes reads 32 consecutive words. A u8 plane keeps the global
// layout, [lane][slot] (a lane's P or K flags side by side), so the block's
// span copies in 16-byte words and a warp's byte reads of one slot fall in
// distinct banks (P = 4) or two lanes to a bank (P = 8).

// i32 planes with P slots per lane
enum { FP_MATCH, FP_NEXT, FP_RSTATE, FP_SNAP_SENT, FP_FLAGS, FP_HINT, FP_HINT2,
       FP_PREV_INDEX, FP_PREV_TERM, FP_N_ENTRIES, FP_COMMIT, FP_COUNT };
// i32 planes with R slots per lane
enum { FR_CTX, FR_CTX2, FR_INDEX, FR_ACKS, FR_READY_CTX, FR_READY_CTX2,
       FR_READY_INDEX, FR_COUNT };
// i32 planes with K slots per lane: inbox slot k's fields until the lane
// has read that message, then the response it produced
enum { FK_MTYPE, FK_FROM, FK_TERM, FK_LOG_INDEX, FK_LOG_TERM, FK_COMMIT,
       FK_HINT, FK_HINT_HIGH, FK_N_ENTRIES, FK_COUNT };
enum { FK_RESP_TYPE = FK_MTYPE, FK_RESP_TO = FK_FROM, FK_RESP_TERM = FK_TERM,
       FK_RESP_LOG_INDEX = FK_LOG_INDEX, FK_RESP_HINT = FK_LOG_TERM,
       FK_RESP_HINT2 = FK_COMMIT, FK_PROP_BASE = FK_HINT,
       FK_REP_BASE = FK_HINT_HIGH };
#define F_COUNTERS 8
// i32 planes with one slot per lane, after the counters: the lane's
// pending appends at the end of its step (first ring slot, count, term)
// and its commit index
enum { FL_PD_W0, FL_PD_N, FL_PD_TERM, FL_COMMITTED, FL_COUNT };
// u8 planes with P slots per lane, then the K-slot reject plane (bl * P
// and bl * K bytes)
enum { FB_MEMBER, FB_VOTING, FB_OBSERVER, FB_RACT, FB_VRESP, FB_VGRANT,
       FB_PROBE, FB_COUNT };

DB_HD int frame_rows_i32(int P, int K, int R) {
  return FP_COUNT * P + FR_COUNT * R + FK_COUNT * K + F_COUNTERS + FL_COUNT;
}
DB_HD int frame_rows_u8(int P, int K) { return FB_COUNT * P + K; }

// Bytes of a frame of `bl` lanes (the u8 part rounded up to 16 bytes).
DB_HD size_t frame_bytes(int P, int K, int R, int bl) {
  const size_t u8 = (size_t)frame_rows_u8(P, K) * bl;
  return (size_t)frame_rows_i32(P, K, R) * bl * 4 + ((u8 + 15) & ~(size_t)15);
}

#ifdef __CUDACC__
// The block's frame, in dynamic shared memory sized at launch. The lanes
// reach it through this symbol, so every access is a shared-memory access
// with a 32-bit offset.
extern __shared__ int4 db_frame[];
#endif

// One block's frame: lanes g0 .. g0 + nl - 1, rows of bl lanes.
struct Frame {
  int32_t* I;  // i32 rows
  uint8_t* B;  // u8 planes
  int bl, nl, g0, P, K, R;
  DB_MEM int rp(int j) const { return j * P; }
  DB_MEM int rr(int j) const { return FP_COUNT * P + j * R; }
  DB_MEM int rk(int j) const { return FP_COUNT * P + FR_COUNT * R + j * K; }
  DB_MEM int rc() const { return FP_COUNT * P + FR_COUNT * R + FK_COUNT * K; }
  DB_MEM int rl(int j) const { return rc() + F_COUNTERS + j; }
  DB_MEM uint8_t* bp(int j) const { return B + j * bl * P; }  // u8 plane j
  DB_MEM uint8_t* bk() const { return B + FB_COUNT * bl * P; }  // reject
};

DB_DEV Frame frame_of(const StepParams& S, void* mem, int bl, int g0) {
  Frame F;
  F.I = (int32_t*)mem;
  F.B = (uint8_t*)(F.I + frame_rows_i32(S.P, S.K, S.R) * bl);
  F.bl = bl;
  F.g0 = g0;
  F.nl = S.G - g0 < bl ? S.G - g0 : bl;
  F.P = S.P;
  F.K = S.K;
  F.R = S.R;
  return F;
}

// ------------------------------------------------------------ staging

struct Word4 {
  int32_t v[4];
};

// 16 bytes at a 16-byte aligned address, and back
DB_DEV Word4 load16(const int32_t* p) {
  Word4 w;
#ifdef __CUDA_ARCH__
  const int4 q = *(const int4*)p;
  w.v[0] = q.x; w.v[1] = q.y; w.v[2] = q.z; w.v[3] = q.w;
#else
  memcpy(w.v, p, 16);
#endif
  return w;
}

DB_DEV void store16(int32_t* p, const Word4& w) {
#ifdef __CUDA_ARCH__
  *(int4*)p = make_int4(w.v[0], w.v[1], w.v[2], w.v[3]);
#else
  memcpy(p, w.v, 16);
#endif
}

// 4 bytes at a 4-byte aligned address of a u8 plane
DB_DEV void store4(uint8_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  *(uint32_t*)p = v;
#else
  memcpy(p, &v, 4);
#endif
}

//
// The block's threads copy every span the lanes read into the frame with
// asynchronous copies (cp.async), all in flight at once, and write every
// state and output span back with coalesced stores; the lanes then touch
// only the frame, their scalars and their ring rows.

// Asynchronous global -> shared copies of 4 and 16 bytes on the card;
// plain copies in the host build.
DB_DEV void copy4_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  memcpy(dst, src, 4);
#endif
}

DB_DEV void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

DB_DEV void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// The elements i = start, start + step, ... of a block's span of a [G, X]
// plane, with i's lane l = i / X and slot x = i % X kept by increments (no
// division per element).
struct SpanWalk {
  int i, l, x, dl, dx, X;
  DB_MEM SpanWalk(int start, int step, int X_) : i(start), X(X_) {
    l = start / X;
    x = start - l * X;
    dl = step / X;
    dx = step - dl * X;
  }
  DB_MEM void next(int step) {
    i += step;
    l += dl;
    x += dx;
    if (x >= X) {
      x -= X;
      ++l;
    }
  }
};

// The block's spans of NP [G, X] i32 planes src[j] into frame rows
// [rows[j], rows[j] + X), transposed on the way; thread `tid` of `nt`
// takes every nt-th element, so neighbouring threads read neighbouring
// words. An element's (lane, slot) is found once for all NP planes.
template <int NP>
DB_DEV void stage_in_i32(const Frame& F, const int (&rows)[NP], const int32_t* const (&src)[NP],
                         int X, int tid, int nt) {
  const size_t base = (size_t)F.g0 * X;
  const int n = F.nl * X;
  for (SpanWalk w(tid, nt, X); w.i < n; w.next(nt)) {
    const int at = w.x * F.bl + w.l;
#pragma unroll
    for (int j = 0; j < NP; ++j) copy4_async(F.I + rows[j] * F.bl + at, src[j] + base + w.i);
  }
}

// Frame rows [rows[j], rows[j] + X) back to the block's spans of dst[j]:
// an element's words of all NP planes are read out of the frame before
// any is stored, so the reads are in flight together.
template <int NP>
DB_DEV void stage_out_i32(const Frame& F, const int (&rows)[NP], int32_t* const (&dst)[NP],
                          int X, int tid, int nt) {
  const size_t base = (size_t)F.g0 * X;
  const int n = F.nl * X;
  for (SpanWalk w(tid, nt, X); w.i < n; w.next(nt)) {
    const int at = w.x * F.bl + w.l;
    int32_t v[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) v[j] = F.I[rows[j] * F.bl + at];
#pragma unroll
    for (int j = 0; j < NP; ++j) dst[j][base + w.i] = v[j];
  }
}

// The block's span of a [G, X] u8 plane into its frame plane, as is: in
// 16-byte words where both ends are aligned, the rest byte by byte.
DB_DEV void stage_in_u8(uint8_t* dst, const uint8_t* src, const Frame& F, int X, int tid,
                        int nt) {
  src += (size_t)F.g0 * X;
  const int n = F.nl * X;
  int i0 = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    i0 = n & ~15;
    for (int i = 16 * tid; i < i0; i += 16 * nt) copy16_async(dst + i, src + i);
  }
  for (int i = i0 + tid; i < n; i += nt) dst[i] = src[i];
}

DB_DEV void stage_out_u8(uint8_t* dst, const uint8_t* src, const Frame& F, int X, int tid,
                         int nt) {
  dst += (size_t)F.g0 * X;
  const int n = F.nl * X;
  int i0 = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    i0 = n & ~15;
    for (int i = 16 * tid; i < i0; i += 16 * nt) store16((int32_t*)(dst + i), load16((const int32_t*)(src + i)));
  }
  for (int i = i0 + tid; i < n; i += nt) dst[i] = src[i];
}

// Everything the block's lanes read from [G, X] planes, into the frame.
// On the card the copies are still in flight when this returns:
// copy_async_wait() and a barrier come before the lanes read the frame.
DB_DEV void stage_in(const StepParams& S, const Frame& F, int tid, int nt) {
  const int P = S.P, R = S.R, K = S.K;
  {
    const int rows[] = {F.rp(FP_MATCH), F.rp(FP_NEXT), F.rp(FP_RSTATE), F.rp(FP_SNAP_SENT)};
    const int32_t* const src[] = {S.match, S.next, S.rstate, S.snap_sent};
    stage_in_i32(F, rows, src, P, tid, nt);
  }
  {
    const int rows[] = {F.rr(FR_CTX), F.rr(FR_CTX2), F.rr(FR_INDEX), F.rr(FR_ACKS)};
    const int32_t* const src[] = {S.ri_ctx, S.ri_ctx2, S.ri_index, S.ri_acks};
    stage_in_i32(F, rows, src, R, tid, nt);
  }
  {
    const int rows[] = {F.rk(FK_MTYPE), F.rk(FK_FROM), F.rk(FK_TERM), F.rk(FK_LOG_INDEX),
                        F.rk(FK_LOG_TERM), F.rk(FK_COMMIT), F.rk(FK_HINT), F.rk(FK_HINT_HIGH),
                        F.rk(FK_N_ENTRIES)};
    const int32_t* const src[] = {S.in_mtype, S.in_from_slot, S.in_term, S.in_log_index,
                                  S.in_log_term, S.in_commit, S.in_hint, S.in_hint_high,
                                  S.in_n_entries};
    stage_in_i32(F, rows, src, K, tid, nt);
  }
  stage_in_u8(F.bp(FB_MEMBER), S.member, F, P, tid, nt);
  stage_in_u8(F.bp(FB_VOTING), S.voting, F, P, tid, nt);
  stage_in_u8(F.bp(FB_OBSERVER), S.observer, F, P, tid, nt);
  stage_in_u8(F.bp(FB_RACT), S.ract, F, P, tid, nt);
  stage_in_u8(F.bp(FB_VRESP), S.vresp, F, P, tid, nt);
  stage_in_u8(F.bp(FB_VGRANT), S.vgrant, F, P, tid, nt);
  stage_in_u8(F.bk(), S.in_reject, F, K, tid, nt);
}

// Every [G, X] state row and output plane, from the frame.
DB_DEV void stage_out(const StepParams& S, const Frame& F, int tid, int nt) {
  const int P = S.P, R = S.R, K = S.K;
  {
    const int rows[] = {F.rp(FP_MATCH), F.rp(FP_MATCH), F.rp(FP_NEXT), F.rp(FP_RSTATE),
                        F.rp(FP_RSTATE), F.rp(FP_SNAP_SENT), F.rp(FP_FLAGS), F.rp(FP_HINT),
                        F.rp(FP_HINT2), F.rp(FP_PREV_INDEX), F.rp(FP_PREV_TERM),
                        F.rp(FP_N_ENTRIES), F.rp(FP_COMMIT)};
    int32_t* const dst[] = {S.match, S.o_match, S.next, S.rstate, S.o_rstate, S.snap_sent,
                            S.o_send_flags, S.o_send_hint, S.o_send_hint2, S.o_send_prev_index,
                            S.o_send_prev_term, S.o_send_n_entries, S.o_send_commit};
    stage_out_i32(F, rows, dst, P, tid, nt);
  }
  {
    // the heartbeat commit, min(match, commit index), per peer
    int32_t* dst = S.o_send_hb_commit + (size_t)F.g0 * P;
    const int n = F.nl * P;
    for (SpanWalk w(tid, nt, P); w.i < n; w.next(nt)) {
      const int m = F.I[(F.rp(FP_MATCH) + w.x) * F.bl + w.l];
      const int c = F.I[F.rl(FL_COMMITTED) * F.bl + w.l];
      dst[w.i] = m < c ? m : c;
    }
  }
  {
    const int rows[] = {F.rr(FR_CTX), F.rr(FR_CTX2), F.rr(FR_INDEX), F.rr(FR_ACKS),
                        F.rr(FR_READY_CTX), F.rr(FR_READY_CTX2), F.rr(FR_READY_INDEX)};
    int32_t* const dst[] = {S.ri_ctx, S.ri_ctx2, S.ri_index, S.ri_acks, S.o_ready_ctx,
                            S.o_ready_ctx2, S.o_ready_index};
    stage_out_i32(F, rows, dst, R, tid, nt);
  }
  {
    const int rows[] = {F.rk(FK_RESP_TYPE), F.rk(FK_RESP_TO), F.rk(FK_RESP_TERM),
                        F.rk(FK_RESP_LOG_INDEX), F.rk(FK_RESP_HINT), F.rk(FK_RESP_HINT2),
                        F.rk(FK_PROP_BASE), F.rk(FK_REP_BASE)};
    int32_t* const dst[] = {S.o_resp_type, S.o_resp_to, S.o_resp_term, S.o_resp_log_index,
                            S.o_resp_hint, S.o_resp_hint2, S.o_prop_base, S.o_rep_base};
    stage_out_i32(F, rows, dst, K, tid, nt);
  }
  {
    const int rows[] = {F.rc()};
    int32_t* const dst[] = {(int32_t*)S.o_counters};
    stage_out_i32(F, rows, dst, F_COUNTERS, tid, nt);
  }
  stage_out_u8(S.ract, F.bp(FB_RACT), F, P, tid, nt);
  stage_out_u8(S.vresp, F.bp(FB_VRESP), F, P, tid, nt);
  stage_out_u8(S.vgrant, F.bp(FB_VGRANT), F, P, tid, nt);
  stage_out_u8(S.o_resp_reject, F.bk(), F, K, tid, nt);
}

// ------------------------------------------------------------ the lane

DB_DEV int fmod_i(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}
DB_DEV int imax(int a, int b) { return a > b ? a : b; }
// the ring slot after slot w
DB_DEV int ring_next(int w, int W) { return w + 1 == W ? 0 : w + 1; }
DB_DEV int imin(int a, int b) { return a < b ? a : b; }
DB_DEV int clip(int x, int lo, int hi) { return imin(imax(x, lo), hi); }
DB_DEV int shl1(int n) { return (n >= 0 && n < 32) ? (int)(1u << n) : 0; }
DB_DEV int popc32(int x) {
#ifdef __CUDA_ARCH__
  return __popc((unsigned)x);
#else
  return __builtin_popcount((unsigned)x);
#endif
}

DB_DEV uint32_t mix32(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t x = (a * 2654435761u) ^ (b * 40503u) ^ (c * 2246822519u);
  x ^= x >> 15;
  x *= 2246822519u;
  x ^= x >> 13;
  return x;
}

DB_DEV int rand_timeout(uint32_t seed, int term, int slot, int et) {
  uint32_t x = mix32(seed, (uint32_t)term, (uint32_t)slot);
  uint32_t etu = (uint32_t)et;
  uint32_t r = etu ? x % etu : 0u;  // XLA: a u32 remainder by 0 is 0
  return (int)((uint32_t)et + r);
}

// One lane's state, held by its thread for the whole step: the scalars in
// registers, every per-slot row in the block's frame (column `l`).
struct Lane {
  int P, R, W, E, K;
  int l;              // the lane's column of the frame
  int rr0, rk0, rc0, rl0;  // first row of the R-, K-slot, counter and lane planes
#ifdef __CUDA_ARCH__
  int b0;  // byte offset of the frame's u8 planes
#else
  int32_t* I;  // the frame's i32 rows
  uint8_t* B;  // its u8 planes
  int bl;      // lanes per row
#endif
  int* ring;         // log_term row of the lane (global memory)
  uint8_t* ring_cc;  // log_is_cc row
  bool active, check_quorum, prevote_on, lease_on, clock_ok, transfer_flag,
      pending_cc, quiesce_on, quiesced;
  int self_slot, term, vote, role, leader, tick_count, election_tick,
      heartbeat_tick, rand_timeout, election_timeout, heartbeat_timeout,
      lease_margin, lease_until, hb_round_tick, hb_ack_bits, first_index,
      marker_term, last_index, committed, processed, applied, unsaved_from,
      transfer_to, quiesce_threshold, idle_ticks, ri_count;
  uint32_t seed;
  // The tail: every index in [tl_lo, last_index] has term tl_term (empty
  // when tl_lo > last_index). The pending appends: indexes [pd_lo,
  // last_index] of the tail, cc flags 0, not yet in the ring row (none
  // when pd_lo > last_index); flush() writes them.
  int tl_lo, tl_term, pd_lo;

  // the lane's word of i32 row `row`, and byte `at` of the u8 planes
#ifdef __CUDA_ARCH__
  DB_MEM int& cell(int row) const { return ((int32_t*)db_frame)[row * STEP_LANES + l]; }
  DB_MEM uint8_t& byte(int at) const { return ((uint8_t*)db_frame)[b0 + at]; }
  DB_MEM int lanes() const { return STEP_LANES; }
#else
  DB_MEM int& cell(int row) const { return I[row * bl + l]; }
  DB_MEM uint8_t& byte(int at) const { return B[at]; }
  DB_MEM int lanes() const { return bl; }
#endif
  DB_MEM int& pi(int j, int p) const { return cell(j * P + p); }
  DB_MEM int& ri(int j, int r) const { return cell(rr0 + j * R + r); }
  DB_MEM int& ki(int j, int k) const { return cell(rk0 + j * K + k); }
  DB_MEM uint8_t& pb(int j, int p) const { return byte((j * lanes() + l) * P + p); }
  DB_MEM uint8_t& reject(int k) const { return byte(FB_COUNT * lanes() * P + l * K + k); }
  DB_MEM int& counter(int c) const { return cell(rc0 + c); }
  DB_MEM int& lane_row(int j) const { return cell(rl0 + j); }

  // per-peer state rows
  DB_MEM uint8_t& member(int p) const { return pb(FB_MEMBER, p); }
  DB_MEM uint8_t& voting(int p) const { return pb(FB_VOTING, p); }
  DB_MEM uint8_t& observer(int p) const { return pb(FB_OBSERVER, p); }
  DB_MEM uint8_t& ract(int p) const { return pb(FB_RACT, p); }
  DB_MEM uint8_t& vresp(int p) const { return pb(FB_VRESP, p); }
  DB_MEM uint8_t& vgrant(int p) const { return pb(FB_VGRANT, p); }
  DB_MEM int& match(int p) const { return pi(FP_MATCH, p); }
  DB_MEM int& next(int p) const { return pi(FP_NEXT, p); }
  DB_MEM int& rstate(int p) const { return pi(FP_RSTATE, p); }
  DB_MEM int& snap_sent(int p) const { return pi(FP_SNAP_SENT, p); }
  // ReadIndex queue rows
  DB_MEM int& ri_ctx(int r) const { return ri(FR_CTX, r); }
  DB_MEM int& ri_ctx2(int r) const { return ri(FR_CTX2, r); }
  DB_MEM int& ri_index(int r) const { return ri(FR_INDEX, r); }
  DB_MEM int& ri_acks(int r) const { return ri(FR_ACKS, r); }
  // per-peer send accumulators (the reference's `out` planes)
  DB_MEM int& send_flags(int p) const { return pi(FP_FLAGS, p); }
  DB_MEM int& send_hint(int p) const { return pi(FP_HINT, p); }
  DB_MEM int& send_hint2(int p) const { return pi(FP_HINT2, p); }
  DB_MEM uint8_t& force_probe(int p) const { return pb(FB_PROBE, p); }
};

// Per-step scalar accumulators of the output planes.
struct Acc {
  int noop_appended, noop_term, dropped_propose, lease_served,
      lease_fallback, fwd_leader;
  bool dropped_cc, log_full;
  int ctr_started, ctr_won, ctr_hb, ctr_rejects;
};

// One inbox slot of the lane.
struct Msg {
  int mtype, from, term, log_index, log_term, commit, hint, hint_high, nent;
  bool reject;
  const int32_t* eterms;  // E entry terms (global memory)
  const uint8_t* ecc;     // E entry cc flags
};

DB_DEV bool is_self(const Lane& L, int p) { return p == L.self_slot; }

DB_DEV int num_voting(const Lane& L) {
  int n = 0;
  for (int p = 0; p < L.P; ++p) n += L.voting(p);
  return n;
}
DB_DEV int quorum(const Lane& L) { return num_voting(L) / 2 + 1; }

// ring slot w's term as the row would hold it with the pending appends
// written: tl_term where a pending index maps to w
DB_DEV int ring_term(const Lane& L, int w) {
  if (L.pd_lo <= L.last_index) {
    const int n = L.last_index - L.pd_lo + 1;
    int d = w - fmod_i(L.pd_lo, L.W);
    if (d < 0) d += L.W;
    if (n >= L.W || d < n) return L.tl_term;
  }
  return L.ring[w];
}

// term of entry idx: the tail's term, ring lookup, marker, or 0 out of the
// window
DB_DEV int term_at(const Lane& L, int idx) {
  if (idx >= L.first_index && idx <= L.last_index && idx >= 1)
    return idx >= L.tl_lo ? L.tl_term : ring_term(L, fmod_i(idx, L.W));
  return idx == L.first_index - 1 ? L.marker_term : 0;
}

// 8 bytes at an 8-byte aligned address
DB_DEV uint64_t load8(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *(const uint64_t*)p;
#else
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
#endif
}

// any nonzero byte in p[0, n): the bytes up to an 8-byte boundary, 8-byte
// words, then the tail, OR-ed together with no early exit, so the loads
// are independent and in flight together
DB_DEV bool any_byte(const uint8_t* p, int n) {
  uint64_t acc = 0;
  int k = 0;
#pragma unroll 4
  for (; k < n && ((uintptr_t)(p + k) & 7); ++k) acc |= p[k];
#pragma unroll 4
  for (; k + 8 <= n; k += 8) acc |= load8(p + k);
#pragma unroll 4
  for (; k < n; ++k) acc |= p[k];
  return acc != 0;
}

// any config-change entry at indexes lo..hi (at most W of them): one run
// of the ring row, or two where it wraps
DB_DEV bool any_cc(const Lane& L, int lo, int hi) {
  if (lo > hi) return false;
  const int a = fmod_i(lo, L.W), n = hi - lo + 1;
  const int first = imin(n, L.W - a);
  return any_byte(L.ring_cc + a, first) || any_byte(L.ring_cc, n - first);
}

// ---- runs of ring slots ----
// Entry k of a run that starts at ring slot w0 goes to slot (w0 + k) mod W:
// a run of at most W entries is one or two contiguous pieces of the lane's
// row. The pieces are written in 16-byte (terms) and 8-byte (cc flags)
// words between a scalar head and tail, so an append is a few wide stores
// instead of one narrow store per entry.

DB_DEV void store8(uint8_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  *(uint64_t*)p = v;
#else
  memcpy(p, &v, 8);
#endif
}

// t into words p[0, n)
DB_DEV void fill_words(int32_t* p, int n, int32_t t) {
  int k = 0;
  for (; k < n && ((uintptr_t)(p + k) & 15); ++k) p[k] = t;
  const Word4 w = {{t, t, t, t}};
  for (; k + 4 <= n; k += 4) store16(p + k, w);
  for (; k < n; ++k) p[k] = t;
}

// zero bytes p[0, n)
DB_DEV void zero_bytes(uint8_t* p, int n) {
  int k = 0;
  for (; k < n && ((uintptr_t)(p + k) & 7); ++k) p[k] = 0;
  for (; k + 8 <= n; k += 8) store8(p + k, 0);
  for (; k < n; ++k) p[k] = 0;
}

// Entries e0 .. e0 + n - 1 of a message (entry e read at min(e, E - 1),
// as the reference clamps) into terms t[0, n) and cc flags c[0, n) as 0/1.
DB_DEV void copy_entries(int32_t* t, uint8_t* c, const Msg& m, int e0, int n, int E) {
  int k = 0;
  for (; k < n && ((uintptr_t)(t + k) & 15); ++k) t[k] = m.eterms[imin(e0 + k, E - 1)];
  for (; k + 4 <= n; k += 4) {
    Word4 w;
    for (int j = 0; j < 4; ++j) w.v[j] = m.eterms[imin(e0 + k + j, E - 1)];
    store16(t + k, w);
  }
  for (; k < n; ++k) t[k] = m.eterms[imin(e0 + k, E - 1)];
  k = 0;
  for (; k < n && ((uintptr_t)(c + k) & 3); ++k) c[k] = m.ecc[imin(e0 + k, E - 1)] != 0;
  for (; k + 4 <= n; k += 4) {
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j) v |= (uint32_t)(m.ecc[imin(e0 + k + j, E - 1)] != 0) << (8 * j);
    store4(c + k, v);
  }
  for (; k < n; ++k) c[k] = m.ecc[imin(e0 + k, E - 1)] != 0;
}

// ---- pending appends ----
// A leader's appends (its no-op, proposals without a config change) are
// runs at its term with cc flags 0. They are kept as the range [pd_lo,
// last_index] and written to the ring row once, by flush(), in a few wide
// stores, instead of in narrow pieces per message. Reads of the row go
// through the tail (term_at) or ring_term(), which see the pending range
// as written; every other write of the row, and every scan of its cc
// flags, flushes first, so the row's contents and their order of writing
// are the reference's.

// write the pending appends into the ring row: the last W of them cover
// every slot the range maps to
DB_DEV void flush(Lane& L) {
  if (L.pd_lo > L.last_index) return;
  const int lo = imax(L.pd_lo, L.last_index - L.W + 1);
  const int n = L.last_index - lo + 1, w0 = fmod_i(lo, L.W), n1 = imin(n, L.W - w0);
  fill_words(L.ring + w0, n1, L.tl_term);
  fill_words(L.ring, n - n1, L.tl_term);
  zero_bytes(L.ring_cc + w0, n1);
  zero_bytes(L.ring_cc, n - n1);
  L.pd_lo = DB_INT_MAX;
}

// indexes from lo = last_index + 1 on are about to take the lane's term:
// extend the tail, or start a new one (the pending appends carry the old
// tail's term, so they are written first)
DB_DEV void tail_append(Lane& L, int lo) {
  if (L.tl_lo > L.last_index || L.tl_term != L.term) {
    flush(L);
    L.tl_lo = lo;
    L.tl_term = L.term;
  }
}

// indexes last_index + 1 .. last_index + n (n >= 1) at the lane's term with
// cc flags 0, as pending appends
DB_DEV void append_pending(Lane& L, int n) {
  const int lo = L.last_index + 1;
  tail_append(L, lo);
  if (L.pd_lo > L.last_index) L.pd_lo = lo;
  L.last_index += n;
}

// any config-change entry in (committed, last_index]
DB_DEV bool has_uncommitted_cc(Lane& L) {
  flush(L);
  int lo = imax(imax(L.committed + 1, L.first_index), L.last_index - L.W + 1);
  return any_cc(L, lo, L.last_index);
}

// any config-change entry in (applied, committed]
DB_DEV bool has_cc_to_apply(Lane& L) {
  flush(L);
  int lo = imax(imax(L.applied + 1, L.first_index), L.last_index - L.W + 1);
  return any_cc(L, lo, imin(L.committed, L.last_index));
}

// the shared reset on any role change
DB_DEV void reset(Lane& L, int new_term) {
  if (new_term != L.term) L.vote = 0;
  L.term = new_term;
  L.election_tick = 0;
  L.heartbeat_tick = 0;
  L.rand_timeout = rand_timeout(L.seed, new_term, L.self_slot, L.election_timeout);
  L.transfer_to = 0;
  L.pending_cc = false;
  L.ri_count = 0;
  L.lease_until = 0;
  L.hb_round_tick = 0;
  L.hb_ack_bits = 0;
  for (int r = 0; r < L.R; ++r)
    L.ri_ctx(r) = L.ri_ctx2(r) = L.ri_index(r) = L.ri_acks(r) = 0;
  for (int p = 0; p < L.P; ++p) {
    L.vresp(p) = L.vgrant(p) = 0;
    L.match(p) = is_self(L, p) ? L.last_index : 0;
    L.next(p) = L.last_index + 1;
    L.rstate(p) = 0;
    L.snap_sent(p) = 0;
  }
}

DB_DEV void become_follower(Lane& L, int new_term, int leader) {
  int role = (L.role == F_OBSERVER || L.role == F_WITNESS) ? L.role : F_FOLLOWER;
  reset(L, new_term);
  L.role = role;
  L.leader = leader;
}

DB_DEV void become_leader(Lane& L) {
  bool hcc = has_uncommitted_cc(L);
  reset(L, L.term);
  L.role = F_LEADER;
  L.leader = L.self_slot + 1;
  L.pending_cc = hcc;
  // the no-op entry
  append_pending(L, 1);
  if (L.self_slot >= 0 && L.self_slot < L.P) L.match(L.self_slot) = L.last_index;
}

// start an election (or a pre-vote poll) on this lane if `mask`
DB_DEV void campaign(Lane& L, Acc& A, bool mask, bool transfer_hint,
                     bool force_real) {
  if (!mask) return;
  bool self_voting =
      L.self_slot >= 0 && L.self_slot < L.P && L.voting(L.self_slot);
  bool can = L.active && L.role != F_LEADER && L.role != F_OBSERVER &&
             L.role != F_WITNESS && !has_cc_to_apply(L) && self_voting;
  bool single_now = num_voting(L) == 1;
  bool pre = can && L.prevote_on && !transfer_hint && !single_now && !force_real;
  bool real = can && !pre;
  if (pre) {
    L.role = F_PRE_CANDIDATE;
    L.leader = 0;
    for (int p = 0; p < L.P; ++p) L.vresp(p) = L.vgrant(p) = is_self(L, p);
  }
  bool single = false;
  int noop_at = 0;
  if (real) {
    reset(L, L.term + 1);
    L.role = F_CANDIDATE;
    L.leader = 0;
    L.vote = L.self_slot + 1;
    for (int p = 0; p < L.P; ++p) L.vresp(p) = L.vgrant(p) = is_self(L, p);
    single = num_voting(L) == 1;
    if (single) {
      noop_at = L.last_index + 1;
      become_leader(L);
    }
  }
  A.ctr_started += real;
  A.ctr_won += single;
  bool vote_req = (real && !single) || pre;
  bool hint = real && !single && transfer_hint;
  for (int p = 0; p < L.P; ++p) {
    if (!(L.voting(p) && !is_self(L, p))) continue;
    if (vote_req) L.send_flags(p) |= S_VOTE_REQ;
    if (hint) L.send_hint(p) = L.self_slot + 1;
  }
  A.noop_appended = imax(A.noop_appended, noop_at);
  A.noop_term = imax(A.noop_term, single ? L.term : 0);
}

DB_DEV bool is_leader_msg(int t) {
  return t == M_REPLICATE || t == M_INSTALL_SNAPSHOT || t == M_HEARTBEAT ||
         t == M_TIMEOUT_NOW || t == M_READ_INDEX_RESP;
}

// the response-plane entries one inbox slot produces
struct Resp {
  int type, to, term, log_index, hint, hint2, prop_base, rep_base;
  bool reject;
};

// push a ReadIndex queue entry at position `pos` (a one_hot write: nothing
// is written for a position outside [0, R))
DB_DEV void ri_put(Lane& L, int pos, int ctx, int ctx2, int index, int acks) {
  if (pos < 0 || pos >= L.R) return;
  L.ri_ctx(pos) = ctx;
  L.ri_ctx2(pos) = ctx2;
  L.ri_index(pos) = index;
  L.ri_acks(pos) = acks;
}

DB_DEV bool log_up_to_date(const Lane& L, const Msg& m) {
  int lt = term_at(L, L.last_index);
  return m.log_term > lt || (m.log_term == lt && m.log_index >= L.last_index);
}

// Apply one inbox slot: the term preamble, then the handler for its type.
// Every handler of the reference is masked by one message type, so a
// switch on the type runs exactly the handler whose mask can be true.
DB_DEV void handle_message(Lane& L, Acc& A, const Msg& m, Resp& o) {
  const int P = L.P, W = L.W, E = L.E, R = L.R;
  const int f = m.from;

  // ---- term preamble ----
  bool present = m.mtype != M_NONE;
  bool local = m.term == 0;
  bool higher = present && !local && m.term > L.term;
  bool lower = present && !local && m.term < L.term;
  bool is_pv = m.mtype == M_REQUEST_PREVOTE;
  bool is_pvr = m.mtype == M_REQUEST_PREVOTE_RESP;
  bool drop_rv = higher && (m.mtype == M_REQUEST_VOTE || is_pv) &&
                 L.check_quorum && m.hint != f + 1 && L.leader != 0 &&
                 L.election_tick < L.election_timeout;
  bool step_down = higher && !drop_rv && !is_pv && !(is_pvr && !m.reject);
  if (step_down) become_follower(L, m.term, is_leader_msg(m.mtype) ? f + 1 : 0);
  bool noop_resp = lower && is_leader_msg(m.mtype) && L.check_quorum;
  bool pv_stale = lower && is_pv;
  bool act = present && !(lower || drop_rv);

  const bool is_leader = L.role == F_LEADER;
  const bool is_cand = L.role == F_CANDIDATE;
  const bool is_precand = L.role == F_PRE_CANDIDATE;
  const bool is_obs = L.role == F_OBSERVER;
  const bool is_wit = L.role == F_WITNESS;
  const bool is_fol = L.role == F_FOLLOWER;
  const bool voter_role = is_fol || is_cand || is_precand || is_leader || is_wit;
  const bool follow_role = is_fol || is_obs || is_wit || is_cand || is_precand;

  int resp_type = noop_resp ? M_NOOP : M_NONE;
  if (pv_stale) resp_type = M_REQUEST_PREVOTE_RESP;
  int resp_log_index = 0, resp_hint = 0, resp_hint2 = 0, pv_resp_term = 0;
  bool resp_reject = pv_stale;
  int prop_base = 0, rep_base = 0;
  const bool known_from = f >= 0 && f < P && L.member(f);

  if (act) switch (m.mtype) {
    case M_REQUEST_VOTE:
      if (voter_role) {
        bool grant = (L.vote == 0 || L.vote == f + 1) && log_up_to_date(L, m);
        if (grant) {
          L.vote = f + 1;
          L.election_tick = 0;
        }
        resp_type = M_REQUEST_VOTE_RESP;
        resp_reject = !grant;
      }
      break;

    case M_REQUEST_PREVOTE:
      if (voter_role) {
        bool grant = m.term > L.term && log_up_to_date(L, m);
        resp_type = M_REQUEST_PREVOTE_RESP;
        resp_reject = !grant;
        if (grant) pv_resp_term = m.term;
      }
      break;

    case M_REQUEST_VOTE_RESP:
    case M_REQUEST_PREVOTE_RESP: {
      bool real = m.mtype == M_REQUEST_VOTE_RESP;
      if (!((real ? is_cand : is_precand) && known_from)) break;
      if (!L.vresp(f)) {
        L.vresp(f) = 1;
        L.vgrant(f) = !m.reject;
      }
      int granted = 0, rejected = 0;
      for (int p = 0; p < P; ++p) {
        granted += L.vgrant(p) && L.voting(p);
        rejected += L.vresp(p) && !L.vgrant(p) && L.voting(p);
      }
      int q = quorum(L);
      bool win = granted >= q;
      bool lose = !win && rejected >= q;
      if (real && win) {
        int noop_at = L.last_index + 1;
        become_leader(L);
        A.ctr_won += 1;
        A.noop_appended = imax(A.noop_appended, noop_at);
        A.noop_term = imax(A.noop_term, L.term);
      }
      if (!real) campaign(L, A, win, false, win);
      if (lose) become_follower(L, L.term, 0);
      break;
    }

    case M_ELECTION:
      campaign(L, A, true, false, false);
      break;

    case M_TIMEOUT_NOW:
      campaign(L, A, is_fol, is_fol, false);
      break;

    case M_REPLICATE: {
      if (!follow_role) break;
      if (is_cand || is_precand) become_follower(L, L.term, f + 1);
      L.leader = f + 1;
      L.election_tick = 0;
      int prev = m.log_index, nent = m.nent;
      bool stale = prev < L.committed;
      bool match_prev = term_at(L, prev) == m.log_term;
      bool in_window = prev >= L.first_index - 1 && prev <= L.last_index;
      bool ok = !stale && match_prev && in_window;
      bool rej = !stale && !ok;
      A.ctr_rejects += rej;
      if (ok && E > 0) {
        flush(L);
        // the first entry (e < min(nent, E)) past the log or whose term
        // differs; ring slots are walked by increment, not by modulo
        int first_conf = DB_INT_MAX;
        const int n_chk = imin(nent, E);
        for (int e = 0, w = fmod_i(prev + 1, W); e < n_chk; ++e, w = ring_next(w, W)) {
          int ei = prev + 1 + e;
          if (ei > L.last_index || L.ring[w] != m.eterms[e]) {
            first_conf = ei;
            break;
          }
        }
        if (first_conf != DB_INT_MAX) {
          // the indexes the reference's (G, W) select writes: first_conf ..
          // hi, at most one per ring slot; index i takes entry
          // min(i - (prev + 1), E - 1) of the message
          const int hi = imin(prev + nent, first_conf + (W - 1));
          const int e0 = first_conf - (prev + 1), n = hi - first_conf + 1;
          const int w0 = fmod_i(first_conf, W), n1 = imin(n, W - w0);
          copy_entries(L.ring + w0, L.ring_cc + w0, m, e0, n1, E);
          copy_entries(L.ring, L.ring_cc, m, e0 + n1, n - n1, E);
          L.last_index = prev + nent;
          L.tl_lo = DB_INT_MAX;  // the tail's terms were overwritten
          L.unsaved_from = imin(L.unsaved_from, first_conf);
        }
      }
      int ack_to = prev + nent;
      if (ok) {
        L.committed = clip(imin(ack_to, m.commit), L.committed, L.last_index);
        rep_base = prev + 1;
      }
      resp_type = M_REPLICATE_RESP;
      if (stale) resp_log_index = L.committed;
      else if (ok) resp_log_index = ack_to;
      else if (rej) resp_log_index = prev;
      if (rej) {
        resp_reject = true;
        resp_hint = L.last_index;
      }
      break;
    }

    case M_HEARTBEAT:
      if (!follow_role) break;
      if (is_cand || is_precand) become_follower(L, L.term, f + 1);
      L.leader = f + 1;
      L.election_tick = 0;
      L.committed = clip(m.commit, L.committed, L.last_index);
      resp_type = M_HEARTBEAT_RESP;
      resp_log_index = m.log_index;
      resp_hint = m.hint;
      resp_hint2 = m.hint_high;
      break;

    case M_REPLICATE_RESP: {
      if (!(is_leader && known_from)) break;
      int li = m.log_index;
      int prev_rs = L.rstate(f);
      bool racc = !m.reject;
      bool moved = racc && li > L.match(f);
      L.ract(f) = 1;
      if (racc) {
        L.match(f) = imax(L.match(f), li);
        L.next(f) = imax(L.next(f), li + 1);
      }
      int st = L.rstate(f);
      if (moved && st == RS_WAIT) st = RS_RETRY;
      if (moved && st == RS_RETRY) st = RS_REPLICATE;
      if (moved && st == RS_SNAPSHOT && L.match(f) >= L.snap_sent(f)) st = RS_RETRY;
      L.rstate(f) = st;
      bool in_repl = prev_rs == RS_REPLICATE;
      bool valid_repl = m.reject && in_repl && li > L.match(f);
      bool valid_probe = m.reject && !in_repl && L.next(f) - 1 == li;
      if (valid_repl || valid_probe) {
        L.next(f) = valid_repl ? L.match(f) + 1 : imax(1, imin(li, m.hint + 1));
        L.rstate(f) = RS_RETRY;
      }
      if (racc && L.transfer_to != 0 && f + 1 == L.transfer_to &&
          L.match(f) == L.last_index)
        L.send_flags(f) |= S_TIMEOUT_NOW;
      break;
    }

    case M_HEARTBEAT_RESP: {
      if (!(is_leader && known_from)) break;
      int li = m.log_index;
      L.ract(f) = 1;
      if (L.rstate(f) == RS_WAIT) L.rstate(f) = RS_RETRY;
      if (L.match(f) < L.last_index) L.force_probe(f) = 1;
      int fb = shl1(f);
      for (int r = 0; r < R; ++r)
        if (L.ri_ctx(r) == m.hint && L.ri_ctx2(r) == m.hint_high && L.ri_ctx(r) != 0)
          L.ri_acks(r) |= fb;
      bool tag = L.lease_on && li != 0 && li == L.hb_round_tick && L.voting(f);
      int bits = tag ? (L.hb_ack_bits | fb) : L.hb_ack_bits;
      bool grant = L.lease_on && L.clock_ok && L.hb_round_tick != 0 &&
                   popc32(bits) + 1 >= quorum(L);
      L.hb_ack_bits = bits;
      if (grant)
        L.lease_until = imax(L.lease_until,
                             L.hb_round_tick + L.election_timeout - L.lease_margin);
      break;
    }

    case M_READ_INDEX: {
      if (!is_leader) break;
      bool single = num_voting(L) == 1;
      bool ok_ri = single || term_at(L, L.committed) == L.term;
      bool slot_free = L.ri_count < R;
      bool lease_valid = L.lease_on && L.clock_ok && L.tick_count < L.lease_until &&
                         L.transfer_to == 0;
      bool imm_lease = ok_ri && !single && lease_valid && slot_free;
      bool enq = ok_ri && !single && !lease_valid && slot_free;
      if (enq) {
        ri_put(L, L.ri_count, m.hint, m.hint_high, L.committed, 0);
        L.ri_count += 1;
        for (int p = 0; p < P; ++p) {
          if (!(L.voting(p) && !is_self(L, p))) continue;
          L.send_flags(p) |= S_HEARTBEAT;
          A.ctr_hb += 1;
          L.send_hint(p) = m.hint;
          L.send_hint2(p) = m.hint_high;
        }
      }
      if ((ok_ri && single) || imm_lease) {
        ri_put(L, L.ri_count, m.hint, m.hint_high, L.committed, -1);
        L.ri_count += 1;
      }
      A.lease_served += imm_lease;
      A.lease_fallback += enq && L.lease_on;
      break;
    }

    case M_PROPOSE: {
      int nent = m.nent;
      bool pok = L.role == F_LEADER && L.transfer_to == 0;
      const bool has_cc = any_byte(m.ecc, clip(nent, 0, E));
      bool cc_allowed = pok && has_cc && !L.pending_cc;
      if (pok && has_cc && L.pending_cc) A.dropped_cc = true;
      if (cc_allowed) L.pending_cc = true;
      bool room = L.last_index - L.first_index + 1 + nent <= W;
      bool can_append = pok && room;
      if (can_append) prop_base = L.last_index + 1;
      if (can_append && E > 0) {
        // indexes last_index + 1 .. last_index + min(nent, W) take the
        // term; where a config change is allowed they are written now with
        // the message's cc flags, else they join the pending appends
        const int lo = L.last_index + 1, n = imin(nent, W);
        if (n > 0 && cc_allowed) {
          tail_append(L, lo);
          flush(L);
          const int w0 = fmod_i(lo, W), n1 = imin(n, W - w0);
          fill_words(L.ring + w0, n1, L.term);
          fill_words(L.ring, n - n1, L.term);
          for (int e = 0, w = w0; e < n; ++e, w = ring_next(w, W))
            L.ring_cc[w] = m.ecc[imin(e, E - 1)] != 0;
          L.last_index += nent;
        } else if (n > 0) {
          append_pending(L, nent);
        } else {
          flush(L);  // a negative nent shortens the log past written entries
          L.last_index += nent;
        }
        if (L.self_slot >= 0 && L.self_slot < P) L.match(L.self_slot) = L.last_index;
      }
      if (!can_append) A.dropped_propose += nent;
      if (!pok) A.fwd_leader = L.leader;
      if (pok && !room) A.log_full = true;
      break;
    }

    case M_READ_INDEX_RESP:
      if (!(is_fol || is_obs)) break;
      L.leader = f + 1;
      L.election_tick = 0;
      if (L.ri_count < R) {
        ri_put(L, L.ri_count, m.hint, m.hint_high, m.log_index, -1);
        L.ri_count += 1;
      }
      break;

    case M_LEADER_TRANSFER: {
      if (!is_leader) break;
      int target = m.hint;
      bool lt_ok = L.transfer_to == 0 && target != L.self_slot + 1 && target != 0;
      if (lt_ok) {
        L.transfer_to = target;
        L.election_tick = 0;
      }
      int t = imax(target - 1, 0);
      if (lt_ok && t < P && L.match(t) == L.last_index) L.send_flags(t) |= S_TIMEOUT_NOW;
      break;
    }

    case M_UNREACHABLE:
      if (is_leader && known_from && L.rstate(f) == RS_REPLICATE) L.rstate(f) = RS_RETRY;
      break;

    case M_SNAPSHOT_STATUS:
      if (is_leader && known_from && L.rstate(f) == RS_SNAPSHOT) {
        int old_sent = L.snap_sent(f);
        if (m.reject) L.snap_sent(f) = 0;
        L.next(f) = imax(L.match(f) + 1, old_sent + 1);
        L.rstate(f) = RS_WAIT;
      }
      break;

    default:
      break;
  }

  o.type = (act || noop_resp || pv_stale) ? resp_type : M_NONE;
  o.to = f;
  o.term = pv_resp_term > 0 ? pv_resp_term : L.term;
  o.log_index = resp_log_index;
  o.reject = resp_reject;
  o.hint = resp_hint;
  o.hint2 = resp_hint2;
  o.prop_base = prop_base;
  o.rep_base = rep_base;
}

// advance logical clocks (quiesce freeze first), elections, check-quorum,
// heartbeats and the lease round
DB_DEV void tick_phase(Lane& L, Acc& A, int ticks) {
  const int P = L.P, K = L.K;
  // ---- quiesce ----
  bool activity = false;
  for (int k = 0; k < K; ++k) {
    int t = L.ki(FK_MTYPE, k);
    activity |= t != M_NONE && t != M_HEARTBEAT && t != M_HEARTBEAT_RESP;
  }
  int idle = (activity || !L.quiesce_on) ? 0 : L.idle_ticks + imax(ticks, 0);
  bool entering = L.quiesce_on && L.active && !L.quiesced && idle >= L.quiesce_threshold;
  bool exiting = L.quiesced && activity;
  L.idle_ticks = idle;
  L.quiesced = (L.quiesced || entering) && !activity;
  if (exiting) L.election_tick = 0;

  // ---- tick ----
  bool do_tick = L.active && ticks > 0 && !L.quiesced;
  if (do_tick) {
    L.tick_count += ticks;
    L.election_tick += ticks;
  }
  bool was_leader = L.role == F_LEADER;
  bool can_campaign = do_tick && !was_leader && L.role != F_OBSERVER &&
                      L.role != F_WITNESS && L.election_tick >= L.rand_timeout;
  if (can_campaign) L.election_tick = 0;
  campaign(L, A, can_campaign, false, false);
  bool cq_due = do_tick && was_leader && L.election_tick >= L.election_timeout;
  if (cq_due) {
    L.election_tick = 0;
    L.transfer_to = 0;
    int active_cnt = 0;
    for (int p = 0; p < P; ++p) active_cnt += (L.ract(p) || is_self(L, p)) && L.voting(p);
    bool down = L.check_quorum && active_cnt < quorum(L);
    for (int p = 0; p < P; ++p) L.ract(p) = 0;
    if (down) become_follower(L, L.term, 0);
  }
  bool leader = L.role == F_LEADER;
  if (do_tick && leader) L.heartbeat_tick += ticks;
  bool hb_due = do_tick && leader && L.heartbeat_tick >= L.heartbeat_timeout;
  if (!hb_due) return;
  L.heartbeat_tick = 0;
  if (L.lease_on) {
    L.hb_round_tick = L.tick_count;
    L.hb_ack_bits = 0;
  }
  bool pending = L.ri_count > 0;
  int hint = 0, hint2 = 0;
  if (pending) {
    // take_along_axis at max(ri_count - 1, 0): INT_MIN past the queue end
    int pos = imax(L.ri_count - 1, 0);
    hint = pos < L.R ? L.ri_ctx(pos) : DB_INT_MIN;
    hint2 = pos < L.R ? L.ri_ctx2(pos) : DB_INT_MIN;
  }
  for (int p = 0; p < P; ++p) {
    bool others_v = L.voting(p) && !is_self(L, p);
    bool tgt = pending ? others_v : (others_v || L.observer(p));
    if (!tgt) continue;
    L.send_flags(p) |= S_HEARTBEAT;
    A.ctr_hb += 1;
    L.send_hint(p) = hint;
    L.send_hint2(p) = hint2;
  }
}

// The whole step of lane l of the block, against the staged frame. The
// lane's frame rows are written here; stage_out copies them back.
DB_DEV void step_lane(const StepParams& S, const Frame& F, int l) {
  const int P = S.P, W = S.W, K = S.K, E = S.E, R = S.R;
  const int g = F.g0 + l;
  const size_t gk = (size_t)g * K;
  Lane L;
  L.P = P; L.R = R; L.W = W; L.E = E; L.K = K;
  L.l = l;
#ifdef __CUDA_ARCH__
  L.b0 = (int)(F.B - (uint8_t*)F.I);
#else
  L.I = F.I;
  L.B = F.B;
  L.bl = F.bl;
#endif
  L.rr0 = FP_COUNT * P;
  L.rk0 = L.rr0 + FR_COUNT * R;
  L.rc0 = L.rk0 + FK_COUNT * K;
  L.rl0 = L.rc0 + F_COUNTERS;
  L.ring = S.log_term + (size_t)g * W;
  L.ring_cc = S.log_is_cc + (size_t)g * W;
#define LOAD(f) L.f = S.f[g]
#define LOADB(f) L.f = S.f[g] != 0
  LOADB(active); LOAD(self_slot); LOAD(term); LOAD(vote); LOAD(role);
  LOAD(leader); LOAD(tick_count); LOAD(election_tick); LOAD(heartbeat_tick);
  LOAD(rand_timeout); LOAD(election_timeout); LOAD(heartbeat_timeout);
  LOADB(check_quorum); LOADB(prevote_on); LOADB(lease_on); LOAD(lease_margin);
  LOAD(lease_until); LOAD(hb_round_tick); LOAD(hb_ack_bits); LOADB(clock_ok);
  LOAD(first_index); LOAD(marker_term); LOAD(last_index); LOAD(committed);
  LOAD(processed); LOAD(applied); LOAD(unsaved_from); LOAD(transfer_to);
  LOADB(transfer_flag); LOADB(pending_cc); LOADB(quiesce_on);
  LOAD(quiesce_threshold); LOADB(quiesced); LOAD(idle_ticks); LOAD(ri_count);
  LOAD(seed);
  L.tl_lo = L.pd_lo = DB_INT_MAX;
  L.tl_term = 0;
  const int prev_term = L.term, prev_vote = L.vote, prev_commit = L.committed;
  const int save_base_floor = L.unsaved_from;

  Acc A;
  for (int p = 0; p < P; ++p) {
    L.send_flags(p) = L.send_hint(p) = L.send_hint2(p) = 0;
    L.force_probe(p) = 0;
  }
  A.noop_appended = A.noop_term = A.dropped_propose = 0;
  A.lease_served = A.lease_fallback = A.fwd_leader = 0;
  A.dropped_cc = A.log_full = false;
  A.ctr_started = A.ctr_won = A.ctr_hb = A.ctr_rejects = 0;

  tick_phase(L, A, S.ticks[g]);

  // ---- inbox scan: slot k's message is read out of the frame, then its
  // response takes its place ----
  for (int k = 0; k < K; ++k) {
    Msg m;
    m.mtype = L.ki(FK_MTYPE, k);
    m.from = L.ki(FK_FROM, k);
    m.term = L.ki(FK_TERM, k);
    m.log_index = L.ki(FK_LOG_INDEX, k);
    m.log_term = L.ki(FK_LOG_TERM, k);
    m.commit = L.ki(FK_COMMIT, k);
    m.reject = L.reject(k) != 0;
    m.hint = L.ki(FK_HINT, k);
    m.hint_high = L.ki(FK_HINT_HIGH, k);
    m.nent = L.ki(FK_N_ENTRIES, k);
    m.eterms = S.in_entry_terms + (gk + k) * E;
    m.ecc = S.in_entry_cc + (gk + k) * E;
    Resp o;
    handle_message(L, A, m, o);
    L.ki(FK_RESP_TYPE, k) = o.type;
    L.ki(FK_RESP_TO, k) = o.to;
    L.ki(FK_RESP_TERM, k) = o.term;
    L.ki(FK_RESP_LOG_INDEX, k) = o.log_index;
    L.reject(k) = o.reject;
    L.ki(FK_RESP_HINT, k) = o.hint;
    L.ki(FK_RESP_HINT2, k) = o.hint2;
    L.ki(FK_PROP_BASE, k) = o.prop_base;
    L.ki(FK_REP_BASE, k) = o.rep_base;
  }

  // ---- quorum commit: k-th order statistic of the voting match ----
  const bool is_leader = L.role == F_LEADER;
  const int nv = num_voting(L);
  const int q = nv / 2 + 1;
  {
    // rank selection over PMAX values (INT_MAX past P, as the reference's
    // sort fill): the value with fewer than idx+1 smaller and more than
    // idx no-larger values; unrolled, so the values stay in registers
    int v[PMAX];
#pragma unroll
    for (int p = 0; p < PMAX; ++p)
      v[p] = (p < P && L.voting(p)) ? L.match(p) : DB_INT_MAX;
    const int idx = clip(nv - q, 0, P - 1);
    int qidx = DB_INT_MAX;
#pragma unroll
    for (int p = 0; p < PMAX; ++p) {
      int lt = 0, le = 0;
#pragma unroll
      for (int o = 0; o < PMAX; ++o) {
        lt += v[o] < v[p];
        le += v[o] <= v[p];
      }
      if (lt <= idx && idx < le) qidx = v[p];
    }
    if (is_leader && nv > 0 && qidx > L.committed && term_at(L, qidx) == L.term)
      L.committed = qidx;
  }

  // ---- replication fan-out ----
  const bool commit_moved = L.committed != prev_commit;
  for (int p = 0; p < P; ++p) {
    if (L.rstate(p) == RS_SNAPSHOT && L.match(p) >= L.snap_sent(p)) L.rstate(p) = RS_RETRY;
    bool peer_tgt = L.member(p) && !is_self(L, p);
    bool lag = L.next(p) <= L.last_index;
    bool paused = L.rstate(p) == RS_WAIT || L.rstate(p) == RS_SNAPSHOT;
    bool compacted = L.next(p) < L.first_index;
    bool send = is_leader && peer_tgt && (lag || commit_moved || L.force_probe(p)) &&
                !paused && !compacted;
    bool need_snap = is_leader && peer_tgt && lag && !paused && compacted && L.ract(p);
    int n_send = clip(L.last_index - L.next(p) + 1, 0, E);
    int prev_idx = L.next(p) - 1;
    if (send) L.send_flags(p) |= S_REPLICATE;
    if (need_snap) {
      L.send_flags(p) |= S_NEED_SNAPSHOT;
      L.snap_sent(p) = L.last_index;
      L.rstate(p) = RS_SNAPSHOT;
    }
    L.pi(FP_PREV_INDEX, p) = send ? prev_idx : 0;
    L.pi(FP_PREV_TERM, p) =
        !send ? 0
        : prev_idx == L.first_index - 1               ? L.marker_term
        : prev_idx >= L.tl_lo && prev_idx <= L.last_index ? L.tl_term
                                                      : ring_term(L, fmod_i(prev_idx, W));
    L.pi(FP_N_ENTRIES, p) = send ? n_send : 0;
    L.pi(FP_COMMIT, p) = send ? L.committed : 0;
    if (send && n_send > 0 && L.rstate(p) == RS_REPLICATE) L.next(p) += n_send;
    else if (send && n_send > 0 && L.rstate(p) == RS_RETRY) L.rstate(p) = RS_WAIT;
  }

  // ---- ReadIndex ready-queue pop ----
  int last_conf = 0, conf_idx = 0;
  for (int r = 0; r < R; ++r) {
    int acks = L.ri_acks(r);
    bool confirmed = (popc32(acks) + 1 >= q || acks == -1) && r < L.ri_count &&
                     L.ri_ctx(r) != 0;
    if (confirmed) {
      last_conf = r + 1;
      conf_idx = imax(conf_idx, L.ri_index(r));
    }
  }
  for (int r = 0; r < R; ++r) {
    bool pop = r < last_conf;
    L.ri(FR_READY_CTX, r) = pop ? L.ri_ctx(r) : 0;
    L.ri(FR_READY_CTX2, r) = pop ? L.ri_ctx2(r) : 0;
    L.ri(FR_READY_INDEX, r) = pop ? imin(L.ri_index(r), conf_idx) : 0;
  }
  {
    // shift the queue left by last_conf, in place: the source position
    // clip(r + last_conf, 0, R - 1) is never below r, so it is still unread
    const int keep = L.ri_count - last_conf;
    for (int r = 0; r < R; ++r) {
      int t = clip(r + last_conf, 0, R - 1);
      bool kept = r < keep;
      L.ri_ctx(r) = kept ? L.ri_ctx(t) : 0;
      L.ri_ctx2(r) = kept ? L.ri_ctx2(t) : 0;
      L.ri_index(r) = kept ? L.ri_index(t) : 0;
      L.ri_acks(r) = kept ? L.ri_acks(t) : 0;
    }
    L.ri_count = keep;
  }
  const int ready_count = last_conf;

  // ---- engine directives ----
  const int save_from = imin(save_base_floor, L.unsaved_from);
  const bool has_save = L.last_index >= save_from && L.active;
  S.o_save_from[g] = has_save ? save_from : 0;
  S.o_save_to[g] = has_save ? L.last_index : 0;
  L.unsaved_from = L.last_index + 1;
  const int apply_from = L.processed + 1;
  const bool has_apply = L.committed >= apply_from && L.active;
  const int apply_to = has_apply ? L.committed : 0;
  S.o_apply_from[g] = has_apply ? apply_from : 0;
  S.o_apply_to[g] = apply_to;
  L.processed = imax(L.processed, L.committed);
  L.applied = imax(L.applied, apply_to);

  const bool end_leader = L.role == F_LEADER;
  const bool end_cand = L.role == F_CANDIDATE || L.role == F_PRE_CANDIDATE;
  const int leader_bits = S_REPLICATE | S_HEARTBEAT | S_TIMEOUT_NOW | S_NEED_SNAPSHOT;
  for (int p = 0; p < P; ++p) {
    int fl = L.send_flags(p);
    if (!end_leader) fl &= ~leader_bits;
    if (!end_cand) fl &= ~S_VOTE_REQ;
    L.send_flags(p) = L.active ? fl : 0;
  }
  S.o_vote_last_index[g] = L.last_index;
  S.o_vote_last_term[g] = term_at(L, L.last_index);
  S.o_commit_index[g] = L.committed;
  S.o_hard_changed[g] = (L.term != prev_term || L.vote != prev_vote ||
                         L.committed != prev_commit) && L.active;
  S.o_ready_count[g] = L.active ? ready_count : 0;
  S.o_dropped_propose[g] = A.dropped_propose;
  S.o_dropped_cc[g] = A.dropped_cc;
  S.o_fwd_leader[g] = A.fwd_leader;
  S.o_noop_appended[g] = A.noop_appended;
  S.o_noop_term[g] = A.noop_term;
  S.o_log_full[g] = A.log_full;
  S.o_leader[g] = L.leader;
  S.o_term[g] = L.term;
  S.o_vote[g] = L.vote;
  S.o_role[g] = L.role;
  S.o_last_index[g] = L.last_index;
  S.o_quiesced[g] = L.quiesced;
  S.o_lease_round[g] = (L.lease_on && end_leader) ? L.hb_round_tick : 0;
  S.o_lease_served[g] = A.lease_served;
  S.o_lease_fallback[g] = A.lease_fallback;
  S.o_lease_ok[g] = L.lease_on && L.clock_ok && end_leader &&
                    L.tick_count < L.lease_until && L.transfer_to == 0;
  L.counter(0) = A.ctr_started;
  L.counter(1) = A.ctr_won;
  L.counter(2) = A.ctr_hb;
  L.counter(3) = A.ctr_rejects;
  L.counter(4) = (int)((uint32_t)L.committed - (uint32_t)prev_commit);
  L.counter(5) = A.lease_served;
  L.counter(6) = A.lease_fallback;
  L.counter(7) = L.active ? ready_count : 0;
  // the pending appends are left to the block's write_pending (the last W
  // of them cover every slot they map to)
  {
    const bool pend = L.pd_lo <= L.last_index;
    const int lo = pend ? imax(L.pd_lo, L.last_index - W + 1) : 0;
    L.lane_row(FL_PD_W0) = fmod_i(lo, W);
    L.lane_row(FL_PD_N) = pend ? L.last_index - lo + 1 : 0;
    L.lane_row(FL_PD_TERM) = L.tl_term;
    L.lane_row(FL_COMMITTED) = L.committed;
  }

  // ---- write the lane's scalars back (in place) ----
#define STORE(f) S.f[g] = L.f
  STORE(active); STORE(self_slot); STORE(term); STORE(vote); STORE(role);
  STORE(leader); STORE(tick_count); STORE(election_tick); STORE(heartbeat_tick);
  STORE(rand_timeout); STORE(election_timeout); STORE(heartbeat_timeout);
  STORE(check_quorum); STORE(prevote_on); STORE(lease_on); STORE(lease_margin);
  STORE(lease_until); STORE(hb_round_tick); STORE(hb_ack_bits); STORE(clock_ok);
  STORE(first_index); STORE(marker_term); STORE(last_index); STORE(committed);
  STORE(processed); STORE(applied); STORE(unsaved_from); STORE(transfer_to);
  STORE(transfer_flag); STORE(pending_cc); STORE(quiesce_on);
  STORE(quiesce_threshold); STORE(quiesced); STORE(idle_ticks); STORE(ri_count);
#undef LOAD
#undef LOADB
#undef STORE
}

// Every lane's pending appends into its ring row, by the whole block: the
// threads form groups of (up to) a warp, each group takes every ng-th lane,
// and a group's threads write consecutive slots of the lane's run, so a
// warp's stores cover whole sectors of the row.
DB_DEV void write_pending(const StepParams& S, const Frame& F, int tid, int nt) {
  const int W = S.W, gs = nt < 32 ? nt : 32, ng = nt / gs;
  if (tid >= ng * gs) return;
  for (int l = tid / gs; l < F.nl; l += ng) {
    const int n = F.I[F.rl(FL_PD_N) * F.bl + l];
    if (n == 0) continue;
    const int w0 = F.I[F.rl(FL_PD_W0) * F.bl + l];
    const int t = F.I[F.rl(FL_PD_TERM) * F.bl + l];
    int32_t* ring = S.log_term + (size_t)(F.g0 + l) * W;
    uint8_t* cc = S.log_is_cc + (size_t)(F.g0 + l) * W;
    for (int j = tid % gs; j < n; j += gs) {
      const int w = w0 + j < W ? w0 + j : w0 + j - W;  // n <= W
      ring[w] = t;
      cc[w] = 0;
    }
  }
}

// After the lanes' step: the frame back to the state and output planes,
// and the pending appends into the ring.
DB_DEV void write_back(const StepParams& S, const Frame& F, int tid, int nt) {
  stage_out(S, F, tid, nt);
  write_pending(S, F, tid, nt);
}

#ifdef __CUDACC__
// A block of STEP_LANES lanes: all its threads stage, its first warp runs
// the lanes, all write back.
__global__ void __launch_bounds__(STEP_LANES * STEP_STAGE_WARPS)
    step_batch_kernel(const StepParams S) {
  const Frame F = frame_of(S, db_frame, STEP_LANES, blockIdx.x * STEP_LANES);
  stage_in(S, F, threadIdx.x, blockDim.x);
  copy_async_wait();
  __syncthreads();
  if ((int)threadIdx.x < F.nl) step_lane(S, F, threadIdx.x);
  __syncthreads();
  write_back(S, F, threadIdx.x, blockDim.x);
}

// Launch one step on `stream`. Returns cudaGetLastError() (0 = launched).
// The frame stays under the 48 KB of dynamic shared memory a launch gets
// without opting in (at most 27,648 bytes: P <= 8, R <= 4, K <= 8, which
// the wrapper enforces).
extern "C" int step_batch_launch(const StepParams* params, void* stream) {
  if (params->G <= 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int blocks = (params->G + STEP_LANES - 1) / STEP_LANES;
  const size_t shm = frame_bytes(params->P, params->K, params->R, STEP_LANES);
  // STEP_STAGE_WARPS warps while every block has an SM to itself; past
  // that, the most warps (halving from there) that leave an SM as many
  // resident blocks as one warp per block does, so helper warps never
  // cost lanes in flight
  int warps = STEP_STAGE_WARPS;
  if (blocks > sms) {
    int one = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&one, step_batch_kernel, STEP_LANES, shm);
    for (;; warps /= 2) {
      int got = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, step_batch_kernel,
                                                    STEP_LANES * warps, shm);
      if (warps == 1 || got >= one) break;
    }
  }
  step_batch_kernel<<<blocks, STEP_LANES * warps, shm, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

extern "C" int step_batch_params_size() { return (int)sizeof(StepParams); }
#endif

// Lanes per block and frame bytes per block at (P, K, R), for the host
// build's block loop and for reports.
extern "C" int step_batch_block_lanes() { return STEP_LANES; }
extern "C" long long step_batch_frame_bytes(int P, int K, int R, int bl) {
  return (long long)frame_bytes(P, K, R, bl);
}
