// rebase.cu — the engine's window rebase, by hand for Hopper.
//
// Replaces dragonboat_tpu/ops/state.py:rebase (line 542) and the residual
// inbox's shift that dragonboat_tpu/engine/vector.py:_do_rebase writes
// inline (lines 3383-3399). Neither reaches a pl.pallas_call: the JAX
// package left both to XLA. The plain PyTorch versions are
// dragonboat_tpu_torch/ops/state.py:rebase and
// dragonboat_tpu_torch/engine/vector.py:rebase_resid; one launch of this
// kernel on the shard's stream does the work of both.
//
// What it writes, for each lane g of [0, G) with its delta d = delta[g]
// (a multiple of the window W, so ring slots stay where they are; 0 for a
// lane that does not move, which still takes the floors below, as the
// plain version does):
//   - first_index, last_index, committed, processed, applied and
//     unsaved_from: x - d;
//   - match, next and snap_sent (P per lane) and ri_index (R per lane):
//     max(x - d, floor), with floors 0, 1, 0 and 0;
//   - when a residual inbox is given (K > 0), per parked message k of the
//     lane by its type mtype[g, k]: log_index - d for REPLICATE,
//     REPLICATE_RESP, READ_INDEX_RESP and REQUEST_VOTE; max(commit - d, 0)
//     for REPLICATE and HEARTBEAT; max(hint - d, 0) for REPLICATE_RESP.
//     The residual inbox carries indexes in its destination lane's units,
//     so the destination's delta applies.
// Subtraction wraps as int32 does in both plain versions.
//
// The reference returns a new tree; this kernel writes in place, so the
// planes keep their addresses (parameter structs built on them stay valid).
//
// Bound: bytes (delta and every plane read once, the planes written once;
// ops/state.py has no operation heavy enough to matter). The grid is
// plane-major: a block owns 32 consecutive lanes, and each of its warps
// one unit of work for them (one of the six index scalars, one of the four
// rows, or the residual inbox's four planes). A warp's lanes touch
// neighbouring rows, so every access coalesces; a row whose width is a
// multiple of 4 moves as 16-byte loads and stores (P=4 or 8, K=4 or 8),
// other widths element by element. Every load of a unit is issued before
// its stores, and the units are independent warps, so the card keeps
// many loads in flight.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RB_DEV __device__ __forceinline__
typedef int4 rb_v4;
#else
#define RB_DEV static inline
struct alignas(16) rb_v4 { int32_t x, y, z, w; };
#endif

#define RB_LANES 32      // lanes of one block (one per thread of a warp)
#define RB_UNITS 11      // 6 scalars, 4 rows, the residual inbox
#define RB_MAX_WIDTH 8   // P, R and K

// ops/cuda.py mirrors this struct in a ctypes.Structure.
struct RebaseParams {
  const int32_t* delta;      // [G]
  int32_t* scalars[6];       // first_index .. unsaved_from, [G] each
  int32_t* rows[4];          // match, next, snap_sent [G, P]; ri_index [G, R]
  const int32_t* r_mtype;    // the residual inbox [G, K]; null: none
  int32_t* r_log_index;
  int32_t* r_commit;
  int32_t* r_hint;
  int32_t G, P, R, K;
  // message types (ops/state.py:MSG)
  int32_t t_replicate, t_replicate_resp, t_read_index_resp, t_request_vote, t_heartbeat;
};

RB_DEV int32_t rb_sub(int32_t x, int32_t d) {
  return (int32_t)((uint32_t)x - (uint32_t)d);
}

RB_DEV int32_t rb_max(int32_t a, int32_t b) { return a > b ? a : b; }

// Row g of a [G, w] plane into e[0, w): 16-byte loads where the row is
// 16-byte aligned and w a multiple of 4, else element by element.
RB_DEV bool rb_vec(const int32_t* row, int w) {
  return (w & 3) == 0 && ((uintptr_t)row & 15) == 0;
}

RB_DEV void rb_load(const int32_t* row, int w, int32_t e[RB_MAX_WIDTH]) {
  if (rb_vec(row, w)) {
#pragma unroll
    for (int c = 0; c < RB_MAX_WIDTH / 4; ++c) {
      if (4 * c < w) {
        const rb_v4 v = ((const rb_v4*)row)[c];
        e[4 * c] = v.x; e[4 * c + 1] = v.y; e[4 * c + 2] = v.z; e[4 * c + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < RB_MAX_WIDTH; ++k)
      if (k < w) e[k] = row[k];
  }
}

RB_DEV void rb_store(int32_t* row, int w, const int32_t e[RB_MAX_WIDTH]) {
  if (rb_vec(row, w)) {
#pragma unroll
    for (int c = 0; c < RB_MAX_WIDTH / 4; ++c) {
      if (4 * c < w) {
        rb_v4 v;
        v.x = e[4 * c]; v.y = e[4 * c + 1]; v.z = e[4 * c + 2]; v.w = e[4 * c + 3];
        ((rb_v4*)row)[c] = v;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < RB_MAX_WIDTH; ++k)
      if (k < w) row[k] = e[k];
  }
}

// One thread's work in block `block` of a launch of `threads`-thread blocks
// (a multiple of 32): lane block * 32 + thread % 32, units thread / 32,
// thread / 32 + threads / 32, ... of RB_UNITS.
RB_DEV void rebase_block(const RebaseParams& p, int64_t block, int thread, int threads) {
  const int64_t g = block * RB_LANES + (thread & (RB_LANES - 1));
  if (g >= p.G) return;
  const int32_t d = p.delta[g];
  for (int u = thread / RB_LANES; u < RB_UNITS; u += threads / RB_LANES) {
    if (u < 6) {
      int32_t* x = p.scalars[u] + g;
      *x = rb_sub(*x, d);
    } else if (u < 10) {
      const int w = u == 9 ? p.R : p.P;
      const int32_t lo = u == 7 ? 1 : 0;
      int32_t* row = p.rows[u - 6] + (size_t)g * w;
      int32_t e[RB_MAX_WIDTH];
      rb_load(row, w, e);
#pragma unroll
      for (int k = 0; k < RB_MAX_WIDTH; ++k)
        if (k < w) e[k] = rb_max(rb_sub(e[k], d), lo);
      rb_store(row, w, e);
    } else if (p.r_mtype != 0 && p.K > 0) {
      const int w = p.K;
      const size_t at = (size_t)g * w;
      int32_t mt[RB_MAX_WIDTH], li[RB_MAX_WIDTH], cm[RB_MAX_WIDTH], hi[RB_MAX_WIDTH];
      rb_load(p.r_mtype + at, w, mt);
      rb_load(p.r_log_index + at, w, li);
      rb_load(p.r_commit + at, w, cm);
      rb_load(p.r_hint + at, w, hi);
#pragma unroll
      for (int k = 0; k < RB_MAX_WIDTH; ++k) {
        if (k >= w) continue;
        const int32_t t = mt[k];
        const bool idx_t = t == p.t_replicate || t == p.t_replicate_resp ||
                           t == p.t_read_index_resp || t == p.t_request_vote;
        const bool commit_t = t == p.t_replicate || t == p.t_heartbeat;
        const bool hint_t = t == p.t_replicate_resp;
        if (idx_t) li[k] = rb_sub(li[k], d);
        if (commit_t) cm[k] = rb_max(rb_sub(cm[k], d), 0);
        if (hint_t) hi[k] = rb_max(rb_sub(hi[k], d), 0);
      }
      rb_store(p.r_log_index + at, w, li);
      rb_store(p.r_commit + at, w, cm);
      rb_store(p.r_hint + at, w, hi);
    }
  }
}

#ifdef __CUDACC__
#define RB_THREADS (RB_LANES * RB_UNITS)

__global__ void __launch_bounds__(RB_THREADS) rebase_kernel(const RebaseParams p) {
  rebase_block(p, blockIdx.x, threadIdx.x, blockDim.x);
}

// Launch one rebase on `stream`. Returns cudaGetLastError() (0 = launched).
extern "C" int rebase_launch(const RebaseParams* p, void* stream) {
  if (p->G <= 0) return 0;
  if (p->P <= 0 || p->P > RB_MAX_WIDTH || p->R <= 0 || p->R > RB_MAX_WIDTH ||
      p->K < 0 || p->K > RB_MAX_WIDTH)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((p->G + RB_LANES - 1) / RB_LANES);
  rebase_kernel<<<blocks, RB_THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int rebase_params_size() { return (int)sizeof(RebaseParams); }
#endif
