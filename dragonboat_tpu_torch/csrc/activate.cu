// activate.cu — lane activation, by hand for Hopper.
//
// Replaces dragonboat_tpu/engine/vector.py:_make_activate_fn (line 192), the
// jitted bulk lane activation: n lanes' bring-up values scattered into the
// device state in one compiled program. It reaches no pl.pallas_call; the
// JAX package left it to XLA, which fuses its 50 `.at[gi].set` updates into
// one program. Eager PyTorch made it one index_put_ per plane (50 launches a
// batch) behind 28 host copies; this kernel is one launch per batch and
// shard behind one copy. The plain PyTorch versions are
// dragonboat_tpu_torch/engine/vector.py:activate_lanes_reference (the
// per-lane values as separate tensors) and activate_packed_reference (the
// packed buffer below, read as this kernel reads it).
//
// What it writes, for each of the n lane rows of the batch:
//   - the 26 planes of vector._ACT_SET from the batch's values;
//   - the 21 planes of vector._ACT_ZERO to 0;
//   - `active` to true, `next` to the lane's value in all P slots, `rstate`
//     to RSTATE.RETRY in all P slots.
// ri_ctx2, clock_ok and seed are not written. A lane row outside [0, G) is
// skipped, as JAX's scatter drops an out-of-bounds update. The engine pads
// a batch to its bucket by repeating the last lane with equal values (up to
// three rows in four of a batch are padding), so a row equal to the row
// before it is skipped: its values are already written, and the writes
// stay order-free.
//
// Inputs: the lane rows and the per-lane values, all views of ONE packed
// buffer whose layout ops/cuda.py states (activation_layout: the rows, the
// i32 and bool columns, the [P] member/voting/observer/witness rows, the [W]
// log_term and log_is_cc rows, each plane 16-byte aligned), which the
// engine fills in pinned host memory and copies to the card once a batch.
// ops/cuda.py fills one ActPlane per plane written: its destination, its
// source column (null for a constant), the widths and its first block.
//
// Bound: bytes (each value read once, each written row written once). Each
// block writes up to AC_ELEMS consecutive elements of one plane's n x width
// (lane, element) grid: neighbouring threads write neighbouring elements of
// a lane's row (the [W] and [P] rows coalesce) or the same plane of
// neighbouring lanes (the scalar planes coalesce where the rows are
// consecutive, as a bring-up's are). Every plane has its own blocks, so no
// block runs empty and all 50 planes are written in one launch.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define AC_DEV __device__ __forceinline__
#else
#define AC_DEV static inline
#endif

#define AC_MAX_PLANES 64
#define AC_THREADS 256
#define AC_ELEMS 1024  // elements of one plane a block writes

// ops/cuda.py mirrors these structs in ctypes.Structures.
struct ActPlane {
  void* dst;             // the state plane, G x width elements
  const void* src;       // its value column, n x src_width elements; null: fill
  int64_t first_block;   // the plane's first block of the launch
  int32_t width;         // elements per lane row of the plane (1, P, W or R)
  int32_t src_width;     // elements per lane of src: width, or 1 (broadcast)
  int32_t elem;          // bytes per element: 4 (i32) or 1 (bool)
  int32_t fill;          // the value written where src is null
};

struct ActivateParams {
  const int32_t* rows;   // the n lane rows of the batch
  ActPlane planes[AC_MAX_PLANES];
  int64_t blocks;        // the launch's blocks, every plane's together
  int32_t n;             // lane rows (the padded bucket)
  int32_t G;             // rows of every plane
  int32_t n_planes;
};

// One thread's elements of block `block`: `thread` of `threads`. The
// block's plane is the last whose first block is at or below it (a binary
// search over the struct, the same for every thread); element x of the
// plane is lane row x / width, element x % width, in 32-bit arithmetic
// (ops/cuda.py keeps n * width below 2^31).
AC_DEV void activate_block(const ActivateParams& p, int64_t block, int thread, int threads) {
  int lo = 0, hi = p.n_planes - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.planes[mid].first_block <= block) lo = mid; else hi = mid - 1;
  }
  const ActPlane& a = p.planes[lo];
  const uint32_t w = (uint32_t)a.width;
  const uint32_t sw = (uint32_t)a.src_width;
  const uint32_t total = (uint32_t)p.n * w;
  const uint32_t begin = (uint32_t)(block - a.first_block) * AC_ELEMS;
  const uint32_t end = begin + AC_ELEMS < total ? begin + AC_ELEMS : total;
  for (uint32_t x = begin + (uint32_t)thread; x < end; x += (uint32_t)threads) {
    const uint32_t i = w == 1 ? x : x / w;
    const uint32_t e = x - i * w;
    const int32_t g = p.rows[i];
    // a row equal to the one before it is padding with equal values: the
    // first copy writes them
    if (g < 0 || g >= p.G || (i > 0 && p.rows[i - 1] == g)) continue;
    const size_t at = (size_t)g * w + e;
    const uint32_t from = i * sw + (sw == 1 ? 0 : e);
    if (a.elem == 4) {
      ((int32_t*)a.dst)[at] = a.src ? ((const int32_t*)a.src)[from] : a.fill;
    } else {
      ((uint8_t*)a.dst)[at] = a.src ? ((const uint8_t*)a.src)[from] : (uint8_t)a.fill;
    }
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(AC_THREADS) activate_kernel(const ActivateParams p) {
  activate_block(p, blockIdx.x, threadIdx.x, blockDim.x);
}

// Launch one batch's activation on `stream`. Returns cudaGetLastError()
// (0 = launched).
extern "C" int activate_launch(const ActivateParams* p, void* stream) {
  if (p->n <= 0 || p->blocks <= 0) return 0;
  if (p->n_planes <= 0 || p->n_planes > AC_MAX_PLANES || p->blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  activate_kernel<<<(unsigned)p->blocks, AC_THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int activate_params_size() { return (int)sizeof(ActivateParams); }
#endif
