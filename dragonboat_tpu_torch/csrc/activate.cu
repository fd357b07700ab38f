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
//
// Bound: bytes (the lane rows read once, each distinct lane's values read
// once, each written row written once). Most of them are the two [W] planes
// (1 KB of log_term and W bytes of log_is_cc a lane at W=256), so the
// design copies those rows wide and issues every load before a store:
//   - A block owns a tile of AC_TILE consecutive lane rows. Its first
//     threads load the tile's rows into shared memory once, each with its
//     skip flag (out of [0, G), or equal to the row before it); no thread
//     reads the lane rows again, and a tile of padding rows ends there.
//   - The [W] planes: one warp per lane row. Both planes' rows are
//     contiguous in the buffer and in the state, so the warp copies them
//     in 16-byte loads and stores, with a byte copy where a row is not
//     16-byte aligned.
//   - The scalar planes and the [P] / [R] row planes: one thread per
//     (lane row, plane) of the tile, the tile's row from `thread & (AC_TILE
//     - 1)` and the plane from a shift; ops/cuda.py orders the planes by
//     width, element size and source, so a warp's four planes mostly take
//     one path. A row plane's width is a template parameter (1-8), so a
//     row is written with the widest stores its size and alignment allow
//     (16 bytes for an i32 row of 4, 8-byte pieces for one of 5, 4-byte
//     words for a bool row of 4).
//   - A thread loads its (at most two) small items and its warp's [W]
//     chunks, then stores them: one memory round trip after the tile's.
// No per-element division. On the H100 the [W] planes alone take about
// what a device-to-device copy of their bytes takes; with a batch's lane
// rows scattered over the state, the scalar and row planes' writes (one
// 32-byte sector a plane and lane, about 50 a lane) take the most time,
// and with consecutive rows, as a bring-up's are, they coalesce
// (tree_probe.py activation times each part).

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define AC_DEV __device__ __forceinline__
typedef uint4 ac_v16;
typedef uint2 ac_v8;
#else
#define AC_DEV static inline
struct alignas(16) ac_v16 { uint32_t x, y, z, w; };
struct alignas(8) ac_v8 { uint32_t x, y; };
#endif

#define AC_MAX_SMALL 56  // scalar and row planes one launch writes
#define AC_TILE 8        // lane rows of one block (a power of two)
#define AC_TILE_LOG2 3
#define AC_THREADS 256  // 8 warps, one a tile row for the [W] planes
#define AC_MIN_BLOCKS 4  // resident blocks an SM (<= 64 registers a thread)
#define AC_MAX_ROW 8     // widest row plane (P, R)

// ops/cuda.py mirrors these structs in ctypes.Structures.
struct ActSmall {        // one scalar or row plane
  void* dst;             // the state plane, G x width elements
  const void* src;       // its value column, n x (bcast ? 1 : width); null: fill
  int32_t fill;          // the value written where src is null
  int8_t width;          // elements per lane row (1, P or R)
  int8_t elem;           // bytes per element: 4 (i32) or 1 (bool)
  int8_t bcast;          // src holds one value per lane, written to every element
  int8_t pad;
};

struct ActWindow {       // one [W] plane
  void* dst;             // G x row_bytes
  const void* src;       // n x row_bytes
  int64_t row_bytes;     // W x element bytes
};

struct ActivateParams {
  const int32_t* rows;   // the n lane rows of the batch
  ActWindow window[2];   // log_term, log_is_cc
  ActSmall small[AC_MAX_SMALL];  // the scalar planes, then the row planes
  int32_t n;             // lane rows (the padded bucket)
  int32_t G;             // rows of every plane
  int32_t n_small;
};

// The tile's rows in shared memory: the lane row and whether it is skipped.
struct ActTile {
  int32_t g[AC_TILE];
  int32_t skip[AC_TILE];
};

// Thread t < AC_TILE of block `block` loads its row of the tile.
AC_DEV void activate_tile_row(const ActivateParams& p, int64_t block, int t, ActTile& tile) {
  const int64_t i = block * AC_TILE + t;
  int32_t g = -1, skip = 1;
  if (i < p.n) {
    g = p.rows[i];
    // a row equal to the one before it is padding with equal values: the
    // first copy writes them
    skip = g < 0 || g >= p.G || (i > 0 && p.rows[i - 1] == g);
  }
  tile.g[t] = g;
  tile.skip[t] = skip;
}

// ---- the [W] planes: one warp copies lane row i's two rows into row g,
// in rounds of up to four 16-byte chunks a lane (chunk c < na is plane
// a's, the rest plane b's), each round's loads before its stores

struct WinRow {
  const uint8_t* sa; const uint8_t* sb;  // the two source rows
  uint8_t* da; uint8_t* db;              // the two destination rows
  int64_t ba, bb;                        // their bytes
  int na, total;                         // 16-byte chunks of plane a, of both
  bool va, vb;                           // each row 16-byte aligned
};

AC_DEV bool ac_aligned16(const void* a, const void* b, int64_t bytes) {
  return ((bytes & 15) == 0) && ((((uintptr_t)a) | ((uintptr_t)b)) & 15) == 0;
}

AC_DEV void win_row(const ActivateParams& p, int64_t i, int32_t g, WinRow& w) {
  const ActWindow& a = p.window[0];
  const ActWindow& b = p.window[1];
  w.ba = a.row_bytes; w.bb = b.row_bytes;
  w.sa = (const uint8_t*)a.src + i * w.ba;
  w.sb = (const uint8_t*)b.src + i * w.bb;
  w.da = (uint8_t*)a.dst + (int64_t)g * w.ba;
  w.db = (uint8_t*)b.dst + (int64_t)g * w.bb;
  w.va = ac_aligned16(w.sa, w.da, w.ba);
  w.vb = ac_aligned16(w.sb, w.db, w.bb);
  w.na = w.va ? (int)(w.ba >> 4) : 0;
  w.total = w.na + (w.vb ? (int)(w.bb >> 4) : 0);
}

AC_DEV void win_load(const WinRow& w, int base, ac_v16 v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = base + 32 * j;
    if (c < w.total)
      v[j] = c < w.na ? ((const ac_v16*)w.sa)[c] : ((const ac_v16*)w.sb)[c - w.na];
  }
}

AC_DEV void win_store(const WinRow& w, int base, const ac_v16 v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = base + 32 * j;
    if (c < w.total) {
      if (c < w.na) ((ac_v16*)w.da)[c] = v[j];
      else ((ac_v16*)w.db)[c - w.na] = v[j];
    }
  }
}

// the rounds after the first, and the byte copy of a row that is not
// 16-byte aligned
AC_DEV void win_rest(const WinRow& w, int lane) {
  for (int base = lane + 4 * 32; base < w.total; base += 4 * 32) {
    ac_v16 v[4];
    win_load(w, base, v);
    win_store(w, base, v);
  }
  if (!w.va)
    for (int64_t x = lane; x < w.ba; x += 32) w.da[x] = w.sa[x];
  if (!w.vb)
    for (int64_t x = lane; x < w.bb; x += 32) w.db[x] = w.sb[x];
}

AC_DEV void window_rows(const ActivateParams& p, int64_t i, int32_t g, int lane) {
  WinRow w;
  win_row(p, i, g, w);
  ac_v16 v[4];
  win_load(w, lane, v);
  win_store(w, lane, v);
  win_rest(w, lane);
}

// ---- the scalar and row planes, in two phases so that a thread's loads
// are all issued before its first store. The load phase keeps a lane
// row's values in two words: an i32 plane's one value (a scalar, a
// constant, or one value a lane written to every element; ops/cuda.py
// refuses an i32 row of distinct values, which activation has none of),
// or a bool row's bytes, little-endian (up to 8). WID is the row's width
// (1 for a scalar plane).

struct SmallVal {
  uint32_t lo, hi;
};

template <int WID>
AC_DEV void small_load_w(const ActSmall& a, int64_t i, SmallVal& s) {
  if (a.elem == 4) {
    s.lo = a.src ? ((const uint32_t*)a.src)[i] : (uint32_t)a.fill;
  } else if (!a.src || a.bcast || WID == 1) {
    const uint32_t x = a.src ? ((const uint8_t*)a.src)[i] : (uint8_t)a.fill;
    s.lo = s.hi = x * 0x01010101u;
  } else {
    const uint8_t* src = (const uint8_t*)a.src + i * WID;
    s.lo = s.hi = 0;
#pragma unroll
    for (int k = 0; k < WID; ++k) {
      const uint32_t b = (uint32_t)src[k] << (8 * (k & 3));
      if (k < 4) s.lo |= b;
      else s.hi |= b;
    }
  }
}

template <int WID>
AC_DEV void small_store_w(const ActSmall& a, int32_t g, const SmallVal& s) {
  if (a.elem == 4) {
    uint32_t* d = (uint32_t*)a.dst + (int64_t)g * WID;
    // one value in every element: 16-byte stores where the row allows,
    // else 8-byte ones after a 4-byte head (a row of 5 at a 4-byte
    // boundary takes 3 stores, not 5)
    const uint32_t x = s.lo;
    const uintptr_t at = (uintptr_t)d;
    if (WID % 4 == 0 && (at & 15) == 0) {
      ac_v16 q;
      q.x = q.y = q.z = q.w = x;
#pragma unroll
      for (int c = 0; c < WID / 4; ++c) ((ac_v16*)d)[c] = q;
    } else {
      int k = 0;
      if (at & 4) d[k++] = x;
      ac_v8 q;
      q.x = q.y = x;
#pragma unroll
      for (int c = 0; c < WID / 2; ++c)
        if (k + 2 <= WID) { *(ac_v8*)(d + k) = q; k += 2; }
      if (k < WID) d[k] = x;
    }
  } else {
    // a bool row's bytes: 1-, 2- and 4-byte stores on their boundaries
    uint8_t* d = (uint8_t*)a.dst + (int64_t)g * WID;
    const uint64_t all = (uint64_t)s.lo | ((uint64_t)s.hi << 32);
    const uintptr_t at = (uintptr_t)d;
    int k = 0;
    if ((at & 1) && k < WID) { d[0] = (uint8_t)all; k = 1; }
    if (((at + k) & 2) && k + 2 <= WID) {
      *(uint16_t*)(d + k) = (uint16_t)(all >> (8 * k));
      k += 2;
    }
#pragma unroll
    for (int c = 0; c < WID / 4; ++c)
      if (k + 4 <= WID) { *(uint32_t*)(d + k) = (uint32_t)(all >> (8 * k)); k += 4; }
    if (k + 2 <= WID) { *(uint16_t*)(d + k) = (uint16_t)(all >> (8 * k)); k += 2; }
    if (k < WID) d[k] = (uint8_t)(all >> (8 * k));
  }
}

#define AC_BY_WIDTH(fn, ...)                      \
  switch (a.width) {                              \
    case 1: fn<1>(__VA_ARGS__); break;            \
    case 2: fn<2>(__VA_ARGS__); break;            \
    case 3: fn<3>(__VA_ARGS__); break;            \
    case 4: fn<4>(__VA_ARGS__); break;            \
    case 5: fn<5>(__VA_ARGS__); break;            \
    case 6: fn<6>(__VA_ARGS__); break;            \
    case 7: fn<7>(__VA_ARGS__); break;            \
    case 8: fn<8>(__VA_ARGS__); break;            \
    default: break;                               \
  }

AC_DEV void small_load(const ActSmall& a, int64_t i, SmallVal& s) {
  AC_BY_WIDTH(small_load_w, a, i, s)
}

AC_DEV void small_store(const ActSmall& a, int32_t g, const SmallVal& s) {
  AC_BY_WIDTH(small_store_w, a, g, s)
}

// One thread's writes in block `block` of a launch of `threads`-thread
// blocks (a multiple of 32), once the tile is loaded. Warp w copies the
// [W] rows of tile rows w, w + threads / 32, ...; thread x of the (plane,
// row) grid writes tile row x & (AC_TILE - 1) of small plane
// x >> AC_TILE_LOG2, for x = thread, thread + threads, ... In a full block
// (AC_THREADS threads, the engine's 48 small planes) a thread has at most
// two small items and one [W] row, and issues the loads of all three
// before it stores any: one memory round trip after the tile's.
AC_DEV void activate_block(const ActivateParams& p, int64_t block, int thread, int threads,
                           const ActTile& tile) {
  const int lane = thread & 31;
  const int warp = thread >> 5;
  const int64_t first = block * AC_TILE;
  const int items = p.n_small << AC_TILE_LOG2;
  const int m = AC_TILE - 1;
  // loads: the thread's first two small items, its warp's first [W] row
  const int x0 = thread, x1 = thread + threads;
  const bool h0 = x0 < items && !tile.skip[x0 & m];
  const bool h1 = x1 < items && !tile.skip[x1 & m];
  SmallVal s0, s1;
  if (h0) small_load(p.small[x0 >> AC_TILE_LOG2], first + (x0 & m), s0);
  if (h1) small_load(p.small[x1 >> AC_TILE_LOG2], first + (x1 & m), s1);
  WinRow w;
  ac_v16 v[4];
  const bool win = warp < AC_TILE && !tile.skip[warp];
  if (win) {
    win_row(p, first + warp, tile.g[warp], w);
    win_load(w, lane, v);
  }
  // their stores
  if (h0) small_store(p.small[x0 >> AC_TILE_LOG2], tile.g[x0 & m], s0);
  if (h1) small_store(p.small[x1 >> AC_TILE_LOG2], tile.g[x1 & m], s1);
  if (win) {
    win_store(w, lane, v);
    win_rest(w, lane);
  }
  // what a block of fewer threads has left
  for (int r = warp + (threads >> 5); r < AC_TILE; r += threads >> 5)
    if (!tile.skip[r]) window_rows(p, first + r, tile.g[r], lane);
  for (int x = thread + 2 * threads; x < items; x += threads) {
    const int r = x & m;
    if (tile.skip[r]) continue;
    const ActSmall& a = p.small[x >> AC_TILE_LOG2];
    small_load(a, first + r, s0);
    small_store(a, tile.g[r], s0);
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(AC_THREADS, AC_MIN_BLOCKS)
activate_kernel(const ActivateParams p) {
  __shared__ ActTile tile;
  if (threadIdx.x < AC_TILE) activate_tile_row(p, blockIdx.x, threadIdx.x, tile);
  __syncthreads();
  activate_block(p, blockIdx.x, threadIdx.x, blockDim.x, tile);
}

// Launch one batch's activation on `stream`. Returns cudaGetLastError()
// (0 = launched).
extern "C" int activate_launch(const ActivateParams* p, void* stream) {
  if (p->n <= 0) return 0;
  if (p->n_small <= 0 || p->n_small > AC_MAX_SMALL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((p->n + AC_TILE - 1) / AC_TILE);
  activate_kernel<<<blocks, AC_THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int activate_params_size() { return (int)sizeof(ActivateParams); }
#endif
