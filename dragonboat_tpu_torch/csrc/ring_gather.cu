// ring_gather.cu — the candidate exchange between the lane blocks of a
// sharded super-step, by hand for Hopper.
//
// Replaces dragonboat_tpu/ops/kernel.py:_pallas_ring_gather, the JAX
// package's only Pallas kernel: an all-gather of every shard's i32
// candidate record into an (n, L) stack on every shard, shard-major and
// byte-identical to lax.all_gather(tiled=False). The plain PyTorch version
// is dragonboat_tpu_torch/ops/kernel.py:gather_for (one destination) and
// ring_gather_reference (all of them).
//
// What it computes, not how the TPU did it: the Pallas kernel's neighbour
// barrier and its n-1 remote-DMA hops exist because a TPU core can write
// only to its ring neighbour over ICI. On Hopper a kernel can read any
// card's memory that is mapped for it (peer access over NVLink, addressed
// through unified virtual addresses), so the gather is a pull: ONE launch
// per destination shard, on that shard's device and stream, copies the n
// source records through a pointer table into the destination's stack at
// offset source * L. On one card the table holds plain device pointers; on
// distinct cards it holds the peers' pointers, and ring_gather_enable_peers
// maps every pair once when the sharded function is built (a pair that
// cannot reach each other is refused there; nothing stages through the
// host).
//
// Ordering comes from events, not from stream order: every shard runs on a
// stream of its own, so the launch that pulls record s may run while shard
// s is still writing it, or after shard s has started to write the next
// inner step's record. The host code of the super-step
// (ops/cuda.py:sharded_multi_step_cuda, _Exchange) makes the
// destination's stream wait on every source's columns-done event
// before this launch (read after write) and makes each source's stream wait
// on every destination's gather-done event before it writes its record
// again (write after read).
//
// Bound: bytes (n inputs of L*4 read, n*L*4 written per destination). Copies
// use 16-byte loads and stores when both the source and the destination of
// a source are 16-byte aligned, which holds when L is a multiple of 4, with
// scalar code for the ragged tail; otherwise scalar.

#include <stddef.h>
#include <stdint.h>

#define RG_MAX_SHARDS 16

// ops/cuda.py mirrors this struct in a ctypes.Structure.
struct RingGatherParams {
  const int32_t* src[RG_MAX_SHARDS];  // shard s's record, L elements (any card)
  int32_t* dst;                       // the destination's stack, n*L elements
  int64_t L;
  int32_t n;
};

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) ring_gather_kernel(const RingGatherParams p) {
  const int s = blockIdx.y;
  const int32_t* in = p.src[s];
  int32_t* out = p.dst + (size_t)s * p.L;
  const size_t L = (size_t)p.L;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t done = 0;
  if ((((uintptr_t)in | (uintptr_t)out) & 15) == 0) {
    const size_t nv = L / 4;
    const int4* vi = reinterpret_cast<const int4*>(in);
    int4* vo = reinterpret_cast<int4*>(out);
    for (size_t i = tid; i < nv; i += stride) vo[i] = vi[i];
    done = nv * 4;
  }
  for (size_t i = done + tid; i < L; i += stride) out[i] = in[i];
}

// Launch one destination's gather on `stream` (a stream of the current
// device, which owns p->dst). Returns cudaGetLastError() (0 = launched).
extern "C" int ring_gather_launch(const RingGatherParams* p, void* stream) {
  if (p->n <= 0 || p->L <= 0) return 0;
  if (p->n > RG_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  // enough chunks to fill the card, each thread moving a few 16-byte words
  long long chunks = (p->L / 4 + threads * 4 - 1) / (threads * 4);
  const long long cap = (132 * 16 + (long long)p->n - 1) / (long long)p->n;
  if (chunks > cap) chunks = cap;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)chunks, (unsigned)p->n);
  ring_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

// Map every ordered pair of the n distinct cards in `devs` for peer access
// (a kernel on devs[a] may then read memory of devs[b]). Returns 0, a
// cudaError, or -1 - (a * RG_MAX_SHARDS + b) when card devs[a] cannot
// reach card devs[b]. The caller's current device is restored.
extern "C" int ring_gather_enable_peers(const int* devs, int n) {
  if (n > RG_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  int rc = 0;
  for (int a = 0; a < n && rc == 0; ++a) {
    for (int b = 0; b < n && rc == 0; ++b) {
      if (devs[a] == devs[b]) continue;
      int ok = 0;
      err = cudaDeviceCanAccessPeer(&ok, devs[a], devs[b]);
      if (err != cudaSuccess) { rc = (int)err; break; }
      if (!ok) { rc = -1 - (a * RG_MAX_SHARDS + b); break; }
      err = cudaSetDevice(devs[a]);
      if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(devs[b], 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // already mapped: not an error
        err = cudaSuccess;
      }
      if (err != cudaSuccess) rc = (int)err;
    }
  }
  cudaSetDevice(cur);
  return rc;
}

extern "C" int ring_gather_params_size() { return (int)sizeof(RingGatherParams); }
#endif
