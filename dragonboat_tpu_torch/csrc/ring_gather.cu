// ring_gather.cu — the candidate exchange between the lane blocks of a
// sharded super-step, by hand for Hopper.
//
// Replaces dragonboat_tpu/ops/kernel.py:_pallas_ring_gather, the JAX
// package's only Pallas kernel: an all-gather of every shard's (C, M) i32
// candidate slab into an (n, C, M) stack on every shard, shard-major and
// byte-identical to lax.all_gather(tiled=False). The plain PyTorch version
// is dragonboat_tpu_torch/ops/kernel.py:ring_gather_reference.
//
// What it computes, not how the TPU did it: the Pallas kernel's neighbour
// barrier and its n-1 remote-DMA hops exist because a TPU core can write
// only to its ring neighbour over ICI. Here the n shards are lane blocks of
// one card, so every shard's slab already lies in the same memory, and the
// gather is a pull through a pointer table: one launch covers all n
// destinations, the grid runs over (destination, source, chunk), and each
// block copies its chunk of slab `source` into stack `destination` at
// offset source * C * M. The slabs were written by earlier kernels on the
// same stream, so stream order makes them visible; no barrier is needed.
//
// Bound: bytes (n inputs of C*M*4 read, n*n*C*M*4 written). Copies use
// 16-byte loads and stores when both the source and the destination of a
// (destination, source) pair are 16-byte aligned, which holds when C*M is a
// multiple of 4, with scalar code for the ragged tail; otherwise scalar.

#include <stddef.h>
#include <stdint.h>

#define RG_MAX_SHARDS 16

// ops/cuda.py mirrors this struct in a ctypes.Structure.
struct RingGatherParams {
  const int32_t* src[RG_MAX_SHARDS];  // shard s's slab, C*M elements
  int32_t* dst[RG_MAX_SHARDS];        // shard d's stack, n*C*M elements
  int64_t L;                          // C*M
  int32_t n;
};

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) ring_gather_kernel(const RingGatherParams p) {
  const int s = blockIdx.y, d = blockIdx.z;
  const int32_t* in = p.src[s];
  int32_t* out = p.dst[d] + (size_t)s * p.L;
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

// Launch one gather on `stream`. Returns cudaGetLastError() (0 = launched).
extern "C" int ring_gather_launch(const RingGatherParams* p, void* stream) {
  if (p->n <= 0 || p->L <= 0) return 0;
  if (p->n > RG_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  // enough chunks to fill the card, each thread moving a few 16-byte words
  long long chunks = (p->L / 4 + threads * 4 - 1) / (threads * 4);
  const long long cap = (132 * 16 + (long long)p->n * p->n - 1) / ((long long)p->n * p->n);
  if (chunks > cap) chunks = cap;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)chunks, (unsigned)p->n, (unsigned)p->n);
  ring_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int ring_gather_params_size() { return (int)sizeof(RingGatherParams); }
#endif
