// Shared pieces of the storage-path kernels: the launch shape, the exact
// f32 quantize step, and a block-level integer count reduction.
//
// Every kernel here is an elementwise pass that moves a few bytes per
// element and does a handful of operations on them, so it is bound by
// device-memory bandwidth. Each one is a grid-stride loop over the flat
// tensor (neighbouring threads read neighbouring elements, the ragged tail
// is masked by the loop bound), and any counts are reduced in registers,
// then across the block, then added with one 64-bit atomicAdd per block.
// Integer sums are exact, so the order in which blocks add does not matter.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// Blocks for an n-element pass: one per kThreads elements, capped at a few
// waves over the device's SMs; the grid-stride loop covers the rest.
static inline int grid_for(int64_t n, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * kBlocksPerSM;
  return (int)(blocks < cap ? blocks : cap);
}

// Algorithm 1's quantize step, rounded exactly as the CPU oracle and the
// numpy twins round it: a true f32 division (not a multiply by 1/scale),
// then +0.5 and floor. The intrinsics are never contracted into an FMA.
__device__ __forceinline__ int quantize(float p1, float p2, float scale) {
  return (int)floorf(__fadd_rn(__fdiv_rn(__fsub_rn(p1, p2), scale), 0.5f));
}

// p - f32(q) * scale as two separately rounded operations (no FMA), as
// the numpy twin host_dequant computes it.
__device__ __forceinline__ float dequantize(float p, int q, float scale) {
  return __fsub_rn(p, __fmul_rn((float)q, scale));
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Adds the block-wide sums of a and b to the 64-bit counters *out_a and
// *out_b (out_b may be null). Every thread of the block must call it. A
// block's own sums stay 32-bit: each block covers at most a few million
// elements, while a whole tensor may hold more than 2^31.
__device__ __forceinline__ void block_count_add(int a, int b, unsigned long long* out_a,
                                                unsigned long long* out_b) {
  __shared__ int part_a[kThreads / 32];
  __shared__ int part_b[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    part_a[warp] = a;
    part_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    a = lane < nwarps ? part_a[lane] : 0;
    b = lane < nwarps ? part_b[lane] : 0;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      if (a) atomicAdd(out_a, (unsigned long long)a);
      if (b && out_b) atomicAdd(out_b, (unsigned long long)b);
    }
  }
}

// The error of the last launch on this thread, as the wrapper reports it.
extern "C" const char* mgit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
