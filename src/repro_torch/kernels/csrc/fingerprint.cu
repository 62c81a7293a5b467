// Content fingerprint of a tensor's bits on Hopper: a position-mixed
// 2x32-bit hash, wrap-summed over the reference's padded extent.
//
// Replaces the TPU kernel repro/kernels/fingerprint.py::fingerprint_2d
// (_fingerprint_kernel).
//
// Bound by bytes: it reads each element's 2 or 4 bytes once and writes
// 16 bytes in all, for about a dozen integer operations per element. One
// kernel body serves every dtype, because it takes the raw bits (u16 for
// bf16/f16, zero-extended; u32 for f32/int32). Each thread mixes its
// elements in a grid-stride loop and keeps h1 and h2 in registers; the
// block reduces them with __shfl_xor_sync and shared memory, then adds
// them with one atomicAdd each. Addition mod 2^32 is associative and
// commutative, so the result is exact whatever order the blocks add in.
//
// The TPU kernel hashes the bits zero-padded to (rows, 1024), rows a
// multiple of 8, and a padding element (bits 0, index i) still adds to
// the hash. So the loop runs over [0, n_pad) and reads 0 past n: the
// padding is never materialized.
#include "common.cuh"

constexpr uint32_t kC1 = 0x9E3779B1u;  // repro/kernels/ref.py FP_C1..FP_C3
constexpr uint32_t kC2 = 0x85EBCA77u;
constexpr uint32_t kC3 = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t warp_wrap_sum(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out[0] += h1 and out[2] += h2: the low halves of two little-endian int64.
template <typename T>
__global__ void fingerprint_kernel(const T* __restrict__ bits, int64_t n, int64_t n_pad,
                                   uint32_t* __restrict__ out) {
  uint32_t h1 = 0, h2 = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_pad; i += stride) {
    const uint32_t b = i < n ? (uint32_t)bits[i] : 0u;
    const uint32_t idx = (uint32_t)i;
    uint32_t x = (b * kC1) ^ (idx * kC2);
    x *= kC3;
    h1 += x ^ (x >> 15);
    const uint32_t y = (b + idx) * kC2;
    h2 += y ^ (y >> 13);
  }
  __shared__ uint32_t part1[kThreads / 32];
  __shared__ uint32_t part2[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  h1 = warp_wrap_sum(h1);
  h2 = warp_wrap_sum(h2);
  if (lane == 0) {
    part1[warp] = h1;
    part2[warp] = h2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    h1 = warp_wrap_sum(lane < nwarps ? part1[lane] : 0u);
    h2 = warp_wrap_sum(lane < nwarps ? part2[lane] : 0u);
    if (lane == 0) {
      atomicAdd(&out[0], h1);
      atomicAdd(&out[2], h2);
    }
  }
}

// out (two int64, zeroed here) = [h1, h2] of the first n of the n_pad
// elements at bits, each elem_bytes (2 or 4) wide; each sum is in [0, 2^32).
extern "C" int mgit_fingerprint(const void* bits, int elem_bytes, int64_t n, int64_t n_pad,
                                int64_t* out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(int64_t), stream);
  if (err != cudaSuccess) return (int)err;
  if (n_pad == 0) return 0;
  // Each sum wraps in the low 32 bits of its int64; the high halves stay 0
  // from the memset, so the int64 values are the u32 sums.
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
  const int grid = grid_for(n_pad, device);
  if (elem_bytes == 2) {
    fingerprint_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(bits), n, n_pad, words);
  } else if (elem_bytes == 4) {
    fingerprint_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(bits), n, n_pad, words);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
