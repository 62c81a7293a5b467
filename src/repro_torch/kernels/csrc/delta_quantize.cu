// Algorithm 1's lossy step on Hopper: quantize a delta, and apply one back.
//
// Replaces two TPU kernels of the reference package:
//   repro/kernels/delta_quantize.py::delta_quantize_2d (_delta_quantize_kernel)
//   repro/kernels/delta_quantize.py::dequant_apply_2d  (_dequant_apply_kernel)
//
// Both take float32, float16 or bfloat16 operands and widen them to f32 in
// registers (exact), as the TPU kernels widen their tiles; dequant narrows
// its f32 result to the output type with round-to-nearest-even in the
// kernel (a bf16 NaN becomes the quiet NaN of its sign, 0x7FC0 / 0xFFC0,
// as jnp's astype and the host's numpy twin give it).
//
// Bound by bytes: quantize reads two operands and writes one int32 per
// element (12 B in f32, 8 B in f16 or bf16) for four operations; dequant
// reads an operand and an int32 and writes the output (12 B f32 -> f32,
// 8 B f16 -> f16 or bf16 -> bf16) for three. The TPU versions pad to (rows, 1024) tiles and
// reduce one zero count per tile of block_rows x 1024 elements. Here the
// tensor stays flat and the tail is masked; each block walks one
// contiguous span of the tensor and adds its zeros to the 64-bit counter of
// each tile it touches (one atomicAdd per block per tile), so a tensor may
// hold more than 2^31 elements. The wrapper passes
// the reference's tile size, or a size past n for one total; padding zeros
// are added on the host.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

// Operand type codes of the C entry points.
enum : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, __half* out) { *out = __float2half_rn(x); }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* out) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u)   // NaN: quiet, sign kept (cvt gives 0x7FFF)
    *reinterpret_cast<uint16_t*>(out) = (uint16_t)(((u >> 16) & 0x8000u) | 0x7fc0u);
  else
    *out = __float2bfloat16_rn(x);
}

template <typename T1, typename T2>
__global__ void delta_quantize_kernel(const T1* __restrict__ p1,
                                      const T2* __restrict__ p2,
                                      int32_t* __restrict__ q,
                                      unsigned long long* __restrict__ tile_zeros, int64_t n,
                                      int64_t span, int64_t tile, float scale) {
  // span and tile are multiples of blockDim.x (or tile >= n), so every
  // blockDim-wide step of the walk lies in one tile and the tile changes
  // at the same step for every thread of the block
  const int64_t begin = (int64_t)blockIdx.x * span;
  const int64_t end = begin + span < n ? begin + span : n;
  int64_t cur = begin / tile;
  int nz = 0;
  for (int64_t base = begin; base < end; base += blockDim.x) {
    if (base / tile != cur) {
      block_count_add(nz, 0, tile_zeros + cur, nullptr);
      __syncthreads();  // the block's partials are reused by the next add
      cur = base / tile;
      nz = 0;
    }
    const int64_t i = base + threadIdx.x;
    if (i < end) {
      const int v = quantize(widen(p1[i]), widen(p2[i]), scale);
      q[i] = v;
      nz += (v == 0);
    }
  }
  block_count_add(nz, 0, tile_zeros + cur, nullptr);
}

template <typename T, typename TOut>
__global__ void dequant_apply_kernel(const T* __restrict__ p1,
                                     const int32_t* __restrict__ q,
                                     TOut* __restrict__ out, int64_t n,
                                     float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    narrow(dequantize(widen(p1[i]), q[i], scale), out + i);
  }
}

template <typename T1, typename T2>
static void launch_quantize(const void* p1, const void* p2, int32_t* q,
                            unsigned long long* tile_zeros, int64_t n, int64_t tile,
                            float scale, int device, cudaStream_t stream) {
  const int64_t blocks = grid_for(n, device);
  int64_t span = (n + blocks - 1) / blocks;
  span = (span + kThreads - 1) / kThreads * kThreads;
  const int grid = (int)((n + span - 1) / span);
  delta_quantize_kernel<T1, T2><<<grid, kThreads, 0, stream>>>(
      (const T1*)p1, (const T2*)p2, q, tile_zeros, n, span, tile, scale);
}

template <typename T, typename TOut>
static void launch_dequant(const void* p1, const int32_t* q, void* out,
                           int64_t n, float scale, int device,
                           cudaStream_t stream) {
  dequant_apply_kernel<T, TOut><<<grid_for(n, device), kThreads, 0, stream>>>(
      (const T*)p1, q, (TOut*)out, n, scale);
}

// The operand-type switch of the entry points: launch_quantize or
// launch_dequant with p1's type and the second code's type; false for an
// unknown code.
template <typename T1>
static bool quantize_second(int p2_type, const void* p1, const void* p2, int32_t* q,
                            unsigned long long* tile_zeros, int64_t n, int64_t tile, float scale, int device,
                            cudaStream_t stream) {
  switch (p2_type) {
    case kF32: launch_quantize<T1, float>(p1, p2, q, tile_zeros, n, tile, scale, device, stream); return true;
    case kF16: launch_quantize<T1, __half>(p1, p2, q, tile_zeros, n, tile, scale, device, stream); return true;
    case kBF16: launch_quantize<T1, __nv_bfloat16>(p1, p2, q, tile_zeros, n, tile, scale, device, stream); return true;
    default: return false;
  }
}

template <typename T>
static bool dequant_second(int out_type, const void* p1, const int32_t* q, void* out, int64_t n,
                           float scale, int device, cudaStream_t stream) {
  switch (out_type) {
    case kF32: launch_dequant<T, float>(p1, q, out, n, scale, device, stream); return true;
    case kF16: launch_dequant<T, __half>(p1, q, out, n, scale, device, stream); return true;
    case kBF16: launch_dequant<T, __nv_bfloat16>(p1, q, out, n, scale, device, stream); return true;
    default: return false;
  }
}

// q = floor((f32(p1) - f32(p2)) / scale + 0.5); tile_zeros[i / tile] +=
// count(q[i] == 0), 64-bit counters. p1_type and p2_type are kF32, kF16 or
// kBF16. tile is a multiple of 256, or at least n (one counter). tile_zeros
// must hold 0s before the launch.
extern "C" int mgit_delta_quantize(const void* p1, int p1_type, const void* p2,
                                   int p2_type, int32_t* q,
                                   unsigned long long* tile_zeros,
                                   int64_t n, int64_t tile, float scale,
                                   int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n <= 0 || tile <= 0 || (tile < n && tile % kThreads != 0)) return (int)cudaErrorInvalidValue;
  bool known;
  switch (p1_type) {
    case kF32: known = quantize_second<float>(p2_type, p1, p2, q, tile_zeros, n, tile, scale, device, stream); break;
    case kF16: known = quantize_second<__half>(p2_type, p1, p2, q, tile_zeros, n, tile, scale, device, stream); break;
    case kBF16: known = quantize_second<__nv_bfloat16>(p2_type, p1, p2, q, tile_zeros, n, tile, scale, device, stream); break;
    default: known = false;
  }
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out = narrow(f32(p1) - f32(q) * scale) to out_type, rounding to nearest
// even. p1_type and out_type are kF32, kF16 or kBF16.
extern "C" int mgit_dequant_apply(const void* p1, int p1_type, const int32_t* q,
                                  void* out, int out_type, int64_t n,
                                  float scale, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  bool known;
  switch (p1_type) {
    case kF32: known = dequant_second<float>(out_type, p1, q, out, n, scale, device, stream); break;
    case kF16: known = dequant_second<__half>(out_type, p1, q, out, n, scale, device, stream); break;
    case kBF16: known = dequant_second<__nv_bfloat16>(out_type, p1, q, out, n, scale, device, stream); break;
    default: known = false;
  }
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
