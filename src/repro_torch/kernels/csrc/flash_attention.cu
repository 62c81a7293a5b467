// Forward attention with an online softmax on Hopper: GQA, causal,
// sliding-window and prefix-LM masks, masked key tiles skipped.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel). It computes what flash_attention_ref computes, not what
// the Pallas body does block by block: the Pallas kernel skips a key block
// that lies in the causal future even when a prefix-LM mask makes part of
// it visible, and this kernel does not.
//
// Bound by operations: 4 * hd flops per visible (query, key) pair against
// 4 * hd bytes per row of q, k, v and out, so at prefill lengths the f32
// CUDA-core rate is the limit. The design is the simple one: one block of
// 256 threads per (batch, head, 64-query tile) walks the 64-key tiles of
// its KV head (h / (Hq / Hkv)) in order. q (scaled by hd^-0.5 as it is
// loaded, as the oracle scales it), k and v are converted to f32 and staged
// in shared memory; the scores and the output accumulator never leave the
// chip. Four threads own one query row: each holds 16 of the tile's 64
// scores and a quarter of the row's accumulator in registers, and the
// row's max and sum are reduced among the four with shuffles. The
// probabilities go through shared memory to the P @ V product, which each
// thread reads only for its own row. Sums run in another order than the
// oracle's, so results agree to f32 rounding, not bit for bit.
//
// Masks, as the oracle: key k is visible from query q when
// (!causal || k <= q || k < prefix_len) && (window == 0 || q - k < window);
// a masked score is -1e30 (NEG_INF), a key past the end of the sequence is
// -inf (weight exactly 0). A key tile is skipped when it is masked for
// every query of the tile: wholly in the causal future and wholly past
// prefix_len, or wholly outside the window. The wrapper refuses the one
// case where a query row could see no key at all (a window with Sq > Skv).
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int kTile = 64;            // queries per block and keys per tile
constexpr int kFlashThreads = 256;   // 4 threads per query row
constexpr int kPerThread = kTile / 4;  // scores each thread holds per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [row0, row0 + kTile) of a (seq, hd) slice into a (kTile, LD) f32
// tile, rows past seq as zeros, every value times mul.
template <typename T, int LD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0, int seq,
                                      int hd, float mul) {
  for (int i = threadIdx.x; i < kTile * hd; i += kFlashThreads) {
    const int r = i / hd, d = i - r * hd;
    const int row = row0 + r;
    dst[r * LD + d] = row < seq ? load_f32(src + (int64_t)row * hd + d) * mul : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Hq, int Hkv, int Sq, int Skv, int hd, int causal,
             int window, int prefix_len, float scale) {
  constexpr int LD = HD + 1;   // odd row stride: the four rows a warp reads sit in four banks
  constexpr int kAcc = HD / 4;
  extern __shared__ float smem[];
  float* qs = smem;                  // (kTile, LD) scaled queries
  float* ks = qs + kTile * LD;       // (kTile, LD) keys
  float* vs = ks + kTile * LD;       // (kTile, LD) values
  float* ps = vs + kTile * LD;       // (kTile, kTile + 1) probabilities

  const int q_start = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const T* qh = q + ((int64_t)b * Hq + h) * Sq * hd;
  const T* kh = k + ((int64_t)b * Hkv + kvh) * Skv * hd;
  const T* vh = v + ((int64_t)b * Hkv + kvh) * Skv * hd;
  T* oh = out + ((int64_t)b * Hq + h) * Sq * hd;

  const int r = threadIdx.x >> 2;     // this thread's query row in the tile
  const int quad = threadIdx.x & 3;   // its quarter of the row
  const int qpos = q_start + r;

  stage<T, LD>(qs, qh, q_start, Sq, hd, scale);

  // the key tiles some query of this tile can see
  const int q_last = min(q_start + kTile - 1, Sq - 1);
  const int n_k = (Skv + kTile - 1) / kTile;
  int kt_end = n_k;
  if (causal) {
    const int last_key = max(q_last, prefix_len - 1);
    kt_end = min(n_k, last_key / kTile + 1);
  }
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q_start - window + 1) / kTile;

  float m = kNegInf, l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * kTile;
    __syncthreads();   // the previous tile's products are done with ks, vs
    stage<T, LD>(ks, kh, k_start, Skv, hd, 1.f);
    stage<T, LD>(vs, vh, k_start, Skv, hd, 1.f);
    __syncthreads();

    // scores of row r against keys quad + 4j
    float s[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s[j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) s[j] = fmaf(qd, ks[(quad + 4 * j) * LD + d], s[j]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int kpos = k_start + quad + 4 * j;
      bool ok = !causal || kpos <= qpos || kpos < prefix_len;
      if (window > 0) ok = ok && (qpos - kpos < window);
      s[j] = kpos >= Skv ? -INFINITY : (ok ? s[j] : kNegInf);
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const float p = expf(s[j] - m_new);
      tile_sum += p;
      ps[r * (kTile + 1) + quad + 4 * j] = p;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    l = l * alpha + tile_sum;
    m = m_new;
    __syncwarp();   // row r's probabilities come from its own quad, in this warp

    // acc = acc * alpha + P[r, :] @ V[:, quad + 4j]
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] *= alpha;
    for (int c = 0; c < kTile; ++c) {
      const float p = ps[r * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        if (quad + 4 * j < hd) acc[j] = fmaf(p, vs[c * LD + quad + 4 * j], acc[j]);
      }
    }
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int d = quad + 4 * j;
      if (d < hd) store_from_f32(oh + (int64_t)qpos * hd + d, acc[j] / denom);
    }
  }
}

template <typename T, int HD>
static int launch_flash(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                        int Hkv, int Sq, int Skv, int hd, int causal, int window,
                        int prefix_len, float scale, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  const size_t smem = (size_t)(3 * kTile * LD + kTile * (kTile + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  flash_kernel<T, HD><<<grid, kFlashThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Skv, hd, causal, window,
      prefix_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                       int Hkv, int Sq, int Skv, int hd, int causal, int window, int prefix_len,
                       float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch_flash<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, hd, causal, window,
                               prefix_len, scale, stream);
  if (hd <= 64)
    return launch_flash<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, hd, causal, window,
                               prefix_len, scale, stream);
  return launch_flash<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, hd, causal, window,
                              prefix_len, scale, stream);
}

// out (B, Hq, Sq, hd) = attention of q (B, Hq, Sq, hd) over k, v
// (B, Hkv, Skv, hd); all contiguous, of one dtype: 0 = f32, 1 = bf16.
// hd <= 128 and Hq % Hkv == 0 are the wrapper's to check.
extern "C" int mgit_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int causal,
                                    int window, int prefix_len, float scale, int dtype,
                                    int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (hd > 128 || hd < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, B, Hq, Hkv, Sq, Skv, hd, causal, window,
                              prefix_len, scale, stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, hd, causal, window,
                                      prefix_len, scale, stream);
  return (int)cudaErrorInvalidValue;
}
