// Forward attention with an online softmax on Hopper's tensor cores: GQA,
// causal, sliding-window and prefix-LM masks, masked key tiles skipped.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel). It computes what flash_attention_ref computes, not what
// the Pallas body does block by block: the Pallas kernel skips a key block
// that lies in the causal future even when a prefix-LM mask makes part of
// it visible, and this kernel does not.
//
// Bound: 4 * hd flops per visible (query, key) pair against 4 * hd * item
// bytes per row of q, k, v and out. At the serving prefill (8, 12, 512, 64)
// causal that is 3.23 GFLOP over 25.2 MB (bf16) or 50.3 MB (f32): bf16 is
// bound by bytes (0.0075 ms at 3.35 TB/s; its operations take 0.0033 ms at
// 989 TFLOP/s), f32 by operations (three TF32 passes at 495 TFLOP/s:
// 0.0196 ms). At paligemma-3b's prefill (8, 8 q / 1 kv, 768, 256) causal
// with a 256-token prefix, 327,936 visible pairs per head make 21.5 GFLOP
// over 56.6 MB (bf16): bound by operations, 0.0217 ms (bytes 0.0169 ms).
// flash_attention.py::roofline computes both.
//
// Design. One block per (batch, head, query tile); the heaviest causal
// tiles are launched first. Its warps split into one producer warp and
// consumer warpgroups of 4 warps x 16 query rows: one (64 rows) for bf16
// and for f32 at hd 128 and 256, two (128 rows, sharing each k/v tile) for
// f32 at hd 64. A warpgroup skips the key tiles none of its rows can see.
// Head dims are instantiated at 64, 128 and 256.
// - The producer's lane 0 loads the q tiles once and then each key tile
//   (64 keys; 32 for f32 at hd 256) of k and v some row of the block can
//   see by TMA (cp.async.bulk.tensor over a 3-D tensor map (hd, S, B * H),
//   so rows past the sequence and columns past hd read as zeros from
//   inside the head) into a ring of kStages stages, with a full and an
//   empty mbarrier per stage (two stages; one for f32 above hd 64, whose
//   tiles fill shared memory). The next tile loads while the consumers run
//   the current one's products.
// - Tiles are 128-byte rows, 128-byte swizzled, as wgmma's descriptors
//   read them; a head dim over 128 bytes is stored as column slabs.
// - bf16 and f16 (one path, T the 16-bit type): S = Q K^T is wgmma
//   m64n64k16 from shared memory (q and k both K-major, as stored); the
//   online softmax runs on the f32 accumulator registers, scaled by
//   hd^-0.5 in f32 after the product; P is rounded to T in registers and is
//   wgmma's A operand for O += P V, with V the B operand read MN-major
//   through the descriptor's transpose bit. The f16 path is the bf16 one
//   with wgmma's f16 operand type and f16 rounding of P and the output.
// - f32: 3xTF32 on wgmma m64nNk8.tf32. Each operand x is split once into
//   big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and each
//   product is small*big + big*small + big*big, accumulated in f32: one
//   TF32 pass keeps about three decimal digits, three keep f32's 2e-5.
//   The consumers split q once, and each k tile in place (small parts
//   beside it), as it arrives. wgmma takes TF32 operands only K-major,
//   which V is not as stored, so the same pass writes V^T (big and small)
//   into tiles of its own and the ring stage is released after Q K^T. At
//   hd 256 the q tiles alone take 128 KB, so V^T is written after Q K^T
//   into the stage's k tile and k's small tile, and the stage is released
//   after P V (224 KB in all). P
//   stays in registers as the A operand: the thread holding keys (2c,
//   2c + 1) of an 8-key group feeds them as k indices (c, c + 4), and
//   V^T's columns are written in that order.
// Both accumulators have one layout (thread lane of warp w holds rows
// 16w + lane/4 and +8, keys 8j + 2 (lane % 4) + {0, 1}), so the row max and
// sum reduce across the four threads of a row with two shuffles.
//
// Masks, as the oracle: key k is visible from query q when
// (!causal || k <= q || k < prefix_len) && (window == 0 || q - k < window);
// a masked score, like a key past the end of the sequence, is -inf (weight
// exactly 0). Every query row sees some key, so this equals the oracle's
// -1e30 (NEG_INF). A finite -1e30 went wrong in a row whose first tile is
// wholly outside a sliding window: the FFMA below turns -1e30 * scale - m
// into the rounding residue of that product (about 1e22) instead of 0, and
// ex2 of it into inf. A key tile is skipped when it is masked for
// every query of the warpgroup's rows: wholly in the causal future and
// wholly past prefix_len, or wholly outside the window. Masks are applied
// only on tiles where some pair is masked; scores are scaled into base-2
// units by one FFMA per score on the way into ex2. The wrapper refuses the one
// case where a query row could see no key at all (a window with Sq > Skv),
// pads hd to a multiple of 8 and passes 16-byte aligned tensors.
#include <cuda.h>   // CUtensorMap and its enums; the entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

constexpr int kBM = 64;                   // query rows per consumer warpgroup
constexpr int kRowBytes = 128;            // a swizzled tile row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// barriers and TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity has completed. A wait of
// about ten seconds means an arrival was lost: trap, so the launch fails
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One box (128-byte rows x 64 rows x 1 head) at element (x, y, z) of the
// map into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// A shared-memory matrix descriptor for a 128-byte swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout
// type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads of wgmma's accumulators across the
// wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A @ B^T for a 64 x 16 16-bit A and a 64 x 16 16-bit B, both K-major
// in shared memory; d is the m64n64 f32 accumulator.
#define MGIT_WGMMA_M64N64K16_SS(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    MGIT_WGMMA_M64N64K16_SS("f16");
  } else {
    MGIT_WGMMA_M64N64K16_SS("bf16");
  }
}
#undef MGIT_WGMMA_M64N64K16_SS

// d += A @ B for a 64 x 16 16-bit A in registers and a 16 x 64 16-bit B in
// shared memory, MN-major (the transpose bit set); d is m64n64 f32.
#define MGIT_WGMMA_M64N64K16_RS(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                  uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value) {
    MGIT_WGMMA_M64N64K16_RS("f16");
  } else {
    MGIT_WGMMA_M64N64K16_RS("bf16");
  }
}
#undef MGIT_WGMMA_M64N64K16_RS

// d += A @ B for a 64 x 16 16-bit A in registers and a 16 x 128 16-bit B in
// shared memory, MN-major (the transpose bit set); d is m64n128 f32.
#define MGIT_WGMMA_M64N128K16_RS(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a,
                                                  uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value) {
    MGIT_WGMMA_M64N128K16_RS("f16");
  } else {
    MGIT_WGMMA_M64N128K16_RS("bf16");
  }
}
#undef MGIT_WGMMA_M64N128K16_RS

// ---------------------------------------------------------------------------
// 3xTF32 (f32)

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x as big + small, each a TF32 value, rounded to nearest, ties away.
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  big = to_tf32(x);
  small = to_tf32(x - big);
}

// d (+)= A @ B^T for a 64 x 8 TF32 A and a 64 x 8 TF32 B, both K-major in
// shared memory; d is the m64n64 f32 accumulator.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A @ B^T for a 64 x 8 TF32 A and a 32 x 8 TF32 B, both K-major in
// shared memory; d is the m64n32 f32 accumulator (f32 at hd 256).
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A @ B for a 64 x 8 TF32 A in registers and a 64 x 8 TF32 B^T in
// shared memory, K-major; d is m64n64 f32.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t* a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A @ B for a 64 x 8 TF32 A in registers and a 128 x 8 TF32 B^T in
// shared memory, K-major; d is m64n128 f32.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t* a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// Offset in floats of (row, col) in an f32 tile of ROWS rows as TMA
// writes it and wgmma reads it: column slabs of 32 floats, each row 128
// bytes, the 16-byte chunks of a row XOR-swizzled by row % 8.
template <int ROWS>
__device__ __forceinline__ int swz_f32(int row, int col) {
  return (col >> 5) * (ROWS * 32) + row * 32 + ((((col >> 2) & 7) ^ (row & 7)) << 2) + (col & 3);
}

// Splits an f32 tile in place into its big part and writes the small part
// to small at the same offsets (the swizzle is kept).
template <int BYTES, int THREADS>
__device__ __forceinline__ void split_tile(float* tile, float* small) {
  for (int i = threadIdx.x; i < BYTES / 16; i += THREADS) {
    float4 x = reinterpret_cast<float4*>(tile)[i], lo;
    split_tf32(x.x, x.x, lo.x);
    split_tf32(x.y, x.y, lo.y);
    split_tf32(x.z, x.z, lo.z);
    split_tf32(x.w, x.w, lo.w);
    reinterpret_cast<float4*>(tile)[i] = x;
    reinterpret_cast<float4*>(small)[i] = lo;
  }
}

// V (BN keys x HD) as TMA wrote it into V^T (HD rows x BN keys, K-major,
// as wgmma's B operand of P V must be for TF32), split into big and small.
// Keys are permuted inside each group of 8: key 2c + e sits at k index
// c + 4e, the order in which a thread's P registers (keys 2c, 2c + 1 of
// the wgmma accumulator) enter the A fragment (k indices c, c + 4).
template <int HD, int BN, int THREADS>
__device__ __forceinline__ void transpose_split_v(const float* v, float* vt_big, float* vt_small) {
  for (int u = threadIdx.x; u < HD * BN / 4; u += THREADS) {
    const int n = u % HD, a = u / HD;   // row n of V^T, its 16-byte chunk a
    const int key0 = 8 * (a >> 1) + (a & 1);
    float4 big, small;
    split_tf32(v[swz_f32<BN>(key0, n)], big.x, small.x);
    split_tf32(v[swz_f32<BN>(key0 + 2, n)], big.y, small.y);
    split_tf32(v[swz_f32<BN>(key0 + 4, n)], big.z, small.z);
    split_tf32(v[swz_f32<BN>(key0 + 6, n)], big.w, small.w);
    const int off = swz_f32<HD>(n, 4 * a);
    *reinterpret_cast<float4*>(vt_big + off) = big;
    *reinterpret_cast<float4*>(vt_small + off) = small;
  }
}

// A barrier of the consumer warps alone (the producer warp is not in it).
template <int THREADS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// The consumers' barrier after they wrote tiles that wgmma reads.
template <int THREADS>
__device__ __forceinline__ void consumers_sync_for_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync<THREADS>();
}

// ---------------------------------------------------------------------------
// the parts both kernels share

struct Problem {
  int Hq, Hkv, Sq, Skv, hd, causal, window, prefix_len;
  float scale_log2;   // hd^-0.5 * log2(e): scores in base-2 units
};

// Key tiles of bn keys [begin, end) some query of rows [q_start, q_start +
// rows) can see; none when those rows lie past Sq.
__device__ __forceinline__ void key_tiles(const Problem& P, int q_start, int rows, int bn,
                                          int& begin, int& end) {
  if (q_start >= P.Sq) {
    begin = end = 0;
    return;
  }
  const int q_last = min(q_start + rows - 1, P.Sq - 1);
  const int n_k = (P.Skv + bn - 1) / bn;
  end = n_k;
  if (P.causal) end = min(n_k, max(q_last, P.prefix_len - 1) / bn + 1);
  begin = P.window > 0 ? max(0, q_start - P.window + 1) / bn : 0;
}

// Whether any (query, key) pair of a warpgroup's 64 rows from q_start and
// the key tile of bn keys from k_start is masked or past Skv.
__device__ __forceinline__ bool tile_needs_mask(const Problem& P, int q_start, int k_start,
                                                int bn) {
  const int k_end = k_start + bn;
  if (k_end > P.Skv) return true;
  if (P.causal && k_end - 1 > q_start && k_end > P.prefix_len) return true;
  return P.window > 0 && q_start + kBM - 1 - k_start >= P.window;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step on a warp's 16 x BN fragment of raw scores s
// (s[4j + 2h + e] is row row0 + 8h, key k_start + 8j + 2c + e): mask, fold
// the tile's row max (in base-2 units, hd^-0.5 * log2(e) applied in f32
// after the product) into m, the rescale factors into alpha, s into
// exp2(s * scale_log2 - m) with one FFMA and one ex2 per score, and this
// thread's share of the row sums into l.
template <int BN>
__device__ __forceinline__ void softmax_step(const Problem& P, float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], int row0,
                                             int k_start, int c, bool masked) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int qpos = row0 + 8 * ((i >> 1) & 1);
      const int kpos = k_start + 8 * (i >> 2) + 2 * c + (i & 1);
      bool ok = !P.causal || kpos <= qpos || kpos < P.prefix_len;
      if (P.window > 0) ok = ok && (qpos - kpos < P.window);
      s[i] = ok && kpos < P.Skv ? s[i] : -INFINITY;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * P.scale_log2);
    alpha[h] = exp2_approx(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        s[i] = exp2_approx(fmaf(s[i], P.scale_log2, -m_new));
        sum += s[i];
      }
    }
    l[h] = l[h] * alpha[h] + sum;
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Two f32 values rounded to nearest in the 16-bit type T, packed as one
// 32-bit wgmma A register (the first in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 two = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&two);
  } else {
    __nv_bfloat162 two = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&two);
  }
}

// o / l for rows row0 and row0 + 8 of the output, columns < hd.
template <typename T, int N>
__device__ __forceinline__ void write_rows(const Problem& P, T* oh, float (&o)[N], float (&l)[2],
                                           int row0, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = 8 * j + 2 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (col < P.hd && row < P.Sq)
        store2(oh + (int64_t)row * P.hd + col, o[4 * j + 2 * h] * l[h], o[4 * j + 2 * h + 1] * l[h]);
    }
  }
}

// A block's shape and shared memory, in 1024-byte aligned tiles of
// 128-byte swizzled column slabs: each consumer warpgroup's q tile (64
// rows x HD); a ring of kStages k tiles and kStages v tiles (kBN rows x
// HD); for f32 also each q tile's small part, k's small part and V^T's
// big and small parts (HD rows x kBN); then the barriers. f32 at hd 64
// has two consumer warpgroups (128 rows), which share each k/v tile and
// the work of splitting it; f32 at hd 128 fits one warpgroup and one
// stage; f32 at hd 256 takes 32-key tiles and writes V^T over the stage's
// k tile and k's small part (kReuse). bf16 keeps one warpgroup: two made
// it slower at the serving shape (half as many blocks, the same warps per
// SM).
template <typename T, int HD>
struct Smem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kReuse = kF32 && HD > 128;
  static constexpr int kBN = kReuse ? 32 : 64;                // keys per tile
  static constexpr int kGroups = kF32 && HD <= 64 ? 2 : 1;   // consumer warpgroups
  static constexpr int kStages = kF32 && HD > 64 ? 1 : 2;
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 32;           // + the producer warp
  static constexpr int kRows = kBM * kGroups;                // query rows per block
  static constexpr int kSlabs = HD * (int)sizeof(T) / kRowBytes;
  static constexpr int kSlabElems = kRowBytes / (int)sizeof(T);
  static constexpr int kQBytes = kBM * HD * (int)sizeof(T);
  static constexpr int kKVBytes = kBN * HD * (int)sizeof(T);   // also V^T's
  static constexpr int kRing = kGroups * kQBytes;                // first ring tile
  static constexpr int kExtra = kRing + 2 * kStages * kKVBytes;  // first f32 tile
  static constexpr int kKSmall = kExtra + kGroups * kQBytes;
  static constexpr int kEnd = kF32 ? kKSmall + (kReuse ? 1 : 3) * kKVBytes : kExtra;
  static constexpr int kBytes = kEnd + (1 + 2 * kStages) * 8;
  static_assert(!kReuse || kStages == 1, "V^T over the k tile needs one stage");
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
  uint8_t* base;
  __device__ uint8_t* q(int w) const { return base + w * kQBytes; }
  __device__ uint8_t* k(int st) const { return base + kRing + st * kKVBytes; }
  __device__ uint8_t* v(int st) const { return base + kRing + (kStages + st) * kKVBytes; }
  __device__ float* f32_at(int offset) const { return reinterpret_cast<float*>(base + offset); }
  __device__ float* q_small(int w) const { return f32_at(kExtra + w * kQBytes); }
  __device__ float* k_small() const { return f32_at(kKSmall); }
  __device__ float* vt_big() const {
    return kReuse ? reinterpret_cast<float*>(k(0)) : f32_at(kKSmall + kKVBytes);
  }
  __device__ float* vt_small() const { return kReuse ? k_small() : f32_at(kKSmall + 2 * kKVBytes); }
  __device__ uint64_t* q_full() const { return reinterpret_cast<uint64_t*>(base + kEnd); }
  __device__ uint64_t* full(int st) const { return q_full() + 1 + st; }
  __device__ uint64_t* empty(int st) const { return q_full() + 1 + kStages + st; }
};

// The producer warp's lane 0: the q tiles, then every k/v tile some row of
// the block can see into the ring, each stage reused once every consumer
// warp released it (bf16, and f32 at hd 256: after P V; f32 below: after
// Q K^T, once V is copied out as V^T).
template <typename T, int HD>
__device__ __forceinline__ void produce(const Smem<T, HD>& sm, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        int q_start, int q_head, int kv_head, int kt_begin,
                                        int kt_end) {
  using S = Smem<T, HD>;
  mbar_expect_tx(sm.q_full(), S::kGroups * S::kQBytes);
#pragma unroll
  for (int w = 0; w < S::kGroups; ++w) {
#pragma unroll
    for (int s = 0; s < S::kSlabs; ++s)
      tma_load(sm.q(w) + s * kBM * kRowBytes, qmap, sm.q_full(), s * S::kSlabElems,
               q_start + w * kBM, q_head);
  }
  for (int i = 0, kt = kt_begin; kt < kt_end; ++i, ++kt) {
    const int st = i % S::kStages;
    if (i >= S::kStages) mbar_wait(sm.empty(st), (i / S::kStages - 1) & 1);
    mbar_expect_tx(sm.full(st), 2 * S::kKVBytes);
#pragma unroll
    for (int s = 0; s < S::kSlabs; ++s) {
      tma_load(sm.k(st) + s * S::kBN * kRowBytes, kmap, sm.full(st), s * S::kSlabElems,
               kt * S::kBN, kv_head);
      tma_load(sm.v(st) + s * S::kBN * kRowBytes, vmap, sm.full(st), s * S::kSlabElems,
               kt * S::kBN, kv_head);
    }
  }
}

// o (m64 x HD) += A @ B for a 64 x 16 16-bit A in registers and V's 16
// rows of the stage (MN-major), in n128 halves above hd 128.
template <typename T, int HD>
__device__ __forceinline__ void pv_16bit(float (&o)[HD / 2], const uint32_t* a,
                                         const uint8_t* v_rows) {
  const uint64_t dv = smem_desc(v_rows, 64 * kRowBytes, 1024);
  if constexpr (HD == 64) {
    wgmma_m64n64k16_rs<T>(o, a, dv);
  } else if constexpr (HD == 128) {
    wgmma_m64n128k16_rs<T>(o, a, dv);
  } else {
    static_assert(HD == 256, "head dims 64, 128 and 256");
    // columns 128..255 start at the third 64-column slab
    wgmma_m64n128k16_rs<T>(*reinterpret_cast<float(*)[64]>(o), a, dv);
    wgmma_m64n128k16_rs<T>(*reinterpret_cast<float(*)[64]>(o + 64), a,
                           smem_desc(v_rows + 2 * 64 * kRowBytes, 64 * kRowBytes, 1024));
  }
}

// o (m64 x HD) += A @ B for a 64 x 8 TF32 A in registers and 8 keys of
// V^T (HD rows, K-major), in n128 halves above hd 128.
template <int HD>
__device__ __forceinline__ void pv_tf32(float (&o)[HD / 2], const uint32_t* a,
                                        const uint8_t* vt_keys) {
  const uint64_t dv = smem_desc(vt_keys, 16, 1024);
  if constexpr (HD == 64) {
    wgmma_m64n64k8_tf32_rs(o, a, dv);
  } else if constexpr (HD == 128) {
    wgmma_m64n128k8_tf32_rs(o, a, dv);
  } else {
    static_assert(HD == 256, "head dims 64, 128 and 256");
    // rows 128..255 of V^T are 128 rows of 128 bytes further on
    wgmma_m64n128k8_tf32_rs(*reinterpret_cast<float(*)[64]>(o), a, dv);
    wgmma_m64n128k8_tf32_rs(*reinterpret_cast<float(*)[64]>(o + 64), a,
                            smem_desc(vt_keys + 128 * kRowBytes, 16, 1024));
  }
}

// ---------------------------------------------------------------------------
// the kernel

template <typename T, int HD>
__global__ void __launch_bounds__(Smem<T, HD>::kThreads)
flash_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, T* __restrict__ out, const Problem P) {
  using S = Smem<T, HD>;
  constexpr int BN = S::kBN;
  // The block's dynamic shared memory starts 1024-byte aligned (it has no
  // static shared memory), as the 128-byte swizzle of TMA and wgmma needs.
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (smem_addr(smem_raw) & 1023) __trap();
  const S sm{smem_raw};

  const int q_start = (gridDim.x - 1 - blockIdx.x) * S::kRows;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_head = b * P.Hq + h;
  const int kv_head = b * P.Hkv + h / (P.Hq / P.Hkv);

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), S::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int kt_begin, kt_end;   // the block's key tiles
  key_tiles(P, q_start, S::kRows, BN, kt_begin, kt_end);
  if (warp == S::kConsumers / 32) {
    if (lane == 0) produce(sm, &qmap, &kmap, &vmap, q_start, q_head, kv_head, kt_begin, kt_end);
    return;
  }

  const int wg = warp / 4;                 // this warp's warpgroup and its 64 rows
  const int q0 = q_start + wg * kBM;
  int my_begin, my_end;                    // the key tiles those rows can see
  key_tiles(P, q0, kBM, BN, my_begin, my_end);
  const int g = lane >> 2, c = lane & 3;
  const int row0 = q0 + 16 * (warp % 4) + g;   // this thread's rows: row0, row0 + 8
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(sm.q_full(), 0);
  if constexpr (S::kF32) {
    split_tile<S::kGroups * S::kQBytes, S::kConsumers>(reinterpret_cast<float*>(sm.q(0)),
                                                       sm.q_small(0));
    consumers_sync_for_wgmma<S::kConsumers>();
  }

  for (int i = 0, kt = kt_begin; kt < kt_end; ++i, ++kt) {
    const int st = i % S::kStages;
    const int k_start = kt * BN;
    const bool mine = kt >= my_begin && kt < my_end;
    mbar_wait(sm.full(st), (i / S::kStages) & 1);
    float s[BN / 2];
    float alpha[2];
    if constexpr (!S::kF32) {
      static_assert(BN == kBM, "16-bit tiles of 64 keys");
      if (mine) {
        // S = Q K^T: HD / 16 steps of k16, 32 bytes each along a 128-byte slab
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < HD / 16; ++k) {
          const int off = (k / 4) * kBM * kRowBytes + (k % 4) * 32;
          wgmma_m64n64k16_ss<T>(s, smem_desc(sm.q(wg) + off, 16, 1024),
                             smem_desc(sm.k(st) + off, 16, 1024), k > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        softmax_step<BN>(P, s, m, l, alpha, row0, k_start, c, tile_needs_mask(P, q0, k_start, BN));
        rescale(o, alpha);
        // P as 16-bit A fragments (T, rounded to nearest): k16 step kk is
        // key chunks 2kk and 2kk + 1
        uint32_t pa[BN / 4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[4 * kk + r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          }
        }
        // O += P V: V is (keys, HD) as stored, MN-major; 16 keys per step
        // are two 8-row groups (1024 bytes apart), column slabs 64 rows apart
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          pv_16bit<T, HD>(o, pa + 4 * kk, sm.v(st) + kk * 16 * kRowBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(st));
    } else {
      // k and v into big and small TF32 parts, by all consumers: k in place
      // (small part in k_small), v transposed into V^T; then the stage is
      // free once Q K^T has read k (with kReuse: once P V has read V^T, which
      // is written over k after Q K^T). Every warp's share of the last
      // tile's products is done with k_small and V^T first. (Splitting the
      // next tile while this one's products run was slower: the split and
      // the shared-memory operands of Q K^T contend for shared memory.)
      if (i > 0) consumers_sync<S::kConsumers>();
      split_tile<S::kKVBytes, S::kConsumers>(reinterpret_cast<float*>(sm.k(st)), sm.k_small());
      if constexpr (!S::kReuse)
        transpose_split_v<HD, BN, S::kConsumers>(reinterpret_cast<const float*>(sm.v(st)),
                                                 sm.vt_big(), sm.vt_small());
      consumers_sync_for_wgmma<S::kConsumers>();
      if (mine) {
        // S = Q K^T in three passes of HD / 8 steps of k8 (32 bytes each):
        // q_small k_big + q_big k_small + q_big k_big
        const uint8_t* qa[3] = {reinterpret_cast<const uint8_t*>(sm.q_small(wg)), sm.q(wg),
                                sm.q(wg)};
        const uint8_t* kb[3] = {sm.k(st), reinterpret_cast<const uint8_t*>(sm.k_small()),
                                sm.k(st)};
        wgmma_fence();
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
          for (int k = 0; k < HD / 8; ++k) {
            const int qoff = (k / 4) * kBM * kRowBytes + (k % 4) * 32;
            const int koff = (k / 4) * BN * kRowBytes + (k % 4) * 32;
            const uint64_t da = smem_desc(qa[pass] + qoff, 16, 1024);
            const uint64_t db = smem_desc(kb[pass] + koff, 16, 1024);
            if constexpr (BN == 64)
              wgmma_m64n64k8_tf32_ss(s, da, db, pass + k > 0);
            else
              wgmma_m64n32k8_tf32_ss(s, da, db, pass + k > 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
      }
      if constexpr (S::kReuse) {
        // every warp's Q K^T has read k and k_small: V^T goes over them
        consumers_sync<S::kConsumers>();
        transpose_split_v<HD, BN, S::kConsumers>(reinterpret_cast<const float*>(sm.v(st)),
                                                 sm.vt_big(), sm.vt_small());
        consumers_sync_for_wgmma<S::kConsumers>();
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty(st));
      }
      if (mine) {
        softmax_step<BN>(P, s, m, l, alpha, row0, k_start, c, tile_needs_mask(P, q0, k_start, BN));
        rescale(o, alpha);
        // P as TF32 A fragments, big and small: k8 step kk holds this
        // thread's keys 8kk + 2c (k index c) and 8kk + 2c + 1 (k index c + 4)
        uint32_t pb[BN / 2], ps[BN / 2];
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float big, small;
            split_tf32(s[4 * kk + ((r & 1) << 1) + (r >> 1)], big, small);
            pb[4 * kk + r] = __float_as_uint(big);
            ps[4 * kk + r] = __float_as_uint(small);
          }
        }
        // O += P V in three passes of BN / 8 steps over V^T (HD rows, BN
        // keys in slabs of 32): p_small v_big + p_big v_small + p_big v_big
        const uint32_t* pa[3] = {ps, pb, pb};
        const uint8_t* vb[3] = {reinterpret_cast<const uint8_t*>(sm.vt_big()),
                                reinterpret_cast<const uint8_t*>(sm.vt_small()),
                                reinterpret_cast<const uint8_t*>(sm.vt_big())};
        wgmma_fence();
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
          for (int kk = 0; kk < BN / 8; ++kk)
            pv_tf32<HD>(o, pa[pass] + 4 * kk, vb[pass] + (kk / 4) * HD * kRowBytes + (kk % 4) * 32);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      if constexpr (S::kReuse) {
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty(st));
      }
    }
  }

  T* oh = out + (int64_t)q_head * P.Sq * P.hd;
  write_rows(P, oh, o, l, row0, c);
}

// ---------------------------------------------------------------------------
// host side

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// the library needs no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map over a contiguous (heads, seq, hd) tensor read in boxes of one
// 128-byte row slab x rows x 1 head, 128-byte swizzled; reads past seq or
// hd fill with zeros.
template <typename T>
static bool make_map(CUtensorMap* map, const void* ptr, int heads, int seq, int hd, int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)seq, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T), (cuuint64_t)seq * hd * sizeof(T)};
  const cuuint32_t box[3] = {kRowBytes / (cuuint32_t)sizeof(T), (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
      : sizeof(T) == 2               ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
static int launch_flash(const void* q, const void* k, const void* v, void* out, int B,
                        const Problem& P, cudaStream_t stream) {
  using S = Smem<T, HD>;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<T>(&qmap, q, B * P.Hq, P.Sq, P.hd, kBM) ||
      !make_map<T>(&kmap, k, B * P.Hkv, P.Skv, P.hd, S::kBN) ||
      !make_map<T>(&vmap, v, B * P.Hkv, P.Skv, P.hd, S::kBN))
    return (int)cudaErrorInvalidValue;
  const int smem = S::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P.Sq + S::kRows - 1) / S::kRows, P.Hq, B);
  flash_kernel<T, HD><<<grid, S::kThreads, smem, stream>>>(qmap, kmap, vmap, (T*)out, P);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(const void* q, const void* k, const void* v, void* out, int B,
                       const Problem& P, cudaStream_t stream) {
  if (P.hd <= 64) return launch_flash<T, 64>(q, k, v, out, B, P, stream);
  if (P.hd <= 128) return launch_flash<T, 128>(q, k, v, out, B, P, stream);
  return launch_flash<T, 256>(q, k, v, out, B, P, stream);
}

// out (B, Hq, Sq, hd) = attention of q (B, Hq, Sq, hd) over k, v
// (B, Hkv, Skv, hd); all contiguous, 16-byte aligned, of one dtype: 0 =
// f32, 1 = bf16, 2 = f16. hd <= 256, hd % 8 == 0 and Hq % Hkv == 0 are the
// wrapper's to arrange; scale multiplies the scores.
extern "C" int mgit_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int causal,
                                    int window, int prefix_len, float scale, int dtype,
                                    int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (hd > 256 || hd < 8 || hd % 8) return (int)cudaErrorInvalidValue;
  const Problem P{Hq, Hkv, Sq, Skv, hd, causal, window, prefix_len, scale * kLog2e};
  if (dtype == 0) return dispatch_hd<float>(q, k, v, out, B, P, stream);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, P, stream);
  if (dtype == 2) return dispatch_hd<__half>(q, k, v, out, B, P, stream);
  return (int)cudaErrorInvalidValue;
}
