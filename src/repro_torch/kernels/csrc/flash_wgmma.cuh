// The bf16 flash-attention kernel for Hopper: Q.K^T and P.V on the tensor
// cores (wgmma), Q, K and V brought into shared memory by the Tensor Memory
// Accelerator through a ring of mbarrier-guarded stages.  Included by
// flash_attention.cu (one nvcc, one library); see the note at the top of
// that file for the function, the bound and the design.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_wgmma {

constexpr int kConsumers = 2;         // consumer warpgroups, 64 query rows each
constexpr int kBlockQ = 64 * kConsumers;          // query rows of a CTA
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kTurnBar = 1;           // named barriers 1, 2: consumer turns
constexpr int kColBlock = 64;         // bf16 columns of one 128-byte row
constexpr float kNegInf = -1e30f;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// shared memory: Q, then kStages x (K, V), each a tile of ceil(HD / 64)
// column blocks of 128-byte rows (the 128-byte swizzle's atom: 8 rows, 1
// KB); at head size 80 the second block's columns 80-127 are the TMA's
// zeros.  Then the barriers; 1 KB of slack aligns the tiles to the
// swizzle's 1 KB period.  kBlockK, the key rows of a K/V tile, is wgmma's
// N of S and where P is rounded to bf16 (kernels/flash_attention.py
// WGMMA_TILE); head size 256 takes 64-row tiles in 2 stages, since its Q
// tile is 64 KB and a 128-row K + V stage 128 KB.
template <int HD>
struct Layout {
  static constexpr int kBlockK = HD == 256 ? 64 : 128;
  static constexpr int kStages = HD == 256 ? 2 : 3;
  static constexpr int kColBlocks = (HD + kColBlock - 1) / kColBlock;
  static constexpr int kQBlockBytes = kBlockQ * 128;   // a column block of Q
  static constexpr int kKBlockBytes = kBlockK * 128;   // ... of K or V
  static constexpr int kQBytes = kColBlocks * kQBlockBytes;
  static constexpr int kTileBytes = kColBlocks * kKBlockBytes;
  static constexpr int kQ = 0;
  static constexpr int kStage = kQBytes;                 // K at +0, V at +tile
  static constexpr int kBars = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
  static_assert(HD % 16 == 0, "S takes 16 columns a step");
  static_assert(kBlockQ % kBlockK == 0, "Q loads as whole K/V boxes");
  static_assert(kBytes <= 232448, "fits the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
// K-major (Q, K): rows of 128 bytes, 8-row groups 1 KB apart (SBO), LBO
// unused.  MN-major (V read as B of P.V): 8 key rows of 128 bytes (64 head
// columns) a group, groups 1 KB apart (SBO), 64-column blocks LBO apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
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

// keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions that own them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, f32) (+)= A (64 x 16, bf16, K-major in shared memory) *
// B (128 x 16, bf16, K-major in shared memory)^T
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) (+)= A (64 x 16, bf16, K-major in shared memory) *
// B (64 x 16, bf16, K-major in shared memory)^T
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32],
                                                uint64_t desc_a,
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// S = Q K^T of one k16 step over a tile of N keys
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_m64n64(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(N == 128, "K/V tiles of 64 or 128 rows");
    wgmma_ss_m64n128(d, desc_a, desc_b, accumulate);
  }
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D (64 x 80, f32) += A (64 x 16, bf16, registers) * B (16 x 80, bf16,
// MN-major in shared memory: columns 64-79 from the second 64-column
// block, LBO on)
__device__ __forceinline__ void wgmma_rs_m64n80(float (&d)[40], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// O += P V of one k16 step (16 keys, V's rows `addr` on, its 64-column
// blocks `lbo` bytes apart): one wgmma of N = HD, two of N = 128 at 256
template <int HD>
__device__ __forceinline__ void pv_step(float (&d)[HD / 2], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t addr, uint32_t lbo) {
  const uint64_t desc = smem_desc(addr, lbo, 1024);
  if constexpr (HD == 64) {
    wgmma_rs_m64n64(d, a0, a1, a2, a3, desc, 1);
  } else if constexpr (HD == 80) {
    wgmma_rs_m64n80(d, a0, a1, a2, a3, desc, 1);
  } else if constexpr (HD == 128) {
    wgmma_rs_m64n128(d, a0, a1, a2, a3, desc, 1);
  } else {
    static_assert(HD == 256, "head size 64, 80, 128 or 256");
    wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&d[0]), a0, a1, a2, a3,
                     desc, 1);
    wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&d[64]), a0, a1, a2, a3,
                     smem_desc(addr + 2 * lbo, lbo, 1024), 1);
  }
}

// exp(x sfac - m): expf of x sfac - m rounded once (one FFMA; the
// reference rounds the product and the difference apart, within the same
// tolerance)
__device__ __forceinline__ float exp_shifted(float x, float sfac, float m) {
  return expf(fmaf(x, sfac, -m));
}

// named barriers over the two consumer warpgroups (256 threads)
__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(128 * kConsumers)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// q (B, Sq, H, HD), k and v (B, Sk, KV, HD) arrive through 4-D tensor maps
// (HD, heads, rows, B) in boxes of 64 columns x 1 head x kBlockK rows x 1
// (Q as kBlockQ / kBlockK boxes a column block), so a box past the last row
// or column is zero-filled by the hardware (a 2-D map would read the next
// batch's rows there); o (B, Sq, H, HD) is written from registers.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int n_bh, int n_heads,
                   int n_kv, int sq, int sk, int sk_pad, int causal,
                   int window, float scale) {
  using L = Layout<HD>;
  constexpr int kBlockK = L::kBlockK;
  constexpr int kStages = L::kStages;
  constexpr int kColBlocks = L::kColBlocks;
  constexpr int kS = kBlockK / 2;     // S registers of a thread
  constexpr int kPSteps = kBlockK / 16;  // k16 steps of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base + L::kQ;
  const uint32_t bars = base + L::kBars;
  const uint32_t q_bar = bars + 16 * kStages;
  // stage s: K at k_tile(s), V one tile after it; its full barrier (TMA
  // bytes landed) and empty barrier (both consumers done reading)
  auto k_tile = [&](int s) { return base + L::kStage + 2 * s * L::kTileBytes; };
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };

  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = qb * kBlockQ;
  const int q_last = min(q0 + kBlockQ, sq) - 1;

  // the kv tiles this CTA visits: the union of its rows' bands, or every
  // tile up to Sk_pad when a row has no live key (see flash_attention.cu)
  const bool windowed = window > 0;
  int k_lo = 0;
  int k_hi;
  if (windowed && q_last >= sk + window - 1) {
    k_hi = sk_pad;
  } else {
    k_hi = causal ? min(sk, q_last + 1) : sk;
    if (windowed) k_lo = max(0, q0 - window + 1);
  }
  const int t_first = k_lo / kBlockK;
  const int n_tiles = (k_hi + kBlockK - 1) / kBlockK - t_first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kColBlocks; ++c) {
#pragma unroll
        for (int r = 0; r < kBlockQ / kBlockK; ++r) {
          tma_load_4d(q_tile + c * L::kQBlockBytes + r * L::kKBlockBytes,
                      &tm_q, q_bar, c * kColBlock, h, q0 + r * kBlockK, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(s), 2 * L::kTileBytes);
        const int k0 = (t_first + it) * kBlockK;
#pragma unroll
        for (int c = 0; c < kColBlocks; ++c) {
          tma_load_4d(k_tile(s) + c * L::kKBlockBytes, &tm_k, full_bar(s),
                      c * kColBlock, kvh, k0, b);
          tma_load_4d(k_tile(s) + L::kTileBytes + c * L::kKBlockBytes, &tm_v,
                      full_bar(s), c * kColBlock, kvh, k0, b);
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows; thread (warp, lane) holds rows
    // row0 and row0 + 8 and, in each 8 columns, columns col0 and col0 + 1
    // of every accumulator (wgmma's m64nN layout)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;
    const int row0 = qw0 + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_wg = q_tile + 64 * 128 * wg;
    const float kDead = __int_as_float(0xff800000);  // -inf: past Sk_pad

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

    // O += P V of the tile in stage s: kBlockK / 16 steps of 16 keys (two
    // 8-row groups, 2 KB) with V read MN-major (transposed); then stage s
    // is free
    uint32_t pa[kBlockK / 4];
    auto pv_gemm = [&](int s) {
      const uint32_t vt = k_tile(s) + L::kTileBytes;
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        pv_step<HD>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                    pa[4 * kk + 3], vt + 2048 * kk, L::kKBlockBytes);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty_bar(s));
    };

    mbar_wait(q_bar, 0);
    // the two consumers take turns on the tensor cores: each issues its
    // products (the last tile's P V, this tile's Q K^T) while the other runs
    // its softmax; the first consumer goes first
    if (wg == 1) named_bar_arrive(kTurnBar);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = (t_first + it) * kBlockK;
      named_bar_sync(kTurnBar + wg);
      if (it > 0) pv_gemm((it - 1) % kStages);
      mbar_wait(full_bar(s), (it / kStages) & 1);

      // S = Q K^T: HD / 16 steps of 16 columns, 32 bytes apart within a
      // 128-byte row, the next 64 columns one column block on
      const uint32_t kt = k_tile(s);
      float sc[kS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<kBlockK>(
            sc, smem_desc(q_wg + (kk / 4) * L::kQBlockBytes + off, 16, 1024),
            smem_desc(kt + (kk / 4) * L::kKBlockBytes + off, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      named_bar_arrive(kTurnBar + 1 - wg);

      // mask (the reference's sentinel; -inf past Sk_pad, where the
      // reference has no position), only on tiles that need it; there the
      // scores are scaled on the way (sfac = 1 after), elsewhere the scale
      // is applied below (sfac = scale)
      const bool need_mask = k0 + kBlockK > sk ||
                             (causal && k0 + kBlockK - 1 > qw0) ||
                             (windowed && k0 <= qw0 + 63 - window);
      float sfac = scale;
      if (need_mask) {
        sfac = 1.f;
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + col0 + (e & 1);
            const int qp = row0 + 8 * (e >> 1);
            bool live = kp < sk;
            if (causal) live = live && kp <= qp;
            if (windowed) live = live && kp > qp - window;
            const float x = sc[4 * j + e] * scale;
            sc[4 * j + e] = live ? x : (kp < sk_pad ? kNegInf : kDead);
          }
        }
      }

      // online softmax: m' = max(m, rowmax(s) * sfac) over the quad's 4
      // lanes (rounding is monotonic, so this is rowmax of the scaled s),
      // p = exp(s sfac - m'), alpha = exp(m - m'), l from the f32 p
      float mx[2] = {kDead, kDead};
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r] * sfac);
        alpha[r] = exp_shifted(m[r], 1.f, mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp_shifted(sc[i], sfac, mx[r]);
        sum[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // P in bf16 as wgmma's register A: the S fragment of key columns
      // 16 kk .. 16 kk + 15 is the A fragment of step kk
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[4 * kk + x] =
              pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        }
      }
    }
    if (n_tiles > 0) {
      named_bar_sync(kTurnBar + wg);
      pv_gemm((n_tiles - 1) % kStages);
      if (wg == 0) named_bar_arrive(kTurnBar + 1);
    }

    // out = acc / max(l, 1e-30), rounded once to bf16, rows below Sq only
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst =
          o + ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * HD + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// links no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, rows, heads, hd) bf16 as the 4-D map (hd, heads, rows, B), boxes of
// 64 x 1 x box_rows x 1 with the 128-byte swizzle (at hd 80 the second
// column block's box reaches past the row: its columns 80-127 are zeros)
inline bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                       int hd, int heads, int rows, int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * rows};
  const cuuint32_t box[4] = {kColBlock, 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int sq, int sk, int n_heads, int n_kv,
                   int causal, int window, int sk_pad, float scale,
                   cudaStream_t stream) {
  constexpr int kRows = Layout<HD>::kBlockK;  // one box shape: Q, K and V
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map(enc, &tm_q, q, HD, n_heads, sq, batch, kRows) ||
      !encode_map(enc, &tm_k, k, HD, n_kv, sk, batch, kRows) ||
      !encode_map(enc, &tm_v, v, HD, n_kv, sk, batch, kRows)) {
    return cudaErrorInvalidValue;
  }
  constexpr int kSmem = Layout<HD>::kBytes;
  auto kernel = flash_wgmma_kernel<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int n_bh = batch * n_heads;
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  const dim3 grid(static_cast<unsigned>(n_qb) * n_bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), n_bh, n_heads, n_kv,
      sq, sk, sk_pad, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace flash_wgmma
