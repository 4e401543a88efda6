// Flash attention (forward) for Hopper (sm_90a): the prefill's causal /
// sliding-window GQA attention in one online-softmax pass over K/V, as two
// kernels chosen by the wrapper from (dtype, head size) alone:
//
//   flash_attention_forward_wgmma   bf16, head size 64, 80, 128 or 256
//                                   (every config; zamba2's heads are 80,
//                                   gemma3's 256): flash_wgmma.cuh
//   flash_attention_forward         f32 (TF32 is not allowed), and bf16 at
//                                   head size 16 or 32: flash_fwd_kernel
//
// Both replace repro/kernels/flash_attention.py: flash_attention ->
// _flash_kernel.
//
// q is (B, Sq, H, hd), k and v (B, Sk, KV, hd), all contiguous; query head
// h reads K/V head h / (H / KV) directly (no replicated K/V).  The output is
// (B, Sq, H, hd) in q's dtype.  The function is the Pallas kernel's: scores
// s = (q . k) * scale, masked to the -1e30 sentinel (not -inf) where k_pos
// >= Sk, where k_pos > q_pos (causal) and where k_pos <= q_pos - window (a
// static window, also when not causal), with q_pos counted from 0; per row
// a running max m, denominator l and accumulator acc, all f32, updated per
// kv tile as
//   m' = max(m, rowmax s), p = exp(s - m'), alpha = exp(m - m'),
//   l' = l alpha + rowsum p, acc' = acc alpha + p v;
// out = acc / max(l, 1e-30).  The (Sq, Sk) scores never reach memory.
//
// kv tiles that lie wholly outside every row's causal / window band are
// skipped, which leaves the result unchanged: in the reference a wholly
// masked block before a row's first live one gives p = 1 everywhere, and
// the first live block multiplies that by alpha = exp(-1e30 - m) = 0; a
// wholly masked block after a live one gives p = 0 and alpha = 1 (both
// exact in bf16 too).  A row with no live key at all (only with a window,
// when q_pos >= Sk + window - 1) keeps p = 1 over every position of the
// reference's padded K/V, zero rows included: its output is sum(v) /
// Sk_pad.  A CTA holding such a row visits every tile up to Sk_pad (a
// multiple of 64, which the wrapper checks), masking the positions past Sk
// as the reference does; the wgmma kernel's 128-row tiles set the
// positions past Sk_pad to -inf (p = 0: the reference has no such
// position; its 64-row tiles at head size 256 end at Sk_pad).
//
// -- flash_attention_forward_wgmma (flash_wgmma.cuh) --------------------------
//
// Bound on this card: at the prefill's shapes (qwen2-0.5b: H 14, KV 2, hd
// 64, Sq = Sk in the thousands) the work is 4 hd flops per live (q, k) pair
// against one read of q, k, v and one write of o, hundreds of flops per
// byte: bound by the tensor cores' 989 TFLOP/s (bf16), 0.1216 ms for the
// 8,192-token causal prefill of one layer.  At hd 64 the exponentials bound
// as hard: one MUFU ex2 per live pair against 256 tensor-core flops, at 16
// ex2 a clock per SM about 0.12 ms at 8,192 tokens; expf without fast-math
// adds its range reduction on the FMA pipe.
//
// What the design does about it: a CTA of 384 threads owns 128 query rows
// of one (batch, head), heaviest query blocks first.  One producer warp
// (its warpgroup gives up registers with setmaxnreg.dec to 24) loads Q once
// and K/V in tiles of 128 rows (64 at head size 256) by TMA (4-D tensor
// maps, so the rows past Sk are zero-filled, 128-byte swizzle) into a ring
// of 3 stages (2 at 256) guarded by full / empty mbarriers.  Two consumer
// warpgroups (setmaxnreg.inc to 240) take 64 query rows each: S = Q K^T is
// hd / 16 wgmma m64n{tile}k16 from shared memory (both operands K-major),
// masked in registers from positions computed from the accumulator layout
// (only on tiles that cross a band edge), the online softmax in registers
// (row max and sum across a quad's 4 lanes, expf of one FFMA s scale - m,
// no fast-math), then O += P V is tile / 16 k16 steps with P from
// registers (the S fragment of 16 keys is the A fragment of one step) and
// V read MN-major from shared memory: one wgmma m64n{hd}k16 a step at 64,
// 80 and 128, two m64n128k16 at 256.  The two consumers take turns on two
// named barriers (ping-pong): each issues its products (the last tile's P
// V, this tile's Q K^T) while the other runs its softmax.  O stays in f32
// registers and is divided by max(l, 1e-30) and rounded once to bf16 at
// the end.  Shared memory: 112 KB at hd 64, 224 KB at hd 80 and 128, 192
// KB at hd 256 (Q 64 KB + 2 x 64 KB); one CTA per SM.
//
// Head size 80: a 160-byte row has no 128-byte swizzle row of its own, so
// the maps keep dims[0] = 80 and the layout of hd 128: two 64-column boxes
// a tile, the TMA filling columns 80-127 of the second with zeros (the
// transaction count is the whole box, as for rows past Sk).  S takes 5
// k16 steps (the fifth from the second block), P V one m64n80k16 a step,
// whose MN-major B spans the first block and 16 columns of the second (LBO
// on), so no tensor work falls on the zero columns; the store writes
// columns below 80 only.
//
// Head size 256: a 128-row K + V stage is 128 KB beside a 64 KB Q tile,
// so the tiles are 64 rows in 2 stages (192 KB); S is m64n64k16 (32
// registers, P 16).  The consumers' registers: O 128 + S 32 + P 16 a
// thread fit the 240 that setmaxnreg gives them: ptxas allocates the
// consumer path past the launch bound's 168 (the SASS names registers up
// to R225), with 0 bytes spilled.
//
// Where the time goes (PERF.md, the kernel table): the softmax, not the
// tensor cores -- expf's range reduction is most of its instructions an
// element, with two consumer warps a scheduler.
//
// The one difference from the reference: the tensor cores take bf16
// operands, so P is rounded to bf16 for P V (l is summed from the f32 p).
// Each p moves by at most 2^-8 of itself and the weights p / l sum to 1, so
// an output element moves by at most 2^-8 max|v|; the plain version with
// p_dtype=bfloat16 rounds at the same points (its tiles: 128 keys, 64 at
// head size 256).
//
// ptxas (-Xptxas -v, sm_90a): flash_wgmma_kernel<64>, <80>, <128> and
// <256> 168 registers (the launch bound, which the producer keeps; the
// SASS of the consumers names up to R205, R217, R237 and R225), 0 bytes
// spilled.
//
// -- flash_attention_forward (flash_fwd_kernel, below) ------------------------
//
// Bound: 4 hd flops per live pair at 67 TFLOP/s on the f32 CUDA cores (f32
// inputs; bf16 at hd 16 / 32 reads too few columns a row to feed wgmma's
// 64-column swizzle rows, and takes this kernel).  Head sizes
// 16, 32, 64, 80, 128, 256: hd / 8 output columns a thread (10 at hd 80,
// read as float2), shared memory 4 ((64 + 2 64) (hd + 4) + 64 68) bytes,
// 212 KB at hd 256 (sm_90 gives one block up to 227 KB).
//
// What this design does about it (a first, simple kernel): one CTA of 128
// threads per (batch x head, block of 64 query rows), heaviest query blocks
// first so the causal triangle's long rows do not trail.  The query block
// is staged once in shared memory as f32; a loop over 64-row kv tiles
// stages K and V as f32 (bf16 widened on load, which is exact) and each
// thread computes a 4 x 8 register tile of scores with f32 FMAs, so every
// shared-memory read feeds ~10 FMAs.  The 8 threads of a row group are
// lanes of one warp: row max and row sum are warp shuffles, and P goes
// through a warp-private patch of shared memory (only __syncwarp) into the
// P.V product, whose 4 x hd/8 accumulator tile each thread keeps in
// registers.  No TF32, no fast-math intrinsics: expf, an IEEE divide, P
// kept in f32 for P.V as in the reference.
//
// Both kernels launch on the caller's stream, allocate nothing and return
// a cudaError_t so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace flash {

constexpr int kBlockQ = 64;        // query rows per CTA
constexpr int kBlockK = 64;        // key rows per shared-memory tile
constexpr int kThreads = 128;      // 4 warps; warp w owns rows 16w..16w+15
constexpr int kRows = 4;           // rows of a thread's tile
constexpr int kCols = 8;           // threads sharing a row group (one warp)
constexpr int kLdP = kBlockK + 4;  // row stride of P in shared memory
constexpr float kNegInf = -1e30f;
static_assert(kBlockQ == kBlockK, "load_tile stages both blocks");
static_assert(kThreads / 32 * (32 / kCols) * kRows == kBlockQ,
              "the threads' row tiles cover the query block");

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// 64 rows of one head (row r at src + r * stride) into shared memory as f32
// with row stride HD + 4; rows at or past n_valid are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t stride, int n_valid,
                                          float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int c = threadIdx.x; c < kBlockK * kPerRow; c += kThreads) {
    const int row = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    float vals[kVec];
    if (row < n_valid) {
      load16(src + row * stride + col, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
    float* d = dst + row * (HD + 4) + col;
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      *reinterpret_cast<float4*>(d + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
    }
  }
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * ((kBlockQ + 2 * kBlockK) * (HD + 4) + kBlockQ * kLdP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_bh,
                 int n_heads, int n_kv, int sq, int sk, int sk_pad,
                 int causal, int window, float scale) {
  constexpr int kLd = HD + 4;
  constexpr int kOut = HD / kCols;  // output columns of a thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBlockQ * kLd;
  float* v_s = k_s + kBlockK * kLd;
  float* p_s = v_s + kBlockK * kLd;

  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = qb * kBlockQ;
  const int q_rows = min(kBlockQ, sq - q0);
  const int64_t q_stride = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * sq + q0) * q_stride +
                        static_cast<int64_t>(h) * HD;
  const T* k_head = k + static_cast<int64_t>(b) * sk * kv_stride +
                    static_cast<int64_t>(kvh) * HD;
  const T* v_head = v + static_cast<int64_t>(b) * sk * kv_stride +
                    static_cast<int64_t>(kvh) * HD;

  // the kv positions this CTA visits: the union of its rows' bands, or the
  // whole padded K/V when a row has no live key (see the note above)
  const bool windowed = window > 0;
  const int q_last = q0 + q_rows - 1;
  int k_lo = 0;
  int k_hi;
  if (windowed && q_last >= sk + window - 1) {
    k_hi = sk_pad;
  } else {
    k_hi = causal ? min(sk, q_last + 1) : sk;
    if (windowed) k_lo = max(0, q0 - window + 1);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (warp * (32 / kCols) + lane / kCols) * kRows;
  const int cg = lane % kCols;

  load_tile<T, HD>(q + q_off, q_stride, q_rows, q_s);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kBlockK) * kBlockK; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K, V and P are read
    const int n_valid = min(kBlockK, sk - k0);
    const int64_t off = static_cast<int64_t>(max(0, min(k0, sk - 1))) *
                        kv_stride;
    load_tile<T, HD>(k_head + off, kv_stride, n_valid, k_s);
    load_tile<T, HD>(v_head + off, kv_stride, n_valid, v_s);
    __syncthreads();

    // scores of rows r0.., columns cg + 8 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(q_s + (r0 + i) * kLd + d);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(
            k_s + (cg + kCols * j) * kLd + d);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float t = fmaf(qv[i].x, kv[j].x, s[i][j]);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          s[i][j] = fmaf(qv[i].w, kv[j].w, t);
        }
      }
    }

    // mask, online softmax, P into this warp's rows of p_s
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + cg + kCols * j;
        bool live = k_pos < sk;
        if (causal) live = live && k_pos <= q_pos;
        if (windowed) live = live && k_pos > q_pos - window;
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < kCols; w <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        p_s[(r0 + i) * kLdP + cg + kCols * j] = s[i][j];
      }
#pragma unroll
      for (int w = 1; w < kCols; w <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncwarp();

    // acc += P V: this thread's columns cg * kOut ..
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(p_s + (r0 + i) * kLdP + kk);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = v_s + (kk + t) * kLd + cg * kOut;
        float vv[kOut];
        if constexpr (kOut % 4 == 0) {
#pragma unroll
          for (int c = 0; c < kOut; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = x.x;
            vv[c + 1] = x.y;
            vv[c + 2] = x.z;
            vv[c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < kOut; c += 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + c);
            vv[c] = x.x;
            vv[c + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = t == 0 ? pv[i].x
                          : t == 1 ? pv[i].y
                          : t == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int c = 0; c < kOut; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = o + q_off + (r0 + i) * q_stride + cg * kOut;
#pragma unroll
    for (int c = 0; c < kOut; ++c) store(dst + c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int sq, int sk, int n_heads, int n_kv,
                   int causal, int window, int sk_pad, float scale,
                   cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int n_bh = batch * n_heads;
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  const dim3 grid(static_cast<unsigned>(n_qb) * n_bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_bh, n_heads, n_kv, sq,
      sk, sk_pad, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int batch, int sq, int sk, int n_heads,
                     int n_kv, int causal, int window, int sk_pad,
                     float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal,
                           window, sk_pad, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal,
                           window, sk_pad, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal,
                           window, sk_pad, scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal,
                           window, sk_pad, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, sq, sk, n_heads, n_kv,
                            causal, window, sk_pad, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, batch, sq, sk, n_heads, n_kv,
                            causal, window, sk_pad, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash

extern "C" {

// dtype 0: float32, 1: bfloat16; window <= 0: no window; sk_pad: Sk rounded
// up to the reference's kv block (a multiple of 64).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int dtype, int hd, int batch, int sq,
                            int sk, int n_heads, int n_kv, int causal,
                            int window, int sk_pad, float scale,
                            cudaStream_t stream) {
  if (dtype == 0) {
    return static_cast<int>(flash::dispatch<float>(
        hd, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, sk_pad,
        scale, stream));
  }
  if (dtype == 1) {
    return static_cast<int>(flash::dispatch<__nv_bfloat16>(
        hd, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, sk_pad,
        scale, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 only; hd 64, 80, 128 or 256; the same arguments otherwise.
int flash_attention_forward_wgmma(const void* q, const void* k, const void* v,
                                  void* o, int hd, int batch, int sq, int sk,
                                  int n_heads, int n_kv, int causal,
                                  int window, int sk_pad, float scale,
                                  cudaStream_t stream) {
  switch (hd) {
    case 64:
      return static_cast<int>(flash_wgmma::launch<64>(
          q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, sk_pad,
          scale, stream));
    case 80:
      return static_cast<int>(flash_wgmma::launch<80>(
          q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, sk_pad,
          scale, stream));
    case 128:
      return static_cast<int>(flash_wgmma::launch<128>(
          q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, sk_pad,
          scale, stream));
    case 256:
      return static_cast<int>(flash_wgmma::launch<256>(
          q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, sk_pad,
          scale, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
