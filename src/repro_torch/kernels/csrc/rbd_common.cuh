// Launch geometry, the fixed-order block reduction, the basis generator of
// each PRNG impl, the two halves of a projection block, the dir-block dot
// of the reconstructions and the launch dispatch shared by the packed
// kernels (rbd_step.cu) and the per-leaf kernels (rbd_flat.cu).
//
// PRNG impls (the reference's PrngSpec, repro/core/rng.py:385).  The
// kernels take the impl as a template argument, chosen at launch from the
// impl code the wrapper passes (RBD_DISPATCH), as the distribution is:
//   kThreefry    value (row, col) from Threefry on its own counter;
//   kHwEmulated  repro/core/rng.py:_hw_emulated_tile (340): the (8, PB)
//                tile at (row0, col0) of its segment is keyed by
//                hw_tile_key(seed, row0, col0), each value by its
//                within-tile index r * PB + c and its draw (one Threefry
//                per bit stream);
//   kHw          the reference's _hw_tile (348), which is the TPU's
//                hardware PRNG; here the tile-keyed Philox4x32-10 of
//                philox.cuh, one call per two rows at one column.
// The applies compute a tile's key once per CUDA block into shared memory
// (fill_tile_keys); the projection computes it once per (thread, tile)
// for hw_emulated, when a thread's column enters a new pos-block.
//
// kHw, designed for this card (the other impls keep their code paths).
// Its Philox costs ~17 instructions a value, so the work around it sets
// the pace: the hw kernels run at about 78% of issue whatever their form
// (chip_smoke.py phase 1 counts the hot loops' SASS; PERF.md, PR 19), so
// what they issue is what they take:
//   * the normal transform, 71 instructions a value through the CUDA math
//     library, runs the library's own fast paths without the code its
//     inputs never reach (threefry.cuh: hw_logf, hw_cosf, hw_sqrtf; the
//     same bits on every input): 55;
//   * the projection's tile keys: its CUDA block computes the key of
//     every pos-block of its chunk once, one thread each, and stores the
//     20 Philox round keys in shared memory (project_sums_hw), where each
//     thread had formed key and round keys at every pos-block it entered;
//   * uniforms in one FFMA (uniform01_fma, the same bits).
// The projection's loop went from 108 to 78 instructions a value, the
// apply's from 107 to 83.  A thread takes one column at a time: two
// columns of a pos-block together (one key set-up, 8 Philox chains), the
// next column's Philox rounds spread between this one's transforms, and
// 64 registers (launch bounds) all measured slower on an H100.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "threefry.cuh"

namespace rbd {

constexpr int kDirBlock = 8;       // directions per coordinate block
constexpr int kThreads = 256;      // threads per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 2 * kDirBlock;  // u and sq per direction
// tile keys a hw projection block holds, one per pos-block of its chunk
// (the launches pass pos_chunk <= kMaxTileKeys), each as its 20 Philox
// round keys
constexpr int kMaxTileKeys = 64;
constexpr int kRoundKeyWords = 2 * kPhiloxRounds;

enum Impl : int { kThreefry = 0, kHwEmulated = 1, kHw = 2 };

// Per-tile generator state: nothing for Threefry, the two key words of the
// emulated stream, the Philox round keys of hw.
template <int IMPL>
struct TileKey {
  __device__ __forceinline__ explicit TileKey(uint32_t) {}
};
template <>
struct TileKey<kHwEmulated> {
  uint32_t k0, k1;
  __device__ __forceinline__ explicit TileKey(uint32_t k)
      : k0(k), k1(k ^ kKeySalt) {}
};
template <>
struct TileKey<kHw> {
  PhiloxKey pk;
  __device__ __forceinline__ explicit TileKey(uint32_t k)
      : pk(philox_key(k, k ^ kKeySalt)) {}
};

// The 8 basis values of rows row0 .. row0 + 7 at column `col` of a segment
// with seed `sd`; `cin` is the column within its (8, pb) tile, whose key
// is in `tk` (tile-keyed impls).
template <int DIST, int IMPL>
__device__ __forceinline__ void tile_column(const TileKey<IMPL>& tk,
                                            uint32_t sd, uint32_t row0,
                                            uint32_t col, uint32_t cin,
                                            uint32_t pb,
                                            float (&p)[kDirBlock]) {
  if constexpr (IMPL == kThreefry) {
#pragma unroll
    for (int i = 0; i < kDirBlock; ++i) {
      p[i] = basis_sample<DIST>(sd, row0 + i, col);
    }
  } else if constexpr (IMPL == kHwEmulated) {
#pragma unroll
    for (int i = 0; i < kDirBlock; ++i) {
      const uint32_t idx = static_cast<uint32_t>(i) * pb + cin;
      const uint32_t b0 = emulated_bits(tk.k0, tk.k1, idx, 0u);
      const uint32_t b1 =
          kBitStreams<DIST> == 2 ? emulated_bits(tk.k0, tk.k1, idx, 1u) : 0u;
      p[i] = bits_to_sample<DIST>(b0, b1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kDirBlock / 2; ++j) {
      uint32_t w[4];
      philox4x32_10(tk.pk, cin, static_cast<uint32_t>(j), 0u, 0u, w);
      p[2 * j] = bits_to_sample<DIST, true>(w[0], w[1]);
      p[2 * j + 1] = bits_to_sample<DIST, true>(w[2], w[3]);
    }
  }
}

// hw: the 8 values at within-tile column cin of the tile whose round keys
// are at rk (shared memory), as tile_column's kHw branch computes them.
template <int DIST>
__device__ __forceinline__ void hw_column(const uint32_t* rk, uint32_t cin,
                                          float (&p)[kDirBlock]) {
  uint32_t w[4][4];
  philox_start(cin, w);
  philox_rounds<0, kPhiloxRounds>(rk, w);
#pragma unroll
  for (int j = 0; j < kDirBlock / 2; ++j) {
    p[2 * j] = bits_to_sample<DIST, true>(w[j][0], w[j][1]);
    p[2 * j + 1] = bits_to_sample<DIST, true>(w[j][2], w[j][3]);
  }
}

// Tile keys of one apply block: keys[k * n_db + db] = hw_tile_key(seed[k *
// stride], db * 8, col0) for the n_groups seeds (workers or adapters) of
// the block's segment and its pos-block at within-segment column col0.
// Nothing for Threefry.  Every thread of the block must call it.
template <int IMPL>
__device__ __forceinline__ void fill_tile_keys(uint32_t* keys,
                                               const uint32_t* seed,
                                               int64_t stride, int n_groups,
                                               int n_db, uint32_t col0) {
  if constexpr (IMPL != kThreefry) {
    for (int i = threadIdx.x; i < n_groups * n_db; i += kThreads) {
      const int k = i / n_db;
      const int db = i - k * n_db;
      keys[i] = hw_tile_key(seed[k * stride],
                            static_cast<uint32_t>(db * kDirBlock), col0);
    }
    __syncthreads();
  }
}

// Fixed-order sum over the block of each of the kAcc accumulators: a
// shuffle tree within each warp, then the warp totals in warp order.
// Afterwards thread k (k < kAcc) holds the block total of accumulator k in
// acc[0].
__device__ __forceinline__ void block_sum(float (&acc)[kAcc],
                                          float (&smem)[kAcc][kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) smem[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += smem[threadIdx.x][w];
    acc[0] = t;  // thread k holds the block total of accumulator k
  }
}

// One CUDA block of a projection, in two halves that the packed
// (rbd_step.cu) and per-leaf (rbd_flat.cu) projection kernels both call --
// they differ only in how they find the arguments, so equal arguments give
// equal bits.  The packed kernel works out its coordinate block between
// the halves: worked out before the column loop, the index and the table
// load behind it stay live across the loop, which made it about 2.5%
// slower on an H100.
//
// project_sums: this thread's sums of p * g and p * p over its columns of
// [c0, c1) of the compartment's gradient `gs`, for the 8 basis rows row0
// .. row0 + 7 of seed `sd`, in (8, pb) tiles.  With DBUF the next column's
// 8 values and gradient are generated and loaded before the FMAs of the
// current one (the reference's two-slot _buffered_tile, rbd_step.py:68, as
// a register pipeline); the sums keep their order, so the result is
// bit-identical either way.  No value is generated past c1.
//
// kHw (project_sums_hw): the block first writes the round keys of every
// pos-block that meets [c0, c1) into shared memory, one thread a
// pos-block (c0 may start inside one: the sharded projection's slab
// edge); each thread then reads its column's from there.  Every thread of
// the block must call it (it synchronizes once).
template <int DIST, bool DBUF>
__device__ __forceinline__ void project_sums_hw(const float* __restrict__ gs,
                                                uint32_t sd, uint32_t row0,
                                                int64_t c0, int64_t c1,
                                                uint32_t pb,
                                                float (&acc)[kAcc]) {
  __shared__ __align__(16) uint32_t rks[kMaxTileKeys * kRoundKeyWords];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  const int64_t first = c0 / pb;  // the block's first pos-block
  const int n_tiles =
      c1 > c0 ? static_cast<int>((c1 - 1) / pb - first) + 1 : 0;
  for (int i = threadIdx.x; i < n_tiles; i += kThreads) {
    const uint32_t k =
        hw_tile_key(sd, row0, static_cast<uint32_t>((first + i) * pb));
    philox_store_round_keys(k, k ^ kKeySalt, rks + i * kRoundKeyWords);
  }
  __syncthreads();
  // the next column to generate: its place in its pos-block and the
  // pos-block's index in rks
  int64_t col = c0 + threadIdx.x;
  const int64_t rel = col - first * pb;
  int ti = static_cast<int>(rel / pb);
  uint32_t cin = static_cast<uint32_t>(rel - static_cast<int64_t>(ti) * pb);
  auto gen = [&](float (&p)[kDirBlock]) {
    hw_column<DIST>(rks + ti * kRoundKeyWords, cin, p);
    cin += kThreads;
    while (cin >= pb) {
      cin -= pb;
      ++ti;
    }
  };
  auto fma_column = [&](float gv, const float (&p)[kDirBlock]) {
#pragma unroll
    for (int i = 0; i < kDirBlock; ++i) {
      acc[i] = fmaf(p[i], gv, acc[i]);
      acc[kDirBlock + i] = fmaf(p[i], p[i], acc[kDirBlock + i]);
    }
  };
  if constexpr (!DBUF) {
    for (; col < c1; col += kThreads) {
      const float gv = gs[col];
      float p[kDirBlock];
      gen(p);
      fma_column(gv, p);
    }
  } else {
    float p[kDirBlock];
    float gv = 0.0f;
    if (col < c1) {
      gv = gs[col];
      gen(p);
    }
    for (; col < c1; col += kThreads) {
      float pn[kDirBlock];
      float gn = 0.0f;
      if (col + kThreads < c1) {
        gn = gs[col + kThreads];
        gen(pn);
      }
      fma_column(gv, p);
#pragma unroll
      for (int i = 0; i < kDirBlock; ++i) p[i] = pn[i];
      gv = gn;
    }
  }
}

template <int DIST, int IMPL, bool DBUF>
__device__ __forceinline__ void project_sums(const float* __restrict__ gs,
                                             uint32_t sd, uint32_t row0,
                                             int64_t c0, int64_t c1,
                                             uint32_t pb,
                                             float (&acc)[kAcc]) {
  if constexpr (IMPL == kHw) {
    project_sums_hw<DIST, DBUF>(gs, sd, row0, c0, c1, pb, acc);
    return;
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  TileKey<IMPL> tk(0u);
  uint32_t tile0 = 0u;
  bool keyed = false;
  // the values of column `col`, the tile key renewed when it enters a
  // new pos-block
  auto gen = [&](int64_t col, float (&p)[kDirBlock]) {
    const uint32_t c32 = static_cast<uint32_t>(col);
    if constexpr (IMPL != kThreefry) {
      if (!keyed || c32 - tile0 >= pb) {
        tile0 = c32 - c32 % pb;
        tk = TileKey<IMPL>(hw_tile_key(sd, row0, tile0));
        keyed = true;
      }
    }
    tile_column<DIST, IMPL>(tk, sd, row0, c32, c32 - tile0, pb, p);
  };
  auto fma_column = [&](float gv, const float (&p)[kDirBlock]) {
#pragma unroll
    for (int i = 0; i < kDirBlock; ++i) {
      acc[i] = fmaf(p[i], gv, acc[i]);
      acc[kDirBlock + i] = fmaf(p[i], p[i], acc[kDirBlock + i]);
    }
  };
  int64_t col = c0 + threadIdx.x;
  if constexpr (IMPL == kThreefry && !DBUF) {
    // each value generated right before its two FMAs: the order ptxas
    // schedules best (about 1.5% faster on an H100 than generating the 8
    // values first)
    for (; col < c1; col += kThreads) {
      const float gv = gs[col];
      const uint32_t c32 = static_cast<uint32_t>(col);
#pragma unroll
      for (int i = 0; i < kDirBlock; ++i) {
        const float p = basis_sample<DIST>(sd, row0 + i, c32);
        acc[i] = fmaf(p, gv, acc[i]);
        acc[kDirBlock + i] = fmaf(p, p, acc[kDirBlock + i]);
      }
    }
  } else if constexpr (!DBUF) {
    for (; col < c1; col += kThreads) {
      const float gv = gs[col];
      float p[kDirBlock];
      gen(col, p);
      fma_column(gv, p);
    }
  } else {
    float p[kDirBlock];
    float gv = 0.0f;
    if (col < c1) {
      gv = gs[col];
      gen(col, p);
    }
    for (; col < c1; col += kThreads) {
      const int64_t nxt = col + kThreads;
      float pn[kDirBlock];
      float gn = 0.0f;
      if (nxt < c1) {
        gn = gs[nxt];
        gen(nxt, pn);
      }
      fma_column(gv, p);
#pragma unroll
      for (int i = 0; i < kDirBlock; ++i) p[i] = pn[i];
      gv = gn;
    }
  }
}

// project_store: the block's sums in a fixed order (block_sum), stored as
// block `bid`'s 16 partials.  The last of the `nch` chunk blocks of
// coordinate block `cblk` to arrive -- found with a __threadfence and the
// integer counter arrived[cblk] -- adds the partials of blocks bid - chunk
// .. bid - chunk + nch - 1 in chunk order and writes u and sq at cblk * 8.
__device__ __forceinline__ void project_store(
    float (&acc)[kAcc], int64_t bid, int chunk, int nch, int64_t cblk,
    float* __restrict__ partial, int32_t* __restrict__ arrived,
    float* __restrict__ u, float* __restrict__ sq) {
  __shared__ float smem[kAcc][kWarps];
  __shared__ bool is_last;

  block_sum(acc, smem);
  if (threadIdx.x < kAcc) {
    partial[bid * kAcc + threadIdx.x] = acc[0];
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = (atomicAdd(&arrived[cblk], 1) == nch - 1);
  }
  __syncthreads();
  if (is_last && threadIdx.x < kAcc) {
    __threadfence();
    const int64_t first = bid - chunk;  // block of chunk 0
    float t = 0.0f;
    for (int c = 0; c < nch; ++c) {
      t += __ldcg(&partial[(first + c) * kAcc + threadIdx.x]);
    }
    const int k = threadIdx.x;
    if (k < kDirBlock) {
      u[cblk * kDirBlock + k] = t;
    } else {
      sq[cblk * kDirBlock + (k - kDirBlock)] = t;
    }
  }
}

// part_db = sum_{i<8} sc_{db*8+i} P_{db*8+i, c32}, formed in row order with
// FMAs: dir-block db's contribution at one position, shared by every
// reconstruction and apply kernel.  `key` is the tile key of (db, the
// position's pos-block) for the tile-keyed impls, `cin` the position
// within that pos-block of width pb.
__device__ __forceinline__ float dot_dir_block(const float* sc, int db,
                                               const float (&p)[kDirBlock]) {
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < kDirBlock; ++i) {
    part = fmaf(__ldg(&sc[db * kDirBlock + i]), p[i], part);
  }
  return part;
}

template <int DIST, int IMPL>
__device__ __forceinline__ void dir_block_values(uint32_t sd, uint32_t key,
                                                 int db, uint32_t c32,
                                                 uint32_t cin, uint32_t pb,
                                                 float (&p)[kDirBlock]) {
  tile_column<DIST, IMPL>(TileKey<IMPL>(key), sd,
                          static_cast<uint32_t>(db * kDirBlock), c32, cin,
                          pb, p);
}

template <int DIST, int IMPL>
__device__ __forceinline__ float dir_block_part(uint32_t sd, uint32_t key,
                                                const float* sc, int db,
                                                uint32_t c32, uint32_t cin,
                                                uint32_t pb) {
  if constexpr (IMPL == kThreefry) {
    // each value generated right before its FMA, as in project_sums
    const uint32_t row0 = static_cast<uint32_t>(db * kDirBlock);
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < kDirBlock; ++i) {
      part = fmaf(__ldg(&sc[db * kDirBlock + i]),
                  basis_sample<DIST>(sd, row0 + i, c32), part);
    }
    return part;
  } else {
    float p[kDirBlock];
    dir_block_values<DIST, IMPL>(sd, key, db, c32, cin, pb, p);
    return dot_dir_block(sc, db, p);
  }
}

// The smem key of dir-block db (0 for Threefry, which reads none).
template <int IMPL>
__device__ __forceinline__ uint32_t key_of(const uint32_t* keys, int db) {
  if constexpr (IMPL == kThreefry) {
    return 0u;
  } else {
    return keys[db];
  }
}

// Launch `kernel` on `st` with kThreads threads and `smem` bytes of dynamic
// shared memory (raising the kernel's limit above 48 KB first); returns
// the launch's error code.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rbd

// Return the launch of rbd::KERNEL<distribution, impl> on stream `st`; an
// unknown distribution or impl code returns cudaErrorInvalidValue.
#define RBD_DISPATCH(impl, dist, KERNEL, GRID, SMEM, ...)                   \
  RBD_SWITCH_IMPL(impl, dist, KERNEL, (), GRID, SMEM, __VA_ARGS__)

// The same with the double-buffer flag `dbuf` as KERNEL's third template
// argument.
#define RBD_DISPATCH_DB(impl, dist, dbuf, KERNEL, GRID, SMEM, ...)          \
  if (dbuf) {                                                               \
    RBD_SWITCH_IMPL(impl, dist, KERNEL, (, true), GRID, SMEM, __VA_ARGS__)  \
  } else {                                                                  \
    RBD_SWITCH_IMPL(impl, dist, KERNEL, (, false), GRID, SMEM, __VA_ARGS__) \
  }

// Helpers of the two above: TAIL is the parenthesised rest of KERNEL's
// template arguments after the impl, e.g. `(, true)`.
#define RBD_UNPAREN(...) __VA_ARGS__

#define RBD_SWITCH_IMPL(impl, dist, KERNEL, TAIL, GRID, SMEM, ...)          \
  switch (impl) {                                                           \
    case rbd::kThreefry:                                                    \
      RBD_SWITCH_DIST(dist, KERNEL, (rbd::kThreefry RBD_UNPAREN TAIL), GRID, \
                      SMEM, __VA_ARGS__)                                    \
    case rbd::kHwEmulated:                                                  \
      RBD_SWITCH_DIST(dist, KERNEL, (rbd::kHwEmulated RBD_UNPAREN TAIL),    \
                      GRID, SMEM, __VA_ARGS__)                              \
    case rbd::kHw:                                                          \
      RBD_SWITCH_DIST(dist, KERNEL, (rbd::kHw RBD_UNPAREN TAIL), GRID,      \
                      SMEM, __VA_ARGS__)                                    \
    default:                                                                \
      return static_cast<int>(cudaErrorInvalidValue);                       \
  }

#define RBD_SWITCH_DIST(dist, KERNEL, TARGS, GRID, SMEM, ...)               \
  switch (dist) {                                                           \
    case rbd::kNormal:                                                      \
      return rbd::launch(rbd::KERNEL<rbd::kNormal, RBD_UNPAREN TARGS>,      \
                         GRID, SMEM, st, __VA_ARGS__);                      \
    case rbd::kUniform:                                                     \
      return rbd::launch(rbd::KERNEL<rbd::kUniform, RBD_UNPAREN TARGS>,     \
                         GRID, SMEM, st, __VA_ARGS__);                      \
    case rbd::kRademacher:                                                  \
      return rbd::launch(rbd::KERNEL<rbd::kRademacher, RBD_UNPAREN TARGS>,  \
                         GRID, SMEM, st, __VA_ARGS__);                      \
    case rbd::kSparse:                                                      \
      return rbd::launch(rbd::KERNEL<rbd::kSparse, RBD_UNPAREN TARGS>,      \
                         GRID, SMEM, st, __VA_ARGS__);                      \
    default:                                                                \
      return static_cast<int>(cudaErrorInvalidValue);                       \
  }
