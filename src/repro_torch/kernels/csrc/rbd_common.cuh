// Launch geometry, the fixed-order block reduction, the two halves of a
// projection block, the dir-block dot of the reconstructions and the
// distribution dispatch shared by the packed kernels (rbd_step.cu) and the
// per-leaf kernels (rbd_flat.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace rbd {

constexpr int kDirBlock = 8;       // directions per coordinate block
constexpr int kThreads = 256;      // threads per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 2 * kDirBlock;  // u and sq per direction

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
// .. row0 + 7 of seed `sd`.
template <int DIST>
__device__ __forceinline__ void project_sums(const float* __restrict__ gs,
                                             uint32_t sd, uint32_t row0,
                                             int64_t c0, int64_t c1,
                                             float (&acc)[kAcc]) {
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  for (int64_t col = c0 + threadIdx.x; col < c1; col += kThreads) {
    const float gv = gs[col];
    const uint32_t c32 = static_cast<uint32_t>(col);
#pragma unroll
    for (int i = 0; i < kDirBlock; ++i) {
      const float p = basis_sample<DIST>(sd, row0 + i, c32);
      acc[i] = fmaf(p, gv, acc[i]);
      acc[kDirBlock + i] = fmaf(p, p, acc[kDirBlock + i]);
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
// reconstruction and apply kernel.
template <int DIST>
__device__ __forceinline__ float dir_block_part(uint32_t sd, const float* sc,
                                                int db, uint32_t c32) {
  const uint32_t row0 = static_cast<uint32_t>(db * kDirBlock);
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < kDirBlock; ++i) {
    part = fmaf(__ldg(&sc[db * kDirBlock + i]),
                basis_sample<DIST>(sd, row0 + i, c32), part);
  }
  return part;
}

}  // namespace rbd

// Launch rbd::KERNEL<distribution> on stream `st` with kThreads threads;
// an unknown distribution code returns cudaErrorInvalidValue.
#define RBD_DISPATCH(dist, KERNEL, GRID, ...)                               \
  switch (dist) {                                                           \
    case rbd::kNormal:                                                      \
      rbd::KERNEL<rbd::kNormal><<<GRID, rbd::kThreads, 0, st>>>(__VA_ARGS__); \
      break;                                                                \
    case rbd::kUniform:                                                     \
      rbd::KERNEL<rbd::kUniform><<<GRID, rbd::kThreads, 0, st>>>(__VA_ARGS__); \
      break;                                                                \
    case rbd::kRademacher:                                                  \
      rbd::KERNEL<rbd::kRademacher><<<GRID, rbd::kThreads, 0, st>>>(        \
          __VA_ARGS__);                                                     \
      break;                                                                \
    case rbd::kSparse:                                                      \
      rbd::KERNEL<rbd::kSparse><<<GRID, rbd::kThreads, 0, st>>>(__VA_ARGS__); \
      break;                                                                \
    default:                                                                \
      return static_cast<int>(cudaErrorInvalidValue);                       \
  }
