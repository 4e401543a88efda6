// Packed RBD step kernels for Hopper (sm_90a): the two launches of one
// optimizer step, the K-worker apply of independent bases, the B-adapter
// apply of multi-tenant serving, plus a debug entry that writes one basis
// tile.
//
//   rbd_project_packed        replaces repro/kernels/rbd_step.py:
//                             project_packed -> _project_kernel
//   rbd_reconstruct_apply_packed
//                             replaces repro/kernels/rbd_step.py:
//                             reconstruct_apply_packed -> _recon_apply_kernel
//   rbd_reconstruct_apply_packed_workers
//                             replaces repro/kernels/rbd_step.py:
//                             reconstruct_apply_packed_workers ->
//                             _recon_apply_kernel over the worker tables
//   rbd_reconstruct_apply_packed_adapters
//                             replaces repro/kernels/rbd_step.py:
//                             reconstruct_apply_packed_adapters ->
//                             _adapter_recon_kernel
//   rbd_project_packed_sharded
//                             replaces repro/kernels/rbd_step.py:
//                             project_packed_sharded -> _project_kernel
//                             over one shard's tile tables
//   rbd_reconstruct_apply_packed_sharded
//                             replaces repro/kernels/rbd_step.py:
//                             reconstruct_apply_packed_sharded ->
//                             _recon_apply_kernel over one shard's tables
//   rbd_reconstruct_apply_packed_workers_sharded
//                             replaces repro/kernels/rbd_step.py:
//                             reconstruct_apply_packed_workers_sharded ->
//                             _recon_apply_kernel over one shard's worker
//                             tables
//   rbd_generate_tile         debug: bits and samples of one tile
//
// Bound on this card.  Both kernels regenerate every basis value they use:
// per value one Threefry-2x32-20 (about 75 integer instructions: 20 x
// add/funnel-shift/xor plus the key injections and counter set-up) and, for
// the normal distribution, a Box-Muller step (two uniforms, logf, sqrtf,
// cosf: about 60 more, mostly FP32 and SFU).  The bytes are one read of the
// gradient or of theta and one write of the output, 4 bytes per parameter
// against (coordinates per segment) x 8 generated values per parameter, so
// the kernels are bound by instruction issue, not by memory: at full
// qwen2-0.5b width a launch generates about 4.5e10 values (K times that in
// the K-worker apply, whose bytes stay those of one theta read and write;
// B times that in the B-adapter apply, which reads theta once and writes
// B rows of 4 bytes per parameter -- still far below the generation work).
//
// What the design does about it: every value is generated exactly once per
// launch, in registers, and consumed at once (a fused multiply-add into the
// coordinate or theta accumulator); nothing of the basis touches memory.
// Columns past a segment's size are not generated at all.  The contraction
// uses FP32 FMAs on the CUDA cores (no tensor cores, no TF32): the product
// is GEMV-shaped and generation dominates.  Making generation cheaper
// (instruction count, occupancy, the Box-Muller transcendentals) is later
// work.
//
// Segment lookup: the kernels read only per-segment tables (size, padded
// size, padded dim, parameter and coordinate offsets, seeds) and a prefix
// sum of CUDA blocks per segment; each block finds its segment by binary
// search.  No per-tile table exists on the device.
//
// Model-sharded slabs: a rank of a model group of m holds the slab of
// pos-blocks [blk_lo, blk_lo + bps) of the zero-padded packed buffer.  The
// sharded kernels are new shells over the same helpers, so the unsharded
// kernels above keep their instruction sequences: the projection sweeps the
// unsharded chunk grid restricted to the chunks that meet the slab, each
// chunk clipped to it, and writes a PARTIAL (u, sq) that one sum over the
// model group completes; the applies run one CUDA block per slab pos-block
// with the unsharded kernels' per-block body, so each slab is bit-identical
// to the matching slice of the unsharded output.  Each shard generates
// only its own positions' values: the m slabs together generate one pass.
//
// Determinism: no float atomics.  Every sum runs in a fixed order, so two
// launches on the same inputs give bit-identical outputs.
//
// Kernels launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rbd_common.cuh"

namespace rbd {

// Index of the segment owning CUDA block `bid`: the largest s with
// prefix[s] <= bid (prefix has n_seg + 1 entries, prefix[0] == 0).
__device__ __forceinline__ int find_segment(const int64_t* prefix, int n_seg,
                                            int64_t bid) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= bid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Kernel 1: u = P g and sq = sum P^2 for every segment's 8-direction
// coordinate blocks.  One CUDA block owns one (segment, dir-block, chunk)
// triple: it finds its segment, project_sums sweeps `pos_chunk`
// consecutive pos-blocks of the segment, and in project_store the last
// block of the (segment, dir-block) to finish writes the 8 coordinates
// and 8 squared norms.
template <int DIST>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ g, const uint32_t* __restrict__ seed,
               const int64_t* __restrict__ size,
               const int64_t* __restrict__ param_off,
               const int64_t* __restrict__ coord_off,
               const int32_t* __restrict__ n_chunk,
               const int64_t* __restrict__ blocks, int n_seg, int pos_block,
               int pos_chunk, float* __restrict__ partial,
               int32_t* __restrict__ arrived, float* __restrict__ u,
               float* __restrict__ sq) {
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t local = bid - blocks[s];
  const int nch = n_chunk[s];
  const int di = static_cast<int>(local / nch);
  const int chunk = static_cast<int>(local % nch);
  const int64_t q = size[s];
  // columns at or beyond the segment's size are masked: not generated,
  // contributing zero to both u and sq
  const int64_t c0 = static_cast<int64_t>(chunk) * pos_chunk * pos_block;
  const int64_t c_end = c0 + static_cast<int64_t>(pos_chunk) * pos_block;
  const int64_t c1 = c_end < q ? c_end : q;
  float acc[kAcc];
  project_sums<DIST>(g + param_off[s], seed[s],
                     static_cast<uint32_t>(di * kDirBlock), c0, c1, acc);
  project_store(acc, bid, chunk, nch, coord_off[s] / kDirBlock + di,
                partial, arrived, u, sq);
}

// theta value `th` at column c32 of a segment minus sum_db part_db
// (rbd_common.cuh's dir_block_part), subtracted dir-block by dir-block
// (dot first, then subtract -- the reference's association).  Shared by
// kernels 2, 3 and 4, so one worker's arithmetic is the same instruction
// sequence in each.
template <int DIST>
__device__ __forceinline__ float apply_dir_blocks(float th, uint32_t sd,
                                                  const float* sc, int n_db,
                                                  uint32_t c32) {
  for (int db = 0; db < n_db; ++db) {
    th = __fsub_rn(th, dir_block_part<DIST>(sd, sc, db, c32));
  }
  return th;
}

// Kernel 2: theta' = theta - s P for every segment.  One CUDA block owns one
// (segment, pos-block): each thread loads its theta values, loops over the
// segment's dir-blocks in order (apply_dir_blocks) and writes each value
// once.  Columns at or beyond the segment's size are copied unchanged, so
// the zero padding of a resident theta stays exactly zero.  `out` may alias
// `theta`: each block reads and writes only its own pos-block, each element
// is read before it is written by the same thread, so the in-place update
// is safe.
template <int DIST>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_kernel(const float* scale, const float* theta, float* out,
                         const uint32_t* __restrict__ seed,
                         const int64_t* __restrict__ size,
                         const int32_t* __restrict__ pdim,
                         const int64_t* __restrict__ param_off,
                         const int64_t* __restrict__ coord_off,
                         const int64_t* __restrict__ blocks, int n_seg,
                         int pos_block) {
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t pj = bid - blocks[s];
  const uint32_t sd = seed[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s];

  const int64_t c0 = pj * pos_block;
  for (int64_t col = c0 + threadIdx.x; col < c0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      th = apply_dir_blocks<DIST>(th, sd, sc, n_db,
                                  static_cast<uint32_t>(col));
    }
    out[base + col] = th;
  }
}

// Kernel 3: theta' = theta - sum_k s_k P_k over K workers' bases (packed
// independent_bases mode).  The grid is kernel 2's, one CUDA block per
// (segment, pos-block); each thread reads its theta value once, loops
// workers outer and dir-blocks inner -- worker k with its own segment seed
// seed[k * n_seg + s] and its own scale row scale[k * d_packed + ...] --
// and writes once.  That is the reference oracle's order (a scan over
// workers outside the single-worker tile scan), so the (K*d)-dimensional
// joint update never exists in memory and any K is one launch.  Padding
// columns are copied through and `out` may alias `theta`, as in kernel 2.
template <int DIST>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_workers_kernel(const float* scale, const float* theta,
                                 float* out,
                                 const uint32_t* __restrict__ seed,
                                 const int64_t* __restrict__ size,
                                 const int32_t* __restrict__ pdim,
                                 const int64_t* __restrict__ param_off,
                                 const int64_t* __restrict__ coord_off,
                                 const int64_t* __restrict__ blocks,
                                 int n_seg, int pos_block, int k_workers,
                                 int64_t d_packed) {
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t pj = bid - blocks[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s];

  const int64_t c0 = pj * pos_block;
  for (int64_t col = c0 + threadIdx.x; col < c0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      const uint32_t c32 = static_cast<uint32_t>(col);
      for (int k = 0; k < k_workers; ++k) {
        th = apply_dir_blocks<DIST>(th, seed[k * n_seg + s],
                                    sc + k * d_packed, n_db, c32);
      }
    }
    out[base + col] = th;
  }
}

// Kernel 4: B personalized rows from one shared base (multi-tenant serving),
// row a = theta - s_a P_a.  The grid is kernel 2's, one CUDA block per
// (segment, pos-block); each thread reads its theta value once and, for
// each adapter a in order, runs apply_dir_blocks from that value with
// adapter a's segment seed seed[a * n_seg + s] and scale row
// scale[a * d_packed + ...], writing out[a * q_packed + base + col].  Row a
// is thus the single-tenant instruction sequence on the same inputs: bit for
// bit kernel 2's output.  Padding columns copy theta into every row, so the
// zero padding of a resident theta stays exactly zero.  `out` (B, q_packed)
// must not alias `theta`.
template <int DIST>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_adapters_kernel(const float* __restrict__ scale,
                                  const float* __restrict__ theta,
                                  float* __restrict__ out,
                                  const uint32_t* __restrict__ seed,
                                  const int64_t* __restrict__ size,
                                  const int32_t* __restrict__ pdim,
                                  const int64_t* __restrict__ param_off,
                                  const int64_t* __restrict__ coord_off,
                                  const int64_t* __restrict__ blocks,
                                  int n_seg, int pos_block, int n_adapters,
                                  int64_t d_packed, int64_t q_packed) {
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t pj = bid - blocks[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s];

  const int64_t c0 = pj * pos_block;
  for (int64_t col = c0 + threadIdx.x; col < c0 + pos_block;
       col += kThreads) {
    const float th = theta[base + col];
    const uint32_t c32 = static_cast<uint32_t>(col);
    for (int a = 0; a < n_adapters; ++a) {
      float v = th;
      if (col < q) {
        v = apply_dir_blocks<DIST>(th, seed[a * n_seg + s], sc + a * d_packed,
                                   n_db, c32);
      }
      out[a * q_packed + base + col] = v;
    }
  }
}

// Kernel 5: the PARTIAL u and sq of one slab of the model-sharded buffer.
// The grid is kernel 1's (segment, dir-block, chunk) grid restricted to the
// n_chunk[s] chunks from chunk_lo[s] on that meet the slab; each chunk's
// columns are clipped to the slab's live columns [col_lo[s], col_hi[s]).
// A segment with no column in the slab has one empty chunk per dir-block,
// which writes zeros: every coordinate of the partial is written.  `g` is
// the (q_slab,) slab, whose first element is packed position slab_off.
template <int DIST>
__global__ void __launch_bounds__(kThreads)
project_sharded_kernel(const float* __restrict__ g,
                       const uint32_t* __restrict__ seed,
                       const int64_t* __restrict__ param_off,
                       const int64_t* __restrict__ coord_off,
                       const int64_t* __restrict__ col_lo,
                       const int64_t* __restrict__ col_hi,
                       const int32_t* __restrict__ chunk_lo,
                       const int32_t* __restrict__ n_chunk,
                       const int64_t* __restrict__ blocks, int n_seg,
                       int64_t slab_off, int pos_block, int pos_chunk,
                       float* __restrict__ partial,
                       int32_t* __restrict__ arrived, float* __restrict__ u,
                       float* __restrict__ sq) {
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t local = bid - blocks[s];
  const int nch = n_chunk[s];
  const int di = static_cast<int>(local / nch);
  const int chunk = static_cast<int>(local % nch);
  const int64_t span = static_cast<int64_t>(pos_chunk) * pos_block;
  const int64_t start = (chunk_lo[s] + chunk) * span;
  const int64_t lo = col_lo[s];
  const int64_t hi = col_hi[s];
  const int64_t c0 = start > lo ? start : lo;
  const int64_t c1 = start + span < hi ? start + span : hi;
  float acc[kAcc];
  project_sums<DIST>(g + (param_off[s] - slab_off), seed[s],
                     static_cast<uint32_t>(di * kDirBlock), c0, c1, acc);
  project_store(acc, bid, chunk, nch, coord_off[s] / kDirBlock + di,
                partial, arrived, u, sq);
}

// Kernel 6: slab' = slab - s P on one slab.  One CUDA block per slab
// pos-block b, global pos-block blk_lo + b; its segment is found in the
// unsharded apply prefix `blocks`, and the body is kernel 2's.  Blocks
// past the live buffer (the last slab's zero padding) copy theta through.
// `out` may alias `theta`, as in kernel 2.
template <int DIST>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_sharded_kernel(const float* scale, const float* theta,
                                 float* out,
                                 const uint32_t* __restrict__ seed,
                                 const int64_t* __restrict__ size,
                                 const int32_t* __restrict__ pdim,
                                 const int64_t* __restrict__ param_off,
                                 const int64_t* __restrict__ coord_off,
                                 const int64_t* __restrict__ blocks,
                                 int n_seg, int64_t blk_lo, int pos_block) {
  const int64_t gb = blk_lo + blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * pos_block;
  if (gb >= blocks[n_seg]) {
    for (int64_t i = c0 + threadIdx.x; i < c0 + pos_block; i += kThreads) {
      out[i] = theta[i];
    }
    return;
  }
  const int s = find_segment(blocks, n_seg, gb);
  const int64_t pj = gb - blocks[s];
  const uint32_t sd = seed[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s] - blk_lo * pos_block;

  const int64_t col0 = pj * pos_block;
  for (int64_t col = col0 + threadIdx.x; col < col0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      th = apply_dir_blocks<DIST>(th, sd, sc, n_db,
                                  static_cast<uint32_t>(col));
    }
    out[base + col] = th;
  }
}

// Kernel 7: slab' = slab - sum_k s_k P_k on one slab: kernel 6's window over
// kernel 3's per-thread loop (workers outer, dir-blocks inner), one launch
// for any K; each slab is bit-identical to the matching slice of kernel 3.
template <int DIST>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_workers_sharded_kernel(
    const float* scale, const float* theta, float* out,
    const uint32_t* __restrict__ seed, const int64_t* __restrict__ size,
    const int32_t* __restrict__ pdim, const int64_t* __restrict__ param_off,
    const int64_t* __restrict__ coord_off,
    const int64_t* __restrict__ blocks, int n_seg, int64_t blk_lo,
    int pos_block, int k_workers, int64_t d_packed) {
  const int64_t gb = blk_lo + blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * pos_block;
  if (gb >= blocks[n_seg]) {
    for (int64_t i = c0 + threadIdx.x; i < c0 + pos_block; i += kThreads) {
      out[i] = theta[i];
    }
    return;
  }
  const int s = find_segment(blocks, n_seg, gb);
  const int64_t pj = gb - blocks[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s] - blk_lo * pos_block;

  const int64_t col0 = pj * pos_block;
  for (int64_t col = col0 + threadIdx.x; col < col0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      const uint32_t c32 = static_cast<uint32_t>(col);
      for (int k = 0; k < k_workers; ++k) {
        th = apply_dir_blocks<DIST>(th, seed[k * n_seg + s],
                                    sc + k * d_packed, n_db, c32);
      }
    }
    out[base + col] = th;
  }
}

template <int DIST>
__global__ void generate_tile_kernel(uint32_t seed, uint32_t row0,
                                     uint32_t col0, int rows, int cols,
                                     uint32_t* b0, uint32_t* b1, float* out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * cols) return;
  const uint32_t r = row0 + static_cast<uint32_t>(idx / cols);
  const uint32_t c = col0 + static_cast<uint32_t>(idx % cols);
  uint32_t x0, x1;
  basis_bits(seed, r, c, x0, x1);
  b0[idx] = x0;
  b1[idx] = x1;
  out[idx] = bits_to_sample<DIST>(x0, x1);
}

}  // namespace rbd

extern "C" {

// `arrived` must hold d_packed / 8 zeros; `partial` n_blocks * 16 floats.
int rbd_project_packed(const float* g, const uint32_t* seed,
                       const int64_t* size, const int64_t* param_off,
                       const int64_t* coord_off, const int32_t* n_chunk,
                       const int64_t* blocks, int n_seg, int64_t n_blocks,
                       int pos_block, int pos_chunk, int dist, float* partial,
                       int32_t* arrived, float* u, float* sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH(dist, project_kernel, grid, g, seed, size, param_off,
               coord_off, n_chunk, blocks, n_seg, pos_block, pos_chunk,
               partial, arrived, u, sq);
  return static_cast<int>(cudaGetLastError());
}

int rbd_reconstruct_apply_packed(const float* scale, const float* theta,
                                 float* out, const uint32_t* seed,
                                 const int64_t* size, const int32_t* pdim,
                                 const int64_t* param_off,
                                 const int64_t* coord_off,
                                 const int64_t* blocks, int n_seg,
                                 int64_t n_blocks, int pos_block, int dist,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH(dist, reconstruct_apply_kernel, grid, scale, theta, out, seed,
               size, pdim, param_off, coord_off, blocks, n_seg, pos_block);
  return static_cast<int>(cudaGetLastError());
}

// `scale` is (k_workers, d_packed) row-major, `seed` (k_workers, n_seg).
int rbd_reconstruct_apply_packed_workers(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg,
    int64_t n_blocks, int pos_block, int k_workers, int64_t d_packed,
    int dist, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH(dist, reconstruct_apply_workers_kernel, grid, scale, theta,
               out, seed, size, pdim, param_off, coord_off, blocks, n_seg,
               pos_block, k_workers, d_packed);
  return static_cast<int>(cudaGetLastError());
}

// `scale` is (n_adapters, d_packed) row-major, `seed` (n_adapters, n_seg),
// `out` (n_adapters, q_packed) and distinct from `theta`.
int rbd_reconstruct_apply_packed_adapters(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg,
    int64_t n_blocks, int pos_block, int n_adapters, int64_t d_packed,
    int64_t q_packed, int dist, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH(dist, reconstruct_apply_adapters_kernel, grid, scale, theta,
               out, seed, size, pdim, param_off, coord_off, blocks, n_seg,
               pos_block, n_adapters, d_packed, q_packed);
  return static_cast<int>(cudaGetLastError());
}

// `g` is the (q_slab,) slab starting at packed position slab_off; `arrived`
// must hold d_packed / 8 zeros; `partial` n_blocks * 16 floats.
int rbd_project_packed_sharded(
    const float* g, const uint32_t* seed, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* col_lo, const int64_t* col_hi,
    const int32_t* chunk_lo, const int32_t* n_chunk, const int64_t* blocks,
    int n_seg, int64_t n_blocks, int64_t slab_off, int pos_block,
    int pos_chunk, int dist, float* partial, int32_t* arrived, float* u,
    float* sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH(dist, project_sharded_kernel, grid, g, seed, param_off,
               coord_off, col_lo, col_hi, chunk_lo, n_chunk, blocks, n_seg,
               slab_off, pos_block, pos_chunk, partial, arrived, u, sq);
  return static_cast<int>(cudaGetLastError());
}

// `theta`/`out` are the (bps * pos_block,) slab of pos-blocks
// [blk_lo, blk_lo + bps); `blocks` is the unsharded apply prefix.
int rbd_reconstruct_apply_packed_sharded(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg, int64_t bps,
    int64_t blk_lo, int pos_block, int dist, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(bps));
  RBD_DISPATCH(dist, reconstruct_apply_sharded_kernel, grid, scale, theta,
               out, seed, size, pdim, param_off, coord_off, blocks, n_seg,
               blk_lo, pos_block);
  return static_cast<int>(cudaGetLastError());
}

// `scale` is (k_workers, d_packed) row-major, `seed` (k_workers, n_seg).
int rbd_reconstruct_apply_packed_workers_sharded(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg, int64_t bps,
    int64_t blk_lo, int pos_block, int k_workers, int64_t d_packed, int dist,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(bps));
  RBD_DISPATCH(dist, reconstruct_apply_workers_sharded_kernel, grid, scale,
               theta, out, seed, size, pdim, param_off, coord_off, blocks,
               n_seg, blk_lo, pos_block, k_workers, d_packed);
  return static_cast<int>(cudaGetLastError());
}

int rbd_generate_tile(uint32_t seed, uint32_t row0, uint32_t col0, int rows,
                      int cols, int dist, uint32_t* b0, uint32_t* b1,
                      float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(rows) * cols;
  const dim3 grid(static_cast<unsigned>((n + rbd::kThreads - 1) /
                                        rbd::kThreads));
  RBD_DISPATCH(dist, generate_tile_kernel, grid, seed, row0, col0, rows, cols,
               b0, b1, out);
  return static_cast<int>(cudaGetLastError());
}

const char* rbd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
