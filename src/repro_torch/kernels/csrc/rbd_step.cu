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
//   rbd_hw_transform_mismatches
//                             debug: hw's normal transform against the
//                             CUDA math library on every input
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
// PRNG impls and the two-slot schedule.  Every kernel takes the impl as a
// template argument, chosen at launch (RBD_DISPATCH, rbd_common.cuh):
// Threefry, the reference's hw_emulated stub and the port's hw (tile-keyed
// Philox4x32-10).  The tile-keyed impls key each (8, pos_block) tile by
// (seed, row0, col0) WITHIN its segment -- slab boundaries fall on
// pos-blocks, so the sharded kernels see the same tiles.  The applies
// compute the keys once per CUDA block into dynamic shared memory (K or B
// groups x the segment's dir-blocks, 4 bytes each); the hw projection
// writes the 20 round keys of each pos-block of its chunk into static
// shared memory once per CUDA block (5 KB), hw_emulated's once per
// (thread, tile).  hw's instances are designed for this card
// (rbd_common.cuh's header): Philox ~18 SASS instructions a value and the
// normal transform's library fast paths ~55, ~77 a value in all, against
// ~140 for Threefry's; hw_emulated draws one Threefry per bit stream (two
// for normal and sparse).  Kernels 1-3 and 5-7 take the reference's
// double_buffer flag (_buffered_tile, repro/kernels/rbd_step.py:68) as a
// template argument: the next column's (projection) or next dir-block's
// (applies) 8 values are generated into a second register set before the
// FMAs of the current one.  The sums keep their order, so both settings
// give the same bits; nothing is generated past the last column or
// dir-block.  On this card the unbuffered instances are the faster for
// every impl, and the wrappers' auto rule takes them.
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
template <int DIST, int IMPL, bool DBUF>
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
  project_sums<DIST, IMPL, DBUF>(g + param_off[s], seed[s],
                                 static_cast<uint32_t>(di * kDirBlock), c0,
                                 c1, static_cast<uint32_t>(pos_block), acc);
  project_store(acc, bid, chunk, nch, coord_off[s] / kDirBlock + di,
                partial, arrived, u, sq);
}

// theta value `th` at column c32 of a segment minus sum_db part_db
// (rbd_common.cuh's dir_block_part), subtracted dir-block by dir-block
// (dot first, then subtract -- the reference's association).  `keys` are
// the segment's tile keys of this pos-block, one per dir-block, `cin` the
// column within it.  Shared by kernels 2-4 and 6-7, so one worker's
// arithmetic is the same instruction sequence in each.  With DBUF dir-block
// db + 1's values are generated before dir-block db's dot.
template <int DIST, int IMPL, bool DBUF>
__device__ __forceinline__ float apply_dir_blocks(float th, uint32_t sd,
                                                  const uint32_t* keys,
                                                  const float* sc, int n_db,
                                                  uint32_t c32, uint32_t cin,
                                                  uint32_t pb) {
  if constexpr (!DBUF) {
    for (int db = 0; db < n_db; ++db) {
      th = __fsub_rn(th, dir_block_part<DIST, IMPL>(
                             sd, key_of<IMPL>(keys, db), sc, db, c32, cin,
                             pb));
    }
  } else {
    float p[kDirBlock];
    dir_block_values<DIST, IMPL>(sd, key_of<IMPL>(keys, 0), 0, c32, cin, pb,
                                 p);
    for (int db = 0; db < n_db; ++db) {
      float pn[kDirBlock];
      if (db + 1 < n_db) {
        dir_block_values<DIST, IMPL>(sd, key_of<IMPL>(keys, db + 1), db + 1,
                                     c32, cin, pb, pn);
      }
      th = __fsub_rn(th, dot_dir_block(sc, db, p));
#pragma unroll
      for (int i = 0; i < kDirBlock; ++i) p[i] = pn[i];
    }
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
template <int DIST, int IMPL, bool DBUF>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_kernel(const float* scale, const float* theta, float* out,
                         const uint32_t* __restrict__ seed,
                         const int64_t* __restrict__ size,
                         const int32_t* __restrict__ pdim,
                         const int64_t* __restrict__ param_off,
                         const int64_t* __restrict__ coord_off,
                         const int64_t* __restrict__ blocks, int n_seg,
                         int pos_block) {
  extern __shared__ uint32_t keys[];
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t pj = bid - blocks[s];
  const uint32_t sd = seed[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s];

  const int64_t c0 = pj * pos_block;
  fill_tile_keys<IMPL>(keys, seed + s, 0, 1, n_db, static_cast<uint32_t>(c0));
  for (int64_t col = c0 + threadIdx.x; col < c0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      th = apply_dir_blocks<DIST, IMPL, DBUF>(
          th, sd, keys, sc, n_db, static_cast<uint32_t>(col),
          static_cast<uint32_t>(col - c0), static_cast<uint32_t>(pos_block));
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
template <int DIST, int IMPL, bool DBUF>
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
  extern __shared__ uint32_t keys[];
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t pj = bid - blocks[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s];

  const int64_t c0 = pj * pos_block;
  fill_tile_keys<IMPL>(keys, seed + s, n_seg, k_workers, n_db,
                       static_cast<uint32_t>(c0));
  for (int64_t col = c0 + threadIdx.x; col < c0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      const uint32_t c32 = static_cast<uint32_t>(col);
      for (int k = 0; k < k_workers; ++k) {
        th = apply_dir_blocks<DIST, IMPL, DBUF>(
            th, seed[k * n_seg + s], keys + k * n_db, sc + k * d_packed,
            n_db, c32, static_cast<uint32_t>(col - c0),
            static_cast<uint32_t>(pos_block));
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
// bit kernel 2's output (unbuffered; the reference's adapter kernel takes
// no double_buffer).  Padding columns copy theta into every row, so the
// zero padding of a resident theta stays exactly zero.  `out` (B, q_packed)
// must not alias `theta`.
template <int DIST, int IMPL>
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
  extern __shared__ uint32_t keys[];
  const int64_t bid = blockIdx.x;
  const int s = find_segment(blocks, n_seg, bid);
  const int64_t pj = bid - blocks[s];
  const int64_t q = size[s];
  const int n_db = pdim[s] / kDirBlock;
  const float* sc = scale + coord_off[s];
  const int64_t base = param_off[s];

  const int64_t c0 = pj * pos_block;
  fill_tile_keys<IMPL>(keys, seed + s, n_seg, n_adapters, n_db,
                       static_cast<uint32_t>(c0));
  for (int64_t col = c0 + threadIdx.x; col < c0 + pos_block;
       col += kThreads) {
    const float th = theta[base + col];
    const uint32_t c32 = static_cast<uint32_t>(col);
    for (int a = 0; a < n_adapters; ++a) {
      float v = th;
      if (col < q) {
        v = apply_dir_blocks<DIST, IMPL, false>(
            th, seed[a * n_seg + s], keys + a * n_db, sc + a * d_packed, n_db,
            c32, static_cast<uint32_t>(col - c0),
            static_cast<uint32_t>(pos_block));
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
// Columns stay within-segment, so the tiles are kernel 1's.
template <int DIST, int IMPL, bool DBUF>
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
  project_sums<DIST, IMPL, DBUF>(g + (param_off[s] - slab_off), seed[s],
                                 static_cast<uint32_t>(di * kDirBlock), c0,
                                 c1, static_cast<uint32_t>(pos_block), acc);
  project_store(acc, bid, chunk, nch, coord_off[s] / kDirBlock + di,
                partial, arrived, u, sq);
}

// Kernel 6: slab' = slab - s P on one slab.  One CUDA block per slab
// pos-block b, global pos-block blk_lo + b; its segment is found in the
// unsharded apply prefix `blocks`, and the body is kernel 2's.  Blocks
// past the live buffer (the last slab's zero padding) copy theta through.
// `out` may alias `theta`, as in kernel 2.
template <int DIST, int IMPL, bool DBUF>
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
  extern __shared__ uint32_t keys[];
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
  fill_tile_keys<IMPL>(keys, seed + s, 0, 1, n_db,
                       static_cast<uint32_t>(col0));
  for (int64_t col = col0 + threadIdx.x; col < col0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      th = apply_dir_blocks<DIST, IMPL, DBUF>(
          th, sd, keys, sc, n_db, static_cast<uint32_t>(col),
          static_cast<uint32_t>(col - col0),
          static_cast<uint32_t>(pos_block));
    }
    out[base + col] = th;
  }
}

// Kernel 7: slab' = slab - sum_k s_k P_k on one slab: kernel 6's window over
// kernel 3's per-thread loop (workers outer, dir-blocks inner), one launch
// for any K; each slab is bit-identical to the matching slice of kernel 3.
template <int DIST, int IMPL, bool DBUF>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_workers_sharded_kernel(
    const float* scale, const float* theta, float* out,
    const uint32_t* __restrict__ seed, const int64_t* __restrict__ size,
    const int32_t* __restrict__ pdim, const int64_t* __restrict__ param_off,
    const int64_t* __restrict__ coord_off,
    const int64_t* __restrict__ blocks, int n_seg, int64_t blk_lo,
    int pos_block, int k_workers, int64_t d_packed) {
  extern __shared__ uint32_t keys[];
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
  fill_tile_keys<IMPL>(keys, seed + s, n_seg, k_workers, n_db,
                       static_cast<uint32_t>(col0));
  for (int64_t col = col0 + threadIdx.x; col < col0 + pos_block;
       col += kThreads) {
    float th = theta[base + col];
    if (col < q) {
      const uint32_t c32 = static_cast<uint32_t>(col);
      for (int k = 0; k < k_workers; ++k) {
        th = apply_dir_blocks<DIST, IMPL, DBUF>(
            th, seed[k * n_seg + s], keys + k * n_db, sc + k * d_packed,
            n_db, c32, static_cast<uint32_t>(col - col0),
            static_cast<uint32_t>(pos_block));
      }
    }
    out[base + col] = th;
  }
}

// Debug: the bits and samples of one (rows, cols) tile at (row0, col0).
// Threefry keys each element by its own counter; the tile-keyed impls
// treat the whole shape as ONE tile (the reference's
// PrngSpec.generate_tile), keyed by hw_tile_key(seed, row0, col0), with
// b0/b1 its two streams (draws 0 and 1 of hw_emulated at index r * cols +
// c; words 0-1 or 2-3 of the Philox call (c, r / 2, 0, 0) for hw).
template <int DIST, int IMPL>
__global__ void __launch_bounds__(kThreads)
generate_tile_kernel(uint32_t seed, uint32_t row0, uint32_t col0, int rows,
                     int cols, uint32_t* b0, uint32_t* b1, float* out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * cols) return;
  const uint32_t r = static_cast<uint32_t>(idx / cols);
  const uint32_t c = static_cast<uint32_t>(idx % cols);
  uint32_t x0, x1;
  if constexpr (IMPL == kThreefry) {
    basis_bits(seed, row0 + r, col0 + c, x0, x1);
  } else if constexpr (IMPL == kHwEmulated) {
    const uint32_t k = hw_tile_key(seed, row0, col0);
    const uint32_t i = r * static_cast<uint32_t>(cols) + c;
    x0 = emulated_bits(k, k ^ kKeySalt, i, 0u);
    x1 = emulated_bits(k, k ^ kKeySalt, i, 1u);
  } else {
    const uint32_t k = hw_tile_key(seed, row0, col0);
    uint32_t w[4];
    philox4x32_10(philox_key(k, k ^ kKeySalt), c, r >> 1, 0u, 0u, w);
    x0 = (r & 1u) ? w[2] : w[0];
    x1 = (r & 1u) ? w[3] : w[1];
  }
  b0[idx] = x0;
  b1[idx] = x1;
  out[idx] = bits_to_sample<DIST, IMPL == kHw>(x0, x1);
}

// Debug: the hw normal transform's fast paths (threefry.cuh) against the
// library's logf / sqrtf and cosf on every input the transform can give
// them: x = 0 .. 2^24 - 1 is the top 24 bits of a uniform's word.  Counts
// the x whose radius sqrtf(-2 logf(u)) or whose cosf(2 pi u) differs in
// any bit into mism[0] / mism[1], and the first such x into mism[2] /
// mism[3] (atomicMin; they start at 0xFFFFFFFF).
__global__ void __launch_bounds__(kThreads)
hw_transform_check_kernel(uint32_t* mism) {
  const uint32_t x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= (1u << 24)) return;
  const uint32_t bits = x << 8;
  const float u = uniform01_fma(bits);
  const float r_lib = sqrtf(__fmul_rn(-2.0f, logf(u)));
  const float r_hw = hw_sqrtf(__fmul_rn(-2.0f, hw_logf(u)));
  const float a = __fmul_rn(kTwoPi, u);
  if (__float_as_uint(r_lib) != __float_as_uint(r_hw)) {
    atomicAdd(&mism[0], 1u);
    atomicMin(&mism[2], x);
  }
  if (__float_as_uint(cosf(a)) != __float_as_uint(hw_cosf(a))) {
    atomicAdd(&mism[1], 1u);
    atomicMin(&mism[3], x);
  }
}

}  // namespace rbd

extern "C" {

// `mism` is 4 uint32 on the card: (radius mismatches, cosine mismatches,
// first x of each), the first two 0 and the last two 0xFFFFFFFF on entry.
int rbd_hw_transform_mismatches(uint32_t* mism, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rbd::hw_transform_check_kernel<<<(1u << 24) / rbd::kThreads, rbd::kThreads,
                                   0, st>>>(mism);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of an apply block: the tile keys of `groups` seeds
// (workers or adapters) x the largest segment's dir-blocks; none for
// Threefry.  `impl` is rbd_common.cuh's Impl code, `dist` its Dist code.
static size_t key_bytes(int impl, int groups, int max_ndb) {
  return impl == rbd::kThreefry
             ? 0
             : static_cast<size_t>(groups) * max_ndb * sizeof(uint32_t);
}

// `arrived` must hold d_packed / 8 zeros; `partial` n_blocks * 16 floats;
// pos_chunk at most rbd::kMaxTileKeys under hw.
int rbd_project_packed(const float* g, const uint32_t* seed,
                       const int64_t* size, const int64_t* param_off,
                       const int64_t* coord_off, const int32_t* n_chunk,
                       const int64_t* blocks, int n_seg, int64_t n_blocks,
                       int pos_block, int pos_chunk, int dist, int impl,
                       int dbuf, float* partial, int32_t* arrived, float* u,
                       float* sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  if (impl == rbd::kHw && pos_chunk > rbd::kMaxTileKeys) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RBD_DISPATCH_DB(impl, dist, dbuf, project_kernel, grid, 0, g, seed, size,
                  param_off, coord_off, n_chunk, blocks, n_seg, pos_block,
                  pos_chunk, partial, arrived, u, sq);
}

// `max_ndb` is the largest pdim / 8 over the segments.
int rbd_reconstruct_apply_packed(const float* scale, const float* theta,
                                 float* out, const uint32_t* seed,
                                 const int64_t* size, const int32_t* pdim,
                                 const int64_t* param_off,
                                 const int64_t* coord_off,
                                 const int64_t* blocks, int n_seg,
                                 int64_t n_blocks, int pos_block,
                                 int max_ndb, int dist, int impl, int dbuf,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH_DB(impl, dist, dbuf, reconstruct_apply_kernel, grid,
                  key_bytes(impl, 1, max_ndb), scale, theta, out, seed, size,
                  pdim, param_off, coord_off, blocks, n_seg, pos_block);
}

// `scale` is (k_workers, d_packed) row-major, `seed` (k_workers, n_seg).
int rbd_reconstruct_apply_packed_workers(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg,
    int64_t n_blocks, int pos_block, int k_workers, int64_t d_packed,
    int max_ndb, int dist, int impl, int dbuf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH_DB(impl, dist, dbuf, reconstruct_apply_workers_kernel, grid,
                  key_bytes(impl, k_workers, max_ndb), scale, theta, out, seed,
                  size, pdim, param_off, coord_off, blocks, n_seg, pos_block,
                  k_workers, d_packed);
}

// `scale` is (n_adapters, d_packed) row-major, `seed` (n_adapters, n_seg),
// `out` (n_adapters, q_packed) and distinct from `theta`.
int rbd_reconstruct_apply_packed_adapters(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg,
    int64_t n_blocks, int pos_block, int n_adapters, int64_t d_packed,
    int64_t q_packed, int max_ndb, int dist, int impl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  RBD_DISPATCH(impl, dist, reconstruct_apply_adapters_kernel, grid,
               key_bytes(impl, n_adapters, max_ndb), scale, theta, out, seed,
               size, pdim, param_off, coord_off, blocks, n_seg, pos_block,
               n_adapters, d_packed, q_packed);
}

// `g` is the (q_slab,) slab starting at packed position slab_off; `arrived`
// must hold d_packed / 8 zeros; `partial` n_blocks * 16 floats; pos_chunk
// at most rbd::kMaxTileKeys under hw.
int rbd_project_packed_sharded(
    const float* g, const uint32_t* seed, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* col_lo, const int64_t* col_hi,
    const int32_t* chunk_lo, const int32_t* n_chunk, const int64_t* blocks,
    int n_seg, int64_t n_blocks, int64_t slab_off, int pos_block,
    int pos_chunk, int dist, int impl, int dbuf, float* partial,
    int32_t* arrived, float* u, float* sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  if (impl == rbd::kHw && pos_chunk > rbd::kMaxTileKeys) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RBD_DISPATCH_DB(impl, dist, dbuf, project_sharded_kernel, grid, 0, g, seed,
                  param_off, coord_off, col_lo, col_hi, chunk_lo, n_chunk,
                  blocks, n_seg, slab_off, pos_block, pos_chunk, partial,
                  arrived, u, sq);
}

// `theta`/`out` are the (bps * pos_block,) slab of pos-blocks
// [blk_lo, blk_lo + bps); `blocks` is the unsharded apply prefix.
int rbd_reconstruct_apply_packed_sharded(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg, int64_t bps,
    int64_t blk_lo, int pos_block, int max_ndb, int dist, int impl, int dbuf,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(bps));
  RBD_DISPATCH_DB(impl, dist, dbuf, reconstruct_apply_sharded_kernel, grid,
                  key_bytes(impl, 1, max_ndb), scale, theta, out, seed, size,
                  pdim, param_off, coord_off, blocks, n_seg, blk_lo,
                  pos_block);
}

// `scale` is (k_workers, d_packed) row-major, `seed` (k_workers, n_seg).
int rbd_reconstruct_apply_packed_workers_sharded(
    const float* scale, const float* theta, float* out, const uint32_t* seed,
    const int64_t* size, const int32_t* pdim, const int64_t* param_off,
    const int64_t* coord_off, const int64_t* blocks, int n_seg, int64_t bps,
    int64_t blk_lo, int pos_block, int k_workers, int64_t d_packed,
    int max_ndb, int dist, int impl, int dbuf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(bps));
  RBD_DISPATCH_DB(impl, dist, dbuf, reconstruct_apply_workers_sharded_kernel,
                  grid, key_bytes(impl, k_workers, max_ndb), scale, theta,
                  out, seed,
                  size, pdim, param_off, coord_off, blocks, n_seg, blk_lo,
                  pos_block, k_workers, d_packed);
}

int rbd_generate_tile(uint32_t seed, uint32_t row0, uint32_t col0, int rows,
                      int cols, int dist, int impl, uint32_t* b0,
                      uint32_t* b1, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(rows) * cols;
  const dim3 grid(static_cast<unsigned>((n + rbd::kThreads - 1) /
                                        rbd::kThreads));
  RBD_DISPATCH(impl, dist, generate_tile_kernel, grid, 0, seed, row0, col0,
               rows, cols, b0, b1, out);
}

const char* rbd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
