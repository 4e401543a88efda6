// Per-leaf RBD kernels for Hopper (sm_90a): one launch per LeafPlan, the
// stacked (layer) index in the grid, for the unpacked strategies
// (fused_per_leaf, coord_unfused's cuda twin, full_space).
//
//   rbd_project_flat          replaces repro/kernels/rbd_project.py:
//                             project_flat -> _project_kernel
//   rbd_reconstruct_flat      replaces repro/kernels/rbd_reconstruct.py:
//                             reconstruct_flat -> _recon_kernel
//   rbd_reconstruct_apply_flat
//                             replaces repro/kernels/rbd_reconstruct.py:
//                             reconstruct_apply_flat -> _recon_apply_kernel
//
// A leaf of n_stack compartments arrives as unpadded (n_stack, q) rows;
// compartment s uses seed[s] = fold_seed(leaf_seed, s) and the rows of its
// virtual basis P_s (d_pad = dim rounded up to 8 rows; the scale rows past
// dim are zero).  Columns at or beyond q are neither read nor generated.
//
// Bound on this card: as for the packed kernels (rbd_step.cu), every basis
// value is regenerated (one Threefry-2x32-20 plus the sample mapping, about
// 75 integer and up to ~40 FP32/SFU instructions) against 4 bytes of the
// gradient or theta read and 4 (2 for bf16) written per parameter: the
// kernels are bound by instruction issue.  At full qwen2-0.5b width a
// step's 14 launches generate the packed step's values (4.46e10).
//
// What the design does about it: each value is generated once per launch in
// registers and consumed at once by an FP32 FMA (no tensor cores, no TF32);
// nothing of the basis touches memory.  The projection uses the packed
// projection's geometry -- one CUDA block per (compartment, dir-block,
// chunk of 64 pos-blocks), a fixed-order block sum, chunk partials summed
// in order by the last block to arrive -- so its (u, sq) are bit-identical
// to rbd_project_packed on the same seeds and gradient (both kernels are
// shells around rbd_common.cuh's project_sums and project_store), and no
// float atomics make reruns differ.  The two reconstructions run one CUDA
// block per (pos-block, compartment); each thread owns a position and
// visits the dir-blocks in order, as the reference's grid (direction
// innermost) does.
//
// Shard instances (template flag SHARD; Threefry only).  Under pjit-style
// parameter sharding a rank holds a leaf shard: each compartment's tail
// (a, n_k, b) cut on n_k into m equal parts, shard r holding the
// contiguous index range r of that dimension, as (n_stack, q_local) rows.
// The instance reads those rows and generates (and consumes) every basis
// value at the compartment's GLOBAL column
//   col = (j / w) * W + off + j % w,   j the local position,
// with w = (n_k / m) * b, W = n_k * b and off = r * (n_k / m) * b (ColMap;
// w = W, off = 0 is the identity).  Threefry keys a value by (seed, row,
// col) alone, so a shard's reconstruction and apply equal the same
// positions of the unsharded kernels' output bit for bit (one thread a
// position, the dir-blocks in order), and its projection is a partial sum
// that one sum over the model group completes (the unsharded sums in
// another order).  The map costs one 32-bit division a column against the
// ~1,100 instructions of its 8 values.  The tile-keyed impls key a value by
// its (8, 512) tile of the compartment; the wrappers refuse them here, as
// no per-leaf plan resolves to them.  The unsharded instances (SHARD
// false) compile as before: the map is never read.
//
// PRNG impls: as in rbd_step.cu, each kernel takes the impl as a template
// argument chosen at launch.  The reference's per-leaf kernels take the
// tile-keyed impls too (repro/kernels/rbd_project.py:49,
// rbd_reconstruct.py:40, 65), keyed
// by the (8, 512) tile at (di * 8, pj * 512) of the compartment, though its
// resolve_prng_impl routes every per-leaf strategy to Threefry; so do
// these kernels.  The reconstructions key their block's 512 positions once
// per CUDA block into dynamic shared memory (one key per dir-block).
//
// Kernels launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rbd_common.cuh"

namespace rbd {

constexpr int kPosBlock = 512;     // positions per CUDA block (apply, recon)

// A leaf shard's column map (see the header); unused when SHARD is false.
struct ColMap {
  uint32_t w, W, off;
};

template <bool SHARD>
__device__ __forceinline__ uint32_t global_col(int64_t j, const ColMap& cm) {
  if constexpr (SHARD) {
    const uint32_t j32 = static_cast<uint32_t>(j);
    const uint32_t blk = j32 / cm.w;
    return blk * cm.W + cm.off + (j32 - blk * cm.w);
  } else {
    return static_cast<uint32_t>(j);
  }
}

// project_sums (rbd_common.cuh) over a shard's local columns [c0, c1):
// gradient values read at local position j, basis values generated at the
// mapped global column, each right before its two FMAs.
template <int DIST>
__device__ __forceinline__ void project_sums_shard(
    const float* __restrict__ gs, uint32_t sd, uint32_t row0, int64_t c0,
    int64_t c1, const ColMap& cm, float (&acc)[kAcc]) {
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  for (int64_t j = c0 + threadIdx.x; j < c1; j += kThreads) {
    const float gv = gs[j];
    const uint32_t c32 = global_col<true>(j, cm);
#pragma unroll
    for (int i = 0; i < kDirBlock; ++i) {
      const float p = basis_sample<DIST>(sd, row0 + i, c32);
      acc[i] = fmaf(p, gv, acc[i]);
      acc[kDirBlock + i] = fmaf(p, p, acc[kDirBlock + i]);
    }
  }
}

// Kernel 8: raw projections u_s = P_s g_s and squared row norms for every
// compartment s of one leaf.  Grid (n_db * n_chunk, n_stack): block x of
// row s owns dir-block x / n_chunk and the chunk x % n_chunk of
// `chunk_cols` positions; project_sums and project_store do the rest, as
// in the packed projection.  Outputs are (n_stack, d_pad).  The shard
// instance: q is the shard's q_local, the values at the mapped columns.
template <int DIST, int IMPL, bool SHARD = false>
__global__ void __launch_bounds__(kThreads)
project_flat_kernel(const float* __restrict__ g,
                    const uint32_t* __restrict__ seed, int64_t q,
                    int n_chunk, int64_t chunk_cols,
                    float* __restrict__ partial, int32_t* __restrict__ arrived,
                    float* __restrict__ u, float* __restrict__ sq,
                    ColMap cm) {
  static_assert(!SHARD || IMPL == kThreefry,
                "the shard instances serve Threefry");
  const int s = blockIdx.y;
  const int di = blockIdx.x / n_chunk;
  const int chunk = blockIdx.x % n_chunk;
  const int n_db = gridDim.x / n_chunk;
  const int64_t c0 = static_cast<int64_t>(chunk) * chunk_cols;
  const int64_t c1 = (c0 + chunk_cols < q) ? c0 + chunk_cols : q;
  // the partial slot and the coordinate block, worked out before the
  // column loop: pure arithmetic here, and this order measured ~1% faster
  // on an H100 than working them out after it
  const int64_t bid = static_cast<int64_t>(s) * gridDim.x + blockIdx.x;
  const int64_t cblk = static_cast<int64_t>(s) * n_db + di;
  float acc[kAcc];
  if constexpr (SHARD) {
    project_sums_shard<DIST>(g + static_cast<int64_t>(s) * q, seed[s],
                             static_cast<uint32_t>(di * kDirBlock), c0, c1,
                             cm, acc);
  } else {
    project_sums<DIST, IMPL, false>(g + static_cast<int64_t>(s) * q, seed[s],
                                    static_cast<uint32_t>(di * kDirBlock), c0,
                                    c1, kPosBlock, acc);
  }
  project_store(acc, bid, chunk, n_chunk, cblk, partial, arrived, u, sq);
}

// Kernel 9: delta_s = scale_s P_s in float32, (n_stack, q).  Grid
// (ceil(q / 512), n_stack); the accumulator starts at 0 and adds each
// dir-block's part in order (the reference's `out += part`).  The shard
// instance: q is q_local, the values at the mapped columns.
template <int DIST, int IMPL, bool SHARD = false>
__global__ void __launch_bounds__(kThreads)
reconstruct_flat_kernel(const float* __restrict__ scale,
                        const uint32_t* __restrict__ seed, int64_t q,
                        int n_db, float* __restrict__ out, ColMap cm) {
  static_assert(!SHARD || IMPL == kThreefry,
                "the shard instances serve Threefry");
  extern __shared__ uint32_t keys[];
  const int s = blockIdx.y;
  const uint32_t sd = seed[s];
  const float* sc = scale + static_cast<int64_t>(s) * n_db * kDirBlock;
  const int64_t base = static_cast<int64_t>(s) * q;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kPosBlock;
  const int64_t c1 = (c0 + kPosBlock < q) ? c0 + kPosBlock : q;
  fill_tile_keys<IMPL>(keys, seed + s, 0, 1, n_db, static_cast<uint32_t>(c0));
  for (int64_t col = c0 + threadIdx.x; col < c1; col += kThreads) {
    const uint32_t c32 = global_col<SHARD>(col, cm);
    const uint32_t cin = static_cast<uint32_t>(col - c0);
    float acc = 0.0f;
    for (int db = 0; db < n_db; ++db) {
      acc = __fadd_rn(acc, dir_block_part<DIST, IMPL>(
                               sd, key_of<IMPL>(keys, db), sc, db, c32, cin,
                               kPosBlock));
    }
    out[base + col] = acc;
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Kernel 10 body: theta'_s = theta_s - eta * (scale_s P_s).  The float32
// accumulator starts from float(theta) and each dir-block subtracts
// eta * part (product rounded, then difference rounded: the reference's
// `out -= eta * part`); the result is rounded to theta's type once, on the
// store.  `out` may alias `theta`: each thread reads its element before it
// writes it, and no other thread touches it.  The shard instance: q is
// q_local, the values at the mapped columns.
template <int DIST, int IMPL, bool SHARD, typename T>
__device__ __forceinline__ void reconstruct_apply_flat_body(
    const float* __restrict__ scale, const T* theta, T* out, float eta,
    const uint32_t* __restrict__ seed, int64_t q, int n_db, uint32_t* keys,
    const ColMap& cm) {
  static_assert(!SHARD || IMPL == kThreefry,
                "the shard instances serve Threefry");
  const int s = blockIdx.y;
  const uint32_t sd = seed[s];
  const float* sc = scale + static_cast<int64_t>(s) * n_db * kDirBlock;
  const int64_t base = static_cast<int64_t>(s) * q;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kPosBlock;
  const int64_t c1 = (c0 + kPosBlock < q) ? c0 + kPosBlock : q;
  fill_tile_keys<IMPL>(keys, seed + s, 0, 1, n_db, static_cast<uint32_t>(c0));
  for (int64_t col = c0 + threadIdx.x; col < c1; col += kThreads) {
    const uint32_t c32 = global_col<SHARD>(col, cm);
    const uint32_t cin = static_cast<uint32_t>(col - c0);
    float acc = load_f32(theta + base + col);
    for (int db = 0; db < n_db; ++db) {
      acc = __fsub_rn(acc, __fmul_rn(eta, dir_block_part<DIST, IMPL>(
                                              sd, key_of<IMPL>(keys, db), sc,
                                              db, c32, cin, kPosBlock)));
    }
    store_from_f32(out + base + col, acc);
  }
}

template <int DIST, int IMPL, bool SHARD = false>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_flat_f32(const float* __restrict__ scale,
                           const float* theta, float* out, float eta,
                           const uint32_t* __restrict__ seed, int64_t q,
                           int n_db, ColMap cm) {
  extern __shared__ uint32_t keys[];
  reconstruct_apply_flat_body<DIST, IMPL, SHARD, float>(
      scale, theta, out, eta, seed, q, n_db, keys, cm);
}

template <int DIST, int IMPL, bool SHARD = false>
__global__ void __launch_bounds__(kThreads)
reconstruct_apply_flat_bf16(const float* __restrict__ scale,
                            const __nv_bfloat16* theta, __nv_bfloat16* out,
                            float eta, const uint32_t* __restrict__ seed,
                            int64_t q, int n_db, ColMap cm) {
  extern __shared__ uint32_t keys[];
  reconstruct_apply_flat_body<DIST, IMPL, SHARD, __nv_bfloat16>(
      scale, theta, out, eta, seed, q, n_db, keys, cm);
}

}  // namespace rbd

extern "C" {

// Dynamic shared memory of a reconstruction block: one tile key per
// dir-block; none for Threefry.  `impl` is rbd_common.cuh's Impl code.
static size_t flat_key_bytes(int impl, int n_db) {
  return impl == rbd::kThreefry
             ? 0
             : static_cast<size_t>(n_db) * sizeof(uint32_t);
}

// g: (n_stack, q) float32.  `partial` must hold n_stack * n_db * n_chunk *
// 16 floats, `arrived` n_stack * n_db zeros; u and sq are (n_stack, n_db *
// 8).  Under hw, chunk_cols is whole pos-blocks, at most
// rbd::kMaxTileKeys of them: a block holds the round keys of the
// pos-blocks its chunk meets.
int rbd_project_flat(const float* g, const uint32_t* seed, int n_stack,
                     int64_t q, int n_db, int n_chunk, int64_t chunk_cols,
                     int dist, int impl, float* partial, int32_t* arrived,
                     float* u, float* sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_db * n_chunk),
                  static_cast<unsigned>(n_stack));
  if (impl == rbd::kHw &&
      (chunk_cols % rbd::kPosBlock != 0 ||
       chunk_cols > static_cast<int64_t>(rbd::kMaxTileKeys) * rbd::kPosBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RBD_DISPATCH(impl, dist, project_flat_kernel, grid, 0, g, seed, q,
               n_chunk, chunk_cols, partial, arrived, u, sq, rbd::ColMap{});
}

// scale: (n_stack, n_db * 8) float32, zero past dim; out: (n_stack, q).
int rbd_reconstruct_flat(const float* scale, const uint32_t* seed,
                         int n_stack, int64_t q, int n_db, int dist,
                         int impl, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((q + rbd::kPosBlock - 1) /
                                        rbd::kPosBlock),
                  static_cast<unsigned>(n_stack));
  RBD_DISPATCH(impl, dist, reconstruct_flat_kernel, grid,
               flat_key_bytes(impl, n_db), scale, seed, q, n_db, out,
               rbd::ColMap{});
}

// theta, out: (n_stack, q) float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// `out` may equal `theta`.
int rbd_reconstruct_apply_flat(const float* scale, const void* theta,
                               void* out, float eta, const uint32_t* seed,
                               int n_stack, int64_t q, int n_db, int dist,
                               int impl, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((q + rbd::kPosBlock - 1) /
                                        rbd::kPosBlock),
                  static_cast<unsigned>(n_stack));
  if (bf16) {
    const __nv_bfloat16* th = static_cast<const __nv_bfloat16*>(theta);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    RBD_DISPATCH(impl, dist, reconstruct_apply_flat_bf16, grid,
                 flat_key_bytes(impl, n_db), scale, th, o, eta, seed, q, n_db,
                 rbd::ColMap{});
  }
  const float* th = static_cast<const float*>(theta);
  float* o = static_cast<float*>(out);
  RBD_DISPATCH(impl, dist, reconstruct_apply_flat_f32, grid,
               flat_key_bytes(impl, n_db), scale, th, o, eta, seed, q, n_db,
               rbd::ColMap{});
}

// The shard instances (Threefry): the same arguments as the three entries
// above, with q the shard's q_local, plus the column map (w, W, off) of
// the shard (see the header); w must be at least 1.
int rbd_project_flat_shard(const float* g, const uint32_t* seed, int n_stack,
                           int64_t q, int n_db, int n_chunk,
                           int64_t chunk_cols, int dist, uint32_t w,
                           uint32_t W, uint32_t off, float* partial,
                           int32_t* arrived, float* u, float* sq,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_db * n_chunk),
                  static_cast<unsigned>(n_stack));
  RBD_SWITCH_DIST(dist, project_flat_kernel, (rbd::kThreefry, true), grid, 0,
                  g, seed, q, n_chunk, chunk_cols, partial, arrived, u, sq,
                  rbd::ColMap{w, W, off});
}

int rbd_reconstruct_flat_shard(const float* scale, const uint32_t* seed,
                               int n_stack, int64_t q, int n_db, int dist,
                               uint32_t w, uint32_t W, uint32_t off,
                               float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((q + rbd::kPosBlock - 1) /
                                        rbd::kPosBlock),
                  static_cast<unsigned>(n_stack));
  RBD_SWITCH_DIST(dist, reconstruct_flat_kernel, (rbd::kThreefry, true),
                  grid, 0, scale, seed, q, n_db, out,
                  rbd::ColMap{w, W, off});
}

int rbd_reconstruct_apply_flat_shard(const float* scale, const void* theta,
                                     void* out, float eta,
                                     const uint32_t* seed, int n_stack,
                                     int64_t q, int n_db, int dist, int bf16,
                                     uint32_t w, uint32_t W, uint32_t off,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((q + rbd::kPosBlock - 1) /
                                        rbd::kPosBlock),
                  static_cast<unsigned>(n_stack));
  const rbd::ColMap cm{w, W, off};
  if (bf16) {
    const __nv_bfloat16* th = static_cast<const __nv_bfloat16*>(theta);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    RBD_SWITCH_DIST(dist, reconstruct_apply_flat_bf16, (rbd::kThreefry, true),
                    grid, 0, scale, th, o, eta, seed, q, n_db, cm);
  }
  const float* th = static_cast<const float*>(theta);
  float* o = static_cast<float*>(out);
  RBD_SWITCH_DIST(dist, reconstruct_apply_flat_f32, (rbd::kThreefry, true),
                  grid, 0, scale, th, o, eta, seed, q, n_db, cm);
}

}  // extern "C"
