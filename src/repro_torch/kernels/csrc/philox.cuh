// Philox4x32-10 (Salmon et al. 2011, the Random123 constants): the port's
// generator for the reference's `hw` PRNG impl, which on a TPU is the
// core's hardware PRNG (repro/core/rng.py:_hw_tile, 348).  Hopper has no
// hardware PRNG, so `hw` is this counter-based generator keyed by the
// tile, as the TPU's is seeded by it:
//
//   k       = hw_tile_key(seed, row0, col0)        (threefry.cuh)
//   key     = (k, k ^ 0x85EBCA6B)
//   counter = (c, r / 2, 0, 0)                     (within-tile row, column)
//   words   = Philox4x32-10(counter, key)
//
// Words 0-1 are the (b0, b1) bit streams of the even row of the pair r / 2
// and words 2-3 those of the odd row, so one call serves two of the 8 rows
// a thread holds at one column.  Per call: 10 rounds of two 32x32->64
// multiplies (one IMAD.WIDE.U32 each, both halves) and two 3-input xors
// (LOP3): ~18 SASS instructions a value with the first round's shared
// terms folded (chip_smoke.py phase 1 counts them), against ~72 of
// Threefry-2x32-20.  The plain version is repro_torch/core/rng.py:
// philox4x32 and checks Random123's known answers.
//
// Two forms of the same function: philox4x32_10 under a PhiloxKey (the 20
// round keys in registers: the applies, generate_tile), and philox_start +
// philox_rounds under round keys in shared memory (the projection, whose
// CUDA block writes each tile's round keys there once).
#pragma once

#include <stdint.h>

namespace rbd {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kPhiloxRounds = 10;

// The 20 round keys of one Philox key, computed once per tile.
struct PhiloxKey {
  uint32_t k0[kPhiloxRounds];
  uint32_t k1[kPhiloxRounds];
};

__device__ __forceinline__ PhiloxKey philox_key(uint32_t key0,
                                                uint32_t key1) {
  PhiloxKey pk;
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    pk.k0[r] = key0;
    pk.k1[r] = key1;
    key0 += kPhiloxW0;
    key1 += kPhiloxW1;
  }
  return pk;
}

__device__ __forceinline__ void philox4x32_10(const PhiloxKey& pk,
                                              uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t (&out)[4]) {
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ pk.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ pk.k1[r];
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The 4 calls (c, j, 0, 0), j = 0 .. 3, of one column (words 0-1 and 2-3
// of call j: rows 2j and 2j + 1 of the tile), run round by round under
// round keys in shared memory: philox_start sets the counters,
// philox_rounds<R0, R1> runs rounds R0 .. R1 - 1, reading k0 and k1 of
// round r at rk[2r] and rk[2r + 1] (8-byte aligned; two rounds' keys are
// one LDS.128).
__device__ __forceinline__ void philox_start(uint32_t c,
                                             uint32_t (&w)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j][0] = c;
    w[j][1] = static_cast<uint32_t>(j);
    w[j][2] = 0u;
    w[j][3] = 0u;
  }
}

template <int R0, int R1>
__device__ __forceinline__ void philox_rounds(const uint32_t* rk,
                                              uint32_t (&w)[4][4]) {
#pragma unroll
  for (int r = R0; r < R1; ++r) {
    const uint2 k = reinterpret_cast<const uint2*>(rk)[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t (&x)[4] = w[j];
      const uint32_t hi0 = __umulhi(kPhiloxM0, x[0]);
      const uint32_t lo0 = kPhiloxM0 * x[0];
      const uint32_t hi1 = __umulhi(kPhiloxM1, x[2]);
      const uint32_t lo1 = kPhiloxM1 * x[2];
      x[0] = hi1 ^ x[1] ^ k.x;
      x[1] = lo1;
      x[2] = hi0 ^ x[3] ^ k.y;
      x[3] = lo0;
    }
  }
}

// The 20 round keys of key (key0, key1) into rk (k0, k1 of round r at
// rk[2r], rk[2r + 1]).
__device__ __forceinline__ void philox_store_round_keys(uint32_t key0,
                                                        uint32_t key1,
                                                        uint32_t* rk) {
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    rk[2 * r] = key0;
    rk[2 * r + 1] = key1;
    key0 += kPhiloxW0;
    key1 += kPhiloxW1;
  }
}

}  // namespace rbd
