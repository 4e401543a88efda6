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
// multiplies (4 IMAD: hi and lo of each) and two 3-input xors (LOP3), with
// the round keys hoisted per tile: about 60 integer instructions for two
// basis values, against 73 of Threefry-2x32-20 for one.  The plain version
// is repro_torch/core/rng.py:philox4x32 and checks Random123's known
// answers.
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

}  // namespace rbd
