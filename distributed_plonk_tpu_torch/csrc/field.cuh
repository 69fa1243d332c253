// Device field arithmetic over BLS12-381 Fr (8 x 32-bit words) and Fq
// (12 x 32-bit words), shared by every kernel of the port.
//
// Elements are little-endian 32-bit words in Montgomery form with
// R = 2^256 (Fr) / 2^384 (Fq): the same radix as the JAX package's 16-bit
// limbs, so word i of a value here is limb 2i | limb 2i+1 << 16 there and
// every canonical result is bit-identical to field_jax's.
//
// Handles are limb-major: word k of element i sits at [k * stride + i], so a
// warp's 32 threads read 32 neighbouring words per load.
//
// The constants below are checked against constants.py by
// tests/test_torch_field.py (the CPU has no nvcc, so a typo here would only
// show on the card otherwise).
#pragma once
#include <stdint.h>

__constant__ uint32_t kFrP[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
__constant__ uint32_t kFqP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod q: 1 in Montgomery form (the y of the projective identity (0:1:0))
__constant__ uint32_t kFqOne[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// -p^-1 mod 2^32 for the word-level CIOS reduction
#define DPT_FR_N0 0xffffffffu
#define DPT_FQ_N0 0xfffcfffdu

struct Fr {
  enum { N = 8 };
  static __device__ __forceinline__ uint32_t p(int j) { return kFrP[j]; }
  static __device__ __forceinline__ uint32_t n0() { return DPT_FR_N0; }
};

struct Fq {
  enum { N = 12 };
  static __device__ __forceinline__ uint32_t p(int j) { return kFqP[j]; }
  static __device__ __forceinline__ uint32_t n0() { return DPT_FQ_N0; }
};

// r = t - p if (hi:t) >= p else t, for a value (hi:t) < 2p.
template <class F>
__device__ __forceinline__ void fe_reduce_once(uint32_t* r, const uint32_t* t,
                                               uint32_t hi) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    uint64_t x = (uint64_t)t[j] - F::p(j) - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 32) & 1u;
  }
  const bool take_d = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = take_d ? d[j] : t[j];
}

// a + b mod p, inputs < p.
template <class F>
__device__ __forceinline__ void fe_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  uint32_t s[F::N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce_once<F>(r, s, (uint32_t)c);
}

// a - b mod p, inputs < p.
template <class F>
__device__ __forceinline__ void fe_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    uint64_t x = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 32) & 1u;
  }
  // a < b: the difference wrapped mod 2^(32N); adding p brings it back
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    c += (uint64_t)d[j] + (F::p(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// a * b * R^-1 mod p (word-level CIOS), inputs < p, output canonical.
// Every product is 32 x 32 -> 64 bits; t keeps two words above the N
// words of the running sum (t[N] and the carry t[N + 1]) rather than
// relying on Fr's spare top bit.
template <class F>
__device__ __forceinline__ void fe_mont_mul(uint32_t* r, const uint32_t* a,
                                            const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * F::n0();
    c = ((uint64_t)m * F::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c += (uint64_t)m * F::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  // t < 2p here
  fe_reduce_once<F>(r, t, t[N]);
}

template <class F>
__device__ __forceinline__ void fe_load(uint32_t* r, const uint32_t* base,
                                        int64_t stride, int64_t i) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = base[j * stride + i];
}

template <class F>
__device__ __forceinline__ void fe_store(uint32_t* base, int64_t stride,
                                         int64_t i, const uint32_t* v) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) base[j * stride + i] = v[j];
}
