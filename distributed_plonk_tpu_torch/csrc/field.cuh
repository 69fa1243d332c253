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

// --- carry chains ----------------------------------------------------------
//
// Each helper is one PTX instruction on the hardware carry flag (CC.CF):
// `*_cc` forms set it, `*c*` forms consume it. A chain is a run of these
// calls with nothing between them that touches the flag; every asm is
// volatile so that the compiler keeps the calls of a chain in order (ptxas
// maps the flag onto carry predicates and may still interleave two chains).

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// r = t - p if t >= p else t, for t < 2p (< 2^(32N): both moduli leave the
// top bit free). One borrow chain, then a select.
template <class F>
__device__ __forceinline__ void fe_reduce_once(uint32_t* r,
                                               const uint32_t* t) {
  uint32_t d[F::N];
  d[0] = sub_cc(t[0], F::p(0));
#pragma unroll
  for (int j = 1; j < F::N; ++j) d[j] = subc_cc(t[j], F::p(j));
  const bool keep_t = subc(0u, 0u) != 0u;      // borrow out: t < p
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = keep_t ? t[j] : d[j];
}

// a + b mod p, inputs < p. a + b < 2p < 2^(32N), so no carry leaves the top
// word.
template <class F>
__device__ __forceinline__ void fe_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  uint32_t s[F::N];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < F::N - 1; ++j) s[j] = addc_cc(a[j], b[j]);
  s[F::N - 1] = addc(a[F::N - 1], b[F::N - 1]);
  fe_reduce_once<F>(r, s);
}

// a - b mod p, inputs < p: the wrapped difference, plus p if it borrowed
// (the second chain's carry out is the wrap back).
template <class F>
__device__ __forceinline__ void fe_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  uint32_t d[F::N];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < F::N; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0u, 0u);          // all ones iff a < b
  d[0] = add_cc(d[0], F::p(0) & mask);
#pragma unroll
  for (int j = 1; j < F::N - 1; ++j) d[j] = addc_cc(d[j], F::p(j) & mask);
  d[F::N - 1] = addc(d[F::N - 1], F::p(F::N - 1) & mask);
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = d[j];
}

// --- Montgomery product -----------------------------------------------------
//
// Word-level CIOS with the partial products split by the parity of the
// word of `a` they come from. `even` holds a[0]*b, a[2]*b, ... at their own
// words (the lo and hi halves of one product never overlap the next), `odd`
// holds a[1]*b, a[3]*b, ... one word up, so the running sum is
// even + 2^32 * odd and each array takes its products in one carry chain
// of N multiply-adds, lo and hi halves together. A thread has one carry
// flag, so the chains of one thread run one after the other.
//
// Bounds (checked word by word by the Python model in
// tests/test_torch_field.py): both moduli satisfy 2p < 2^(32N) with room
// (top words 0x73eda753 and 0x1a0111ea, under 2^31 - 1), so the running sum
// before a row's division stays under 2^(32N + 32). The carry out of the odd
// array's reduction chain is therefore always 0 and is dropped, and no
// spare word above the N words of each array is needed.

// acc[j], acc[j+1] = a[j] * b for even j (no carries: the halves of one
// product fill two fresh words).
template <int N>
__device__ __forceinline__ void mul_row(uint32_t* acc, const uint32_t* a,
                                        uint32_t b) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = a[j] * b;
    acc[j + 1] = __umulhi(a[j], b);
  }
}

// acc += sum over even j of a[j] * b * 2^(32j), one chain from acc[0] to
// acc[N-1]; the carry out of the top word is left in the flag.
template <int N>
__device__ __forceinline__ void mad_row(uint32_t* acc, const uint32_t* a,
                                        uint32_t b) {
  acc[0] = mad_lo_cc(a[0], b, acc[0]);
  acc[1] = madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madc_lo_cc(a[j], b, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 1]);
  }
}

// acc = (acc >> 64) + sum over even j of a[j] * b * 2^(32j), plus the
// carry flag into acc[0]; the top word takes no carry out.
template <int N>
__device__ __forceinline__ void mad_row_shift(uint32_t* acc,
                                              const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    acc[j] = madc_lo_cc(a[j], b, acc[j + 2]);
    acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 3]);
  }
  acc[N - 2] = madc_lo_cc(a[N - 2], b, 0u);
  acc[N - 1] = madc_hi(a[N - 2], b, 0u);
}

// One CIOS row: add a * b_i to the sum held as lo + 2^32 * hi (lo's word 0
// is 0 from the previous row's reduction, except in the first row), then
// add m * p with m = word 0 * (-p^-1). On return the sum is lo + 2^32 * hi
// with lo[0] == 0: divided by 2^32 it is hi + (lo >> 32), which the next
// row reads with the two arrays' roles swapped (hi at word 0, lo >> 64 one
// word up, lo[1] added into hi[0]).
template <class F>
__device__ __forceinline__ void cios_row(uint32_t* lo, uint32_t* hi,
                                         const uint32_t* a, uint32_t bi,
                                         bool first) {
  constexpr int N = F::N;
  if (first) {
    mul_row<N>(hi, a + 1, bi);
    mul_row<N>(lo, a, bi);
  } else {
    lo[0] = add_cc(lo[0], hi[1]);
    mad_row_shift<N>(hi, a + 1, bi);
    mad_row<N>(lo, a, bi);
    hi[N - 1] = addc(hi[N - 1], 0u);
  }
  uint32_t p[N];
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = F::p(j);
  const uint32_t m = lo[0] * F::n0();
  mad_row<N>(hi, p + 1, m);     // carry out: always 0 (see the bounds)
  mad_row<N>(lo, p, m);
  hi[N - 1] = addc(hi[N - 1], 0u);
}

// a * b * R^-1 mod p, inputs < p, output canonical (< p). r may alias a or
// b.
template <class F>
__device__ __forceinline__ void fe_mont_mul(uint32_t* r, const uint32_t* a,
                                            const uint32_t* b) {
  constexpr int N = F::N;
  static_assert(N % 2 == 0, "the even/odd split needs an even word count");
  uint32_t even[N], odd[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    cios_row<F>(even, odd, a, b[i], i == 0);
    cios_row<F>(odd, even, a, b[i + 1], false);
  }
  // the sum is even + (odd >> 32) < 2p
  even[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) even[j] = addc_cc(even[j], odd[j + 1]);
  even[N - 1] = addc(even[N - 1], 0u);
  fe_reduce_once<F>(r, even);
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
