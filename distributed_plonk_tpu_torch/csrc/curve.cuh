// Complete projective addition on BLS12-381 G1 (y^2 = x^3 + 4, so a = 0 and
// b3 = 12), Renes-Costello-Batina 2015 algorithm 7 (full) and algorithm 8
// (mixed, Q affine). Homogeneous (X : Y : Z) coordinates over Fq in
// Montgomery form, identity (0 : 1 : 0). Complete: P == Q, P == -Q and the
// identity all go through the same straight-line formula, so no thread
// branches on the data.
//
// The op sequence is curve_jax.proj_add / proj_add_mixed's, value for value:
// every field op returns the canonical representative, so the coordinates
// (not only the point) equal the JAX package's. Shared by the standalone
// add kernel (curve_add.cu) and the bucket kernel (msm_bucket.cu).
#pragma once
#include "field.cuh"

typedef uint32_t fq_t[12];

__device__ __forceinline__ void fq_dbl(uint32_t* r, const uint32_t* a) {
  fe_add<Fq>(r, a, a);
}

// 12 * a = 8a + 4a
__device__ __forceinline__ void fq_mul12(uint32_t* r, const uint32_t* a) {
  fq_t a2, a4, a8;
  fq_dbl(a2, a);
  fq_dbl(a4, a2);
  fq_dbl(a8, a4);
  fe_add<Fq>(r, a8, a4);
}

// Shared tail of both formulas: from t0, t1, t3, t4, ym and the b3 term
// t2 (= 12 * Z1 * Z2), the output coordinates.
__device__ __forceinline__ void rcb15_tail(uint32_t* x3, uint32_t* y3,
                                           uint32_t* z3, const uint32_t* t0,
                                           const uint32_t* t1,
                                           const uint32_t* t3,
                                           const uint32_t* t4,
                                           const uint32_t* ym,
                                           const uint32_t* t2) {
  fq_t t0x3, z3a, t1a, y3b, a, b;
  fq_dbl(a, t0);
  fe_add<Fq>(t0x3, a, t0);        // 3 * t0
  fe_add<Fq>(z3a, t1, t2);
  fe_sub<Fq>(t1a, t1, t2);
  fq_mul12(y3b, ym);              // b3 * ym
  fe_mont_mul<Fq>(a, t3, t1a);    // t2c
  fe_mont_mul<Fq>(b, t4, y3b);    // x3a
  fe_sub<Fq>(x3, a, b);
  fe_mont_mul<Fq>(a, t1a, z3a);   // t1b
  fe_mont_mul<Fq>(b, y3b, t0x3);  // y3c
  fe_add<Fq>(y3, a, b);
  fe_mont_mul<Fq>(a, z3a, t4);    // z3b
  fe_mont_mul<Fq>(b, t0x3, t3);   // t0c
  fe_add<Fq>(z3, a, b);
}

// (x3 : y3 : z3) = (x1 : y1 : z1) + (x2 : y2 : z2); outputs may alias inputs.
__device__ __forceinline__ void proj_add_full(uint32_t* x3, uint32_t* y3,
                                              uint32_t* z3,
                                              const uint32_t* x1,
                                              const uint32_t* y1,
                                              const uint32_t* z1,
                                              const uint32_t* x2,
                                              const uint32_t* y2,
                                              const uint32_t* z2) {
  fq_t t0, t1, t2, t3, t4, ym, a, b, m;
  fe_mont_mul<Fq>(t0, x1, x2);
  fe_mont_mul<Fq>(t1, y1, y2);
  fe_mont_mul<Fq>(t2, z1, z2);
  fe_add<Fq>(a, x1, y1);
  fe_add<Fq>(b, x2, y2);
  fe_mont_mul<Fq>(m, a, b);
  fe_add<Fq>(a, t0, t1);
  fe_sub<Fq>(t3, m, a);           // t3 = (x1+y1)(x2+y2) - (t0+t1)
  fe_add<Fq>(a, y1, z1);
  fe_add<Fq>(b, y2, z2);
  fe_mont_mul<Fq>(m, a, b);
  fe_add<Fq>(a, t1, t2);
  fe_sub<Fq>(t4, m, a);           // t4 = (y1+z1)(y2+z2) - (t1+t2)
  fe_add<Fq>(a, x1, z1);
  fe_add<Fq>(b, x2, z2);
  fe_mont_mul<Fq>(m, a, b);
  fe_add<Fq>(a, t0, t2);
  fe_sub<Fq>(ym, m, a);           // ym = (x1+z1)(x2+z2) - (t0+t2)
  fq_mul12(a, t2);                // b3 * t2
  rcb15_tail(x3, y3, z3, t0, t1, t3, t4, ym, a);
}

// (x3 : y3 : z3) = (x1 : y1 : z1) + (x2, y2) with Q affine and finite;
// outputs may alias inputs.
__device__ __forceinline__ void proj_add_mixed(uint32_t* x3, uint32_t* y3,
                                               uint32_t* z3,
                                               const uint32_t* x1,
                                               const uint32_t* y1,
                                               const uint32_t* z1,
                                               const uint32_t* x2,
                                               const uint32_t* y2) {
  fq_t t0, t1, t3, t4, ym, a, b, m;
  fe_mont_mul<Fq>(t0, x1, x2);
  fe_mont_mul<Fq>(t1, y1, y2);
  fe_add<Fq>(a, x1, y1);
  fe_add<Fq>(b, x2, y2);
  fe_mont_mul<Fq>(m, a, b);
  fe_add<Fq>(a, t0, t1);
  fe_sub<Fq>(t3, m, a);           // t3 = (x1+y1)(x2+y2) - (t0+t1)
  fe_mont_mul<Fq>(a, y2, z1);
  fe_add<Fq>(t4, a, y1);          // t4 = y2*z1 + y1
  fe_mont_mul<Fq>(a, x2, z1);
  fe_add<Fq>(ym, a, x1);          // ym = x2*z1 + x1
  fq_mul12(a, z1);                // b3 * z1
  rcb15_tail(x3, y3, z3, t0, t1, t3, t4, ym, a);
}
