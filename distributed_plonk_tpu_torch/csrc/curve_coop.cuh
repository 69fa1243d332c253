// Warp-cooperative complete projective addition on BLS12-381 G1: six lanes
// compute one RCB15 algorithm-7 add (curve.cuh's proj_add_full), its
// twelve Fq products spread over them.
//
// The twelve products of the formula form two levels of six independent
// products: t0 = x1 x2, t1 = y1 y2, t2 = z1 z2 and the three cross
// products (x1 + y1)(x2 + y2), (y1 + z1)(y2 + z2), (x1 + z1)(x2 + z2);
// then the six products of rcb15_tail. Lane r < 6 of a group runs product
// r of a level; every lane runs the same instructions on its own
// operands, so the six products of a level take the time of one. The
// operands reach the lanes, and the products come back, through a
// group's scratch of 12 Fq slots in shared memory, with __syncwarp
// between the stages:
//
//   level 1  lane r: product r into slot r (lanes 3-5 first add the
//            coordinates of their cross product)
//   stage A  lane r: one intermediate of the formula into slot 6 + r:
//            t3, t4, 12 ym, 3 t0, t1 + 12 t2, t1 - 12 t2, by one uniform
//            sequence (x1 = A + B; x2 = C -/+ x1; x3 = 12 x2; x4 = t1 +/-
//            x3) whose operands and signs each lane selects, so no lane
//            diverges
//   level 2  lane r: product r of rcb15_tail into slot r
//   final    lane r < 3: coordinate r of the sum, slot 2r -/+ slot 2r+1
//
// The critical path is two products plus about 11 field additions,
// against twelve products and the same additions in one thread. Every
// field operation returns the canonical representative, and each value
// is the one proj_add_full computes (a subtraction runs as a + (p - b),
// which is fe_sub's canonical value), so every coordinate equals
// proj_add_full's and curve_torch.proj_add_ref's limb for limb.
//
// coop_add_at is the group form: the caller gives each lane its r and
// its group's points and scratch, so that one warp runs several adds in
// one instruction stream (curve_add.cu: five, on lanes 6g..6g+5). A lane
// that is not one of its group's six shadows r = 0 and writes nothing.
// coop_add is the warp form of msm_finish.cu: one add on lanes 0-5,
// lanes 6-31 shadowing lane 0. Points are 36 words, x then y then z,
// word l at p[l * PS]; the whole warp calls an add; the output may alias
// either input.
#pragma once
#include "curve.cuh"

typedef uint32_t coop_pt[36];

// the per-warp scratch of one add: 12 Fq slots
struct CoopScratch {
  uint32_t v[12][12];
};

// an Fq value of 12 words at word stride PS
template <int PS = 1>
__device__ __forceinline__ void fq_get(uint32_t* r, const uint32_t* s) {
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = s[k * PS];
}

template <int PS = 1>
__device__ __forceinline__ void fq_put(uint32_t* s, const uint32_t* r) {
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k * PS] = r[k];
}

// slot i of the scratch s (slot i at s + 12 i), or zero for i = 15 (F in
// the operand tables)
__device__ __forceinline__ void slot_get(uint32_t* r, const uint32_t* s,
                                         int i) {
  const uint32_t keep = i < 12 ? ~0u : 0u;
  const uint32_t* src = s + 12 * (i < 12 ? i : 0);
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = src[k] & keep;
}

// a - b if sub, else a + b; inputs < p. The difference is a + (p - b),
// reduced once: a - b + p when a < b, a - b otherwise (b = 0 gives a + p,
// reduced to a), which is fe_sub's canonical value.
__device__ __forceinline__ void fq_addsub(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b, bool sub) {
  fq_t nb;
  nb[0] = sub_cc(Fq::p(0), b[0]);
#pragma unroll
  for (int j = 1; j < 11; ++j) nb[j] = subc_cc(Fq::p(j), b[j]);
  nb[11] = subc(Fq::p(11), b[11]);
#pragma unroll
  for (int j = 0; j < 12; ++j) nb[j] = sub ? nb[j] : b[j];
  fe_add<Fq>(r, a, nb);
}

// (out) = (p) + (q) by the group whose lane this is: r (0-5) its product,
// `writer` false for a lane that shadows r = 0; points of 36 words at word
// stride PS and the group's scratch s (144 words) in shared memory. Every
// lane of the warp calls it, each with its own group's arguments.
template <int PS>
__device__ __forceinline__ void coop_add_at(uint32_t* out,
                                            const uint32_t* p,
                                            const uint32_t* q, uint32_t* s,
                                            int r, bool writer) {
  fq_t a, b;
  // one product site for both levels keeps the code (and nvcc) small
#pragma unroll 1
  for (int level = 0; level < 2; ++level) {
    if (level == 0) {
      // coordinate i (x, y, z, x, y, x), plus coordinate j for r >= 3
      const int i = (0x010210 >> (4 * r)) & 15;
      const int j = (0x221000 >> (4 * r)) & 15;
      fq_get<PS>(a, p + 12 * PS * i);
      fq_get<PS>(b, q + 12 * PS * i);
      if (r >= 3) {
        fq_t a2, b2;
        fq_get<PS>(a2, p + 12 * PS * j);
        fq_get<PS>(b2, q + 12 * PS * j);
        fe_add<Fq>(a, a, a2);
        fe_add<Fq>(b, b, b2);
      }
    } else {
      // t3 t1a, t4 y3b, t1a z3a, y3b t0x3, z3a t4, t0x3 t3
      slot_get(a, s, (0x9A8B76 >> (4 * r)) & 15);
      slot_get(b, s, (0x679A8B >> (4 * r)) & 15);
    }
    fe_mont_mul<Fq>(a, a, b);
    if (writer) fq_put(s + 12 * r, a);
    __syncwarp();
    if (level == 0) {
      // stage A, slots 0-5 = t0, t1, t2, m_xy, m_yz, m_xz:
      //   r 0: t3 = m_xy - (t0 + t1)      r 3: t0x3 = t0 + (t0 + t0)
      //   r 1: t4 = m_yz - (t1 + t2)      r 4: z3a = t1 + 12 (t2 + 0)
      //   r 2: y3b = 12 (m_xz - (t0 + t2))  r 5: t1a = t1 - 12 (t2 + 0)
      fq_t x1, x2, x3, y;
      slot_get(x1, s, (0x220010 >> (4 * r)) & 15);
      slot_get(y, s, (0xFF0221 >> (4 * r)) & 15);
      fe_add<Fq>(x1, x1, y);
      slot_get(y, s, (0xFF0543 >> (4 * r)) & 15);
      fq_addsub(x2, y, x1, r <= 2);
      fq_mul12(x3, x2);
      slot_get(y, s, 1);
      fq_addsub(y, y, x3, r == 5);
#pragma unroll
      for (int k = 0; k < 12; ++k)
        y[k] = r == 2 ? x3[k] : (r >= 4 ? y[k] : x2[k]);
      if (writer) fq_put(s + 12 * (6 + r), y);
      __syncwarp();
    }
  }
  // slots 0-5 = t2c, x3a, t1b, y3c, z3b, t0c: x3 = t2c - x3a, y3 = t1b +
  // y3c, z3 = z3b + t0c
  fq_get(a, s + 12 * (2 * r));
  fq_get(b, s + 12 * (2 * r + 1));
  fq_addsub(a, a, b, r == 0);
  if (writer && r < 3) fq_put<PS>(out + 12 * PS * r, a);
  __syncwarp();
}

// (out) = (p) + (q), points of 36 contiguous words in shared memory, by
// the whole warp on lanes 0-5; `s` is the warp's own scratch.
__device__ __forceinline__ void coop_add(uint32_t* out, const uint32_t* p,
                                         const uint32_t* q,
                                         CoopScratch& s) {
  const int lane = threadIdx.x & 31;
  coop_add_at<1>(out, p, q, s.v[0], lane < 6 ? lane : 0, lane < 6);
}

// Word l (0-35) of point i of limb-major planes x, y, z (word k of point i
// at [k * stride + i]).
__device__ __forceinline__ uint32_t pt_word(const uint32_t* x,
                                            const uint32_t* y,
                                            const uint32_t* z,
                                            int64_t stride, int64_t i,
                                            int l) {
  const uint32_t* c = l < 12 ? x : (l < 24 ? y : z);
  return c[(int64_t)(l % 12) * stride + i];
}

// Point i of the planes into the shared point `dst`, by the whole warp
// (lane l: words l and l + 32).
__device__ __forceinline__ void pt_load(uint32_t* dst, const uint32_t* x,
                                        const uint32_t* y, const uint32_t* z,
                                        int64_t stride, int64_t i) {
  const int lane = threadIdx.x & 31;
  dst[lane] = pt_word(x, y, z, stride, i, lane);
  if (lane < 4) dst[32 + lane] = pt_word(x, y, z, stride, i, 32 + lane);
  __syncwarp();
}

// The shared point `src` into point i of the planes, by the whole warp.
__device__ __forceinline__ void pt_store(uint32_t* x, uint32_t* y,
                                         uint32_t* z, int64_t stride,
                                         int64_t i, const uint32_t* src) {
  const int lane = threadIdx.x & 31;
  for (int l = lane; l < 36; l += 32) {
    uint32_t* c = l < 12 ? x : (l < 24 ? y : z);
    c[(int64_t)(l % 12) * stride + i] = src[l];
  }
}
