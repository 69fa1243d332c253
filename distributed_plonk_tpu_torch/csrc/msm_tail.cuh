// The weighted bucket sum of kernel 4's msm_tail (curve_add.cu, one block
// per handle over the window-shifted key's bucket sums). The window finish
// (msm_finish.cu) keeps this order with the warp-cooperative add of
// curve_coop.cuh.
//
// One block per lane m: total = sum_j (j + 1) * column_j over the nb
// bucket sums, cut into S <= 8 segments of L columns. Thread s runs the
// running sum over its segment, high column first, giving the segment's
// locally weighted sum L_s and its total T_s; then total = sum_s L_s + L *
// sum_s s * T_s, where warp 0 adds the L_s in a pairwise tree while thread
// 32 runs the running sum over the T_s and log2(L) doublings. The
// dependent chain is about 2(L - 1) + 2(S - 2) + log2(L) + 1 adds (30 at
// nb = 64). The plain version is msm_torch.msm_tail_ref.
#pragma once
#include "curve.cuh"

#define DPT_TAIL_SEGMENTS 8

// A point in shared memory: 36 words, x then y then z.
typedef uint32_t pt_words[36];

__device__ __forceinline__ void pt_get(uint32_t* x, uint32_t* y, uint32_t* z,
                                       const uint32_t* s) {
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    x[k] = s[k];
    y[k] = s[12 + k];
    z[k] = s[24 + k];
  }
}

__device__ __forceinline__ void pt_put(uint32_t* s, const uint32_t* x,
                                       const uint32_t* y, const uint32_t* z) {
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    s[k] = x[k];
    s[12 + k] = y[k];
    s[24 + k] = z[k];
  }
}

__device__ __forceinline__ void pt_copy(uint32_t* x2, uint32_t* y2,
                                        uint32_t* z2, const uint32_t* x,
                                        const uint32_t* y, const uint32_t* z) {
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    x2[k] = x[k];
    y2[k] = y[k];
    z2[k] = z[k];
  }
}

// Column j of handle m (weight j + 1): bucket j when signed; bucket j + 1
// when unsigned (bucket 0 has weight 0), the identity past the last one.
__device__ __forceinline__ void tail_column(
    uint32_t* x, uint32_t* y, uint32_t* z, const uint32_t* bx,
    const uint32_t* by, const uint32_t* bz, int B, int nb, int m, int j,
    int is_signed) {
  const int bucket = is_signed ? j : j + 1;
  if (bucket >= nb) {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      x[k] = 0u;
      y[k] = kFqOne[k];
      z[k] = 0u;
    }
    return;
  }
  const int64_t stride = (int64_t)B * nb;
  const int64_t at = (int64_t)m * nb + bucket;
  fe_load<Fq>(x, bx, stride, at);
  fe_load<Fq>(y, by, stride, at);
  fe_load<Fq>(z, bz, stride, at);
}

// bx/by/bz: (12, B, nb) bucket sums; ox/oy/oz: (12, B) totals. nb = S * L
// with S <= 8 and both powers of two, S >= 2.
__global__ void __launch_bounds__(64) msm_tail_kernel(
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, const uint32_t* __restrict__ bx,
    const uint32_t* __restrict__ by, const uint32_t* __restrict__ bz, int B,
    int nb, int S, int L, int is_signed) {
  __shared__ pt_words seg_l[DPT_TAIL_SEGMENTS];
  __shared__ pt_words seg_t[DPT_TAIL_SEGMENTS];
  __shared__ pt_words ladder;
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  if (t < S) {
    // running sum over columns tL + L - 1 .. tL: run = T_t, acc = L_t
    fq_t rx, ry, rz, ax, ay, az, cx, cy, cz;
    tail_column(rx, ry, rz, bx, by, bz, B, nb, m, t * L + L - 1, is_signed);
    pt_copy(ax, ay, az, rx, ry, rz);
    for (int k = L - 2; k >= 0; --k) {
      tail_column(cx, cy, cz, bx, by, bz, B, nb, m, t * L + k, is_signed);
      proj_add_full(rx, ry, rz, rx, ry, rz, cx, cy, cz);
      proj_add_full(ax, ay, az, ax, ay, az, rx, ry, rz);
    }
    pt_put(seg_l[t], ax, ay, az);
    pt_put(seg_t[t], rx, ry, rz);
  }
  __syncthreads();
  if (t < 32) {
    // warp 0: L_0 += L_h for h = 1, 2, 4, ... (pairwise tree)
    for (int h = 1; h < S; h <<= 1) {
      if ((t & (2 * h - 1)) == 0 && t + h < S) {
        fq_t x1, y1, z1, x2, y2, z2;
        pt_get(x1, y1, z1, seg_l[t]);
        pt_get(x2, y2, z2, seg_l[t + h]);
        proj_add_full(x1, y1, z1, x1, y1, z1, x2, y2, z2);
        pt_put(seg_l[t], x1, y1, z1);
      }
      __syncwarp();
    }
  } else if (t == 32) {
    // sum_{s >= 1} s * T_s by a running sum from the top, then times L
    fq_t rx, ry, rz, ax, ay, az, cx, cy, cz;
    pt_get(rx, ry, rz, seg_t[S - 1]);
    pt_copy(ax, ay, az, rx, ry, rz);
    for (int s = S - 2; s >= 1; --s) {
      pt_get(cx, cy, cz, seg_t[s]);
      proj_add_full(rx, ry, rz, rx, ry, rz, cx, cy, cz);
      proj_add_full(ax, ay, az, ax, ay, az, rx, ry, rz);
    }
    for (int d = 1; d < L; d <<= 1)
      proj_add_full(ax, ay, az, ax, ay, az, ax, ay, az);
    pt_put(ladder, ax, ay, az);
  }
  __syncthreads();
  if (t == 0) {
    fq_t x1, y1, z1, x2, y2, z2;
    pt_get(x1, y1, z1, seg_l[0]);
    pt_get(x2, y2, z2, ladder);
    proj_add_full(x1, y1, z1, x1, y1, z1, x2, y2, z2);
    fe_store<Fq>(ox, B, m, x1);
    fe_store<Fq>(oy, B, m, y1);
    fe_store<Fq>(oz, B, m, z1);
  }
}

