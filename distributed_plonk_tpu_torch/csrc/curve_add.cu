// Kernel 4: complete projective G1 addition, full (RCB15 algorithm 7) and
// mixed (algorithm 8, Q affine; the caller applies any Q-at-infinity
// select, as curve_jax does), and the MSM tail built from it.
//
// Replaces: distributed_plonk_tpu/backend/curve_pallas.py:_add_flat (bodies
// _add_mixed_kernel / _add_full_kernel), the fused whole-formula add behind
// curve_jax.proj_add(_mixed), which on the TPU also carried msm_jax's fold
// and finish: running sums over the buckets, then a Horner ladder of
// c doublings per window.
//
// dpt_proj_add: elementwise, one thread per point, coordinates in
// registers, the same device functions as kernel 3. On the main path it
// builds the window-shifted commit key once per key (c doublings per
// window, each P + P over all n points).
//
// dpt_msm_tail: the MSM tail of one commit batch in one launch, one block
// per handle: total = sum_j (j + 1) * column_j over the nb bucket sums.
// The shifted key leaves no windows to combine, so no Horner chain is
// left; what remains is the weighting, cut into S <= 8 segments of L
// columns. Thread s runs the running sum over its segment, high column
// first, giving the segment's locally weighted sum L_s and its total T_s;
// then total = sum_s L_s + L * sum_s s * T_s, where warp 0 adds the L_s
// in a pairwise tree while thread 32 runs the running sum over the T_s
// and log2(L) doublings. The dependent chain is about 2(L - 1) + 2(S - 2)
// + log2(L) + 1 adds (30 at nb = 64), against 358 launches per batch for
// the fold and finish it replaces.
//
// Bound on the H100: operations. 12 Fq products (about 7,200 32-bit
// multiply-adds) per full add. The elementwise add at the key's width
// (8,224 lanes) and the tail (a few blocks) are too narrow to fill the
// card, so a launch costs one thread's latency through its chain.
#include "curve.cuh"

__global__ void add_full_kernel(uint32_t* __restrict__ x3,
                                uint32_t* __restrict__ y3,
                                uint32_t* __restrict__ z3,
                                const uint32_t* __restrict__ x1,
                                const uint32_t* __restrict__ y1,
                                const uint32_t* __restrict__ z1,
                                const uint32_t* __restrict__ x2,
                                const uint32_t* __restrict__ y2,
                                const uint32_t* __restrict__ z2, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fq_t a, b, c, d, e, f;
  fe_load<Fq>(a, x1, n, i);
  fe_load<Fq>(b, y1, n, i);
  fe_load<Fq>(c, z1, n, i);
  fe_load<Fq>(d, x2, n, i);
  fe_load<Fq>(e, y2, n, i);
  fe_load<Fq>(f, z2, n, i);
  proj_add_full(a, b, c, a, b, c, d, e, f);
  fe_store<Fq>(x3, n, i, a);
  fe_store<Fq>(y3, n, i, b);
  fe_store<Fq>(z3, n, i, c);
}

__global__ void add_mixed_kernel(uint32_t* __restrict__ x3,
                                 uint32_t* __restrict__ y3,
                                 uint32_t* __restrict__ z3,
                                 const uint32_t* __restrict__ x1,
                                 const uint32_t* __restrict__ y1,
                                 const uint32_t* __restrict__ z1,
                                 const uint32_t* __restrict__ x2,
                                 const uint32_t* __restrict__ y2, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fq_t a, b, c, d, e;
  fe_load<Fq>(a, x1, n, i);
  fe_load<Fq>(b, y1, n, i);
  fe_load<Fq>(c, z1, n, i);
  fe_load<Fq>(d, x2, n, i);
  fe_load<Fq>(e, y2, n, i);
  proj_add_mixed(a, b, c, a, b, c, d, e);
  fe_store<Fq>(x3, n, i, a);
  fe_store<Fq>(y3, n, i, b);
  fe_store<Fq>(z3, n, i, c);
}

// --- the MSM tail -----------------------------------------------------------

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

// All arrays (12, n) contiguous; z2 == null selects the mixed formula.
// Returns cudaGetLastError().
extern "C" int dpt_proj_add(void* x3, void* y3, void* z3, const void* x1,
                            const void* y1, const void* z1, const void* x2,
                            const void* y2, const void* z2, long long n,
                            void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (z2 != nullptr) {
    add_full_kernel<<<blocks, threads, 0, s>>>(
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, (const uint32_t*)x1,
        (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const uint32_t*)z2, n);
  } else {
    add_mixed_kernel<<<blocks, threads, 0, s>>>(
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, (const uint32_t*)x1,
        (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
        (const uint32_t*)y2, n);
  }
  return (int)cudaGetLastError();
}

// bx/by/bz: (12, B, nb) bucket sums -> ox/oy/oz: (12, B) totals, one block
// per handle. Returns cudaGetLastError(); refuses a segmentation the
// kernel was not written for.
extern "C" int dpt_msm_tail(void* ox, void* oy, void* oz, const void* bx,
                            const void* by, const void* bz, int B, int nb,
                            int S, int L, int is_signed, void* stream) {
  if (S < 2 || S > DPT_TAIL_SEGMENTS || S * L != nb) return -1;
  if (B <= 0) return 0;
  msm_tail_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (const uint32_t*)bx,
      (const uint32_t*)by, (const uint32_t*)bz, B, nb, S, L, is_signed);
  return (int)cudaGetLastError();
}
