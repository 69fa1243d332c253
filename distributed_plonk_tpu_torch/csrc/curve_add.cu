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
// dpt_msm_tail: the MSM tail of one commit batch over the window-shifted
// key in one launch, one block per handle: total = sum_j (j + 1) *
// column_j over the nb bucket sums (msm_tail.cuh: segment running sums,
// about 30 dependent adds at nb = 64), against 358 launches per batch for
// the fold and finish it replaces. The shifted key leaves no windows to
// combine; the base layout's Horner over windows is msm_finish.cu.
//
// Bound on the H100: operations. 12 Fq products (about 7,200 32-bit
// multiply-adds) per full add. The elementwise add at the key's width
// (8,224 lanes) and the tail (a few blocks) are too narrow to fill the
// card, so a launch costs one thread's latency through its chain.
#include "curve.cuh"
#include "msm_tail.cuh"

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
