// Kernel 4: elementwise complete projective G1 addition, full (RCB15
// algorithm 7) and mixed (algorithm 8, Q affine; the caller applies any
// Q-at-infinity select, as curve_jax does).
//
// Replaces: distributed_plonk_tpu/backend/curve_pallas.py:_add_flat (bodies
// _add_mixed_kernel / _add_full_kernel), the fused whole-formula add behind
// curve_jax.proj_add(_mixed).
//
// In the port it carries the MSM tail: the fold of the group planes and
// the bucket running sums and window weighting of `finish`, each an
// O(windows x buckets) batch of independent adds. One thread per point,
// coordinates in registers, the same device function as kernel 3.
//
// Bound on the H100: operations. 12 Fq products (about 3,500 32-bit
// multiply-adds) per 288 bytes moved (full add); at the MSM tail's widths
// (hundreds to tens of thousands of lanes) a launch is also too small to
// fill the card, so launch latency is the practical floor.
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
