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
// dpt_proj_add, the full add: elementwise over n points, with a repeat
// count (out = p + q, then out = out + out reps - 1 more times; the key
// build's window of c doublings is one launch with q = p and reps = c).
// Two bodies:
//  - add_coop_kernel (narrow widths): curve_coop.cuh's two-level add on
//    six lanes an add, five adds a warp (lanes 6g..6g+5, lanes 30-31
//    shadow), a block of 8 warps on 40 consecutive points. The block
//    stages their inputs from the limb-major planes into shared memory
//    (consecutive threads on consecutive points of one word row), keeps
//    each point there between the repeats and writes the results back
//    the same way, so the output may alias an input. An add's chain is
//    two products deep instead of twelve.
//  - add_full_kernel (wide widths): one thread a point, coordinates in
//    registers, the same device functions as kernel 3. It spends about
//    two thirds of the cooperative add's instructions (no operand
//    tables, stage A once instead of on six lanes), which wins once the
//    card is full.
// curve_torch.COOP_MAX_LANES picks the body by width (measurements there).
//
// dpt_msm_tail: the MSM tail of one commit batch over the window-shifted
// key in one launch, one block per handle: total = sum_j (j + 1) *
// column_j over the nb bucket sums (msm_tail.cuh: segment running sums,
// about 30 dependent adds at nb = 64), against 358 launches per batch for
// the fold and finish it replaces. The shifted key leaves no windows to
// combine; the base layout's Horner over windows is msm_finish.cu.
//
// Bound on the H100: operations. 12 Fq products (about 7,200 32-bit
// multiply-adds) per full add. At the v1 key's width (8,224 lanes) and
// the mesh fold's (320) one thread a point cannot fill the card, so its
// chain of twelve products sets the time; the tail (a few blocks) is one
// thread's chain of 30 adds.
#include "curve_coop.cuh"
#include "msm_tail.cuh"

#define DPT_ADD_WARPS 8
#define DPT_ADD_GROUPS 5                                   // adds a warp
#define DPT_ADD_POINTS (DPT_ADD_WARPS * DPT_ADD_GROUPS)    // 40 a block
// word stride of a staged point: odd, so the lanes of a warp that read one
// word of different points and coordinates spread over the banks
#define DPT_ADD_PS (DPT_ADD_POINTS + 1)

__global__ void add_full_kernel(uint32_t* __restrict__ x3,
                                uint32_t* __restrict__ y3,
                                uint32_t* __restrict__ z3,
                                const uint32_t* __restrict__ x1,
                                const uint32_t* __restrict__ y1,
                                const uint32_t* __restrict__ z1,
                                const uint32_t* __restrict__ x2,
                                const uint32_t* __restrict__ y2,
                                const uint32_t* __restrict__ z2, int64_t n,
                                int reps) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fq_t a, b, c, d, e, f;
  fe_load<Fq>(a, x1, n, i);
  fe_load<Fq>(b, y1, n, i);
  fe_load<Fq>(c, z1, n, i);
  fe_load<Fq>(d, x2, n, i);
  fe_load<Fq>(e, y2, n, i);
  fe_load<Fq>(f, z2, n, i);
  // one call site of the add for every repeat
#pragma unroll 1
  for (int k = 0; k < reps; ++k) {
    proj_add_full(a, b, c, a, b, c, d, e, f);
#pragma unroll
    for (int w = 0; w < 12; ++w) {
      d[w] = a[w];
      e[w] = b[w];
      f[w] = c[w];
    }
  }
  fe_store<Fq>(x3, n, i, a);
  fe_store<Fq>(y3, n, i, b);
  fe_store<Fq>(z3, n, i, c);
}

// The cooperative body. Block b owns points 40 b .. 40 b + 39; a ragged
// last block computes its missing adds on its last valid point and
// stores none of them, and every lane reaches every __syncwarp. No block
// reads a point another block writes, so the output may alias an input.
__global__ void __launch_bounds__(32 * DPT_ADD_WARPS) add_coop_kernel(
    uint32_t* x3, uint32_t* y3, uint32_t* z3, const uint32_t* x1,
    const uint32_t* y1, const uint32_t* z1, const uint32_t* x2,
    const uint32_t* y2, const uint32_t* z2, int64_t n, int reps) {
  // word l of staged point j of input k at pts[k][l * DPT_ADD_PS + j]
  __shared__ uint32_t pts[2][36 * DPT_ADD_PS];
  __shared__ CoopScratch scratch[DPT_ADD_POINTS];
  const int64_t p0 = (int64_t)blockIdx.x * DPT_ADD_POINTS;
  const int valid = (int)(n - p0 < DPT_ADD_POINTS ? n - p0 : DPT_ADD_POINTS);
  // q = p (the doublings): one input to stage
  const bool dbl = x2 == x1 && y2 == y1 && z2 == z1;
  const int words = (dbl ? 1 : 2) * 36 * DPT_ADD_POINTS;
  for (int t = threadIdx.x; t < words; t += blockDim.x) {
    const int k = t / (36 * DPT_ADD_POINTS);
    const int l = t / DPT_ADD_POINTS % 36;
    const int j = t % DPT_ADD_POINTS;
    const int64_t i = p0 + (j < valid ? j : valid - 1);
    pts[k][l * DPT_ADD_PS + j] = k ? pt_word(x2, y2, z2, n, i, l)
                                   : pt_word(x1, y1, z1, n, i, l);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int g = lane < 6 * DPT_ADD_GROUPS ? lane / 6 : DPT_ADD_GROUPS - 1;
  const bool writer = lane < 6 * DPT_ADD_GROUPS;
  const int j = (threadIdx.x >> 5) * DPT_ADD_GROUPS + g;
  uint32_t* acc = pts[0] + j;
  const uint32_t* q = pts[dbl ? 0 : 1] + j;
  uint32_t* s = scratch[j].v[0];
  const int r = writer ? lane - 6 * g : 0;
  // one call site of the add for every repeat
#pragma unroll 1
  for (int k = 0; k < reps; ++k)
    coop_add_at<DPT_ADD_PS>(acc, acc, k == 0 ? q : acc, s, r, writer);
  __syncthreads();
  for (int t = threadIdx.x; t < 36 * DPT_ADD_POINTS; t += blockDim.x) {
    const int l = t / DPT_ADD_POINTS, jj = t % DPT_ADD_POINTS;
    if (jj >= valid) continue;
    uint32_t* c = l < 12 ? x3 : (l < 24 ? y3 : z3);
    c[(int64_t)(l % 12) * n + p0 + jj] = pts[0][l * DPT_ADD_PS + jj];
  }
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

// All arrays (12, n) contiguous; z2 == null selects the mixed formula
// (reps 1). Full add: `coop` selects the cooperative body, else the one
// thread a point; reps >= 1 repeats (out = out + out after the first).
// Returns cudaGetLastError(), or -1 for arguments the kernels do not take.
extern "C" int dpt_proj_add(void* x3, void* y3, void* z3, const void* x1,
                            const void* y1, const void* z1, const void* x2,
                            const void* y2, const void* z2, long long n,
                            int reps, int coop, void* stream) {
  if (reps < 1 || (z2 == nullptr && reps != 1)) return -1;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (z2 != nullptr && coop) {
    const unsigned blocks =
        (unsigned)((n + DPT_ADD_POINTS - 1) / DPT_ADD_POINTS);
    add_coop_kernel<<<blocks, 32 * DPT_ADD_WARPS, 0, s>>>(
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, (const uint32_t*)x1,
        (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const uint32_t*)z2, n, reps);
    return (int)cudaGetLastError();
  }
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (z2 != nullptr) {
    add_full_kernel<<<blocks, threads, 0, s>>>(
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, (const uint32_t*)x1,
        (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const uint32_t*)z2, n, reps);
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
