// Kernel 4's window finish: the base layout's bucket sums of a commit batch
// to its totals, the counterpart of msm_jax.finish.
//
// Replaces: the second job of distributed_plonk_tpu/backend/
// curve_pallas.py:_add_flat (the fused whole-formula add behind
// curve_jax.proj_add), which on the TPU carried msm_jax.finish (the
// running sums over the buckets, then a ladder of c doublings per window
// and a pairwise tree over the windows). The window-shifted key needs no
// such finish (curve_add.cu's msm_tail); the base layout, which keeps only
// the n affine bases for keys whose shifted copy would not fit the card,
// does: its bucket sums hold one lane per (handle, window).
//
// Function: bucket sums ((12, B * W, nb),)*3, lane b * W + w, to totals
// ((12, B),)*3: total_b = sum_w 2^(c * w) * sum_j weight(j) * S_(b, w, j),
// weight j + 1 signed and j unsigned.
//
// Design, two launches on the caller's stream:
//  1. msm_tail_kernel (msm_tail.cuh), one block per (handle, window) lane:
//     the weighted bucket sum T_(b, w) by the segment running sums of
//     msm_tail, into a (12, B * W) scratch the wrapper allocates;
//  2. horner_kernel, one thread per handle: acc = T_(b, W - 1), then for
//     w = W - 2 down to 0, c doublings (P + P by the complete add) and
//     acc += T_(b, w): (W - 1) * (c + 1) dependent adds, 252 doublings and
//     36 adds at signed c = 7 (W = 37), 252 and 63 at unsigned c = 4.
// Every addition happens in a fixed order, so the coordinates equal those
// of the plain version (msm_torch.msm_finish_ref) exactly.
//
// What bounds it on the H100: neither bytes nor operations. The scratch is
// a few KB and a batch is a few handles, so one thread's chain of about
// 290 dependent full adds (12 Fq products each) sets the time: latency.
// The Horner loop calls the add from one site, so it is inlined once.
#include "curve.cuh"
#include "msm_tail.cuh"

// tx/ty/tz: (12, B * W) window sums, lane b * W + w; ox/oy/oz: (12, B).
__global__ void __launch_bounds__(32) horner_kernel(
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, const uint32_t* __restrict__ tx,
    const uint32_t* __restrict__ ty, const uint32_t* __restrict__ tz, int B,
    int W, int c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t lanes = (int64_t)B * W;
  const int64_t base = (int64_t)b * W;
  fq_t ax, ay, az, qx, qy, qz;
  fe_load<Fq>(ax, tx, lanes, base + W - 1);
  fe_load<Fq>(ay, ty, lanes, base + W - 1);
  fe_load<Fq>(az, tz, lanes, base + W - 1);
  for (int w = W - 2; w >= 0; --w) {
    for (int k = 0; k <= c; ++k) {
      if (k < c) {
        pt_copy(qx, qy, qz, ax, ay, az);       // doubling: acc + acc
      } else {
        fe_load<Fq>(qx, tx, lanes, base + w);  // then acc + T_(b, w)
        fe_load<Fq>(qy, ty, lanes, base + w);
        fe_load<Fq>(qz, tz, lanes, base + w);
      }
      proj_add_full(ax, ay, az, ax, ay, az, qx, qy, qz);
    }
  }
  fe_store<Fq>(ox, B, b, ax);
  fe_store<Fq>(oy, B, b, ay);
  fe_store<Fq>(oz, B, b, az);
}

// bx/by/bz: (12, B * W, nb) bucket sums; tx/ty/tz: (12, B * W) scratch;
// ox/oy/oz: (12, B) totals. nb = S * L as msm_tail takes it. Returns
// cudaGetLastError() after the second launch; refuses a segmentation the
// tail was not written for.
extern "C" int dpt_msm_finish(void* ox, void* oy, void* oz, void* tx,
                              void* ty, void* tz, const void* bx,
                              const void* by, const void* bz, int B, int W,
                              int c, int nb, int S, int L, int is_signed,
                              void* stream) {
  if (S < 2 || S > DPT_TAIL_SEGMENTS || S * L != nb || W < 1 || c < 1)
    return -1;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  msm_tail_kernel<<<B * W, 64, 0, s>>>(
      (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, (const uint32_t*)bx,
      (const uint32_t*)by, (const uint32_t*)bz, B * W, nb, S, L, is_signed);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  horner_kernel<<<(B + 31) / 32, 32, 0, s>>>(
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (const uint32_t*)tx,
      (const uint32_t*)ty, (const uint32_t*)tz, B, W, c);
  return (int)cudaGetLastError();
}
