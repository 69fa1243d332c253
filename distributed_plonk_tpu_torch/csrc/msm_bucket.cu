// Kernel 3: Pippenger bucket accumulation with complete projective mixed
// adds (RCB15 algorithm 8) over G1.
//
// Replaces: distributed_plonk_tpu/backend/msm_pallas.py:_bucket_call (body
// _bucket_kernel; entries bucket_scan / bucket_scan_signed), the fused
// VMEM-resident bucket kernel behind msm_jax._bucket_scan(_signed) on the
// TPU.
//
// Layout (msm_jax's): n points split into G contiguous groups of
// steps = n / G points; M digit lanes (batch x windows). Op words
// (M, n): bits [0, 8) bucket index, bit 8 negate y, bit 9 skip (zero digit,
// point at infinity, or padding). Output planes (12, G, M, nb) per
// coordinate, word-major like every handle of the port.
//
// Design: the TPU walked the points in a sequential grid with planes
// resident in VMEM. The card has no sequential grid, so one thread owns one
// (group, lane) pair and walks its group's points in order: its nb
// projective buckets (9.2 KB at nb = 64) live in the output planes
// themselves, which the thread initialises to the identity (0 : 1 : 0) and
// updates in place; at the port's group widths the planes fit in the 50 MB
// L2. Each step reads one op word and, unless it skips, one affine point
// (shared by the M threads of its group) and one bucket, and writes the
// bucket back. The planes equal the JAX scan's at the same G, step for
// step.
//
// Bound on the H100: operations. One mixed add is 11 Fq products, each
// 2 * (2 * 12^2 + 12) = 600 32-bit multiply-adds in word CIOS (a 32 x 32
// -> 64-bit product counts as two), so about 6,600 per add, against one
// 96-byte point read shared by the group's lanes. The sequential walk leaves G * M threads in flight (a few
// thousand at the prover's widths), far from filling the card; more
// groups (cheaper per thread, more fold work) or lanes split across
// threads are the levers of a later version.
#include "curve.cuh"

#define DPT_NEG_BIT 8
#define DPT_SKIP_BIT 9

__global__ void bucket_kernel(uint32_t* __restrict__ ox,
                              uint32_t* __restrict__ oy,
                              uint32_t* __restrict__ oz,
                              const uint32_t* __restrict__ px,
                              const uint32_t* __restrict__ py,
                              const int32_t* __restrict__ ops, int groups,
                              int lanes, int nb, int64_t n) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)groups * lanes) return;
  const int64_t g = tid / lanes;
  const int64_t m = tid - g * lanes;
  const int64_t steps = n / groups;
  const int64_t wstride = (int64_t)groups * lanes * nb;  // between words
  const int64_t base = (g * lanes + m) * nb;             // bucket 0 of lane

  for (int b = 0; b < nb; ++b) {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      ox[k * wstride + base + b] = 0u;
      oy[k * wstride + base + b] = kFqOne[k];
      oz[k * wstride + base + b] = 0u;
    }
  }

  const int32_t* lane_ops = ops + m * n + g * steps;
  fq_t x1, y1, z1, x2, y2, zero;
#pragma unroll
  for (int k = 0; k < 12; ++k) zero[k] = 0u;
  for (int64_t s = 0; s < steps; ++s) {
    const uint32_t op = (uint32_t)lane_ops[s];
    if ((op >> DPT_SKIP_BIT) & 1u) continue;
    const int64_t at = base + (op & (uint32_t)(nb - 1));
    const int64_t pt = g * steps + s;
    fe_load<Fq>(x1, ox, wstride, at);
    fe_load<Fq>(y1, oy, wstride, at);
    fe_load<Fq>(z1, oz, wstride, at);
    fe_load<Fq>(x2, px, n, pt);
    fe_load<Fq>(y2, py, n, pt);
    if ((op >> DPT_NEG_BIT) & 1u) fe_sub<Fq>(y2, zero, y2);
    proj_add_mixed(x1, y1, z1, x1, y1, z1, x2, y2);
    fe_store<Fq>(ox, wstride, at, x1);
    fe_store<Fq>(oy, wstride, at, y1);
    fe_store<Fq>(oz, wstride, at, z1);
  }
}

// px/py: (12, n) affine Montgomery; ops: (lanes, n) op words;
// ox/oy/oz: (12, groups, lanes, nb) outputs. groups must divide n and nb
// be a power of two. Returns cudaGetLastError().
extern "C" int dpt_bucket_accumulate(void* ox, void* oy, void* oz,
                                     const void* px, const void* py,
                                     const void* ops, int groups, int lanes,
                                     int nb, long long n, void* stream) {
  const int64_t work = (int64_t)groups * lanes;
  if (work <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  bucket_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (const uint32_t*)px,
      (const uint32_t*)py, (const int32_t*)ops, groups, lanes, nb, n);
  return (int)cudaGetLastError();
}
