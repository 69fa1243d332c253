// Kernel 3: Pippenger digit decode and bucket accumulation over G1, with
// complete projective mixed adds (RCB15 algorithm 8) and full adds
// (algorithm 7).
//
// Replaces: distributed_plonk_tpu/backend/msm_pallas.py:_bucket_call (body
// _bucket_kernel; entries bucket_scan / bucket_scan_signed), the fused
// VMEM-resident kernel behind msm_jax._bucket_scan(_signed) on the TPU,
// which decoded each op word's digit in its own body and kept every
// (group, lane) bucket plane in VMEM for the whole point stream.
//
// Function: for each lane m and bucket b, the sum of the points whose op
// in lane m selects b, over any point stream. With the base layout (lanes
// = handles x windows over the n key points) these are msm_jax's folded
// planes as points; on the main path the stream is the window-shifted key
// (2^(c*w) P_j at row w*n + j), so the lanes are the handles alone and
// the windows need no Horner afterwards.
//
// What bounds it on the H100: operations. A mixed add is 11 Fq products
// of 2 * (2 * 12^2 + 12) = 600 32-bit multiply-adds each, against a
// 96-byte point read from a 29 MB key that stays in the 50 MB L2. A
// thread's add is a dependent chain of those products, so the card is
// full only when several warps per scheduler have independent chains.
//
// Design, in three steps (the wrapper in msm_torch.py runs them):
//  1. msm_digits: one thread per (handle, point) converts the Montgomery
//     scalar to canonical form (one Fr product by 1) and recodes all
//     windows in registers, carry included; it writes each op word
//     (bucket | neg << 8 | skip << 9) and its sort key lane * nb + bucket,
//     or the sentinel lanes * nb for a skip (zero digit, point at
//     infinity, padding).
//  2. A stable sort of the keys (torch, index bookkeeping only): each
//     bucket's points become one run, in point order.
//  3. bucket_sums: each run is cut into chunks of `chunk` points; one
//     thread per chunk gathers its points through the sorted order from
//     the point-major key (six 16-byte loads per point) and adds them from
//     the identity, y negated for negative digits. A second launch with
//     one block per bucket folds the bucket's chunk partials in a fixed
//     pairwise tree (stride 1, 2, 4, ... in place). No thread's chain is
//     longer than chunk + log2(chunks) adds, no atomics, and the order of
//     every addition is fixed, so the coordinates equal those of the plain
//     version (msm_torch.bucket_sums_ref) exactly.
#include "curve.cuh"

#define DPT_NEG_BIT 8
#define DPT_SKIP_BIT 9

// Resident 128-thread blocks per SM that the chunk and tree kernels are
// compiled for. Uncapped, ptxas gives them about 184 registers (two blocks
// per SM); three blocks cap them at 168 with a few dozen bytes of spill,
// three warps per scheduler, and a round-1 batch's ~47,000 chunk threads
// then fit in one wave. Each thread's chain is latency-bound, so the wave
// count sets the time.
#define DPT_MSM_MIN_BLOCKS 3

// --- 1. digit decode --------------------------------------------------------

// v: (8, B, n) Montgomery Fr words; inf: (n,) point-at-infinity flags.
// ops, keys: (B, W, n). Lane of (handle b, window w): b if shifted, else
// b * W + w. Signed windows carry (bias nb = 2^(c-1)); unsigned windows
// use the digit as the bucket and skip digit 0.
__global__ void __launch_bounds__(256) digits_kernel(
    int32_t* __restrict__ ops, int32_t* __restrict__ keys,
    const uint32_t* __restrict__ v, const uint8_t* __restrict__ inf, int B,
    int64_t n, int c, int W, int nb, int is_signed, int shifted) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)B * n) return;
  const int64_t b = tid / n;
  const int64_t j = tid - b * n;
  uint32_t a[8], s[8], one[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = v[(int64_t)k * B * n + tid];
    one[k] = k == 0 ? 1u : 0u;
  }
  fe_mont_mul<Fr>(s, a, one);  // a * 1 * R^-1: the canonical scalar
  const bool pt_skip = inf[j] != 0;
  const int64_t lanes = shifted ? (int64_t)B : (int64_t)B * W;
  const int32_t sentinel = (int32_t)(lanes * nb);
  const uint32_t mask = (1u << c) - 1u;
  uint32_t carry = 0;
  for (int w = 0; w < W; ++w) {
    const int bit = c * w;
    const int i = bit >> 5, off = bit & 31;
    uint32_t u = s[i] >> off;
    if (off + c > 32 && i + 1 < 8) u |= s[i + 1] << (32 - off);
    u &= mask;
    uint32_t op;
    bool skip;
    if (is_signed) {
      const uint32_t t = u + carry;
      carry = t >= (uint32_t)nb ? 1u : 0u;
      const int d = (int)((t + nb) & (2 * nb - 1)) - nb;
      const uint32_t mag = (uint32_t)(d < 0 ? -d : d);
      skip = mag == 0 || pt_skip;
      op = (mag == 0 ? 0u : mag - 1u) | ((d < 0 ? 1u : 0u) << DPT_NEG_BIT);
    } else {
      skip = u == 0 || pt_skip;
      op = u;
    }
    op |= (skip ? 1u : 0u) << DPT_SKIP_BIT;
    const int64_t lane = shifted ? b : b * W + w;
    const int64_t e = (b * W + w) * n + j;
    ops[e] = (int32_t)op;
    keys[e] = skip ? sentinel : (int32_t)(lane * nb + (op & 0xffu));
  }
}

// --- 3. chunked accumulation and the pairwise tree -------------------------

// count4 x 16 bytes -> registers; `cached` reads through the read-only
// path (the key), plain loads read what the same launch wrote (partials).
template <bool cached>
__device__ __forceinline__ void load_words(uint32_t* r, const uint4* src,
                                           int count4) {
#pragma unroll
  for (int i = 0; i < count4; ++i) {
    const uint4 q = cached ? __ldg(src + i) : src[i];
    r[4 * i] = q.x;
    r[4 * i + 1] = q.y;
    r[4 * i + 2] = q.z;
    r[4 * i + 3] = q.w;
  }
}

__device__ __forceinline__ void store_words(uint4* dst, const uint32_t* r,
                                            int count4) {
#pragma unroll
  for (int i = 0; i < count4; ++i)
    dst[i] = make_uint4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
}

// A partial is one projective point, 36 words (9 x 16 bytes): x, y, z.
__device__ __forceinline__ void load_partial(uint32_t* x, uint32_t* y,
                                             uint32_t* z, const uint4* p) {
  load_words<false>(x, p, 3);
  load_words<false>(y, p + 3, 3);
  load_words<false>(z, p + 6, 3);
}

__device__ __forceinline__ void store_partial(uint4* p, const uint32_t* x,
                                              const uint32_t* y,
                                              const uint32_t* z) {
  store_words(p, x, 3);
  store_words(p + 3, y, 3);
  store_words(p + 6, z, 3);
}

// One thread per chunk c < chunk_start[nbk] (the grid is sized from an
// upper bound, so threads past the end return). key: (P, 24) point-major
// affine Montgomery (x then y, 96 bytes a row); order: the stable sort of
// the keys, as flat element indices e = lane * P + point.
__global__ void __launch_bounds__(128, DPT_MSM_MIN_BLOCKS) chunk_kernel(
    uint4* __restrict__ partials, const uint4* __restrict__ key,
    const int32_t* __restrict__ ops, const int32_t* __restrict__ order,
    const int32_t* __restrict__ count_start,
    const int32_t* __restrict__ chunk_start, int64_t P, int nbk,
    int64_t cmax, int chunk) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cmax || c >= chunk_start[nbk]) return;
  // the bucket that owns chunk c: chunk_start[lo] <= c < chunk_start[lo+1]
  int lo = 0, hi = nbk;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= c) lo = mid; else hi = mid;
  }
  const int64_t begin =
      count_start[lo] + (c - chunk_start[lo]) * (int64_t)chunk;
  const int64_t run_end = count_start[lo + 1];
  const int64_t end =
      begin + chunk < run_end ? begin + (int64_t)chunk : run_end;
  fq_t x1, y1, z1, x2, y2, zero;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    x1[k] = 0u;
    y1[k] = kFqOne[k];
    z1[k] = 0u;
    zero[k] = 0u;
  }
  for (int64_t i = begin; i < end; ++i) {
    const int64_t e = order[i];
    const int64_t p = e % P;
    const uint32_t op = (uint32_t)__ldg(ops + e);
    load_words<true>(x2, key + p * 6, 3);
    load_words<true>(y2, key + p * 6 + 3, 3);
    if ((op >> DPT_NEG_BIT) & 1u) fe_sub<Fq>(y2, zero, y2);
    proj_add_mixed(x1, y1, z1, x1, y1, z1, x2, y2);
  }
  store_partial(partials + c * 9, x1, y1, z1);
}

// One block per bucket: partials [start, start + k) folded in place,
// p[i] += p[i + s] for i % 2s == 0, s = 1, 2, 4, ...; then the bucket sum
// p[start] (the identity for an empty bucket) goes to word-major
// (12, nbk) outputs.
__global__ void __launch_bounds__(128, DPT_MSM_MIN_BLOCKS) tree_kernel(
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, uint4* partials,
    const int32_t* __restrict__ chunk_start, int nbk) {
  const int b = blockIdx.x;
  const int64_t start = chunk_start[b];
  const int64_t k = chunk_start[b + 1] - start;
  uint4* p = partials + start * 9;
  for (int64_t s = 1; s < k; s <<= 1) {
    for (int64_t i = (int64_t)threadIdx.x * 2 * s; i + s < k;
         i += (int64_t)blockDim.x * 2 * s) {
      fq_t x1, y1, z1, x2, y2, z2;
      load_partial(x1, y1, z1, p + i * 9);
      load_partial(x2, y2, z2, p + (i + s) * 9);
      proj_add_full(x1, y1, z1, x1, y1, z1, x2, y2, z2);
      store_partial(p + i * 9, x1, y1, z1);
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  fq_t x, y, z;
  if (k == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      x[j] = 0u;
      y[j] = kFqOne[j];
      z[j] = 0u;
    }
  } else {
    load_partial(x, y, z, p);
  }
  fe_store<Fq>(ox, nbk, b, x);
  fe_store<Fq>(oy, nbk, b, y);
  fe_store<Fq>(oz, nbk, b, z);
}

// ops, keys: (B, W, n) int32; v: (8, B, n) Montgomery Fr; inf: (n,) uint8.
// Returns cudaGetLastError().
extern "C" int dpt_msm_digits(void* ops, void* keys, const void* v,
                              const void* inf, int B, long long n, int c,
                              int W, int nb, int is_signed, int shifted,
                              void* stream) {
  const int64_t work = (int64_t)B * n;
  if (work <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  digits_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)ops, (int32_t*)keys, (const uint32_t*)v,
      (const uint8_t*)inf, B, n, c, W, nb, is_signed, shifted);
  return (int)cudaGetLastError();
}

// ox/oy/oz: (12, nbk) bucket sums; partials: (cmax, 36) scratch; key:
// (P, 24) point-major; ops and order: (lanes * P,); count_start and
// chunk_start: (nbk + 1,) exclusive prefix sums of the bucket runs and of
// their chunk counts. cmax bounds chunk_start[nbk]. Returns
// cudaGetLastError() after the second launch.
extern "C" int dpt_bucket_sums(void* ox, void* oy, void* oz, void* partials,
                               const void* key, const void* ops,
                               const void* order, const void* count_start,
                               const void* chunk_start, long long P, int nbk,
                               long long cmax, int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cmax > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((cmax + threads - 1) / threads);
    chunk_kernel<<<blocks, threads, 0, s>>>(
        (uint4*)partials, (const uint4*)key, (const int32_t*)ops,
        (const int32_t*)order, (const int32_t*)count_start,
        (const int32_t*)chunk_start, P, nbk, cmax, chunk);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (nbk <= 0) return 0;
  tree_kernel<<<nbk, 128, 0, s>>>((uint32_t*)ox, (uint32_t*)oy,
                                  (uint32_t*)oz, (uint4*)partials,
                                  (const int32_t*)chunk_start, nbk);
  return (int)cudaGetLastError();
}
