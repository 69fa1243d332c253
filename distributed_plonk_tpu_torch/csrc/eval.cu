// Round 4's batched evaluation, kernel 8: p_b(z_b) for B polynomials of L
// Fr coefficients at B points, every value in Montgomery form (words
// little-endian, limb-major as field.cuh's handles).
//
// Replaces no Pallas kernel. The JAX package computes it as one XLA
// program, prover_jax.poly_eval / poly_eval_many
// (distributed_plonk_tpu/backend/prover_jax.py:319, :353): a vmap of a
// block Horner (a lax.scan of 256 steps), a power combine and a log-tree
// sum. Its plain version here (prover_torch.poly_eval_ref) unrolls that
// scan into 256 kernel-1 launches, each with a plain field add of about 60
// torch launches, then a power loop of dependent kernel-1 launches; a call
// of this kernel is one launch, or two where a polynomial spans blocks.
//
// Bound on the H100: operations. B * L Fr products at about 272 32-bit
// multiply-adds each (trace.FR_MUL_IMADS) against 32 bytes read per
// coefficient, 8.5 multiply-adds a byte, above the card's balance of about
// 5: v1's round 4, (8, 10, 8,195), 1.3 us; v2's, (8, 10, 262,147), 42.6
// us; 2^20's, (8, 10, 1,048,579), 170.5 us (bytes: 0.8 / 25.0 / 100.2
// us).
//
// Few polynomials: B is 10 on the main path (round 4's ten evaluations)
// and 1 on a fleet worker's EVAL, so the parallelism comes from splitting
// each polynomial, not from B. A polynomial takes `blocks` blocks of 256
// threads (a power of two, the largest with blocks * 256 * 32 <= L, at
// least 1: every thread of a split polynomial holds 32 coefficients or
// more), G = blocks * 256 threads in all. The split is interleaved:
// thread r takes coefficients r, r + G, r + 2G, ... and runs Horner over
// them in base z^G in registers, one product and one add a coefficient,
// so the 32 threads of a warp read 32 neighbouring words of each load
// (lanes are contiguous); a contiguous run a thread would read words a run
// apart. The block's 256 values then fold in a shared-memory tree whose
// level of stride h adds v[t + h] * z^h into v[t], leaving the block's
// partial sum_t v_t z^t. The powers z^(2^i) come from one squaring chain
// a block, made by thread 0 in shared memory. With more than one block a
// polynomial, the partials (the wrapper's (8, B, blocks) scratch) are a
// polynomial in z^256, which a second launch of the same kernel evaluates
// at one block a polynomial. Blocks run in no order, so no sum is carried
// across them.
//
// Every step is a Montgomery product or a field add of field.cuh, both
// exact on canonical inputs, so the output equals the plain version word
// for word whatever the split.
#include "field.cuh"

#define DPT_EVAL_THREADS 256
#define DPT_EVAL_LOG_THREADS 8
// z^(2^i) for i <= shift + log2 G, at most 30 (log_blocks <= 22)
#define DPT_EVAL_CHAIN 40

// One block of polynomial blockIdx.y: out[k * out_word + b * out_poly +
// blockIdx.x] = sum over this block's threads t of v_t * y^t, where
// y = z_b^(2^shift), thread r = blockIdx.x * 256 + t holds
// v_r = sum_j in[r + j G] y^(j G) and G = 2^log_g threads cover the
// polynomial. The partial of block x weighs y^(256 x) in p(y).
__global__ void __launch_bounds__(DPT_EVAL_THREADS) eval_kernel(
    uint32_t* out, long long out_word, long long out_poly,
    const uint32_t* in, long long in_word, long long in_poly, long long L,
    const uint32_t* zs, long long z_word, long long z_poly, int shift,
    int log_g) {
  __shared__ uint32_t pw[DPT_EVAL_CHAIN][8];          // z^(2^i)
  __shared__ uint32_t part[8][DPT_EVAL_THREADS];      // the tree, by word
  const int t = threadIdx.x;
  const long long b = blockIdx.y;
  if (t == 0) {
    uint32_t x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = zs[k * z_word + b * z_poly];
#pragma unroll
    for (int k = 0; k < 8; ++k) pw[0][k] = x[k];
#pragma unroll 1
    for (int i = 1; i <= shift + log_g; ++i) {
      fe_mont_mul<Fr>(x, x, x);
#pragma unroll
      for (int k = 0; k < 8; ++k) pw[i][k] = x[k];
    }
  }
  __syncthreads();

  // Horner over the thread's coefficients, the last first, in base y^G
  const long long G = 1LL << log_g;
  const long long r = (long long)blockIdx.x * DPT_EVAL_THREADS + t;
  const uint32_t* p = in + b * in_poly;
  uint32_t acc[8], c[8], yg[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[k] = 0u;
    yg[k] = pw[shift + log_g][k];
  }
  if (r < L) {
    long long i = r + (L - 1 - r) / G * G;
    fe_load<Fr>(acc, p, in_word, i);
#pragma unroll 1
    for (i -= G; i >= r; i -= G) {
      fe_load<Fr>(c, p, in_word, i);
      fe_mont_mul<Fr>(acc, acc, yg);
      fe_add<Fr>(acc, acc, c);
    }
  }

  // the block's tree: at stride h, v[t] += v[t + h] * y^h for t < h
#pragma unroll
  for (int k = 0; k < 8; ++k) part[k][t] = acc[k];
#pragma unroll 1
  for (int lg = DPT_EVAL_LOG_THREADS - 1; lg >= 0; --lg) {
    const int h = 1 << lg;
    __syncthreads();
    if (t < h) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        c[k] = part[k][t + h];
        yg[k] = pw[shift + lg][k];
      }
      fe_mont_mul<Fr>(c, c, yg);
      fe_add<Fr>(acc, acc, c);
#pragma unroll
      for (int k = 0; k < 8; ++k) part[k][t] = acc[k];
    }
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      out[k * out_word + b * out_poly + blockIdx.x] = acc[k];
  }
}

// out: (8, B) contiguous, p_b(z_b) in Montgomery form. in: the (8, B, L)
// coefficients by word and polynomial strides (coefficients contiguous);
// zs: the (8, B, 1) points by word and polynomial strides. log_blocks:
// log2 of the blocks a polynomial takes; above 0, scratch is an (8, B,
// 2^log_blocks) contiguous buffer for the blocks' partials, which a second
// launch sums. Returns cudaGetLastError() after each launch, or -1 for a
// shape the kernel does not take.
extern "C" int dpt_poly_eval(void* out, void* scratch, const void* in,
                             long long in_word, long long in_poly,
                             long long L, const void* zs, long long z_word,
                             long long z_poly, int B, int log_blocks,
                             void* stream) {
  if (L <= 0 || L >= (1LL << 31) || B <= 0 || B > 65535 || log_blocks < 0
      || log_blocks > 22)
    return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  const int log_g = log_blocks + DPT_EVAL_LOG_THREADS;
  const uint32_t* z = (const uint32_t*)zs;
  if (log_blocks == 0) {
    eval_kernel<<<dim3(1, B), DPT_EVAL_THREADS, 0, s>>>(
        (uint32_t*)out, B, 1, (const uint32_t*)in, in_word, in_poly, L, z,
        z_word, z_poly, 0, log_g);
    return (int)cudaGetLastError();
  }
  const long long blocks = 1LL << log_blocks;
  eval_kernel<<<dim3((unsigned)blocks, B), DPT_EVAL_THREADS, 0, s>>>(
      (uint32_t*)scratch, B * blocks, blocks, (const uint32_t*)in, in_word,
      in_poly, L, z, z_word, z_poly, 0, log_g);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // the partials: `blocks` coefficients of a polynomial in z^256
  eval_kernel<<<dim3(1, B), DPT_EVAL_THREADS, 0, s>>>(
      (uint32_t*)out, B, 1, (const uint32_t*)scratch, B * blocks, blocks,
      blocks, z, z_word, z_poly, DPT_EVAL_LOG_THREADS,
      DPT_EVAL_LOG_THREADS);
  return (int)cudaGetLastError();
}
