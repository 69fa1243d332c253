// Kernel 2: radix-2 NTT over Fr on a (8, B, n) batch, Montgomery form in
// and out, natural order in and out.
//
// Replaces: distributed_plonk_tpu/backend/ntt_pallas.py:_group_call (body
// _ntt_group_kernel, called through run_groups), the fused multi-stage
// constant-geometry NTT that ntt_jax.run_stages runs on the TPU.
//
// Design: one launch per Gentleman-Sande (decimation-in-frequency) stage,
// one thread per butterfly across the whole batch, in place; then one
// bit-reversal gather into the output. Twiddles come from one Montgomery
// table w^0 .. w^(n/2 - 1) that the plan builds once (stage s reads every
// 2^s-th entry). The forward coset pre-scale g^i is fused into the first
// stage's loads; the inverse 1/n (and g^-i for the coset) post-scale into
// the last stage's stores, from a table the plan lays out in bit-reversed
// order so the post-scale lands on the right element after the gather.
//
// Bound on the H100: at n = 2^16 every stage streams the batch through HBM
// (32 bytes in and out per element and stage) while doing one Fr product
// per butterfly (128 multiply-adds): about 4 multiply-adds per byte, near
// the card's balance point, so this first version is bounded by its
// log2(n) + 1 full passes over memory. Fusing several stages per pass in
// shared memory (what the TPU kernel did in VMEM) is the next step.
#include "field.cuh"

__global__ void ntt_stage_kernel(uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ tw,
                                 const uint32_t* __restrict__ pre,
                                 const uint32_t* __restrict__ post,
                                 int log_n, int stage, int64_t batch) {
  const int64_t n = (int64_t)1 << log_n;
  const int64_t half_n = n >> 1;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= batch * half_n) return;
  const int64_t b = tid >> (log_n - 1);
  const int64_t j = tid & (half_n - 1);
  const int span_log = log_n - stage - 1;       // half-block = 2^span_log
  const int64_t k = j & (((int64_t)1 << span_log) - 1);
  const int64_t blk = j >> span_log;
  const int64_t i0 = (blk << (span_log + 1)) + k;
  const int64_t i1 = i0 + ((int64_t)1 << span_log);
  const int64_t stride = batch * n;             // between words
  uint32_t u[8], v[8], t[8], w[8];
  fe_load<Fr>(u, x, stride, b * n + i0);
  fe_load<Fr>(v, x, stride, b * n + i1);
  if (pre != nullptr) {
    fe_load<Fr>(w, pre, n, i0);
    fe_mont_mul<Fr>(u, u, w);
    fe_load<Fr>(w, pre, n, i1);
    fe_mont_mul<Fr>(v, v, w);
  }
  fe_sub<Fr>(t, u, v);
  fe_add<Fr>(u, u, v);
  fe_load<Fr>(w, tw, half_n, k << stage);
  fe_mont_mul<Fr>(v, t, w);
  if (post != nullptr) {
    fe_load<Fr>(w, post, n, i0);
    fe_mont_mul<Fr>(u, u, w);
    fe_load<Fr>(w, post, n, i1);
    fe_mont_mul<Fr>(v, v, w);
  }
  fe_store<Fr>(x, stride, b * n + i0, u);
  fe_store<Fr>(x, stride, b * n + i1, v);
}

__global__ void bitrev_kernel(uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ in, int log_n,
                              int64_t batch) {
  const int64_t n = (int64_t)1 << log_n;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= batch * n) return;
  const int64_t b = tid >> log_n;
  const int64_t i = tid & (n - 1);
  const int64_t r = (int64_t)(__brev((unsigned)i) >> (32 - log_n));
  const int64_t stride = batch * n;
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k * stride + b * n + i] =
      in[k * stride + b * n + r];
}

// x: (8, batch, n) contiguous, transformed in place by one stage.
// tw: (8, n/2); pre/post: (8, n) or null. Returns cudaGetLastError().
extern "C" int dpt_ntt_stage(void* x, const void* tw, const void* pre,
                             const void* post, int log_n, int stage,
                             long long batch, void* stream) {
  const int64_t work = batch * ((int64_t)1 << (log_n - 1));
  if (work <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  ntt_stage_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)x, (const uint32_t*)tw, (const uint32_t*)pre,
      (const uint32_t*)post, log_n, stage, batch);
  return (int)cudaGetLastError();
}

// out[:, b, i] = in[:, b, bitrev(i)] for (8, batch, n) arrays.
extern "C" int dpt_ntt_bitrev(void* out, const void* in, int log_n,
                              long long batch, void* stream) {
  const int64_t work = batch * ((int64_t)1 << log_n);
  if (work <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  bitrev_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, log_n, batch);
  return (int)cudaGetLastError();
}
