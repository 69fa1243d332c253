// Kernel 1: elementwise Montgomery product a * b * R^-1 mod p over Fr or Fq.
//
// Replaces: distributed_plonk_tpu/backend/field_pallas.py:_mont_mul_flat
// (bodies _mont_mul_kernel / _mont_mul_kernel_lazy / _mont_mul_kernel_mxu),
// the multiplier behind field_jax.mont_mul on the TPU.
//
// Bound on the H100: bytes at the main path's widths. One Fr product is
// about 2 * (2 * 8^2 + 8) = 272 32-bit multiply-adds (each a lo/hi pair) on
// 96 bytes moved: at 2^16 lanes the products need about 1.1 us of the
// card's 132 SMs x 64 IMADs a clock, the 6.3 MB about 1.9 us of HBM. The
// TPU kernel split 16-bit limbs into bytes to ride the
// f32 units and a bf16 Toeplitz matmul; Hopper has a native 32 x 32 -> 64
// integer multiply and a hardware carry flag, so this is word-level CIOS
// on carry chains (field.cuh) with one thread per element.
//
// Operands are read through their strides, so the wrapper never copies
// one: the lanes form a (outer, inner) grid, and each operand has its own
// word stride and lane strides (0 for a broadcast axis, e.g. an (8, 1)
// scalar against (8, n), or the word stride of a slice x[:, i] of a
// stacked (8, k, n) tensor). The output is contiguous (L, outer * inner).
#include "field.cuh"

struct Operand {
  const uint32_t* p;
  int64_t word, outer, inner;   // strides, in words
};

template <class F>
__global__ void __launch_bounds__(256) mont_mul_kernel(
    uint32_t* __restrict__ out, Operand a, Operand b, uint32_t outer,
    uint32_t inner) {
  const uint32_t total = outer * inner;
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint32_t o = i / inner;
  const uint32_t r = i - o * inner;
  const int64_t ia = (int64_t)o * a.outer + (int64_t)r * a.inner;
  const int64_t ib = (int64_t)o * b.outer + (int64_t)r * b.inner;
  uint32_t x[F::N], y[F::N], z[F::N];
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    x[j] = __ldg(a.p + j * a.word + ia);
    y[j] = __ldg(b.p + j * b.word + ib);
  }
  fe_mont_mul<F>(z, x, y);
  fe_store<F>(out, total, i, z);
}

// field: 0 = Fr, 1 = Fq. out: (N_words, outer * inner) contiguous; a and b
// by pointer and strides (word, outer, inner) in words. outer * inner must
// be under 2^31. Returns the cudaGetLastError() code of the launch.
extern "C" int dpt_mont_mul(int field, void* out, const void* a,
                            long long a_word, long long a_outer,
                            long long a_inner, const void* b,
                            long long b_word, long long b_outer,
                            long long b_inner, long long outer,
                            long long inner, void* stream) {
  const long long n = outer * inner;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const Operand oa = {(const uint32_t*)a, a_word, a_outer, a_inner};
  const Operand ob = {(const uint32_t*)b, b_word, b_outer, b_inner};
  if (field == 0) {
    mont_mul_kernel<Fr><<<blocks, threads, 0, s>>>(
        (uint32_t*)out, oa, ob, (uint32_t)outer, (uint32_t)inner);
  } else {
    mont_mul_kernel<Fq><<<blocks, threads, 0, s>>>(
        (uint32_t*)out, oa, ob, (uint32_t)outer, (uint32_t)inner);
  }
  return (int)cudaGetLastError();
}
