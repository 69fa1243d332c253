// Kernel 1: elementwise Montgomery product a * b * R^-1 mod p over Fr or Fq.
//
// Replaces: distributed_plonk_tpu/backend/field_pallas.py:_mont_mul_flat
// (bodies _mont_mul_kernel / _mont_mul_kernel_lazy / _mont_mul_kernel_mxu),
// the multiplier behind field_jax.mont_mul on the TPU.
//
// Bound on the H100: operations. One Fq product is 2 * 12^2 = 288 32-bit
// multiply-adds (each a lo/hi pair of IMADs) against 3 * 48 bytes moved, so
// the integer pipes bound it long before HBM does (Fr: 128 multiply-adds
// per 96 bytes). The TPU kernel split 16-bit limbs into bytes to ride the
// f32 units and a bf16 Toeplitz matmul; Hopper has a native 32 x 32 -> 64
// integer multiply, so this is plain word-level CIOS with one thread per
// element, the operands in registers and limb-major (coalesced) loads.
#include "field.cuh"

template <class F>
__global__ void mont_mul_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::N], y[F::N], r[F::N];
  fe_load<F>(x, a, n, i);
  fe_load<F>(y, b, n, i);
  fe_mont_mul<F>(r, x, y);
  fe_store<F>(out, n, i, r);
}

// field: 0 = Fr, 1 = Fq. out/a/b: (N_words, n) contiguous. Returns the
// cudaGetLastError() code of the launch.
extern "C" int dpt_mont_mul(int field, void* out, const void* a,
                            const void* b, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) {
    mont_mul_kernel<Fr><<<blocks, threads, 0, s>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n);
  } else {
    mont_mul_kernel<Fq><<<blocks, threads, 0, s>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n);
  }
  return (int)cudaGetLastError();
}
