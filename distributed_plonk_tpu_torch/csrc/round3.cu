// Round 3's pointwise folds over the quotient domain, one lane per thread:
// the gate fold (a batch of selector coset planes into the gate
// accumulator), the sigma fold (a batch of sigma coset planes into the
// permutation accumulator acc2) and the quotient combine (acc1 from the
// wires and the coset points, then zh_inv * (gate + alpha * (acc1 - acc2))
// + l1), whose (8, m) output is the coset iNTT's input.
//
// Replaces no Pallas kernel. The JAX package computes these folds in XLA,
// fused into its coset-NTT programs (backend/jax_backend.py
// _gate_epilogue, _sigma_epilogue and _combine_prologue under
// DPT_R3_FUSE, through NttPlan.kernel_fused): XLA fuses each fold with the
// NTT's output gather, outside the pallas_call. Their plain versions
// (prover_torch.gate_fold_ref, sigma_fold_ref, quotient_combine_ref) run
// about 60 torch launches per field add; here each fold is one launch.
// They stay kernels of their own, not modes of ntt.cu's passes: a K2
// block owns one batch row (one selector), while the gate fold sums every
// selector of a batch into one lane.
//
// Bound on the H100: operations. A lane of the gate fold over all 13
// selectors does 30 Fr products (the four Q_HASH terms x^5 cost 4 each),
// the sigma fold 2 per sigma plane, the combine 14 (k_j * beta is folded
// on the host: 5 products per lane fewer than the plain version's 19),
// about 272 32-bit multiply-adds each (mont_mul.cu), against 32 bytes per
// plane and lane. At 14-30 products over 12-20 planes that is 6-13
// multiply-adds a byte, above the card's balance of about 5.
//
// Every output is canonical (< r): each step is a Montgomery product or a
// field add/sub of field.cuh, and those are exact, so the outputs equal
// the plain versions word for word whatever the order of the adds; each
// term keeps the plain version's number of products (each product
// carries one R^-1).
//
// Operands are read through their word and plane strides (lanes
// contiguous), so views of a stacked NTT output are never copied: word k
// of plane j at lane i sits at p[k * word + j * plane + i]. Each output
// is a fresh (8, m) plane (out_word = m).
#include "field.cuh"

// at most this many quotient-domain planes or scalars per launch
#define DPT_R3_SELECTORS 13
#define DPT_R3_WIRES 5
#define DPT_R3_SCALARS 9

struct Planes {
  const uint32_t* p;
  long long word, plane;   // strides, in words
};

struct Plane {
  const uint32_t* p;
  long long word;
};

// Montgomery words of the launch's scalars, by value in the kernel's
// parameter space (no device copy, no host synchronisation)
struct Scalars {
  uint32_t w[DPT_R3_SCALARS][8];
};

__device__ __forceinline__ void load_plane(uint32_t* r, const Planes& a,
                                           int j, uint32_t i) {
  fe_load<Fr>(r, a.p + (long long)j * a.plane, a.word, i);
}

__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  fe_mont_mul<Fr>(r, a, b);
}

__device__ __forceinline__ void scalar(uint32_t* r, const Scalars& s,
                                       int k) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = s.w[k][j];
}

// gate (8, m) + the terms of selectors start .. start + count - 1 of
// circuit.py's order (Q_LC x4, Q_MUL x2, Q_HASH x4, Q_O, Q_C, Q_ECC),
// their coset planes sel[0 .. count - 1], over the five wire planes w.
// The step kind follows from the selector index: the table is fixed.
__global__ void __launch_bounds__(256) gate_fold_kernel(
    uint32_t* out, long long out_word, const uint32_t* gate,
    long long gate_word, Planes sel, Planes w, int start, int count,
    uint32_t m) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t acc[8], s[8], t[8], x[8], y[8];
  fe_load<Fr>(acc, gate, gate_word, i);
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    const int q = start + j;
    load_plane(s, sel, j, i);
    if (q == 11) {                               // Q_C: gate += sel
      fe_add<Fr>(acc, acc, s);
      continue;
    }
    if (q < 4) {                                 // Q_LC: sel * w_q
      load_plane(t, w, q, i);
    } else if (q < 6) {                          // Q_MUL: sel * (wa * wb)
      load_plane(x, w, 2 * (q - 4), i);
      load_plane(y, w, 2 * (q - 4) + 1, i);
      mul(t, x, y);
    } else if (q < 10) {                         // Q_HASH: sel * w^5
      load_plane(x, w, q - 6, i);
      mul(y, x, x);
      mul(y, y, y);
      mul(t, y, x);
    } else if (q == 10) {                        // Q_O: gate -= sel * e
      load_plane(t, w, 4, i);
    } else {                                     // Q_ECC: sel * abcde
      load_plane(x, w, 0, i);
      load_plane(y, w, 1, i);
      mul(t, x, y);
      load_plane(x, w, 2, i);
      load_plane(y, w, 3, i);
      mul(x, x, y);
      mul(t, t, x);
      load_plane(y, w, 4, i);
      mul(t, t, y);
    }
    mul(t, s, t);
    if (q == 10) {
      fe_sub<Fr>(acc, acc, t);
    } else {
      fe_add<Fr>(acc, acc, t);
    }
  }
  fe_store<Fr>(out, out_word, i, acc);
}

// acc2 * prod_j (w_{start+j} + gamma + beta * sigma_j); scalars 0 = beta,
// 1 = gamma.
__global__ void __launch_bounds__(256) sigma_fold_kernel(
    uint32_t* out, long long out_word, const uint32_t* acc2,
    long long acc_word, Planes sig, Planes w, int start, int count,
    uint32_t m, Scalars sc) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t acc[8], beta[8], gamma[8], s[8], x[8];
  scalar(beta, sc, 0);
  scalar(gamma, sc, 1);
  fe_load<Fr>(acc, acc2, acc_word, i);
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    load_plane(s, sig, j, i);
    mul(s, s, beta);
    load_plane(x, w, start + j, i);
    fe_add<Fr>(x, x, gamma);
    fe_add<Fr>(x, x, s);
    mul(acc, acc, x);
  }
  fe_store<Fr>(out, out_word, i, acc);
}

// The quotient's coset evaluations. in[]: z, gate, acc2, ep, zh_inv,
// shifted_inv; scalars 0 = gamma, 1 = alpha, 2 = alpha^2 / n, 3 = one,
// 4 + j = k_j * beta.
__global__ void __launch_bounds__(256) combine_kernel(
    uint32_t* out, Planes w, Plane z_p, Plane gate_p, Plane acc2_p,
    Plane ep_p, Plane zh_p, Plane sh_p, uint32_t m, Scalars sc) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t acc[8], z[8], ep[8], c[8], t[8], x[8];
  fe_load<Fr>(z, z_p.p, z_p.word, i);
  fe_load<Fr>(ep, ep_p.p, ep_p.word, i);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = z[j];
  scalar(c, sc, 0);                              // gamma
#pragma unroll
  for (int j = 0; j < DPT_R3_WIRES; ++j) {      // acc1 *= w_j + gamma
    load_plane(x, w, j, i);                      //   + k_j beta ep
    fe_add<Fr>(x, x, c);
    scalar(t, sc, 4 + j);
    mul(t, t, ep);
    fe_add<Fr>(x, x, t);
    mul(acc, acc, x);
  }
  fe_load<Fr>(x, acc2_p.p, acc2_p.word, i);
  fe_sub<Fr>(acc, acc, x);                       // acc1 - acc2
  scalar(t, sc, 1);
  mul(acc, t, acc);                              // alpha * (...)
  fe_load<Fr>(x, gate_p.p, gate_p.word, i);
  fe_add<Fr>(acc, x, acc);
  fe_load<Fr>(x, zh_p.p, zh_p.word, i);
  mul(acc, x, acc);                              // zh_inv * (...)
  scalar(t, sc, 3);
  fe_sub<Fr>(z, z, t);                           // z - 1
  scalar(t, sc, 2);
  mul(z, t, z);                                  // alpha^2 / n * (z - 1)
  fe_load<Fr>(x, sh_p.p, sh_p.word, i);
  mul(z, z, x);                                  // l1
  fe_add<Fr>(acc, acc, z);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[(long long)j * m + i] = acc[j];
}

static unsigned blocks_of(long long m) {
  return (unsigned)((m + 255) / 256);
}

static Scalars scalars_of(const void* host, int count) {
  Scalars s;
  const uint32_t* src = (const uint32_t*)host;
  for (int k = 0; k < DPT_R3_SCALARS; ++k)
    for (int j = 0; j < 8; ++j) s.w[k][j] = k < count ? src[8 * k + j] : 0u;
  return s;
}

// out (8, m) at word stride out_word = gate + the
// terms of selectors start .. start + count - 1; sel: their (8, count, m)
// planes, w: the (8, 5, m) wire planes, by pointer and strides in words.
// m must be under 2^31. Returns cudaGetLastError(), or -1 for a selector
// range outside the table.
extern "C" int dpt_r3_gate_fold(void* out, long long out_word,
                                const void* gate, long long gate_word,
                                const void* sel, long long sel_word,
                                long long sel_plane, const void* w,
                                long long w_word, long long w_plane,
                                int start, int count, long long m,
                                void* stream) {
  if (start < 0 || count < 0 || start + count > DPT_R3_SELECTORS) return -1;
  if (m <= 0 || count == 0) return 0;
  const Planes ps = {(const uint32_t*)sel, sel_word, sel_plane};
  const Planes pw = {(const uint32_t*)w, w_word, w_plane};
  gate_fold_kernel<<<blocks_of(m), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, out_word, (const uint32_t*)gate, gate_word, ps, pw,
      start, count, (uint32_t)m);
  return (int)cudaGetLastError();
}

// out (8, m) at word stride out_word = acc2 * the
// factors of sigma planes start .. start + count - 1 (their (8, count, m)
// planes in sig); scalars: host words of beta and gamma, Montgomery form,
// 8 words each. Returns cudaGetLastError(), or -1 for a sigma range
// outside the wires.
extern "C" int dpt_r3_sigma_fold(void* out, long long out_word,
                                 const void* acc2, long long acc_word,
                                 const void* sig, long long sig_word,
                                 long long sig_plane, const void* w,
                                 long long w_word, long long w_plane,
                                 int start, int count, long long m,
                                 const void* scalars, void* stream) {
  if (start < 0 || count < 0 || start + count > DPT_R3_WIRES) return -1;
  if (m <= 0 || count == 0) return 0;
  const Planes ps = {(const uint32_t*)sig, sig_word, sig_plane};
  const Planes pw = {(const uint32_t*)w, w_word, w_plane};
  sigma_fold_kernel<<<blocks_of(m), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, out_word, (const uint32_t*)acc2, acc_word, ps, pw,
      start, count, (uint32_t)m, scalars_of(scalars, 2));
  return (int)cudaGetLastError();
}

// out: (8, m) contiguous. w: the (8, 5, m) wire planes by strides; in:
// the six (8, m) planes z, gate, acc2, ep, zh_inv, shifted_inv and words:
// their word strides; scalars: host words (Montgomery form, 8 each) of
// gamma, alpha, alpha^2 / n, one and k_j * beta for j < 5. Returns
// cudaGetLastError().
extern "C" int dpt_r3_combine(void* out, const void* w, long long w_word,
                              long long w_plane, const void* const* in,
                              const long long* words, long long m,
                              const void* scalars, void* stream) {
  if (m <= 0) return 0;
  const Planes pw = {(const uint32_t*)w, w_word, w_plane};
  Plane p[6];
  for (int k = 0; k < 6; ++k) p[k] = {(const uint32_t*)in[k], words[k]};
  combine_kernel<<<blocks_of(m), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, pw, p[0], p[1], p[2], p[3], p[4], p[5], (uint32_t)m,
      scalars_of(scalars, DPT_R3_SCALARS));
  return (int)cudaGetLastError();
}
