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
// torch launches, then a power loop of dependent kernel-1 launches. A call
// of this kernel is one launch at every shape.
//
// Bound on the H100: operations. B * L Fr products at about 272 32-bit
// multiply-adds each (trace.FR_MUL_IMADS) against 32 bytes read per
// coefficient, 8.5 multiply-adds a byte, above the card's balance of about
// 5: v1's round 4, (8, 10, 8,195), 1.3 us; v2's, (8, 10, 262,147), 42.6
// us; 2^20's, (8, 10, 1,048,579), 170.5 us (bytes: 0.8 / 25.0 / 100.2
// us). At v1 and on a fleet worker's EVAL (B = 1, about 2,049
// coefficients) the bound is out of reach: the time is the longest chain
// of dependent products, at least log2(L) of them (a product at most
// doubles the degree in z).
//
// The split. A polynomial takes `ctas` CTAs of `run * 256` coefficients
// (prover_torch.eval_geometry, from B, L and the card's SM count: one CTA
// an SM while a lane's run is shorter than the weight's chain below, else
// 4 an SM). A CTA is 8 Horner warps and one power warp. Warp w of CTA r
// owns the 32 * run coefficients from (r * 8 + w) * 32 * run, and lane l
// takes every 32nd of them from its own, so each load of the warp reads
// 32 neighbouring words straight from global memory, and evaluates them
// by Horner in base z^32. The lanes' values weigh z^l: five shuffle levels
// inside a warp (v[l] += v[l + d] * z^d), then three over the 8 warps'
// sums in shared memory (a warp's sum weighs z^(32 * run * w)), leave the
// CTA's partial, which weighs z^(run * 256 * r) in p(z).
//
// Why this split and not contiguous runs in base z (which need no power
// before the first product): a contiguous run must be staged through
// shared memory to keep the loads coalesced, and on the H100 the staging
// (4-byte cp.async copies, their address arithmetic, the shared reads)
// cost more than it saved: staged contiguous runs were slower than this
// split at v2's and 2^20's shapes. Here only z^32, five squarings, comes
// before the Horner's second product, and the power warp makes it while
// the first loads are in flight; on short runs the weight's chain is
// longer anyway.
//
// The powers. The power warp builds every power the CTA needs beside the
// Horner: z^(2^i) for the shuffle levels, z^32, z^(32 * run * 2^i) for the
// levels over the warps and the CTA's weight z^(run * 256 * r). Lane 31
// squares z once a step, and lane i < 10 multiplies the square of the
// step into its own power at the set bits of its exponent, one product a
// step for the whole warp (the lanes' products run side by side). Each
// power is posted to shared memory with an mbarrier of its own as soon as
// its top bit is done, and each level waits only for its own power. The
// weight takes about log2(L) steps, the least any split can take, and is
// the critical path where runs are short (v1: 13 steps).
//
// The combine, inside the launch. One CTA: its partial is p(z). More: a
// ticket. Each CTA writes its weighted partial to a slot of a static
// `__device__` workspace (zero when the module loads), fences and takes a
// ticket with atomicAdd; the CTA that draws the last ticket adds every
// slot (read from L2) in one warp, stores p(z) and sets the ticket back to
// 0, so no call fills anything first. No CTA waits for another: the last
// to arrive does the sum. The workspace holds DPT_EVAL_LANES lanes, and a
// launch uses the lane the wrapper keeps for its stream
// (prover_torch._eval_lane): launches that share a lane run on one stream,
// one after the other, and launches on two streams, which may overlap,
// never share one. A lane is static memory, so a stream met first under
// CUDA graph capture needs no allocation or fill either.
//
// Against a design with one interleaved Horner over the whole polynomial
// in base z^G (a chain of log2(G) squarings before its first product),
// an 8-level shared-memory tree and a second launch over the blocks'
// partials: (1) a polynomial spreads over the card at every B (v1: 11
// CTAs a polynomial, 110 in all; a B = 1 EVAL of 2,049: 9); (2) the
// Horner waits for z^32 only, and the powers come from their own warp,
// each level taking its own as it is posted; (3) five of the eight tree
// levels are shuffles, with no barrier; (4) one launch, no scratch
// tensor; (5) on long runs 4 CTAs an SM, 32 Horner warps (56 registers
// a thread), hide a dependent product.
//
// Every step is a Montgomery product or a field add of field.cuh, both
// exact on canonical inputs, so the output equals the plain version word
// for word whatever the split.
#include "field.cuh"

#define DPT_EVAL_WARPS 8                        // Horner warps a CTA
#define DPT_EVAL_THREADS (32 * DPT_EVAL_WARPS)  // their lanes
#define DPT_EVAL_BLOCK (DPT_EVAL_THREADS + 32)  // and the power warp
#define DPT_EVAL_CTAS_PER_SM 4
// the powers, by power-warp lane: z^(2^i) for the 5 shuffle levels, z^32
// (the Horner's base), z^(32 run 2^i) for the 3 levels over the warps,
// the CTA's weight
#define DPT_EVAL_BASE 5
#define DPT_EVAL_WEIGHT 9
#define DPT_EVAL_POWERS 10
#define DPT_EVAL_SLOTS 1024      // ticket slots a lane: (polynomial, CTA)
#define DPT_EVAL_LANES 64        // workspace lanes: streams of a device
#define DPT_EVAL_FULL 0xffffffffu

struct EvalShared {
  uint32_t pw[DPT_EVAL_POWERS][8];
  uint32_t warp_sum[DPT_EVAL_WARPS][8];
  unsigned long long bar[DPT_EVAL_POWERS];
};

// the ticket workspace, by lane: a counter a polynomial, a partial a
// (polynomial, CTA) slot; every counter is 0 between launches
__device__ unsigned int eval_tickets[DPT_EVAL_LANES][DPT_EVAL_SLOTS];
__device__ uint32_t eval_partials[DPT_EVAL_LANES][DPT_EVAL_SLOTS][8];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;"
               :: "r"(smem_addr(b)), "r"(1u) : "memory");
}

// release: the power's words, stored before, are seen by every waiter
__device__ __forceinline__ void bar_arrive(unsigned long long* b) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared.b64 st, [%0];\n\t}"
               :: "r"(smem_addr(b)) : "memory");
}

// acquire: returns once the barrier's first phase has completed
__device__ __forceinline__ void bar_wait(unsigned long long* b) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_addr(b)), "r"(0u) : "memory");
  }
}

// one tree level of stride d: v += (lane + d's v) * pw. A lane past the
// warp's end reads its own v back; only lanes that are multiples of 2d
// carry on.
__device__ __forceinline__ void tree_level(uint32_t* v, const uint32_t* pw,
                                           int d) {
  uint32_t o[8], P[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    o[k] = __shfl_down_sync(DPT_EVAL_FULL, v[k], d);
    P[k] = pw[k];
  }
  fe_mont_mul<Fr>(o, o, P);
  fe_add<Fr>(v, v, o);
}

// The power warp: posts pw[i] = z^(e_i), e_i = 2^i for i <= 5 (the shuffle
// levels, then the Horner's base z^32), 32 * run * 2^(i - 6) for i = 6..8
// (the levels over the warps) and the CTA's weight 256 * run * r for i = 9
// (not for r = 0, whose weight is 1). Lane 31 holds z^(2^k) after step k;
// lane i adds 2^k to its power's exponent at each set bit k of e_i, the
// first set bit by taking z^(2^k) itself.
__device__ __forceinline__ void power_warp(EvalShared& sh, const uint32_t* z,
                                           int lane, int run, int r) {
  const bool squares = lane == 31;
  unsigned long long e = 0;
  if (lane <= DPT_EVAL_BASE)
    e = 1ull << lane;
  else if (lane < DPT_EVAL_WEIGHT)
    e = (32ull * run) << (lane - DPT_EVAL_BASE - 1);
  else if (lane == DPT_EVAL_WEIGHT)
    e = (unsigned long long)r * run * DPT_EVAL_THREADS;
  uint32_t x[8], P[8], o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = z[k];
  bool have = false;
#pragma unroll 1
  while (__any_sync(DPT_EVAL_FULL, e != 0)) {
#pragma unroll
    for (int k = 0; k < 8; ++k) P[k] = __shfl_sync(DPT_EVAL_FULL, x[k], 31);
    fe_mont_mul<Fr>(o, x, P);          // lane 31: its square
    if (squares) {
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = o[k];
    } else if (e != 0) {
      if (e & 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = have ? o[k] : P[k];
        have = true;
      }
      e >>= 1;
      if (e == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) sh.pw[lane][k] = x[k];
        bar_arrive(&sh.bar[lane]);
      }
    }
  }
}

// Horner warp `warp` of CTA r: the warp's 32 * run coefficients from
// s_w = (r * 8 + warp) * 32 * run, lane l taking s_w + l + 32 j for j <
// run; v = sum_j c[s_w + l + 32 j] z^(32 j), by Horner in base z^32 (0
// past L). Each load of the warp reads 32 neighbouring words.
__device__ __forceinline__ void horner(EvalShared& sh, uint32_t* v,
                                       const uint32_t* p, long long in_word,
                                       long long L, int warp, int lane,
                                       int run, int r) {
  const long long first = ((long long)r * DPT_EVAL_WARPS + warp) * 32 * run;
  if (first >= L) return;
  // every position is below L + 31 < 2^32: 32-bit indices from here
  const uint32_t s_w = (uint32_t)first, n = (uint32_t)L;
  const uint32_t steps = min((uint32_t)run, (n - s_w + 31) / 32);
  uint32_t y[8], c[8];
  uint32_t pos = s_w + lane + 32 * (steps - 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = pos < n ? p[k * in_word + pos] : 0u;
  if (steps == 1) return;
  bar_wait(&sh.bar[DPT_EVAL_BASE]);    // the base, once it is posted
#pragma unroll
  for (int k = 0; k < 8; ++k) y[k] = sh.pw[DPT_EVAL_BASE][k];
#pragma unroll 1
  for (uint32_t j = 1; j < steps; ++j) {
    pos -= 32;
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = pos < n ? p[k * in_word + pos] : 0u;
    fe_mont_mul<Fr>(v, v, y);
    fe_add<Fr>(v, v, c);
  }
}

// Grid (ctas, B): CTA r of polynomial blockIdx.y; above one CTA, the
// ticket over workspace lane `lane`.
__global__ void __launch_bounds__(DPT_EVAL_BLOCK, DPT_EVAL_CTAS_PER_SM)
eval_kernel(uint32_t* out, const uint32_t* in, long long in_word,
            long long in_poly, long long L, const uint32_t* zs,
            long long z_word, long long z_poly, int B, int ctas, int run,
            int lane_of_stream) {
  __shared__ EvalShared sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const long long b = blockIdx.y;
  if (threadIdx.x < DPT_EVAL_POWERS) bar_init(&sh.bar[threadIdx.x]);
  __syncthreads();
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = 0u;
  if (warp == DPT_EVAL_WARPS) {
    uint32_t z[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) z[k] = zs[k * z_word + b * z_poly];
    power_warp(sh, z, lane, run, r);
  } else {
    horner(sh, v, in + b * in_poly, in_word, L, warp, lane, run, r);
#pragma unroll 1
    for (int i = 0; i < 5; ++i) {
      bar_wait(&sh.bar[i]);
      tree_level(v, sh.pw[i], 1 << i);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) sh.warp_sum[warp][k] = v[k];
    }
    asm volatile("bar.sync 1, %0;" :: "n"(DPT_EVAL_THREADS) : "memory");
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = lane < DPT_EVAL_WARPS ? sh.warp_sum[lane][k] : 0u;
#pragma unroll 1
      for (int i = 0; (1 << i) < DPT_EVAL_WARPS; ++i) {
        bar_wait(&sh.bar[DPT_EVAL_BASE + 1 + i]);
        tree_level(v, sh.pw[DPT_EVAL_BASE + 1 + i], 1 << i);
      }
      if (r > 0) {                     // the CTA's weight
        uint32_t P[8];
        bar_wait(&sh.bar[DPT_EVAL_WEIGHT]);
#pragma unroll
        for (int k = 0; k < 8; ++k) P[k] = sh.pw[DPT_EVAL_WEIGHT][k];
        fe_mont_mul<Fr>(v, v, P);
      }
    }
  }

  // the polynomial's CTAs combine; thread 0 holds this CTA's partial
  if (ctas == 1) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k * B + b] = v[k];
    }
  } else if (warp == 0) {
    unsigned int* tickets = eval_tickets[lane_of_stream];
    uint32_t(*partials)[8] = eval_partials[lane_of_stream];
    const long long slot = b * ctas;
    unsigned int last = 0;
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) partials[slot + r][k] = v[k];
      __threadfence();
      last = atomicAdd(&tickets[b], 1u) == (unsigned int)(ctas - 1);
    }
    if (__shfl_sync(DPT_EVAL_FULL, last, 0)) {
      __threadfence();
      uint32_t s[8], o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = 0u;
#pragma unroll 1
      for (int q = lane; q < ctas; q += 32) {
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = __ldcg(&partials[slot + q][k]);
        fe_add<Fr>(s, s, o);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = __shfl_down_sync(DPT_EVAL_FULL, s[k], d);
        fe_add<Fr>(s, s, o);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) out[k * B + b] = s[k];
        tickets[b] = 0u;               // ready for the next launch
      }
    }
  }
}

// out: (8, B) contiguous, p_b(z_b) in Montgomery form. in: the (8, B, L)
// coefficients by word and polynomial strides (coefficients contiguous);
// zs: the (8, B, 1) points by word and polynomial strides. ctas and run:
// prover_torch.eval_geometry's CTAs a polynomial and coefficients a lane
// (ctas * run * 256 >= L > (ctas - 1) * run * 256); lane: the stream's
// workspace lane (0 .. 63). One launch; returns its error
// (cudaGetLastError() after it), or -1 for a shape the kernel does not
// take.
extern "C" int dpt_poly_eval(void* out, const void* in, long long in_word,
                             long long in_poly, long long L, const void* zs,
                             long long z_word, long long z_poly, int B,
                             int ctas, int run, int lane, void* stream) {
  const long long chunk = (long long)run * DPT_EVAL_THREADS;
  if (L <= 0 || L >= (1LL << 31) || B <= 0 || B > 65535 || ctas <= 0
      || run <= 0 || chunk * ctas < L || chunk * (ctas - 1) >= L
      || lane < 0 || lane >= DPT_EVAL_LANES
      || (ctas > 1 && (long long)B * ctas > DPT_EVAL_SLOTS))
    return -1;
  eval_kernel<<<dim3((unsigned)ctas, (unsigned)B), DPT_EVAL_BLOCK, 0,
                (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, in_word, in_poly, L,
      (const uint32_t*)zs, z_word, z_poly, B, ctas, run, lane);
  return (int)cudaGetLastError();
}
