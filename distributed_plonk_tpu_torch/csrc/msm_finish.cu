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
// What bounds it on the H100: neither bytes nor operations. The scratch is
// a few KB and a batch is a few handles, so the dependent chain of complete
// adds sets the time: the Horner's (W - 1)(c + 1) adds (252 doublings and
// 36 adds at signed c = 7, W = 37) after the window sums' 30 or so. The
// design spreads each add over the lanes of a warp (curve_coop.cuh: the six
// products of each of its two levels side by side), so a step costs about
// two products and the additions between them, not twelve products.
//
// Two launches on the caller's stream:
//  1. window_sum_kernel, one block of S warps per (handle, window) lane: the
//     weighted bucket sum T_(b, w) in msm_tail_kernel's order (msm_tail.cuh:
//     warp s runs the running sum over segment s, high column first; warp
//     0 then adds the segment sums L_s in a pairwise tree while warp 1 runs
//     the running sum over the segment totals T_s and its log2(L)
//     doublings; warp 0 adds the two), into a (12, B * W) scratch the
//     wrapper allocates;
//  2. horner_kernel, one warp per handle, DPT_HORNER_WARPS handles a
//     block: acc = T_(b, W - 1), then for w = W - 2 down to 0, c doublings
//     (acc + acc by the complete add) and acc += T_(b, w).
// Every addition happens in the plain version's order with the same
// formula, so the coordinates equal msm_torch.msm_finish_ref's exactly.
#include "curve_coop.cuh"

#define DPT_TAIL_SEGMENTS 8
#define DPT_HORNER_WARPS 4

// The complete add with its own call site: the window sums add at seven
// places, and one copy of the add keeps nvcc's time down.
__device__ __noinline__ void coop_add_call(uint32_t* out, const uint32_t* p,
                                           const uint32_t* q,
                                           CoopScratch& s) {
  coop_add(out, p, q, s);
}

// Word l of column j of lane m (weight j + 1): bucket j when signed; bucket
// j + 1 when unsigned (bucket 0 has weight 0), the identity (0 : 1 : 0)
// past the last one. bx/by/bz: (12, M, nb).
__device__ __forceinline__ uint32_t column_word(
    const uint32_t* bx, const uint32_t* by, const uint32_t* bz, int M,
    int nb, int m, int j, int is_signed, int l) {
  const int bucket = is_signed ? j : j + 1;
  if (bucket >= nb) return l >= 12 && l < 24 ? kFqOne[l - 12] : 0u;
  return pt_word(bx, by, bz, (int64_t)M * nb, (int64_t)m * nb + bucket, l);
}

// This lane's words (lane, and 32 + lane for lanes 0-3) of column j.
__device__ __forceinline__ void column_regs(
    uint32_t& w0, uint32_t& w1, const uint32_t* bx, const uint32_t* by,
    const uint32_t* bz, int M, int nb, int m, int j, int is_signed) {
  const int lane = threadIdx.x & 31;
  w0 = column_word(bx, by, bz, M, nb, m, j, is_signed, lane);
  w1 = lane < 4 ? column_word(bx, by, bz, M, nb, m, j, is_signed, 32 + lane)
                : 0u;
}

// tx/ty/tz: (12, M) window sums; bx/by/bz: (12, M, nb) bucket sums, nb =
// S * L with 2 <= S <= 8. One block of 32 * S threads per lane m.
__global__ void __launch_bounds__(32 * DPT_TAIL_SEGMENTS) window_sum_kernel(
    uint32_t* __restrict__ tx, uint32_t* __restrict__ ty,
    uint32_t* __restrict__ tz, const uint32_t* __restrict__ bx,
    const uint32_t* __restrict__ by, const uint32_t* __restrict__ bz, int M,
    int nb, int S, int L, int is_signed) {
  __shared__ coop_pt seg_l[DPT_TAIL_SEGMENTS];   // L_s, then the tree
  __shared__ coop_pt seg_t[DPT_TAIL_SEGMENTS];   // T_s
  __shared__ coop_pt col[DPT_TAIL_SEGMENTS];     // each warp's operand
  __shared__ coop_pt ladder;
  __shared__ CoopScratch scratch[DPT_TAIL_SEGMENTS];
  const int m = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  CoopScratch& scr = scratch[warp];
  {
    // warp s: running sum over columns sL + L - 1 .. sL: run = T_s, acc =
    // L_s. Lane l holds words l and l + 32 of the next column ahead of
    // its adds.
    uint32_t* run = seg_t[warp];
    uint32_t* acc = seg_l[warp];
    uint32_t* c = col[warp];
    const int j0 = warp * L, top = j0 + L - 1;
    uint32_t w0, w1;
    column_regs(w0, w1, bx, by, bz, M, nb, m, top, is_signed);
    run[lane] = acc[lane] = w0;
    if (lane < 4) run[32 + lane] = acc[32 + lane] = w1;
    if (top > j0) column_regs(w0, w1, bx, by, bz, M, nb, m, top - 1,
                              is_signed);
    for (int j = top - 1; j >= j0; --j) {
      c[lane] = w0;                    // column j, loaded a round ahead
      if (lane < 4) c[32 + lane] = w1;
      __syncwarp();
      if (j > j0) column_regs(w0, w1, bx, by, bz, M, nb, m, j - 1,
                              is_signed);
      coop_add_call(run, run, c, scr);
      coop_add_call(acc, acc, run, scr);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // L_0 += L_h for h = 1, 2, 4, ... (pairwise tree)
    for (int h = 1; h < S; h <<= 1)
      for (int t = 0; t + h < S; t += 2 * h)
        coop_add_call(seg_l[t], seg_l[t], seg_l[t + h], scr);
  } else if (warp == 1) {
    // sum_{s >= 1} s * T_s by a running sum from the top, then times L
    uint32_t* lrun = col[1];
    const uint32_t* top = seg_t[S - 1];
    lrun[lane] = ladder[lane] = top[lane];
    if (lane < 4) lrun[32 + lane] = ladder[32 + lane] = top[32 + lane];
    __syncwarp();
    for (int s = S - 2; s >= 1; --s) {
      coop_add_call(lrun, lrun, seg_t[s], scr);
      coop_add_call(ladder, ladder, lrun, scr);
    }
    for (int d = 1; d < L; d <<= 1)
      coop_add_call(ladder, ladder, ladder, scr);
  }
  __syncthreads();
  if (warp == 0) {
    coop_add_call(col[0], seg_l[0], ladder, scr);
    pt_store(tx, ty, tz, M, m, col[0]);
  }
}

// tx/ty/tz: (12, B * W) window sums, lane b * W + w; ox/oy/oz: (12, B).
// One warp per handle b. The (W - 1)(c + 1) steps run from one call site of
// the add; T_(b, w) is loaded into registers at the first doubling of its
// window and reaches shared memory before its add.
__global__ void __launch_bounds__(32 * DPT_HORNER_WARPS) horner_kernel(
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, const uint32_t* __restrict__ tx,
    const uint32_t* __restrict__ ty, const uint32_t* __restrict__ tz, int B,
    int W, int c) {
  __shared__ coop_pt acc_s[DPT_HORNER_WARPS];
  __shared__ coop_pt t_s[DPT_HORNER_WARPS];
  __shared__ CoopScratch scratch[DPT_HORNER_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * DPT_HORNER_WARPS + warp;
  if (b >= B) return;                  // the whole warp: no block barrier
  const int64_t lanes = (int64_t)B * W;
  const int64_t base = (int64_t)b * W;
  uint32_t* acc = acc_s[warp];
  uint32_t* t = t_s[warp];
  pt_load(acc, tx, ty, tz, lanes, base + W - 1);
  uint32_t w0 = 0u, w1 = 0u;
  const int steps = (W - 1) * (c + 1);
  for (int i = 0; i < steps; ++i) {
    const int k = i % (c + 1);         // c doublings, then the add
    const int64_t at = base + W - 2 - i / (c + 1);
    if (k == 0) {
      w0 = pt_word(tx, ty, tz, lanes, at, lane);
      if (lane < 4) w1 = pt_word(tx, ty, tz, lanes, at, 32 + lane);
    }
    if (k == c) {
      t[lane] = w0;
      if (lane < 4) t[32 + lane] = w1;
      __syncwarp();
    }
    coop_add(acc, acc, k == c ? t : acc, scratch[warp]);
  }
  pt_store(ox, oy, oz, B, b, acc);
}

// bx/by/bz: (12, B * W, nb) bucket sums; tx/ty/tz: (12, B * W) scratch;
// ox/oy/oz: (12, B) totals. nb = S * L as msm_tail takes it. Returns
// cudaGetLastError() after the second launch; refuses a segmentation the
// window sums were not written for.
extern "C" int dpt_msm_finish(void* ox, void* oy, void* oz, void* tx,
                              void* ty, void* tz, const void* bx,
                              const void* by, const void* bz, int B, int W,
                              int c, int nb, int S, int L, int is_signed,
                              void* stream) {
  if (S < 2 || S > DPT_TAIL_SEGMENTS || S * L != nb || W < 1 || c < 1)
    return -1;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  window_sum_kernel<<<B * W, 32 * S, 0, s>>>(
      (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, (const uint32_t*)bx,
      (const uint32_t*)by, (const uint32_t*)bz, B * W, nb, S, L, is_signed);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  horner_kernel<<<(B + DPT_HORNER_WARPS - 1) / DPT_HORNER_WARPS,
                  32 * DPT_HORNER_WARPS, 0, s>>>(
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (const uint32_t*)tx,
      (const uint32_t*)ty, (const uint32_t*)tz, B, W, c);
  return (int)cudaGetLastError();
}
