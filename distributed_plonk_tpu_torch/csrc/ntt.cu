// Kernel 2: radix-2 NTT over Fr on a (8, B, n) batch, Montgomery form in
// and out, natural order in and out, in ceil(log2 n / R) passes of up to R
// stages each (R = 8 on the main path: n = 2^16 is two passes of 2^8).
//
// Replaces: distributed_plonk_tpu/backend/ntt_pallas.py:_group_call (body
// _ntt_group_kernel, called through run_groups), the fused multi-stage
// NTT that ran R radix-2 stages per HBM round trip in VMEM on the TPU.
//
// Decomposition (Cooley-Tukey on index digits, ntt_torch.NttPlan builds
// the geometry and tables): n = n_1 * ... * n_P. Pass p views each
// sub-transform of size N_p = n_p * S as an (n_p, S) matrix, runs the
// size-n_p DFT down every column (radix-2 decimation in frequency, all in
// shared memory, so the bit-reversed order inside a column costs nothing:
// the store reads row bitrev(k)) and multiplies output (k, s) by
// w_{N_p}^(k s) from a per-pass table; row k of the result is then the
// input of the next pass. The last pass has no table: it writes each
// output to its natural index, so no bit-reversal launch is left. The
// coset pre-scale rides the first pass's first stage, the 1/n (and g^-i)
// post-scale the last pass's stores.
//
// A block walks tiles of `cols` neighbouring columns (neighbouring words
// in the limb-major layout, so the loads coalesce) of one sub-transform,
// 2^log_rows rows each. It is persistent: while it runs the butterflies
// of one tile, cp.async copies the next tile into the second of its two
// shared-memory buffers. Tiles are disjoint, so a middle pass works in
// place.
//
// Bound on the H100: operations. A size-n transform is (n/2) log2 n
// butterflies of one Fr product each (about 272 32-bit multiply-adds, see
// mont_mul.cu), plus one product per element and pass for the twiddles,
// against 64 bytes per element and pass; at 2^16 that is about 9
// multiply-adds a byte, above the card's balance of about 5. Tensor cores
// do not pay here: the TPU fed 8-bit limb products to its bf16 matrix
// unit because it had no wide integer multiply; Hopper multiplies 32 x 32
// -> 64 bits natively, on carry chains (field.cuh).
#include "field.cuh"

struct NttPass {
  int log_rows, log_cols;
  long long mids, tiles_per_mid, tiles;   // tiles = batch * mids * per mid
  long long n, word_stride;               // row length; B * n
  // element (mid, tile t, column c, row r) of batch row b sits at
  // b * n + mid * in_mid + t * in_tile + c * in_col + r * in_row
  long long in_mid, in_tile, in_col, in_row;
  // output k of that column goes to b * n + (lv ? lv[mid] : mid * out_mid)
  // + t * out_tile + c * out_col + k * out_row
  long long out_mid, out_tile, out_col, out_row;
  long long tw_row, tw_tile, tw_words;    // table index k * tw_row + t *
                                          // tw_tile + c, word stride
  long long stage_words;                  // 2^log_rows - 1 stage twiddles
};

struct NttArgs {
  uint32_t* dst;
  const uint32_t *src, *stage_tw, *tw, *pre, *post;
  const long long* lv;
};

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Shared-memory slot of (row r, column c): rows of `cols` words, one pad
// word every 32 / cols rows, so rows a multiple of 32 / cols apart (the
// bit-reversed reads of the store) fall in different banks.
__device__ __forceinline__ int slot(int r, int c, int log_cols) {
  return (r << log_cols) + c + (r >> (5 - log_cols));
}

__host__ __device__ __forceinline__ int slots_per_word(int log_rows,
                                                       int log_cols) {
  return (1 << (log_rows + log_cols)) + (1 << log_rows >> (5 - log_cols));
}

struct Tile {
  long long b, mid, t;
};

__device__ __forceinline__ Tile tile_of(const NttPass& P, long long g) {
  const long long per_b = P.mids * P.tiles_per_mid;
  Tile x;
  x.b = g / per_b;
  const long long rem = g - x.b * per_b;
  x.mid = rem / P.tiles_per_mid;
  x.t = rem - x.mid * P.tiles_per_mid;
  return x;
}

__device__ __forceinline__ void load_tile(const NttPass& P,
                                          const NttArgs& A, long long g,
                                          uint32_t* s) {
  const Tile x = tile_of(P, g);
  const long long base = x.b * P.n + x.mid * P.in_mid + x.t * P.in_tile;
  const int words = slots_per_word(P.log_rows, P.log_cols);
  const int count = 1 << (P.log_rows + P.log_cols);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int c = e & ((1 << P.log_cols) - 1);
    const int r = e >> P.log_cols;
    const uint32_t* src = A.src + base + c * P.in_col + r * P.in_row;
    const int at = slot(r, c, P.log_cols);
#pragma unroll
    for (int w = 0; w < 8; ++w) cp_async4(s + w * words + at,
                                          src + w * P.word_stride);
  }
}

__device__ __forceinline__ void sm_load(uint32_t* v, const uint32_t* s,
                                        int words, int at) {
#pragma unroll
  for (int w = 0; w < 8; ++w) v[w] = s[w * words + at];
}

__device__ __forceinline__ void sm_store(uint32_t* s, int words, int at,
                                         const uint32_t* v) {
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w * words + at] = v[w];
}

__device__ __forceinline__ void g_load(uint32_t* v, const uint32_t* base,
                                       long long stride, long long i) {
#pragma unroll
  for (int w = 0; w < 8; ++w) v[w] = __ldg(base + w * stride + i);
}

// The column DFTs of one tile in shared memory, then its stores.
__device__ __forceinline__ void run_tile(const NttPass& P, const NttArgs& A,
                                         long long g, uint32_t* s) {
  const Tile x = tile_of(P, g);
  const int log_rows = P.log_rows, log_cols = P.log_cols;
  const int rows = 1 << log_rows, cmask = (1 << log_cols) - 1;
  const int words = slots_per_word(log_rows, log_cols);
  const int pairs = 1 << (log_rows + log_cols - 1);
  const long long in_base = x.mid * P.in_mid + x.t * P.in_tile;
  uint32_t u[8], v[8], d[8], w[8];
  for (int st = 0; st < log_rows; ++st) {
    const int log_half = log_rows - st - 1;
    const int half = 1 << log_half;
    const int off = rows - (rows >> st);   // stage st's twiddles: w^(k 2^st)
    // butterfly q: column c and block of the low bits, twiddle index k
    // in the high bits, so that from stage 3 on (2^st blocks x 4 columns
    // >= a warp) a warp shares k and the k = 0 warps skip their w^0 = 1
    // product as one
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int c = q & cmask;
      const int blk = (q >> log_cols) & ((1 << st) - 1);
      const int k = q >> (log_cols + st);
      const int r0 = (blk << (log_half + 1)) + k;
      const int r1 = r0 + half;
      const int a0 = slot(r0, c, log_cols), a1 = slot(r1, c, log_cols);
      sm_load(u, s, words, a0);
      sm_load(v, s, words, a1);
      if (st == 0 && A.pre != nullptr) {
        const long long i0 = in_base + c * P.in_col + r0 * P.in_row;
        g_load(w, A.pre, P.n, i0);
        fe_mont_mul<Fr>(u, u, w);
        g_load(w, A.pre, P.n, i0 + half * P.in_row);
        fe_mont_mul<Fr>(v, v, w);
      }
      fe_sub<Fr>(d, u, v);
      fe_add<Fr>(u, u, v);
      if (k != 0) {
        g_load(w, A.stage_tw, P.stage_words, off + k);
        fe_mont_mul<Fr>(v, d, w);
      } else {                  // w^0 = 1: the product is d itself
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = d[j];
      }
      sm_store(s, words, a0, u);
      sm_store(s, words, a1, v);
    }
    __syncthreads();
  }
  const long long out_base = (A.lv != nullptr ? A.lv[x.mid]
                                              : x.mid * P.out_mid) +
                             x.t * P.out_tile;
  const int count = rows << log_cols;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int c = e & cmask;
    const int k = e >> log_cols;
    const int pos = log_rows ? (int)(__brev((unsigned)k) >> (32 - log_rows))
                             : 0;
    sm_load(u, s, words, slot(pos, c, log_cols));
    if (A.tw != nullptr) {
      g_load(w, A.tw, P.tw_words, k * P.tw_row + x.t * P.tw_tile + c);
      fe_mont_mul<Fr>(u, u, w);
    }
    const long long o = out_base + c * P.out_col + k * P.out_row;
    if (A.post != nullptr) {
      g_load(w, A.post, P.n, o);
      fe_mont_mul<Fr>(u, u, w);
    }
    fe_store<Fr>(A.dst, P.word_stride, x.b * P.n + o, u);
  }
}

// Compiled for one resident block per SM at least: ptxas then gives the
// kernel about 92 registers (two blocks of 256 threads fit), which ran
// faster on an H100 80GB HBM3 (700 W) than capping it at 64-79 registers
// for three or four blocks; the butterflies' carry chains want them.
__global__ void __launch_bounds__(256, 1)
    ntt_pass_kernel(const NttPass P, const NttArgs A) {
  extern __shared__ uint32_t smem[];
  const int buf_words = 8 * slots_per_word(P.log_rows, P.log_cols);
  int buf = 0;
  long long g = blockIdx.x;
  if (g < P.tiles) load_tile(P, A, g, smem);
  cp_async_commit();
  for (; g < P.tiles; g += gridDim.x) {
    const long long next = g + gridDim.x;
    if (next < P.tiles) load_tile(P, A, next, smem + (buf ^ 1) * buf_words);
    cp_async_commit();
    cp_async_wait<1>();    // this tile's copies have landed
    __syncthreads();
    run_tile(P, A, g, smem + buf * buf_words);
    __syncthreads();       // the buffer is free for the tile after next
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// One pass. geo: the 19 integers of NttPass in declaration order (the
// plan's pass geometry). dst / src: (8, B, n) contiguous (the same tensor
// for a middle pass, which works in place); stage_tw: (8, 2^log_rows - 1);
// tw: (8, tw_words) or null; pre / post: (8, n) or null; lv: int64 (mids,)
// or null. Returns cudaGetLastError().
extern "C" int dpt_ntt_pass(const long long* geo, void* dst, const void* src,
                            const void* stage_tw, const void* tw,
                            const void* pre, const void* post, const void* lv,
                            void* stream) {
  NttPass P;
  P.log_rows = (int)geo[0];
  P.log_cols = (int)geo[1];
  P.mids = geo[2];
  P.tiles_per_mid = geo[3];
  P.tiles = geo[4];
  P.n = geo[5];
  P.word_stride = geo[6];
  P.in_mid = geo[7];
  P.in_tile = geo[8];
  P.in_col = geo[9];
  P.in_row = geo[10];
  P.out_mid = geo[11];
  P.out_tile = geo[12];
  P.out_col = geo[13];
  P.out_row = geo[14];
  P.tw_row = geo[15];
  P.tw_tile = geo[16];
  P.tw_words = geo[17];
  P.stage_words = geo[18];
  if (P.tiles <= 0) return 0;
  if (P.log_cols > 5 || P.log_rows < 1 || P.log_rows > 10) return 1;
  const NttArgs A = {(uint32_t*)dst, (const uint32_t*)src,
                     (const uint32_t*)stage_tw, (const uint32_t*)tw,
                     (const uint32_t*)pre, (const uint32_t*)post,
                     (const long long*)lv};
  const int pairs = 1 << (P.log_rows + P.log_cols - 1);
  const int threads = pairs < 32 ? 32 : (pairs > 256 ? 256 : pairs);
  const size_t smem = 2 * 8 * sizeof(uint32_t) *
                      (size_t)slots_per_word(P.log_rows, P.log_cols);
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ntt_pass_kernel,
                                                threads, smem);
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > P.tiles) blocks = P.tiles;
  ntt_pass_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      P, A);
  return (int)cudaGetLastError();
}
