// SSD (state-space duality) intra-chunk kernels for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py (ssd_intra_chunk,
// body _ssd_kernel). Per (batch, head, chunk), with acs = cumsum(a):
//   y[i]    = sum_{j <= i} (C_i . B_j) exp(acs_i - acs_j) xdt_j     (c, hd)
//   S[s, p] = sum_j B_j[s] exp(acs_end - acs_j) xdt_j[p]            (ds, hd)
// All inputs and outputs are f32; B and C (ngroups = 1) are shared by every
// head.
//
// What bounds it on this card: at mamba2-370m's prefill shape (1 x 1024
// tokens, 32 heads, chunk 256, d_state 128, head dim 64) the function moves
// ~22 MB (~6.6 us at 3.35 TB/s) and needs ~1.1 GFLOP on the causal triangle
// with C.B^T shared by the heads. In split TF32 that is ~3.3 GFLOP of
// tensor-core work (~6.7 us at 495 TFLOP/s): operations and bytes bound it
// about equally. The TPU kernel holds the whole (c x c) decay matrix and the
// (c x ds) B and C tiles in VMEM, ~0.5 MB in f32; a Hopper block has at most
// 227 KB, and a block that walks a whole chunk is a long chain of dependent
// steps. The design:
//   * two grids on the stream. The first computes C.B^T once per (batch,
//     chunk), one block per causal 64 x 64 (row tile, key tile) pair, into a
//     workspace (b, nc, c, c); computes S, one block per (batch, chunk,
//     head, 64 state rows), which also stores the cumsums of a for the
//     second grid; and clears y. The second computes y, one block per
//     (batch, chunk, head, 64-row tile, part of at most 128 keys): the strip
//     of C.B^T for its rows is read, not recomputed, so C.B^T is computed
//     once per (batch, chunk), never once per head. One head a block keeps
//     the blocks short and the grid of y at 192 blocks even for one chunk of
//     32 heads;
//   * a row tile past the first 128 keys is split into parts whose blocks
//     add into y with atomicAdd (rows of one part are stored). Up to chunk
//     256 a row has at most two parts, and a sum of two on a cleared y is
//     the same in either order. Longer chunks give three or more parts,
//     added in the order their blocks finish: there y may differ from run
//     to run at the rounding level;
//   * the decay is taken per element from differences of acs, never
//     factorised into exp(acs_i) exp(-acs_j), which overflows in f32 at
//     mamba2's decay rates; key tiles above the diagonal are skipped;
//   * every product is wgmma.m64nNk8 in split TF32 (mma_tf32.cuh): each f32
//     operand becomes a TF32 high part and a TF32 remainder, and
//     lo.hi + hi.lo + hi.hi is accumulated in f32. wgmma takes TF32 B only
//     K-major from shared memory: B's rows (for C.B^T) are K-major as they
//     are, xdt (for P.xdt and the state product) is transposed while its
//     parts are written, 128-byte swizzled. A comes from registers: C, P
//     (from the strip, times the decay) and (B o w)^T, split by the threads
//     that hold them;
//   * B, C, xdt and the strip come through a cp.async ring (16-byte copies
//     where rows are 16-byte aligned, else 4-byte ones), three stages in the
//     first grid and two in the second (one copies while one computes);
//     row pitches are padded so that fragment loads are free of bank
//     conflicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int NT = 128;         // threads a block: one warpgroup
constexpr int BR = 64;          // chunk rows of y a block, 16 a warp
constexpr int BKT = 64;         // key rows a tile of C.B^T
constexpr int BS = 64;          // state rows of S a block, 16 a warp
constexpr int STRIP = 128;      // keys a block of y reduces over
constexpr int KW = 32;          // TF32 values a 128-byte swizzle row: the
                                // reduced depth of every stage
constexpr int LDK = KW + 4;     // pitch of the C and B stages of C.B^T
constexpr int LDW = BS + 8;     // pitch of the B stage of the state product
constexpr int LDP = STRIP + 4;  // pitch of the strip of C.B^T
constexpr int NST = 3;          // stages of the first kernel's ring
constexpr int NST_Y = 2;        // stages of the second kernel's ring
constexpr int ZERO_BLOCKS = 132;  // blocks of the first kernel that clear y
constexpr float LOG2E = 1.4426950408889634f;

constexpr int CB_STAGE = 2 * BR * LDK;  // C and B rows of C.B^T
template <int HD>
__host__ __device__ constexpr int s_stage() {  // B and xdt rows of S
  return KW * (LDW + HD + 8);
}
template <int HD>
__host__ __device__ constexpr int y_stage() {  // xdt rows of P.xdt
  return KW * (HD + 8);
}
template <int HD>
__host__ __device__ constexpr int first_stage() {
  return CB_STAGE > s_stage<HD>() ? CB_STAGE : s_stage<HD>();
}

// bytes of each of the two TF32 parts of a B operand: N rows of one
// 128-byte swizzle row
__host__ __device__ constexpr int part_bytes(int n) { return n * 128; }

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// causal (row tile, key tile) pairs of a chunk
__host__ __device__ inline int tile_pairs(int c) {
  const int r = (c + BR - 1) / BR;
  return r * (r + 1) / 2;
}

// (row tile, key tile <= row tile) of causal pair p, row by row
__device__ inline void pair_of(int p, int& rt, int& kt) {
  rt = 0;
  while (p > rt) p -= ++rt;
  kt = p;
}

// parts of at most STRIP keys that cover keys [0, end)
__host__ __device__ inline int key_parts(int end) {
  return (end + STRIP - 1) / STRIP;
}

// blocks of y for one (batch, chunk, head): a row tile r reaches keys
// [0, min(64 (r + 1), c)), one block for each part of them
__host__ __device__ inline int y_units(int c) {
  int n = 0;
  for (int r0 = 0; r0 < c; r0 += BR) n += key_parts(r0 + BR < c ? r0 + BR : c);
  return n;
}

template <int HD>
size_t first_smem(int c) {
  const int part = part_bytes(BKT > HD ? BKT : HD);
  return 1024 + 2 * size_t(part) +
         sizeof(float) * (round4(c) + 8 + NST * first_stage<HD>());
}

template <int HD>
size_t second_smem(int c) {
  return 1024 + 2 * size_t(part_bytes(HD)) +
         sizeof(float) * (round4(c) + BR * LDP + NST_Y * y_stage<HD>());
}

// 1024-byte-aligned start of a kernel's shared memory, for the swizzle
// (offset from smem_raw, not rounded as an integer, so that the compiler
// still sees a shared-memory pointer and emits LDS/STS)
__device__ __forceinline__ uint32_t* aligned_smem(unsigned char* smem_raw) {
  return reinterpret_cast<uint32_t*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
}

// cp.async of rows [r0, r0 + ROWS) and columns [k0, k0 + COLS) of a
// row-major (n_rows x ld) matrix into dst (pitch ldd); what lies outside the
// matrix reads as zero. vec: ld % 4 == 0 and src 16-byte aligned. Each
// thread keeps one column and steps down the rows, so its addresses are a
// base and a constant stride.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_rows(float* dst, int ldd,
                                           const float* src, int ld,
                                           int n_rows, int r0, int k0,
                                           bool vec) {
  if (vec) {
    constexpr int CV = COLS / 4, STEP = NT / CV;  // rows a pass covers
    static_assert(NT % CV == 0 && ROWS % STEP == 0, "tile of whole passes");
    const int r = threadIdx.x / CV, q = (threadIdx.x % CV) * 4;
    const bool col_ok = k0 + q < ld;
    const float* s = src + (size_t(r0 + r) * ld + k0 + q);
    float* d = dst + r * ldd + q;
#pragma unroll
    for (int k = 0; k < ROWS / STEP; ++k) {
      const bool ok = col_ok && r0 + r + k * STEP < n_rows;
      cp_async16(d + k * STEP * ldd, ok ? s + size_t(k) * STEP * ld : src,
                 ok);
    }
  } else {
    constexpr int STEP = NT / COLS;
    static_assert(NT % COLS == 0 && ROWS % STEP == 0, "tile of whole passes");
    const int r = threadIdx.x / COLS, q = threadIdx.x % COLS;
    const bool col_ok = k0 + q < ld;
    const float* s = src + (size_t(r0 + r) * ld + k0 + q);
    float* d = dst + r * ldd + q;
#pragma unroll
    for (int k = 0; k < ROWS / STEP; ++k) {
      const bool ok = col_ok && r0 + r + k * STEP < n_rows;
      cp_async4(d + k * STEP * ldd, ok ? s + size_t(k) * STEP * ld : src, ok);
    }
  }
}

// word offset of 16-byte chunk ch (of 8) in row r of a 128-byte-swizzled
// tile of TF32 values
__device__ __forceinline__ int sw128_tf32(int r, int ch) {
  return r * KW + ((ch ^ (r & 7)) << 2);
}

__device__ __forceinline__ void store_parts(uint32_t* hi, uint32_t* lo, int o,
                                            float a, float b, float c,
                                            float d) {
  uint4 h, l;
  split_tf32(a, h.x, l.x);
  split_tf32(b, h.y, l.y);
  split_tf32(c, h.z, l.z);
  split_tf32(d, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + o) = h;
  *reinterpret_cast<uint4*>(lo + o) = l;
}

// The TF32 parts of a staged (ROWS x KW) tile (pitch ld), K-major as they
// are: row r of the B operand is row r of the tile.
template <int ROWS>
__device__ __forceinline__ void split_rows(const float* raw, int ld,
                                           uint32_t* hi, uint32_t* lo) {
  constexpr int STEP = NT / 8;  // rows a pass covers
  static_assert(ROWS % STEP == 0, "tile of whole passes");
  const int r = threadIdx.x / 8, ch = threadIdx.x % 8;
#pragma unroll
  for (int k = 0; k < ROWS / STEP; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(
        raw + (r + k * STEP) * ld + 4 * ch);
    store_parts(hi, lo, sw128_tf32(r + k * STEP, ch), v.x, v.y, v.z, v.w);
  }
}

// The TF32 parts of a staged (KW x N) tile (pitch ld), transposed to
// K-major while they are written: row n of the B operand is column n.
template <int N>
__device__ __forceinline__ void split_cols(const float* raw, int ld,
                                           uint32_t* hi, uint32_t* lo) {
  static_assert((N * 8) % NT == 0, "tile of whole passes");
#pragma unroll
  for (int k = 0; k < N * 8 / NT; ++k) {
    const int idx = threadIdx.x + k * NT, n = idx % N, ch = idx / N;
    const float* x = raw + 4 * ch * ld + n;
    store_parts(hi, lo, sw128_tf32(n, ch), x[0], x[ld], x[2 * ld],
                x[3 * ld]);
  }
}

// Runs compute(stage, i) for i in [0, n) while load(stage, i + STAGES - 1)
// fills the ring ahead of it. Ends with every copy landed and a barrier, so
// the ring is free for the next pipeline.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void pipeline(int n, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed; stage it - 1 is read by everyone
    const int nx = it + STAGES - 1;
    if (nx < n) load(nx % STAGES, nx);
    cp_async_commit();
    compute(it % STAGES, it);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acs[i] = a[0] + ... + a[i] over the chunk: a block-wide scan of NT values
// a pass. tmp: 8 floats.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a_c,
                                             float* acs, float* tmp, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float carry = 0.f;
  for (int base = 0; base < c; base += NT) {
    const int i = base + threadIdx.x;
    float v = i < c ? a_c[i] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) tmp[warp] = v;
    __syncthreads();
    float before = carry, total = carry;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) before += tmp[w];
      total += tmp[w];
    }
    if (i < c) acs[i] = v + before;
    carry = total;
    __syncthreads();  // tmp is read before the next pass writes it
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// keeps the compiler from reusing A's registers before the products that
// read them have completed
template <int N>
__device__ __forceinline__ void fence_frags(FragA (&f)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" : "+r"(f[k].hi[i]), "+r"(f[k].lo[i])::"memory");
}

// acc (64 x N) += A (64 x KW, the fragments fa) * B (KW x N, its TF32 parts
// in sHi, sLo), in split TF32; waits for the products to complete
template <int N>
__device__ __forceinline__ void product(float (&acc)[N / 2],
                                        FragA (&fa)[KW / 8],
                                        const uint32_t* sHi,
                                        const uint32_t* sLo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KW / 8; ++kk)  // a k8 step is 32 bytes into the row
    wgmma_3xtf32<N>(acc, fa[kk], gmma_desc(sHi + 8 * kk, 16, 1024),
                    gmma_desc(sLo + 8 * kk, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_frags(fa);
}

// One 64 x 64 tile of C.B^T: causal (row tile, key tile) pair `unit` of
// the chunks' pairs (tile_pairs(c) a chunk, row by row), reduced over
// d_state in stages of KW columns through a ring of NST stages of STAGE
// floats; written to CB (batch * nc, c, c).
template <int STAGE>
__device__ __forceinline__ void cb_tile(const float* __restrict__ Bm,
                                        const float* __restrict__ Cm,
                                        float* __restrict__ CB, int unit,
                                        int c, int ds, int vec_bc,
                                        uint32_t* sHi, uint32_t* sLo,
                                        float* ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile
  FragA fa[KW / 8];
  const int pairs = tile_pairs(c);
  const int bn = unit / pairs;
  int r, jt;
  pair_of(unit % pairs, r, jt);
  const int r0 = r * BR;
  const float* B_c = Bm + size_t(bn) * c * ds;
  const float* C_c = Cm + size_t(bn) * c * ds;
  float cb[BKT / 2];
  zero(cb);
  pipeline<NST>(
      (ds + KW - 1) / KW,
      [&](int st, int it) {
        float* s = ring + st * STAGE;
        stage_rows<BR, KW>(s, LDK, C_c, ds, c, r0, it * KW, vec_bc);
        stage_rows<BKT, KW>(s + BR * LDK, LDK, B_c, ds, c, jt * BKT, it * KW,
                            vec_bc);
      },
      [&](int st, int) {
        const float* sC = ring + st * STAGE;
        split_rows<BKT>(sC + BR * LDK, LDK, sHi, sLo);  // B: keys x k
        fence_proxy_async();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KW / 8; ++kk) {  // A = C
          const float* pc = sC + (wr + g) * LDK + 8 * kk + t;
          fa[kk] = split_a(pc[0], pc[8 * LDK], pc[4], pc[8 * LDK + 4]);
        }
        product<BKT>(cb, fa, sHi, sLo);
      });
  float* out = CB + size_t(bn) * c * c;
#pragma unroll
  for (int nt = 0; nt < BKT / 8; ++nt) {
    const int col = jt * BKT + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + wr + g + 8 * half;
      if (i >= c) continue;
      if (col < c) out[size_t(i) * c + col] = cb[4 * nt + 2 * half];
      if (col + 1 < c) out[size_t(i) * c + col + 1] = cb[4 * nt + 2 * half + 1];
    }
  }
}

// The first kernel, three kinds of block:
//   * S, for one (batch, chunk, head, 64 state rows): the cumsums of a
//     (stored to acs_out for the second kernel by the first state tile),
//     then S = (B o w)^T . xdt with w = exp(acs_end - acs) over the chunk,
//     stages of KW rows;
//   * C.B^T, once per (batch, chunk): one 64 x 64 tile of a causal (row
//     tile, key tile) pair over d_state, stages of KW columns;
//   * clearing y, which the second kernel adds into.
// grid: x = S blocks (batch * nc x heads x state tiles), C.B^T blocks
// (batch * nc x tile pairs), ZERO_BLOCKS.
template <int HD>
__global__ void __launch_bounds__(NT)
ssd_first_kernel(const float* __restrict__ a, const float* __restrict__ xdt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ CB, float* __restrict__ acs_out,
                 float* __restrict__ S, float* __restrict__ y,
                 size_t y_floats, int n_bc, int nh, int nc, int c, int ds,
                 int vec_bc, int vec_x) {
  constexpr int LDX = HD + 8;
  constexpr int STAGE = first_stage<HD>();
  const int s_tiles = (ds + BS - 1) / BS;
  const int n_s = n_bc * nh * s_tiles, n_cb = n_bc * tile_pairs(c);
  if (int(blockIdx.x) >= n_s + n_cb) {
    const size_t first = (blockIdx.x - size_t(n_s + n_cb)) * NT + threadIdx.x;
    const size_t step = size_t(gridDim.x - n_s - n_cb) * NT;
    for (size_t i = first; i < y_floats / 4; i += step)
      reinterpret_cast<float4*>(y)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  constexpr int PART = part_bytes(BKT > HD ? BKT : HD) / 4;
  uint32_t* sHi = aligned_smem(smem_raw);
  uint32_t* sLo = sHi + PART;
  float* sAcs = reinterpret_cast<float*>(sLo + PART);  // c
  float* sTmp = sAcs + round4(c);                     // 8
  float* ring = sTmp + 8;                              // NST x STAGE

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile
  FragA fa[KW / 8];

  if (int(blockIdx.x) < n_s) {
    // ---- S[s0 + rows] = sum_j (B_j[s] w_j) xdt_j ----
    const int bn = blockIdx.x / (nh * s_tiles);
    const int h = blockIdx.x / s_tiles % nh, s0 = blockIdx.x % s_tiles * BS;
    const size_t chunk0 = (size_t(bn / nc) * nh + h) * nc + bn % nc;
    const float* x_c = xdt + chunk0 * c * HD;
    const float* B_c = Bm + size_t(bn) * c * ds;
    chunk_cumsum(a + chunk0 * c, sAcs, sTmp, c);
    if (s0 == 0)  // the second kernel reads the cumsums from here
      for (int i = threadIdx.x; i < c; i += NT) acs_out[chunk0 * c + i] = sAcs[i];
    const float end = sAcs[c - 1];
    __syncthreads();
    for (int i = threadIdx.x; i < c; i += NT)  // w in place
      sAcs[i] = expf(end - sAcs[i]);
    __syncthreads();

    float acc[HD / 2];
    const int nks = (c + KW - 1) / KW;
    pipeline<NST>(
        nks,
        [&](int st, int ks) {
          float* s = ring + st * STAGE;
          stage_rows<KW, BS>(s, LDW, B_c, ds, c, ks * KW, s0, vec_bc);
          stage_rows<KW, HD>(s + KW * LDW, LDX, x_c, HD, c, ks * KW, 0, vec_x);
        },
        [&](int st, int ks) {
          const int j0 = ks * KW;
          const float* sW = ring + st * STAGE;
          split_cols<HD>(sW + KW * LDW, LDX, sHi, sLo);  // xdt^T
          fence_proxy_async();
          __syncthreads();
          if (ks == 0) zero(acc);
          const float* w = sAcs;  // exp(acs_end - acs_j)
#pragma unroll
          for (int kk = 0; kk < KW / 8; ++kk) {  // A = (B o w)^T
            const int ja = j0 + 8 * kk + t, jc = ja + 4;
            const float wa = ja < c ? w[ja] : 0.f;
            const float wc = jc < c ? w[jc] : 0.f;
            const float* pw = sW + (8 * kk + t) * LDW + wr + g;
            fa[kk] = split_a(pw[0] * wa, pw[8] * wa, pw[4 * LDW] * wc,
                             pw[4 * LDW + 8] * wc);
          }
          product<HD>(acc, fa, sHi, sLo);
          if (ks == nks - 1) {
            float* Sh = S + chunk0 * ds * HD;
#pragma unroll
            for (int nt = 0; nt < HD / 8; ++nt) {
              const int col = nt * 8 + 2 * t;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int s = s0 + wr + g + 8 * half;
                if (s < ds)
                  *reinterpret_cast<float2*>(Sh + size_t(s) * HD + col) =
                      make_float2(acc[4 * nt + 2 * half],
                                  acc[4 * nt + 2 * half + 1]);
              }
            }
          }
        });
    return;
  }

  cb_tile<STAGE>(Bm, Cm, CB, blockIdx.x - n_s, c, ds, vec_bc, sHi, sLo,
                 ring);
}

// The second kernel: y[rows] += (C.B^T o decay) . xdt over one part of the
// keys, for one (batch, chunk, head, 64-row tile, key part); C.B^T and the
// cumsums of a from the first kernel, y cleared by it.
// grid: x = units (see y_units; the longest rows first), y = head,
// z = batch * nc + chunk.
template <int HD>
__global__ void __launch_bounds__(NT)
ssd_y_kernel(const float* __restrict__ xdt, const float* __restrict__ CB,
             const float* __restrict__ acs_in, float* __restrict__ y, int nh,
             int nc, int c, int vec_x, int vec_cb) {
  constexpr int LDX = HD + 8;
  constexpr int STAGE = y_stage<HD>();
  extern __shared__ unsigned char smem_raw[];
  uint32_t* sHi = aligned_smem(smem_raw);
  uint32_t* sLo = sHi + part_bytes(HD) / 4;
  float* sAcs = reinterpret_cast<float*>(sLo + part_bytes(HD) / 4);
  float* sCB = sAcs + round4(c);          // BR x LDP
  float* ring = sCB + BR * LDP;           // NST_Y x STAGE

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int bn = blockIdx.z;
  const size_t chunk0 = (size_t(bn / nc) * nh + blockIdx.y) * nc + bn % nc;
  const float* x_c = xdt + chunk0 * c * HD;

  // the unit: (row tile, key part), the longest rows first
  int unit = blockIdx.x, r0 = (c - 1) / BR * BR;
  for (;; r0 -= BR) {
    const int parts = key_parts(min(r0 + BR, c));
    if (unit < parts) break;
    unit -= parts;
  }
  const int kl = unit * STRIP, kh = min(kl + STRIP, min(r0 + BR, c));
  const int i0 = r0 + wr + g, i1 = i0 + 8;  // this thread's rows
  // rows whose keys are one part are this block's alone: stored, not added
  const bool alone = key_parts(min(r0 + BR, c)) == 1;

  // the cumsums and the strip C.B^T[rows, keys kl..kh), in a group of
  // copies older than every stage of the pipeline below
  for (int i = threadIdx.x; i < c; i += NT)
    cp_async4(sAcs + i, acs_in + chunk0 * c + i, true);
  stage_rows<BR, STRIP>(sCB, LDP, CB + size_t(bn) * c * c, c, c, r0, kl,
                        vec_cb);
  cp_async_commit();

  float acc[HD / 2];
  FragA fa[KW / 8];
  const int nks = (kh - kl + KW - 1) / KW;
  pipeline<NST_Y>(
      nks,
      [&](int st, int ks) {
        stage_rows<KW, HD>(ring + st * STAGE, LDX, x_c, HD, c, kl + ks * KW,
                           0, vec_x);
      },
      [&](int st, int ks) {
        const int j0 = kl + ks * KW;
        const float* acs = sAcs;
        const float ai0 = acs[min(i0, c - 1)], ai1 = acs[min(i1, c - 1)];
        // P[i][j] = C.B^T[i][j] exp(acs_i - acs_j) on the causal triangle,
        // 0 elsewhere; the decay from acs, never factorised. Keys wholly
        // below the tile's rows need no mask.
        const bool below = j0 + KW <= r0 && r0 + BR <= c && j0 + KW <= kh;
        auto p = [&](int i, float ai, int j) {
          const float v =
              sCB[(i - r0) * LDP + j - kl] *
              exp2_ftz((ai - acs[below ? j : min(j, c - 1)]) * LOG2E);
          return below || (j <= i && i < c && j < kh) ? v : 0.f;
        };
        split_cols<HD>(ring + st * STAGE, LDX, sHi, sLo);  // xdt^T
        fence_proxy_async();
        __syncthreads();
        if (ks == 0) zero(acc);
#pragma unroll
        for (int kk = 0; kk < KW / 8; ++kk) {  // A = P
          const int ja = j0 + 8 * kk + t, jc = ja + 4;
          fa[kk] = split_a(p(i0, ai0, ja), p(i1, ai1, ja), p(i0, ai0, jc),
                           p(i1, ai1, jc));
        }
        product<HD>(acc, fa, sHi, sLo);
        if (ks == nks - 1) {
          float* yh = y + chunk0 * c * HD;
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt) {
            const int col = nt * 8 + 2 * t;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int i = half ? i1 : i0;
              if (i >= c) continue;
              float* q = yh + size_t(i) * HD + col;
              if (alone) {
                *reinterpret_cast<float2*>(q) = make_float2(
                    acc[4 * nt + 2 * half], acc[4 * nt + 2 * half + 1]);
              } else {
                atomicAdd(q, acc[4 * nt + 2 * half]);
                atomicAdd(q + 1, acc[4 * nt + 2 * half + 1]);
              }
            }
          }
        }
      });
}

// dynamic shared memory up to smem, and the carveout that lets as many
// blocks share an SM as fit
template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

template <int HD>
cudaError_t launch(const float* a, const float* xdt, const float* B,
                   const float* C, float* y, float* S, float* CB, float* acs,
                   int b, int nh, int nc, int c, int ds,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(y)) return cudaErrorMisalignedAddress;
  const int vec_bc = ds % 4 == 0 && aligned(B) && aligned(C);
  const int vec_x = aligned(xdt);
  const int vec_cb = c % 4 == 0 && aligned(CB);
  const int n_bc = b * nc;

  // the largest shared memory each kernel has been set up for
  static size_t first_set = 0, second_set = 0;
  const size_t smem1 = first_smem<HD>(c), smem2 = second_smem<HD>(c);
  cudaError_t e = cudaSuccess;
  if (smem1 > first_set) {
    e = set_smem(ssd_first_kernel<HD>, smem1);
    if (e != cudaSuccess) return e;
    first_set = smem1;
  }
  if (smem2 > second_set) {
    e = set_smem(ssd_y_kernel<HD>, smem2);
    if (e != cudaSuccess) return e;
    second_set = smem2;
  }
  const int n_first = n_bc * nh * ((ds + BS - 1) / BS) +
                      n_bc * tile_pairs(c) + ZERO_BLOCKS;
  ssd_first_kernel<HD><<<n_first, NT, smem1, stream>>>(
      a, xdt, B, C, CB, acs, S, y, size_t(b) * nh * nc * c * HD, n_bc, nh, nc,
      c, ds, vec_bc, vec_x);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_y_kernel<HD><<<dim3(y_units(c), nh, n_bc), NT, smem2, stream>>>(
      xdt, CB, acs, y, nh, nc, c, vec_x, vec_cb);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward of the intra-chunk dual form.
//
// The TPU kernel has no backward: JAX differentiates its jnp ssd_chunked
// (src/repro/models/mamba2.py). Per (batch, chunk, head), with L_ij =
// exp(acs_i - acs_j) for i >= j, G = C.B^T, M = G o L and w_j =
// exp(acs_end - acs_j), for the output gradients dy (c, hd) and dS (ds, hd):
//   dM    = dy.xdt^T on the causal triangle, P = dM o M, U = B.dS (c, hd)
//   dxdt  = M^T.dy + diag(w).U
//   dacs  = rowsum(P) - colsum(P) - q, q_j = w_j (U_j . xdt_j), and
//           dacs_end += sum_j q_j;  da = the reverse cumsum of dacs
//   dG_h  = dM o L
// and per (batch, chunk), the heads summed:
//   dC = (sum_h dG_h).B,  dB = (sum_h dG_h)^T.C + sum_h diag(w_h).xdt_h.dS_h^T
//
// What bounds it on this card: at mamba2-370m's training microbatch (4 x
// 2048 tokens, 32 heads, chunk 256, d_state 128, head dim 64) the least work
// is ~18 GFLOP on the causal triangle with C.B^T once per (batch, chunk),
// and the least traffic ~0.25 GB (a, xdt, B, C, dy, dS read once; da, dxdt,
// dB, dC written once): ~0.076 ms of bytes and, in split TF32 on the tensor
// cores (three TF32 products for each f32 one), ~0.11 ms of operations.
// Operations bound it, so every product runs on the tensor cores, each f32
// product once, and the per-head intermediates (dM_h, P_h, dG_h) stay out
// of device memory. The design:
//   * four grids on the stream, one launch of the wrapper; each block is
//     one warpgroup running wgmma.m64nNk8 in split TF32 with the forward's
//     building blocks (cp.async rings, split_rows and split_cols, product).
//     Several blocks share an SM and overlap one another's barriers,
//     splits and waits: four of the per-head grid (at most 128 registers a
//     thread, ~55 KB of shared memory at head dim 64 and chunk 256), three
//     of the others:
//     (1) prep: G = C.B^T once per (batch, chunk), one block per causal
//         64 x 64 tile pair (the forward's cb_tile), into a (b, nc, c, c)
//         workspace; and the cumsums of a, one block-wide scan per (batch,
//         head, chunk);
//     (2) the heads walked in order, two kinds of block in one grid. (2a)
//         one block per (batch, chunk, tile pair): dM_h = dy_h.xdt_h^T on
//         the tile, then dM_h o L_h added to an f32 register tile, so that
//         the heads' dG is summed on chip in head order and written once
//         (b, nc, c, c); the row and column sums of P_h = dM_h o L_h o G on
//         the tile go to a small workspace (b, nc, nh, tile pairs, 2, 64).
//         dM_h is computed here only: the per-head grid needs P's sums, not
//         P. (2b) the head term sum_h diag(w_h).xdt_h.dS_h^T as one product
//         of depth nh x hd, cut into n_parts parts of consecutive heads,
//         one block per (batch, chunk, row tile, part, 64 state columns),
//         into a (b, nc, n_parts, c, ds) workspace: zamba2's d_state 64
//         would give only 128 blocks of full depth, fewer than the card's
//         SMs. (2a)'s 320 blocks at chunk 256 are one partial wave; (2b)'s
//         fill the rest of the card;
//     (3) per head: one block per (batch, chunk, head), one two-stage
//         cp.async pipeline over every step of every key tile, so that no
//         key tile starts on an empty ring: diag(w).U = (w o B).dS over
//         d_state, q from it, then M^T.dy over the row tiles from the key
//         tile on, 32 rows a product. M = G o L is formed from (1)'s G,
//         read from device memory ahead of the split, and the decays while
//         A's fragments are split: it is never an accumulator, so nothing
//         goes through shared memory for it. Writes dxdt, then da: (2a)'s
//         sums in tile order, q, and a block-wide reverse scan;
//     (4) dC = dG.B and dB = dG^T.C over the triangle, one block per
//         (batch, chunk, row tile, 64 state columns, dC or dB); dB adds
//         (2b)'s parts in part order;
//   * wgmma takes TF32 B only K-major: xdt (for dM), dS (the head term) and
//     B (for G) are K-major as stored; dS (for U), dy (for M^T.dy), B (for
//     dC) and C (for dB) are transposed while their parts are written. An
//     accumulator is never an A fragment: M is formed at A's places, dG^T
//     is read transposed from its staged slab. Ragged edges (chunks and
//     d_state off the tile, head dim 16 under the 32-wide slab) are
//     zero-filled by the copies;
//   * every sum runs in a fixed order and nothing is added by atomics: the
//     same bits from run to run;
//   * the decay is taken per element from differences of acs, never
//     factorised, as in the forward.

namespace bwd {

constexpr int T = 64;         // rows, keys and state columns of a tile
constexpr int LDT = T + 8;    // pitch of a 64-wide tile
constexpr int NSB = 3;        // stages of the slab rings
constexpr int MAX_C = 1024;   // chunk rows the per-head grid keeps in smem

__host__ __device__ inline int tiles(int n) { return (n + T - 1) / T; }

// the sum of every thread's v, the same bits in every thread: a butterfly
// in each warp, then the warps in order. tmp: 4 floats.
__device__ __forceinline__ float block_sum(float v, float* tmp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += tmp[w];
  __syncthreads();  // tmp is read before it is written again
  return s;
}

// out[i] = v[i] + v[i + 1] + ... + v[c - 1]: a block-wide scan of NT
// values a pass from the chunk's end, in a fixed order. tmp: 4 floats.
__device__ __forceinline__ void reverse_cumsum(const float* v, float* out,
                                               float* tmp, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float carry = 0.f;
  for (int base = 0; base < c; base += NT) {
    const int k = base + threadIdx.x, i = c - 1 - k;
    float x = k < c ? v[i] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += u;
    }
    if (lane == 31) tmp[warp] = x;
    __syncthreads();
    float before = carry, total = carry;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) before += tmp[w];
      total += tmp[w];
    }
    if (k < c) out[i] = x + before;
    carry = total;
    __syncthreads();  // tmp is read before the next pass writes it
  }
}

// (1) G = C.B^T on each causal tile pair of each chunk (blocks [0, n_cb)),
// then the cumsums of a, one block per (batch, head, chunk)
__global__ void __launch_bounds__(NT)
bwd_prep_kernel(const float* __restrict__ a, const float* __restrict__ B,
                const float* __restrict__ C, float* __restrict__ cb,
                float* __restrict__ acs, int n_cb, int c, int ds,
                int vec_bc) {
  extern __shared__ unsigned char smem_raw[];
  uint32_t* sHi = aligned_smem(smem_raw);
  uint32_t* sLo = sHi + part_bytes(BKT) / 4;
  float* ring = reinterpret_cast<float*>(sLo + part_bytes(BKT) / 4);
  if (int(blockIdx.x) < n_cb) {
    cb_tile<CB_STAGE>(B, C, cb, blockIdx.x, c, ds, vec_bc, sHi, sLo, ring);
    return;
  }
  const size_t row = blockIdx.x - n_cb;
  chunk_cumsum(a + row * c, acs + row * c, ring, c);
}

size_t prep_smem() {
  return 1024 + 2 * size_t(part_bytes(BKT)) + sizeof(float) * NST * CB_STAGE;
}

// (2a)'s stage: dy and xdt slabs (T x KW each), then the cumsums of the
// rows and keys; two stages, so that with G's tile three blocks fit on an
// SM. (2b)'s stage: xdt and dS slabs (T x KW each), then the cumsums of the
// rows and the chunk's last one
constexpr int DG_STAGE = 2 * T * LDK + 2 * T;
constexpr int DG_STAGES = 2;
constexpr int HT_STAGE = 2 * T * LDK + T + 4;

size_t dg_smem() {
  const size_t dg = sizeof(float) * (4 * T + T * LDT + DG_STAGES * DG_STAGE);
  const size_t ht = sizeof(float) * NSB * HT_STAGE;
  return 1024 + 2 * size_t(part_bytes(T)) + (dg > ht ? dg : ht);
}

// (2a) for causal tile pair `pair` (rt, kt) of chunk bn, the heads in
// order: dG = sum_h dM_h o L_h into dg (bn, c, c), and each head's row and
// column sums of P_h = dM_h o L_h o G on the tile into sums
template <int HD>
__device__ __forceinline__ void dg_block(
    const float* __restrict__ xdt, const float* __restrict__ dy,
    const float* __restrict__ cb, const float* __restrict__ acs,
    float* __restrict__ dg, float* __restrict__ sums, int nh, int nc, int c,
    int vec, int vec_cb, int pair, int bn, unsigned char* smem_raw) {
  constexpr int NSL = (HD + KW - 1) / KW;  // slabs of the head dim
  constexpr int PW = part_bytes(T) / 4;
  uint32_t* parts = aligned_smem(smem_raw);
  float* colp = reinterpret_cast<float*>(parts + 2 * PW);  // 4 warps x T
  float* sG = colp + 4 * T;                                // T x LDT
  float* ring = sG + T * LDT;                  // DG_STAGES x DG_STAGE
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int bi = bn / nc, n = bn % nc;
  int rt, kt;
  pair_of(pair, rt, kt);
  const int r0 = rt * T, k0 = kt * T;
  const int npairs = tile_pairs(c);

  // G's tile, in a group of copies older than every stage below
  stage_rows<T, T>(sG, LDT, cb + size_t(bn) * c * c, c, c, r0, k0, vec_cb);
  cp_async_commit();
  float acc[T / 2], dgs[T / 2];
  zero(dgs);
  FragA fa[KW / 8];
  pipeline<DG_STAGES>(
      nh * NSL,
      [&](int st, int it) {
        const int sl = it % NSL;
        const size_t bhn = (size_t(bi) * nh + it / NSL) * nc + n;
        float* s = ring + st * DG_STAGE;
        stage_rows<T, KW>(s, LDK, dy + bhn * c * HD, HD, c, r0, sl * KW, vec);
        stage_rows<T, KW>(s + T * LDK, LDK, xdt + bhn * c * HD, HD, c, k0,
                          sl * KW, vec);
        if (sl == NSL - 1) {  // the cumsums of the rows, then of the keys
          const int tid = threadIdx.x;
          const int i = tid < T ? r0 + tid : k0 + tid - T;
          const float* ac = acs + bhn * c;
          cp_async4(s + 2 * T * LDK + threadIdx.x, i < c ? ac + i : ac,
                    i < c);
        }
      },
      [&](int st, int it) {
        const int sl = it % NSL;
        const float* s = ring + st * DG_STAGE;
        split_rows<T>(s + T * LDK, LDK, parts, parts + PW);  // xdt: keys x k
        fence_proxy_async();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KW / 8; ++kk) {  // A = dy
          const float* p = s + (wr + g) * LDK + 8 * kk + t;
          fa[kk] = split_a(p[0], p[8 * LDK], p[4], p[8 * LDK + 4]);
        }
        if (sl == 0) zero(acc);
        product<T>(acc, fa, parts, parts + PW);
        if (sl < NSL - 1) return;
        // acc holds dM_h on the tile: dG += dM_h o L_h, P_h = dM_h o L_h o G
        const float* sa = s + 2 * T * LDK;  // acs of the rows, then the keys
        float rowp[2] = {0.f, 0.f}, colv[T / 4];
        zero(colv);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int il = wr + g + 8 * half, i = r0 + il;
          const float ai = sa[il];
#pragma unroll
          for (int nb = 0; nb < T / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jl = 8 * nb + 2 * t + e, q = 4 * nb + 2 * half + e;
              const float l = k0 + jl <= i && i < c
                                  ? exp2_ftz((ai - sa[T + jl]) * LOG2E)
                                  : 0.f;
              const float d = acc[q] * l;
              dgs[q] += d;
              const float pv = d * sG[il * LDT + jl];
              rowp[half] += pv;
              colv[2 * nb + e] += pv;
            }
        }
        float* out = sums + ((size_t(bn) * nh + it / NSL) * npairs + pair) *
                                2 * T;
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // over the keys of a row
          float v = rowp[half];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) out[wr + g + 8 * half] = v;
        }
#pragma unroll
        for (int k = 0; k < T / 4; ++k) {  // over the warp's rows of a key
          colv[k] += __shfl_xor_sync(0xffffffffu, colv[k], 4);
          colv[k] += __shfl_xor_sync(0xffffffffu, colv[k], 8);
          colv[k] += __shfl_xor_sync(0xffffffffu, colv[k], 16);
        }
        if (g == 0)
#pragma unroll
          for (int nb = 0; nb < T / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              colp[warp * T + 8 * nb + 2 * t + e] = colv[2 * nb + e];
        __syncthreads();
        if (threadIdx.x < T)  // the warps in order
          out[T + threadIdx.x] = colp[threadIdx.x] + colp[T + threadIdx.x] +
                                 colp[2 * T + threadIdx.x] +
                                 colp[3 * T + threadIdx.x];
      });
  float* out = dg + size_t(bn) * c * c;
#pragma unroll
  for (int nb = 0; nb < T / 8; ++nb) {
    const int col = k0 + nb * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + wr + g + 8 * half;
      if (i >= c) continue;
      if (col < c) out[size_t(i) * c + col] = dgs[4 * nb + 2 * half];
      if (col + 1 < c)
        out[size_t(i) * c + col + 1] = dgs[4 * nb + 2 * half + 1];
    }
  }
}

// (2b) block `unit` of the head term's grid, (batch x chunk, row tile,
// part, 64 state columns): part `part` of sum_h diag(w_h).xdt_h.dS_h^T,
// heads [part * per, (part + 1) * per) with per = ceil(nh / n_parts), into
// hparts (bn, n_parts, c, ds)
template <int HD>
__device__ __forceinline__ void hterm_block(
    const float* __restrict__ xdt, const float* __restrict__ dS,
    const float* __restrict__ acs, float* __restrict__ hparts, int nh, int nc,
    int c, int ds, int n_parts, int vec, int unit, unsigned char* smem_raw) {
  constexpr int NSL = (HD + KW - 1) / KW;
  constexpr int PW = part_bytes(T) / 4;
  uint32_t* parts = aligned_smem(smem_raw);
  float* ring = reinterpret_cast<float*>(parts + 2 * PW);  // NSB x HT_STAGE
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int s_tiles = tiles(ds), nx = s_tiles * n_parts;
  const int bn = unit / (tiles(c) * nx), x = unit % nx;
  const int s0 = x % s_tiles * T, part = x / s_tiles;
  const int r0 = unit / nx % tiles(c) * T, bi = bn / nc, n = bn % nc;
  const int per = (nh + n_parts - 1) / n_parts, h0 = part * per;
  const int heads = max(0, min(nh, h0 + per) - h0);
  float acc[T / 2];
  zero(acc);
  float w0 = 0.f, w1 = 0.f;
  FragA fa[KW / 8];
  pipeline<NSB>(
      heads * NSL,
      [&](int st, int it) {
        const int sl = it % NSL;
        const size_t bhn = (size_t(bi) * nh + h0 + it / NSL) * nc + n;
        float* s = ring + st * HT_STAGE;
        stage_rows<T, KW>(s, LDK, xdt + bhn * c * HD, HD, c, r0, sl * KW,
                          vec);
        stage_rows<T, KW>(s + T * LDK, LDK, dS + bhn * ds * HD, HD, ds, s0,
                          sl * KW, vec);
        const int tid = threadIdx.x;
        if (sl == 0 && tid <= T) {
          const int i = tid < T ? r0 + tid : c - 1;
          const float* ac = acs + bhn * c;
          cp_async4(s + 2 * T * LDK + tid, i < c ? ac + i : ac, i < c);
        }
      },
      [&](int st, int it) {
        const float* s = ring + st * HT_STAGE;
        split_rows<T>(s + T * LDK, LDK, parts, parts + PW);  // dS: state x k
        fence_proxy_async();
        __syncthreads();
        if (it % NSL == 0) {  // w of this head at the thread's two rows
          const float* sa = s + 2 * T * LDK;
          w0 = r0 + wr + g < c ? exp2_ftz((sa[T] - sa[wr + g]) * LOG2E) : 0.f;
          w1 = r0 + wr + g + 8 < c
                   ? exp2_ftz((sa[T] - sa[wr + g + 8]) * LOG2E)
                   : 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KW / 8; ++kk) {  // A = w o xdt
          const float* p = s + (wr + g) * LDK + 8 * kk + t;
          fa[kk] = split_a(w0 * p[0], w1 * p[8 * LDK], w0 * p[4],
                           w1 * p[8 * LDK + 4]);
        }
        product<T>(acc, fa, parts, parts + PW);
      });
  float* out = hparts + (size_t(bn) * n_parts + part) * c * ds;
#pragma unroll
  for (int nb = 0; nb < T / 8; ++nb)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = r0 + wr + g + 8 * half, sc = s0 + 8 * nb + 2 * t + e;
        if (j < c && sc < ds)
          out[size_t(j) * ds + sc] = acc[4 * nb + 2 * half + e];
      }
}

// (2) the two kinds of block that walk the heads, in one grid: blocks
// [0, n_dg) are (2a)'s, one per (batch x chunk, tile pair); the rest are
// (2b)'s. (2b) needs only the cumsums, so its blocks fill the SMs that
// (2a)'s single wave leaves free.
template <int HD>
__global__ void __launch_bounds__(NT, 3)
bwd_dg_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
              const float* __restrict__ dS, const float* __restrict__ cb,
              const float* __restrict__ acs, float* __restrict__ dg,
              float* __restrict__ sums, float* __restrict__ hparts, int nh,
              int nc, int c, int ds, int n_parts, int n_dg, int vec,
              int vec_cb) {
  extern __shared__ unsigned char smem_raw[];
  const int npairs = tile_pairs(c);
  if (int(blockIdx.x) < n_dg)
    dg_block<HD>(xdt, dy, cb, acs, dg, sums, nh, nc, c, vec, vec_cb,
                 blockIdx.x % npairs, blockIdx.x / npairs, smem_raw);
  else
    hterm_block<HD>(xdt, dS, acs, hparts, nh, nc, c, ds, n_parts, vec,
                    blockIdx.x - n_dg, smem_raw);
}

// a stage of the per-head grid's ring: B (T x KW) and dS (KW x HD) for U,
// or dy (T x HD) for M^T.dy; two stages, so that four blocks fit on an SM
constexpr int HEAD_STAGES = 2;

template <int HD>
__host__ __device__ constexpr int head_stage() {
  return T * LDK + KW * (HD + 8) > T * (HD + 8) ? T * LDK + KW * (HD + 8)
                                                : T * (HD + 8);
}

template <int HD>
size_t head_smem(int c) {
  return 1024 + 2 * size_t(part_bytes(HD)) +
         sizeof(float) * (2 * round4(c) + 8 + HEAD_STAGES * head_stage<HD>());
}

// (3) one block per (head, batch x chunk): dxdt, and da from (2)'s sums
template <int HD>
__global__ void __launch_bounds__(NT, 4)
bwd_head_kernel(const float* __restrict__ xdt, const float* __restrict__ B,
                const float* __restrict__ dy, const float* __restrict__ dS,
                const float* __restrict__ cb, const float* __restrict__ acs,
                const float* __restrict__ sums, float* __restrict__ da,
                float* __restrict__ dxdt, int nh, int nc, int c, int ds,
                int vec_bc, int vec) {
  constexpr int LDX = HD + 8;
  constexpr int PW = part_bytes(HD) / 4;
  constexpr int STAGE = head_stage<HD>();
  extern __shared__ unsigned char smem_raw[];
  uint32_t* parts = aligned_smem(smem_raw);  // high, low
  float* sAcs = reinterpret_cast<float*>(parts + 2 * PW);  // c
  float* sQ = sAcs + round4(c);                            // c: q, then dacs
  float* sTmp = sQ + round4(c);                            // 8
  float* ring = sTmp + 8;                        // HEAD_STAGES x STAGE
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int h = blockIdx.x, bn = blockIdx.y, bi = bn / nc, n = bn % nc;
  const size_t bhn = (size_t(bi) * nh + h) * nc + n;
  const float* x_c = xdt + bhn * c * HD;
  const float* dy_c = dy + bhn * c * HD;
  const float* dS_c = dS + bhn * ds * HD;
  const float* B_c = B + size_t(bn) * c * ds;
  const float* cb_c = cb + size_t(bn) * c * c;
  for (int i = threadIdx.x; i < c; i += NT) sAcs[i] = acs[bhn * c + i];
  __syncthreads();
  const float end = sAcs[c - 1];
  const int nt = tiles(c);
  float acc[HD / 2];
  FragA fa[KW / 8];

  // one pipeline over every key tile's steps, so that the next key tile's
  // copies run under this one's last products: for key tile kt, first nu
  // steps of diag(w).U = (w o B).dS over d_state, KW state columns a step;
  // then one step for each row tile from kt on, dxdt += M^T.dy
  const int nu = (ds + KW - 1) / KW;
  const auto locate = [&](int it, int& kt, int& k) {  // step it of tile kt
    for (kt = 0; it >= nu + nt - kt; ++kt) it -= nu + nt - kt;
    k = it;
  };
  pipeline<HEAD_STAGES>(
      nt * nu + tile_pairs(c),
      [&](int st, int it) {
        int kt, k;
        locate(it, kt, k);
        float* s = ring + st * STAGE;
        if (k < nu) {
          stage_rows<T, KW>(s, LDK, B_c, ds, c, kt * T, k * KW, vec_bc);
          stage_rows<KW, HD>(s + T * LDK, LDX, dS_c, HD, ds, k * KW, 0, vec);
        } else {
          stage_rows<T, HD>(s, LDX, dy_c, HD, c, (kt + k - nu) * T, 0, vec);
        }
      },
      [&](int st, int it) {
        int kt, k;
        locate(it, kt, k);
        const float* s = ring + st * STAGE;
        const int j0 = kt * T + wr + g, j1 = j0 + 8;  // this thread's keys
        const float aj0 = sAcs[min(j0, c - 1)], aj1 = sAcs[min(j1, c - 1)];
        if (k < nu) {
          const float w0 = j0 < c ? exp2_ftz((end - aj0) * LOG2E) : 0.f;
          const float w1 = j1 < c ? exp2_ftz((end - aj1) * LOG2E) : 0.f;
          split_cols<HD>(s + T * LDK, LDX, parts, parts + PW);  // dS^T
          fence_proxy_async();
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < KW / 8; ++kk) {  // A = w o B
            const float* p = s + (wr + g) * LDK + 8 * kk + t;
            fa[kk] = split_a(w0 * p[0], w1 * p[8 * LDK], w0 * p[4],
                             w1 * p[8 * LDK + 4]);
          }
          if (k == 0) zero(acc);
          product<HD>(acc, fa, parts, parts + PW);
          if (k < nu - 1) return;
          // q_j = w_j (U_j . xdt_j): acc holds diag(w).U
          float q0 = 0.f, q1 = 0.f;
#pragma unroll
          for (int nb = 0; nb < HD / 8; ++nb) {
            const int col = 8 * nb + 2 * t;
            if (j0 < c) {
              const float2 x = *reinterpret_cast<const float2*>(
                  x_c + size_t(j0) * HD + col);
              q0 = fmaf(acc[4 * nb], x.x, q0);
              q0 = fmaf(acc[4 * nb + 1], x.y, q0);
            }
            if (j1 < c) {
              const float2 x = *reinterpret_cast<const float2*>(
                  x_c + size_t(j1) * HD + col);
              q1 = fmaf(acc[4 * nb + 2], x.x, q1);
              q1 = fmaf(acc[4 * nb + 3], x.y, q1);
            }
          }
          q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
          q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
          q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
          q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
          if (t == 0 && j0 < c) sQ[j0] = q0;
          if (t == 0 && j1 < c) sQ[j1] = q1;
          return;
        }
        // dxdt += M^T.dy for row tile r0, 32 rows a product: M = G o L
        // formed where A's fragments are split, G read from (1)'s workspace
        // before dy's parts are written, to hide its latency; dy transposed
        // while its parts are written
        const int r0 = (kt + k - nu) * T;
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          float gm[KW / 8][4];  // G[i][j] at A's places of M^T[j][i]
#pragma unroll
          for (int kk = 0; kk < KW / 8; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = r0 + sl * KW + 8 * kk + t + 4 * (q >> 1);
              const int j = q & 1 ? j1 : j0;
              gm[kk][q] = i < c && j < c ? cb_c[size_t(i) * c + j] : 0.f;
            }
          if (sl) __syncthreads();  // the last product's parts are read
          split_cols<HD>(s + sl * KW * LDX, LDX, parts, parts + PW);
          fence_proxy_async();
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < KW / 8; ++kk) {  // A = M^T, 0 above i = j
            const int i0 = r0 + sl * KW + 8 * kk + t, i1 = i0 + 4;
            const float ai0 = sAcs[min(i0, c - 1)];
            const float ai1 = sAcs[min(i1, c - 1)];
            const auto m = [&](int i, float ai, int j, float aj, float gv) {
              return j <= i && i < c ? gv * exp2_ftz((ai - aj) * LOG2E) : 0.f;
            };
            fa[kk] = split_a(m(i0, ai0, j0, aj0, gm[kk][0]),
                             m(i0, ai0, j1, aj1, gm[kk][1]),
                             m(i1, ai1, j0, aj0, gm[kk][2]),
                             m(i1, ai1, j1, aj1, gm[kk][3]));
          }
          product<HD>(acc, fa, parts, parts + PW);
        }
        if (r0 + T < c) return;
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb) {  // the key tile's last step
          const int col = 8 * nb + 2 * t;
          if (j0 < c)
            *reinterpret_cast<float2*>(dxdt + (bhn * c + j0) * HD + col) =
                make_float2(acc[4 * nb], acc[4 * nb + 1]);
          if (j1 < c)
            *reinterpret_cast<float2*>(dxdt + (bhn * c + j1) * HD + col) =
                make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
        }
      });
  __syncthreads();  // every q stored
  // dacs_i = rowsum_i(P) - colsum_i(P) - q_i, and + sum_j q_j at the end;
  // P's sums from (2), tile by tile in order; then da = its reverse cumsum
  float qp = 0.f;
  for (int i = threadIdx.x; i < c; i += NT) qp += sQ[i];
  const float qsum = block_sum(qp, sTmp);
  const float* ps = sums + (size_t(bn) * nh + h) * tile_pairs(c) * 2 * T;
  for (int i = threadIdx.x; i < c; i += NT) {
    const int ti = i / T, il = i % T;
    float rs = 0.f, cs = 0.f;
    for (int k = 0; k <= ti; ++k)  // row i against key tiles 0 .. ti
      rs += ps[(ti * (ti + 1) / 2 + k) * 2 * T + il];
    for (int r = ti; r < nt; ++r)  // key i against row tiles ti .. nt - 1
      cs += ps[(r * (r + 1) / 2 + ti) * 2 * T + T + il];
    sQ[i] = rs - cs - sQ[i] + (i == c - 1 ? qsum : 0.f);
  }
  __syncthreads();
  reverse_cumsum(sQ, da + bhn * c, sTmp, c);
}

// a dG slab (T x KW for dC, KW x T for dB), then B or C (KW x T)
constexpr int DBC_STAGE = T * LDK + KW * LDT;
static_assert(T * LDK == KW * LDT, "dC's and dB's dG slabs take one place");

size_t dbc_smem() {
  return 1024 + 2 * size_t(part_bytes(T)) + sizeof(float) * NSB * DBC_STAGE;
}

// (4) dC = dG.B (blockIdx.x < state tiles) or dB = dG^T.C + the head term's
// parts in order, for row tile blockIdx.y and 64 state columns of chunk bn
__global__ void __launch_bounds__(NT)
bwd_dbc_kernel(const float* __restrict__ B, const float* __restrict__ C,
               const float* __restrict__ dg, const float* __restrict__ hparts,
               float* __restrict__ dB, float* __restrict__ dC, int c, int ds,
               int n_parts, int vec_bc, int vec_cb) {
  constexpr int PW = part_bytes(T) / 4;
  extern __shared__ unsigned char smem_raw[];
  uint32_t* parts = aligned_smem(smem_raw);
  float* ring = reinterpret_cast<float*>(parts + 2 * PW);  // NSB x DBC_STAGE
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int s_tiles = tiles(ds);
  const int s0 = blockIdx.x % s_tiles * T;
  const bool is_db = int(blockIdx.x) >= s_tiles;
  const int r0 = blockIdx.y * T, bn = blockIdx.z;
  const float* dg_c = dg + size_t(bn) * c * c;
  const float* V = (is_db ? C : B) + size_t(bn) * c * ds;
  // the depth: dC's keys [0, min(r0 + T, c)), dB's rows [r0, c)
  const int k_lo = is_db ? r0 : 0, k_hi = is_db ? c : min(r0 + T, c);
  float acc[T / 2];
  zero(acc);
  FragA fa[KW / 8];
  pipeline<NSB>(
      (k_hi - k_lo + KW - 1) / KW,
      [&](int st, int ks) {
        float* s = ring + st * DBC_STAGE;
        const int k0 = k_lo + ks * KW;
        if (is_db)  // dG rows k0 .., keys of this tile
          stage_rows<KW, T>(s, LDT, dg_c, c, c, k0, r0, vec_cb);
        else        // dG rows of this tile, keys k0 ..
          stage_rows<T, KW>(s, LDK, dg_c, c, c, r0, k0, vec_cb);
        stage_rows<KW, T>(s + T * LDK, LDT, V, ds, c, k0, s0, vec_bc);
      },
      [&](int st, int) {
        const float* s = ring + st * DBC_STAGE;
        split_cols<T>(s + T * LDK, LDT, parts, parts + PW);  // B^T or C^T
        fence_proxy_async();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KW / 8; ++kk) {
          if (is_db) {  // A = dG^T, read across the staged rows
            const float* p = s + (8 * kk + t) * LDT + wr + g;
            fa[kk] = split_a(p[0], p[8], p[4 * LDT], p[4 * LDT + 8]);
          } else {      // A = dG
            const float* p = s + (wr + g) * LDK + 8 * kk + t;
            fa[kk] = split_a(p[0], p[8 * LDK], p[4], p[8 * LDK + 4]);
          }
        }
        product<T>(acc, fa, parts, parts + PW);
      });
  if (is_db) {  // + the head term's parts, in part order
    const float* hp = hparts + size_t(bn) * n_parts * c * ds;
    for (int p = 0; p < n_parts; ++p)
#pragma unroll
      for (int nb = 0; nb < T / 8; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = r0 + wr + g + 8 * half, sc = s0 + 8 * nb + 2 * t + e;
            if (j < c && sc < ds)
              acc[4 * nb + 2 * half + e] +=
                  hp[(size_t(p) * c + j) * ds + sc];
          }
  }
  float* out = (is_db ? dB : dC) + size_t(bn) * c * ds;
#pragma unroll
  for (int nb = 0; nb < T / 8; ++nb)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = r0 + wr + g + 8 * half, sc = s0 + 8 * nb + 2 * t + e;
        if (i < c && sc < ds)
          out[size_t(i) * ds + sc] = acc[4 * nb + 2 * half + e];
      }
}

// raises a kernel's dynamic shared memory to smem the first time a call
// needs more than `done`
template <class Kernel>
cudaError_t fit_smem(Kernel kernel, size_t smem, size_t& done) {
  if (smem <= done) return cudaSuccess;
  const cudaError_t e = set_smem(kernel, smem);
  if (e == cudaSuccess) done = smem;
  return e;
}

template <int HD>
cudaError_t launch_bwd(const float* a, const float* xdt, const float* B,
                       const float* C, const float* dy, const float* dS,
                       float* da, float* dxdt, float* dB, float* dC, float* cb,
                       float* dg, float* acs, float* sums, float* hparts,
                       int b, int nh, int nc, int c, int ds, int n_parts,
                       cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(xdt) || !aligned(dxdt)) return cudaErrorMisalignedAddress;
  const int vec_bc = ds % 4 == 0 && aligned(B) && aligned(C);
  const int vec = aligned(dy) && aligned(dS);
  const int vec_cb = c % 4 == 0 && aligned(cb) && aligned(dg);
  static size_t prep_set = 0, dg_set = 0, head_set = 0, dbc_set = 0;
  cudaError_t e;
  if ((e = fit_smem(bwd_prep_kernel, prep_smem(), prep_set)) != cudaSuccess ||
      (e = fit_smem(bwd_dg_kernel<HD>, dg_smem(), dg_set)) != cudaSuccess ||
      (e = fit_smem(bwd_head_kernel<HD>, head_smem<HD>(c), head_set)) !=
          cudaSuccess ||
      (e = fit_smem(bwd_dbc_kernel, dbc_smem(), dbc_set)) != cudaSuccess)
    return e;
  const int n_bc = b * nc, n_cb = n_bc * tile_pairs(c);
  bwd_prep_kernel<<<n_cb + b * nh * nc, NT, prep_smem(), stream>>>(
      a, B, C, cb, acs, n_cb, c, ds, vec_bc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n_ht = n_bc * tiles(c) * tiles(ds) * n_parts;
  bwd_dg_kernel<HD><<<n_cb + n_ht, NT, dg_smem(), stream>>>(
      xdt, dy, dS, cb, acs, dg, sums, hparts, nh, nc, c, ds, n_parts, n_cb,
      vec, vec_cb);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_head_kernel<HD><<<dim3(nh, n_bc), NT, head_smem<HD>(c), stream>>>(
      xdt, B, dy, dS, cb, acs, sums, da, dxdt, nh, nc, c, ds, vec_bc, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dbc_kernel<<<dim3(2 * tiles(ds), tiles(c), n_bc), NT, dbc_smem(),
                   stream>>>(B, C, dg, hparts, dB, dC, c, ds, n_parts, vec_bc,
                             vec_cb);
  return cudaGetLastError();
}

}  // namespace bwd

}  // namespace

// a: (b, nh, nc, c); xdt: (b, nh, nc, c, hd); B, C: (b, nc, c, ds);
// y: (b, nh, nc, c, hd), 16-byte aligned; S: (b, nh, nc, ds, hd); workspace
// CB: (b, nc, c, c) and acs: (b, nh, nc, c). All float32, contiguous.
// Launches the two kernels on the stream and returns the cudaError_t of the
// launches.
extern "C" int ssd_intra_chunk_fwd(const void* a, const void* xdt,
                                   const void* B, const void* C, void* y,
                                   void* S, void* CB, void* acs, int b, int nh,
                                   int nc, int c, int hd, int ds,
                                   void* stream) {
  if (b <= 0 || nh <= 0 || nc <= 0 || c <= 0 || ds <= 0 || b * nc > 65535 ||
      nh > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fx = static_cast<const float*>(xdt);
  const float* fB = static_cast<const float*>(B);
  const float* fC = static_cast<const float*>(C);
  float* fy = static_cast<float*>(y);
  float* fS = static_cast<float*>(S);
  float* fCB = static_cast<float*>(CB);
  float* facs = static_cast<float*>(acs);
  switch (hd) {
    case 16: return int(launch<16>(fa, fx, fB, fC, fy, fS, fCB, facs, b, nh, nc, c, ds, st));
    case 32: return int(launch<32>(fa, fx, fB, fC, fy, fS, fCB, facs, b, nh, nc, c, ds, st));
    case 64: return int(launch<64>(fa, fx, fB, fC, fy, fS, fCB, facs, b, nh, nc, c, ds, st));
    case 128: return int(launch<128>(fa, fx, fB, fC, fy, fS, fCB, facs, b, nh, nc, c, ds, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// The backward. a, xdt, B, C as the forward's; dy: (b, nh, nc, c, hd), dS:
// (b, nh, nc, ds, hd). Writes da (b, nh, nc, c), dxdt (b, nh, nc, c, hd),
// dB and dC (b, nc, c, ds); workspace: cb and dg (b, nc, c, c), acs (b, nh,
// nc, c), sums (b, nc, nh, causal 64 x 64 tile pairs, 2, 64) and hparts (b,
// nc, n_parts, c, ds). All float32, contiguous; c at most 1024, n_parts
// from 1 to nh. The caller allocates hparts and so chooses its part count
// (the wrapper's HEADS_PER_PART heads a part); taking it here keeps the
// workspace's shape and the grid that fills it from disagreeing. Launches
// the four kernels on the stream and returns the cudaError_t of the
// launches.
extern "C" int ssd_intra_chunk_bwd(const void* a, const void* xdt,
                                   const void* B, const void* C,
                                   const void* dy, const void* dS, void* da,
                                   void* dxdt, void* dB, void* dC, void* cb,
                                   void* dg, void* acs, void* sums,
                                   void* hparts, int b, int nh, int nc, int c,
                                   int hd, int ds, int n_parts,
                                   void* stream) {
  if (b <= 0 || nh <= 0 || nc <= 0 || c <= 0 || ds <= 0 ||
      c > bwd::MAX_C || b * nc > 65535 || nh > 65535 || n_parts < 1 ||
      n_parts > nh)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(a),
                       static_cast<const float*>(xdt),
                       static_cast<const float*>(B),
                       static_cast<const float*>(C),
                       static_cast<const float*>(dy),
                       static_cast<const float*>(dS)};
  float* o[9] = {static_cast<float*>(da),   static_cast<float*>(dxdt),
                 static_cast<float*>(dB),   static_cast<float*>(dC),
                 static_cast<float*>(cb),   static_cast<float*>(dg),
                 static_cast<float*>(acs),  static_cast<float*>(sums),
                 static_cast<float*>(hparts)};
#define SSD_BWD(HD)                                                          \
  case HD:                                                                   \
    return int(bwd::launch_bwd<HD>(f[0], f[1], f[2], f[3], f[4], f[5], o[0], \
                                   o[1], o[2], o[3], o[4], o[5], o[6], o[7], \
                                   o[8], b, nh, nc, c, ds, n_parts, st));
  switch (hd) {
    SSD_BWD(16)
    SSD_BWD(32)
    SSD_BWD(64)
    SSD_BWD(128)
    default: return int(cudaErrorInvalidValue);
  }
#undef SSD_BWD
}
