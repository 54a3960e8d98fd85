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

  // ---- one tile of C.B^T ----
  const int pairs = tile_pairs(c);
  const int bn = (blockIdx.x - n_s) / pairs;
  int jt = (blockIdx.x - n_s) % pairs, r = 0;
  while (jt > r) jt -= ++r;  // pairs (r, jt <= r), row by row
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
