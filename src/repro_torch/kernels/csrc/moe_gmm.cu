// MoE grouped matmul for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py:42
// (moe_gmm_ecf, wrapper repro.kernels.ops.moe_gmm): y[e] = x[e] @ w[e] for
// every expert e, with x (E, C, D), w (E, D, F) and y (E, C, F); the products
// are summed in fp32 and y is written in x's type.
//
// Translation.  The Pallas grid (E, C/bc, F/bf, D/bd) carried an fp32 VMEM
// accumulator across the sequential D axis and padded C, D and F to its
// 128/512 MXU blocks.  Here a block loops over D itself (or, at C <= 8, a
// run of D that is merged in a fixed order), and ragged C, D and F edges
// are masked in the kernel: nothing is padded or copied.
//
// Which rows hold tokens.  The wrapper may pass rows (E,) int32 on the
// device: rows[e] leading rows of x[e] hold tokens, the rest are written as
// zeros.  The MoE layer knows it from its capacity count (the dispatch
// buffer's rows past it are zeros), so an expert that holds no token has no
// weight to read.  Without rows every row counts.
//
// What bounds it.  In the MoE layer C is the expert capacity, which is small:
// qwen3-moe-30b (E = 128, D = 2048, F = 768) has C = 1 in decode and C = 77
// for a 975-token prefill.  The bytes that can change the result are the
// weights of the experts that hold a token: at decode 8 of 128 experts (25.2
// MB in bf16, 0.0075 ms at 3.35 TB/s), at prefill most of them (403 MB for
// all 128, 0.120 ms).  On tensor cores the prefill products take 0.031 ms,
// so both phases are bound by bytes.  The design goal is therefore that each
// occupied expert's weights are read from HBM once per launch, with enough
// loads in flight to stream at the HBM rate, and nothing else.  Three
// kernels:
//
// * gmm_stream (bf16, C <= 8: decode): a persistent grid of one block per
//   SM, in groups of one block per 256-column F tile.  Each block reads rows
//   (E ints) and lists the occupied experts; each group takes an equal run
//   of the sequence of the occupied experts' row-slices (64 rows of D), and
//   its blocks stream their F tile's w slice (64 x 256, 32 KB) of each, so
//   at 8 occupied experts the 256 row-slices still spread over all 44
//   groups of 3 blocks (stream-K; with fewer row-slices than groups, one
//   per group).  Slices go through a 3-stage cp.async ring of 16-byte
//   copies (x's few rows with them), 64 KB in flight per block.  The blocks
//   of a group read the same rows at once, each 512 contiguous bytes of
//   them: with each block on its own run of 128-byte row pieces the kernel
//   streamed every expert at only 2.15 TB/s, and 16-row slices with six
//   stages and two blocks per SM (more barriers per byte) were 3-4 %
//   slower than this shape on an H100.  The C rows' outputs live in
//   registers; the 256 threads of a block take 4 columns each and split
//   the slice's 64 rows 4 ways, summed at the end of an item through
//   shared memory.  An item split between runs is summed in a fixed order,
//   not by atomics: each block writes its part to scratch and takes a
//   ticket, and the last one adds the parts in D order and resets the
//   ticket.  The same launch writes the zero rows (every row of an empty
//   expert); no separate memset.
// * gmm_mma (C > 8, bf16: the prefill path): tensor cores, mma.sync.m16n8k16
//   with fp32 sums (helpers in mma_sm90.cuh).  A block of 8 warps owns one
//   (expert, C tile of 16 MT <= 128 rows, 128-column F tile); each warp owns
//   16 columns and all MT 16-row fragments, so C = 77 runs as one 80-row
//   tile and w streams from HBM once.  64-deep slices of x and w go through
//   a 3-stage cp.async ring of 16-byte copies (32 KB of w in flight per
//   block, two blocks per SM; 4 and 6 stages, which leave room for fewer
//   blocks, measured slower), swizzled for conflict-free ldmatrix: x through
//   ldmatrix, w ((D, F) row-major) through ldmatrix.trans.  Ragged D and F
//   are zero-filled by the copies' src-size; rows past C or rows[e] are
//   zero-filled, and a C tile wholly past rows[e] writes zeros and reads no
//   w (gmm_tiled does the same).
//   For C > 128 the balanced C tiles of one (expert, F tile) are
//   neighbouring blocks and share w through L2.  Where a base pointer or a
//   row stride is not 16-byte aligned, the same kernel (VEC = false) fills
//   the slices element by element.  At qwen3's shape the grid is 6 F tiles x
//   128 experts = 768 blocks.
// * gmm_tiled (fp32, every C): a block of 128 threads computes a (16*RM) x
//   64 output tile, RM <= 8 chosen from C, each thread RM rows x 8 columns
//   in fp32 registers, staging 32-deep slices of x and w in shared memory:
//   bound by its scalar FMAs.  Each output is one sequential fp32 sum over
//   D, as cuBLAS takes it (the plain version agrees to the bit); a D split
//   across blocks, as gmm_stream makes, came 1.8e-4 from cuBLAS's sum at
//   D = 2048, beyond the reference's 1e-4 fp32 tolerance.  fp32 stays off
//   the tensor cores because TF32 keeps about three decimal digits.
//
// Layout: x (E, C, D) with arbitrary E and C strides and unit D stride; w
// (E, D, F) with arbitrary E and D strides and unit F stride; y (E, C, F)
// contiguous.  Element types: float or bfloat16 for both x and w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BF = 64;  // output columns per tile (gmm_tiled)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four consecutive elements row[col .. col+3] as floats, zeros past F.  VEC:
// the caller checked that they are aligned for one vector load.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* row, int col, int F,
                                      float out[4]) {
  if (VEC && col + 4 <= F) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + col));
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + col));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.y));
      out[0] = a.x;
      out[1] = a.y;
      out[2] = b.x;
      out[3] = b.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = col + j < F ? to_f(row[col + j]) : 0.f;
  }
}

// The rows of expert e that hold tokens: occ[e] clamped to [0, C], or C.
__device__ __forceinline__ int live_rows(const int* occ, int e, int C) {
  return occ ? min(max(__ldg(occ + e), 0), C) : C;
}

// ---------------------------------------------------------------------------
// C > 8, bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int M_THREADS = 256;  // 8 warps x 16 columns
constexpr int M_BN = 128;       // output columns per block
constexpr int M_BK = 64;        // D depth of a slice
constexpr int M_STAGES = 3;     // cp.async ring depth
constexpr int M_MAX_MT = 8;     // 16-row fragments per C tile: <= 128 rows

template <int MT>
constexpr int mma_smem_bytes() {
  return static_cast<int>(sizeof(bf16)) * M_STAGES *
         (MT * 16 * M_BK + M_BK * M_BN);
}

// dst[0..8) = src[0..n), zeros after; 16-byte aligned cp.async when VEC,
// else element by element (ordinary stores, ordered by the ring's barrier).
template <bool VEC>
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int n) {
  if constexpr (VEC) {
    mma_sm90::cp_async16(dst, src, 2 * n);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < n ? src[i] : __float2bfloat16(0.f);
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(M_THREADS)
gmm_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
        bf16* __restrict__ y, const int* __restrict__ occ, int C, int D,
        int F, int tile_rows,
        long long x_se, long long x_sc, long long w_se, long long w_sd) {
  using namespace mma_sm90;
  constexpr int XR = MT * 16;                 // x rows in shared memory
  constexpr int X_ELEMS = XR * M_BK, W_ELEMS = M_BK * M_BN;
  extern __shared__ __align__(16) unsigned char gmm_mma_smem[];
  bf16* xs = reinterpret_cast<bf16*>(gmm_mma_smem);   // [STAGES][XR][64]
  bf16* ws = xs + M_STAGES * X_ELEMS;                 // [STAGES][64][128]

  const int n_ct = (C + tile_rows - 1) / tile_rows;
  const int ct = blockIdx.x % n_ct, ft = blockIdx.x / n_ct;
  const int e = blockIdx.y;
  const int r0 = ct * tile_rows;
  const int rows = min(tile_rows, C - r0);
  const int f0 = ft * M_BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* xe = x + e * x_se + r0 * x_sc;
  const bf16* we = w + e * w_se;
  // rows of the tile that hold tokens; a tile with none is zeros, and w is
  // not read for it
  const int live = live_rows(occ, e, C) - r0;
  if (live <= 0) {
    for (int i = tid; i < rows * M_BN; i += M_THREADS) {
      const int f = f0 + i % M_BN;
      if (f < F) y[((long long)e * C + r0 + i / M_BN) * F + f] = __float2bfloat16(0.f);
    }
    return;
  }

  // slice [d0, d0 + 64) of the tile's x rows and w columns into stage st
  auto load_slice = [&](int st, int d0) {
    bf16* xd = xs + st * X_ELEMS;
    bf16* wd = ws + st * W_ELEMS;
    for (int i = tid; i < XR * (M_BK / 8); i += M_THREADS) {
      const int r = i / (M_BK / 8), c = i % (M_BK / 8);
      const int d = d0 + c * 8;
      const int n = r < min(rows, live) ? max(0, min(8, D - d)) : 0;
      copy8<VEC>(xd + swizzle<M_BK / 8>(r, c), xe + (n ? r * x_sc + d : 0), n);
    }
    for (int i = tid; i < M_BK * (M_BN / 8); i += M_THREADS) {
      const int r = i / (M_BN / 8), c = i % (M_BN / 8);
      const int d = d0 + r, f = f0 + c * 8;
      const int n = d < D ? max(0, min(8, F - f)) : 0;
      copy8<VEC>(wd + swizzle<M_BN / 8>(r, c),
                 we + (n ? (long long)d * w_sd + f : 0), n);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int n_k = (D + M_BK - 1) / M_BK;
#pragma unroll
  for (int st = 0; st < M_STAGES - 1; ++st) {
    if (st < n_k) load_slice(st, st * M_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<M_STAGES - 2>();
    __syncthreads();    // slice kt landed; slice kt-1's stage is free
    const int next = kt + M_STAGES - 1;
    if (next < n_k) load_slice(next % M_STAGES, next * M_BK);
    cp_async_commit();

    const bf16* xt = xs + (kt % M_STAGES) * X_ELEMS;
    const bf16* wt = ws + (kt % M_STAGES) * W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < M_BK / 16; ++kk) {
      uint32_t bw[4];   // columns [16 warp, 16 warp + 16) of rows 16 kk..
      ldmatrix_x4_trans(bw, wt + swizzle<M_BN / 8>(
                                kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                warp * 2 + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t ax[4];
        ldmatrix_x4(ax, xt + swizzle<M_BK / 8>(i * 16 + (lane & 15),
                                               kk * 2 + (lane >> 4)));
        mma_bf16(acc[i][0], ax, bw[0], bw[1]);
        mma_bf16(acc[i][1], ax, bw[2], bw[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + h * 8;
      if (r >= rows) continue;
      bf16* yr = y + ((long long)e * C + r0 + r) * F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = f0 + warp * 16 + j * 8 + t4 * 2;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (f + 1 < F && F % 2 == 0) {
          *reinterpret_cast<uint32_t*>(yr + f) = pack_bf16x2(v0, v1);
        } else {
          if (f < F) yr[f] = __float2bfloat16(v0);
          if (f + 1 < F) yr[f + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// C <= 8, bf16: a persistent grid streaming the occupied experts' w slices
// ---------------------------------------------------------------------------

constexpr int P_THREADS = 256;
constexpr int P_STAGES = 3;               // cp.async ring depth, in slices
constexpr int P_R = 64;                   // D rows of a slice
constexpr int P_BN = 256;                 // columns of a slice: 512-byte rows
constexpr int P_TX = P_BN / 4;            // 64 threads along F, 4 columns each
constexpr int P_TY = P_THREADS / P_TX;    // 4 threads along D
constexpr int P_CMAX = 8;

// one ring stage: the w slice (P_R x P_BN), then the x slice (CMAX x P_R)
template <int CMAX>
__host__ __device__ constexpr int stage_elems() {
  return P_R * (P_BN + CMAX);
}

// dynamic shared memory: the ring, an item's per-thread-row sums
// ([P_TY][CMAX][P_BN] fp32), the list of occupied experts (16-bit) and the
// occupancy bitmap
template <int CMAX>
inline size_t stream_smem_bytes(int E) {
  return sizeof(bf16) * static_cast<size_t>(P_STAGES * stage_elems<CMAX>()) +
         4 * static_cast<size_t>(P_TY * CMAX * P_BN) +
         4 * static_cast<size_t>((E + 1) / 2) + 4 * static_cast<size_t>((E + 31) / 32);
}

// Work: the grid is n_ft = ceil(F / 256) blocks per group, one per F tile.
// The occupied experts' row-slices (P_R rows of D each, SL per expert), in
// order, are one sequence of T cut into min(groups, T) equal runs, one per
// group (stream-K), and the blocks of a group walk their run in step, each
// reading its F tile's 512 bytes of every row: together the whole row, as
// neighbouring blocks of a grid over (F tile, expert) would.  An item is an
// (occupied expert, F tile): a block sums each item it touches over its
// run; an item inside one run is written straight to y, an item shared by
// several runs as partials (at most two per block: its first and its last
// item), and the block that draws the item's last ticket adds them in run
// order, i.e. in D order.
template <int CMAX, bool VEC>
__global__ void __launch_bounds__(P_THREADS)
gmm_stream(const bf16* __restrict__ x, const bf16* __restrict__ w,
           bf16* __restrict__ y, const int* __restrict__ occ,
           float* __restrict__ part, int* __restrict__ tickets, int E, int C,
           int D, int F, long long x_se, long long x_sc, long long w_se,
           long long w_sd) {
  constexpr int W_CH = P_R * P_BN / 8;          // 16-byte w chunks per slice
  constexpr int X_CH = P_R / 8;                 // chunks per x row of a slice
  constexpr int STAGE = stage_elems<CMAX>();
  constexpr int WARPS = P_THREADS / 32;
  static_assert(W_CH % P_THREADS == 0, "whole w chunks per thread");
  static_assert(P_R % P_TY == 0, "whole slice rows per thread");
  extern __shared__ __align__(16) unsigned char gs_smem[];
  bf16* ring = reinterpret_cast<bf16*>(gs_smem);
  float* red = reinterpret_cast<float*>(ring + P_STAGES * STAGE);
  uint16_t* list = reinterpret_cast<uint16_t*>(red + P_TY * CMAX * P_BN);
  uint32_t* words = reinterpret_cast<uint32_t*>(list + 2 * ((E + 1) / 2));
  __shared__ int s_n, s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % P_TX, ty = tid / P_TX;
  const int G = gridDim.x, bid = blockIdx.x;
  const int n_ft = (F + P_BN - 1) / P_BN;      // the grid is a multiple of it
  const int groups = G / n_ft, grp = bid / n_ft, ft = bid % n_ft;
  const int f0 = ft * P_BN;

  // 1. The occupied experts, in expert order: a ballot per 32 experts, then
  //    one warp compacts.
  const int n_words = (E + 31) / 32;
  for (int e0 = 0; e0 < n_words * 32; e0 += P_THREADS) {
    const int e = e0 + tid;
    const bool live = e < E && live_rows(occ, e, C) > 0;
    const uint32_t bits = __ballot_sync(0xffffffffu, live);
    const int wi = e0 / 32 + warp;
    if (lane == 0 && wi < n_words) words[wi] = bits;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int wi = 0; wi < n_words; ++wi) {
      const uint32_t bits = words[wi];
      if ((bits >> lane) & 1u)
        list[n + __popc(bits & ((1u << lane) - 1u))] = static_cast<uint16_t>(wi * 32 + lane);
      n += __popc(bits);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();

  // 2. This group's run of row-slices: the first min(groups, total) groups
  //    take a run each, none of them empty, so every group between an
  //    expert's first and last row-slice holds a part of it.
  const int SL = max(1, (D + P_R - 1) / P_R);  // row-slices per expert
  const long long total = (long long)s_n * SL;
  const long long runs = min((long long)groups, total);
  auto run_start = [&](long long g) { return g * total / runs; };
  auto group_of = [&](long long sl) {
    return static_cast<int>(((sl + 1) * runs - 1) / total);
  };
  const long long s_begin = grp < runs ? run_start(grp) : 0;
  const int n_mine = grp < runs ? static_cast<int>(run_start(grp + 1) - s_begin) : 0;
  const int first_o = static_cast<int>(s_begin / SL);

  // row-slice k of occupied expert o into stage st
  auto load = [&](int st, int o, int k) {
    const int d0 = k * P_R;
    const int e = list[o];
    bf16* ws = ring + st * STAGE;
    bf16* xs = ws + P_R * P_BN;
    const bf16* we = w + e * w_se;
#pragma unroll
    for (int k = 0; k < W_CH / P_THREADS; ++k) {
      const int i = tid + k * P_THREADS;
      const int r = i / (P_BN / 8), c = i % (P_BN / 8);
      const int d = d0 + r, f = f0 + c * 8;
      const int n = d < D ? max(0, min(8, F - f)) : 0;
      copy8<VEC>(ws + r * P_BN + c * 8, we + (n ? (long long)d * w_sd + f : 0), n);
    }
    if (tid < CMAX * X_CH) {
      const int c = tid / X_CH, q = tid % X_CH;
      const int d = d0 + q * 8;
      const int n = c < live_rows(occ, e, C) ? max(0, min(8, D - d)) : 0;
      copy8<VEC>(xs + c * P_R + q * 8, x + e * x_se + (n ? c * x_sc + d : 0), n);
    }
  };

  float acc[CMAX][4];
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;

  // the (expert, row-slice) positions of the next slice to load and of the
  // slice to sum, advanced by one each step (no division in the loop)
  int lo = first_o, lk = static_cast<int>(s_begin % SL);
  int co = lo, ck = lk;
  auto advance = [&](int& o, int& k) {
    if (++k == SL) {
      k = 0;
      ++o;
    }
  };
#pragma unroll
  for (int st = 0; st < P_STAGES - 1; ++st) {
    if (st < n_mine) {
      load(st, lo, lk);
      advance(lo, lk);
    }
    mma_sm90::cp_async_commit();
  }

  // 3. Rows at or past occ[e] are zeros (every row of an empty expert),
  //    written while the first slices are in flight: a warp per row.
  if (occ) {
    for (long long row = (long long)bid * WARPS + warp; row < (long long)E * C;
         row += (long long)G * WARPS) {
      if (static_cast<int>(row % C) < live_rows(occ, static_cast<int>(row / C), C)) continue;
      bf16* yr = y + row * F;
      for (int f = lane; f < F; f += 32) yr[f] = __float2bfloat16(0.f);
    }
  }

  // 4. Stream the run.
  for (int i = 0; i < n_mine; ++i) {
    mma_sm90::cp_async_wait<P_STAGES - 2>();
    __syncthreads();      // slice i landed; slice i - 1's stage is free
    const int nx = i + P_STAGES - 1;
    if (nx < n_mine) {
      load(nx % P_STAGES, lo, lk);
      advance(lo, lk);
    }
    mma_sm90::cp_async_commit();

    const bf16* ws = ring + (i % P_STAGES) * STAGE;
    const bf16* xs = ws + P_R * P_BN;
#pragma unroll
    for (int u = 0; u < P_R / P_TY; ++u) {
      const int r = ty + P_TY * u;
      const uint2 v2 = *reinterpret_cast<const uint2*>(ws + r * P_BN + tx * 4);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v2.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v2.y));
      const float wv[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) {
          const float xv = to_f(xs[c * P_R + r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][j] = fmaf(xv, wv[j], acc[c][j]);
        }
    }
    const int o = co;
    const bool item_ends = i == n_mine - 1 || ck == SL - 1;
    advance(co, ck);
    if (!item_ends) continue;

    // The item (expert o, this F tile) ends here: sum the block's P_TY
    // D-rows of it and write it, or its partial.
    const int item = o * n_ft + ft;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      *reinterpret_cast<float4*>(red + (ty * CMAX + c) * P_BN + tx * 4) =
          make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
    }
    __syncthreads();
    const int e = list[o];
    const int live = live_rows(occ, e, C);
    const int g_first = group_of((long long)o * SL);
    const int g_last = group_of((long long)o * SL + SL - 1);
    bf16* ye = y + (long long)e * C * F + f0;
    if (g_first == g_last) {
      for (int n = tid; n < live * P_BN; n += P_THREADS) {
        const int c = n / P_BN, f = n % P_BN;
        if (f0 + f >= F) continue;
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < P_TY; ++k) v += red[(k * CMAX + c) * P_BN + f];
        ye[(long long)c * F + f] = __float2bfloat16(v);
      }
    } else {
      constexpr int PART = P_CMAX * P_BN;
      float* mine = part + ((long long)bid * 2 + (o == first_o ? 0 : 1)) * PART;
      for (int n = tid; n < live * P_BN; n += P_THREADS) {
        const int c = n / P_BN, f = n % P_BN;
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < P_TY; ++k) v += red[(k * CMAX + c) * P_BN + f];
        mine[n] = v;
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(tickets + item, 1) == g_last - g_first;
      __syncthreads();
      if (s_last) {
        __threadfence();
        for (int n = tid; n < live * P_BN; n += P_THREADS) {
          const int c = n / P_BN, f = n % P_BN;
          if (f0 + f >= F) continue;
          float v = 0.f;
          for (int gg = g_first; gg <= g_last; ++gg) {
            const int slot = o == run_start(gg) / SL ? 0 : 1;
            v += __ldcg(part + ((long long)(gg * n_ft + ft) * 2 + slot) * PART + n);
          }
          ye[(long long)c * F + f] = __float2bfloat16(v);
        }
        if (tid == 0) tickets[item] = 0;
      }
    }
    __syncthreads();    // red and s_last are free again
  }
  mma_sm90::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// C > 8, fp32: (16*RM) x 64 output tiles, 32-deep slices of x and w staged in
// shared memory
// ---------------------------------------------------------------------------

constexpr int T_THREADS = 128;
constexpr int T_TX = BF / 8;            // 8 threads along F, 8 columns each
constexpr int T_TY = T_THREADS / T_TX;  // 16 threads along C
constexpr int BD = 32;                  // D depth of a shared-memory slice
constexpr int MAX_RM = 8;               // at most 128 rows per tile

template <int RM, bool VEC>
__global__ void __launch_bounds__(T_THREADS)
gmm_tiled(const float* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ y, const int* __restrict__ occ, int C, int D,
          int F, int tile_rows,
          long long x_se, long long x_sc, long long w_se, long long w_sd) {
  constexpr int BC = RM * T_TY;
  __shared__ float xs[BD][BC + 1];          // x slice, transposed: [d][row]
  __shared__ __align__(16) float ws[BD][BF];

  const int n_ct = (C + tile_rows - 1) / tile_rows;
  const int ct = blockIdx.x % n_ct, ft = blockIdx.x / n_ct;
  const int e = blockIdx.y;
  const int r0 = ct * tile_rows;
  const int rows = min(tile_rows, C - r0);
  const int f0 = ft * BF;
  const int tx = threadIdx.x % T_TX, ty = threadIdx.x / T_TX;
  const float* xe = x + e * x_se + r0 * x_sc;
  const float* we = w + e * w_se;
  // rows of the tile that hold tokens; a tile with none is zeros, and w is
  // not read for it
  const int live = live_rows(occ, e, C) - r0;
  if (live <= 0) {
    for (int i = threadIdx.x; i < rows * BF; i += T_THREADS) {
      const int f = f0 + i % BF;
      if (f < F) y[((long long)e * C + r0 + i / BF) * F + f] = 0.f;
    }
    return;
  }

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += BD) {
    // x slice: consecutive threads read consecutive d of a row
    for (int i = threadIdx.x; i < BC * BD; i += T_THREADS) {
      const int r = i / BD, k = i % BD;
      xs[k][r] = (r < min(rows, live) && d0 + k < D) ? xe[r * x_sc + d0 + k] : 0.f;
    }
    // w slice: 16 threads cover one 64-column row, four columns each
    for (int i = threadIdx.x; i < BD * (BF / 4); i += T_THREADS) {
      const int k = i / (BF / 4), c4 = (i % (BF / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (d0 + k < D && f0 + c4 < F)
        load4<float, VEC>(we + (long long)(d0 + k) * w_sd, f0 + c4, F, v);
      *reinterpret_cast<float4*>(&ws[k][c4]) = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BD; ++k) {
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[k][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[k][tx * 8 + 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = xs[k][ty + T_TY * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + T_TY * i;
    if (r >= rows) continue;
    float* yr = y + ((long long)e * C + r0 + r) * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = f0 + tx * 8 + j;
      if (f < F) yr[f] = acc[i][j];
    }
  }
}

template <int CMAX, bool VEC>
cudaError_t launch_stream_cm(const bf16* x, const bf16* w, bf16* y,
                             const int* occ, float* part, int* tickets,
                             int blocks, int E, int C, int D, int F,
                             long long x_se, long long x_sc, long long w_se,
                             long long w_sd, cudaStream_t s) {
  static size_t attr_bytes = 0;   // the dynamic shared memory allowed so far
  const size_t smem = stream_smem_bytes<CMAX>(E);
  if (smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_stream<CMAX, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_bytes = smem;
  }
  gmm_stream<CMAX, VEC><<<blocks, P_THREADS, smem, s>>>(
      x, w, y, occ, part, tickets, E, C, D, F, x_se, x_sc, w_se, w_sd);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_stream(const bf16* x, const bf16* w, bf16* y, const int* occ,
                          float* part, int* tickets, int blocks, int E, int C,
                          int D, int F, long long x_se, long long x_sc,
                          long long w_se, long long w_sd, cudaStream_t s) {
#define STREAM(CM)                                                          \
  return launch_stream_cm<CM, VEC>(x, w, y, occ, part, tickets, blocks, E, \
                                   C, D, F, x_se, x_sc, w_se, w_sd, s)
  if (C <= 1) STREAM(1);
  if (C <= 2) STREAM(2);
  if (C <= 4) STREAM(4);
  STREAM(8);
#undef STREAM
}

// balanced C tiles of at most `max_rows` rows: (number of tiles, rows each)
inline void c_tiles(int C, int max_rows, int* n_ct, int* tile_rows) {
  *n_ct = (C + max_rows - 1) / max_rows;
  *tile_rows = (C + *n_ct - 1) / *n_ct;
}

template <bool VEC>
cudaError_t launch_tiled(const float* x, const float* w, float* y,
                         const int* occ, int E, int C, int D, int F,
                         long long x_se, long long x_sc, long long w_se,
                         long long w_sd, cudaStream_t s) {
  int n_ct, tile_rows;
  c_tiles(C, MAX_RM * T_TY, &n_ct, &tile_rows);
  const int rm = (tile_rows + T_TY - 1) / T_TY;    // rows per thread
  const long long n_blocks = (long long)n_ct * ((F + BF - 1) / BF);
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_blocks, (unsigned)E);
#define TILED(R)                                                          \
  gmm_tiled<R, VEC><<<grid, T_THREADS, 0, s>>>(x, w, y, occ, C, D, F,     \
                                                tile_rows, x_se, x_sc,    \
                                                w_se, w_sd)
  switch (rm) {
    case 1: TILED(1); break;
    case 2: TILED(2); break;
    case 3: TILED(3); break;
    case 4: TILED(4); break;
    case 5: TILED(5); break;
    case 6: TILED(6); break;
    case 7: TILED(7); break;
    default: TILED(8); break;
  }
#undef TILED
  return cudaGetLastError();
}

template <int MT, bool VEC>
cudaError_t launch_mma_mt(const bf16* x, const bf16* w, bf16* y,
                          const int* occ, dim3 grid, int C, int D, int F,
                          int tile_rows, long long x_se, long long x_sc,
                          long long w_se, long long w_sd, cudaStream_t s) {
  const int smem = mma_smem_bytes<MT>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_mma<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gmm_mma<MT, VEC><<<grid, M_THREADS, smem, s>>>(x, w, y, occ, C, D, F, tile_rows,
                                                 x_se, x_sc, w_se, w_sd);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_mma(const bf16* x, const bf16* w, bf16* y, const int* occ,
                       int E, int C, int D, int F, long long x_se, long long x_sc,
                       long long w_se, long long w_sd, cudaStream_t s) {
  int n_ct, tile_rows;
  c_tiles(C, M_MAX_MT * 16, &n_ct, &tile_rows);
  const int mt = (tile_rows + 15) / 16;   // pad rows to 16, not to 128
  const long long n_blocks = (long long)n_ct * ((F + M_BN - 1) / M_BN);
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_blocks, (unsigned)E);
#define MMA(M)                                                           \
  return launch_mma_mt<M, VEC>(x, w, y, occ, grid, C, D, F, tile_rows, x_se, \
                               x_sc, w_se, w_sd, s)
  switch (mt) {
    case 1: MMA(1);
    case 2: MMA(2);
    case 3: MMA(3);
    case 4: MMA(4);
    case 5: MMA(5);
    case 6: MMA(6);
    case 7: MMA(7);
    default: MMA(8);
  }
#undef MMA
}

template <typename T>
cudaError_t launch(const void* xv, const void* wv, void* yv, const int* occ,
                   float* part, int* tickets, int blocks, int E, int C, int D,
                   int F, long long x_se, long long x_sc, long long w_se,
                   long long w_sd, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  if constexpr (std::is_same<T, bf16>::value) {
    // 16-byte copies of 8 elements need 16-byte-aligned bases and rows
    const bool vec = x_se % 8 == 0 && x_sc % 8 == 0 && w_se % 8 == 0 &&
                     w_sd % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (C <= P_CMAX) {
      if (blocks <= 0 || blocks % ((F + P_BN - 1) / P_BN) || !part || !tickets)
        return cudaErrorInvalidValue;
      return vec ? launch_stream<true>(x, w, y, occ, part, tickets, blocks, E, C, D,
                                       F, x_se, x_sc, w_se, w_sd, s)
                 : launch_stream<false>(x, w, y, occ, part, tickets, blocks, E, C, D,
                                        F, x_se, x_sc, w_se, w_sd, s);
    }
    return vec ? launch_mma<true>(x, w, y, occ, E, C, D, F, x_se, x_sc, w_se, w_sd, s)
               : launch_mma<false>(x, w, y, occ, E, C, D, F, x_se, x_sc, w_se, w_sd, s);
  } else {
    const bool vec = F % 4 == 0 && w_sd % 4 == 0 && w_se % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    return vec ? launch_tiled<true>(x, w, y, occ, E, C, D, F, x_se, x_sc, w_se, w_sd, s)
               : launch_tiled<false>(x, w, y, occ, E, C, D, F, x_se, x_sc, w_se, w_sd, s);
  }
}

}  // namespace

// dtype of x and w: 0 = float32, 1 = bfloat16.  Strides in elements.  rows:
// (E,) int32 on the device, the rows of x[e] that hold tokens (rows past it
// are written as zeros), or null for every row.  For bf16 at C <= 8: part
// holds blocks * 2 * 8 * 256 floats of scratch and tickets E * ceil(F / 256)
// ints that are zero before the launch and zero after it, and blocks, the
// size of the persistent grid, is a multiple of ceil(F / 256); unused
// otherwise.  Returns a cudaError_t (0 = launched).
extern "C" int moe_gmm_fwd(int dtype, const void* x, const void* w, void* y,
                           const void* rows, void* part, void* tickets,
                           int blocks, int E, int C, int D, int F,
                           long long x_se, long long x_sc, long long w_se,
                           long long w_sd, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D < 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* occ = static_cast<const int*>(rows);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (dtype == 0)
    return launch<float>(x, w, y, occ, pt, tk, blocks, E, C, D, F, x_se, x_sc,
                         w_se, w_sd, s);
  if (dtype == 1)
    return launch<bf16>(x, w, y, occ, pt, tk, blocks, E, C, D, F, x_se, x_sc,
                        w_se, w_sd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
