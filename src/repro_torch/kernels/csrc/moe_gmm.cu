// MoE grouped matmul for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py:42
// (moe_gmm_ecf, wrapper repro.kernels.ops.moe_gmm): y[e] = x[e] @ w[e] for
// every expert e, with x (E, C, D), w (E, D, F) and y (E, C, F); the products
// are summed in fp32 and y is written in x's type.
//
// Translation.  The Pallas grid (E, C/bc, F/bf, D/bd) carried an fp32 VMEM
// accumulator across the sequential D axis and padded C, D and F to its
// 128/512 MXU blocks.  Here a block owns one (expert, F tile) and loops over
// D itself, so nothing carries between blocks, and ragged C, D and F edges
// are masked in the kernel: nothing is padded or copied.
//
// What bounds it.  In the MoE layer C is the expert capacity, which is small:
// qwen3-moe-30b (E = 128, D = 2048, F = 768) has C = 1 in decode and C = 77
// for a 975-token prefill.  Every expert's whole weight matrix is read in
// every launch (403 MB in bf16), so the decode launch is bound by bytes
// (0.120 ms at 3.35 TB/s) and so, on tensor cores, is the prefill one
// (0.137 ms against 0.031 ms of bf16 tensor-core work).  The design goal is
// therefore that each weight element is read from HBM once per launch, with
// enough loads in flight to stream at the HBM rate.  Three kernels:
//
// * gmm_small_c (C <= 8, decode, both types): the C rows' outputs live in
//   registers and the 256 threads of a block split D, 16 ways, instead of
//   splitting rows, so no thread idles on rows that do not exist.  Each
//   thread reads four consecutive columns of a w row with one vector load
//   (16 threads cover the tile's 64 columns: one coalesced 128- or 256-byte
//   row), keeps four rows' loads in flight, and the 16 partial sums are
//   reduced at the end through warp shuffles and shared memory.  x (a few
//   rows) is read through L1.  At qwen3's decode the grid is 12 F tiles x
//   128 experts = 1536 blocks.
// * gmm_mma (C > 8, bf16: the prefill path): tensor cores, mma.sync.m16n8k16
//   with fp32 sums (helpers in mma_sm90.cuh).  A block of 8 warps owns one
//   (expert, C tile of 16 MT <= 128 rows, 128-column F tile); each warp owns
//   16 columns and all MT 16-row fragments, so C = 77 runs as one 80-row
//   tile and w streams from HBM once.  64-deep slices of x and w go through
//   a 3-stage cp.async ring of 16-byte copies (32 KB of w in flight per
//   block, two blocks per SM; 4 and 6 stages, which leave room for fewer
//   blocks, measured slower), swizzled for conflict-free ldmatrix: x through
//   ldmatrix, w ((D, F) row-major) through ldmatrix.trans.  Ragged D and F
//   are zero-filled by the copies' src-size; rows past C are zero-filled.
//   For C > 128 the balanced C tiles of one (expert, F tile) are
//   neighbouring blocks and share w through L2.  Where a base pointer or a
//   row stride is not 16-byte aligned, the same kernel (VEC = false) fills
//   the slices element by element.  At qwen3's shape the grid is 6 F tiles x
//   128 experts = 768 blocks.
// * gmm_tiled (C > 8, fp32): a block of 128 threads computes a (16*RM) x 64
//   output tile, RM <= 8 chosen from C, each thread RM rows x 8 columns in
//   fp32 registers, staging 32-deep slices of x and w in shared memory: bound
//   by its scalar FMAs.  fp32 stays off the tensor cores because TF32 keeps
//   about three decimal digits and the reference's fp32 tolerance is 1e-4.
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

constexpr int BF = 64;  // output columns per block (gmm_small_c, gmm_tiled)

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

// ---------------------------------------------------------------------------
// C <= CMAX <= 8: rows in registers, D split over the block
// ---------------------------------------------------------------------------

constexpr int S_THREADS = 256;
constexpr int S_TX = BF / 4;            // 16 threads along F, 4 columns each
constexpr int S_TY = S_THREADS / S_TX;  // 16-way split of D
constexpr int S_UNROLL = 4;             // w rows in flight per thread

template <typename T, int CMAX, bool VEC>
__global__ void __launch_bounds__(S_THREADS)
gmm_small_c(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ y, int C, int D, int F, long long x_se,
            long long x_sc, long long w_se, long long w_sd) {
  const int e = blockIdx.y;
  const int tx = threadIdx.x % S_TX, ty = threadIdx.x / S_TX;
  const int col = blockIdx.x * BF + tx * 4;
  const T* xe = x + e * x_se;
  const T* we = w + e * w_se;

  float acc[CMAX][4];
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;

  if (col < F) {
    int d = ty;
    for (; d + (S_UNROLL - 1) * S_TY < D; d += S_UNROLL * S_TY) {
      float wv[S_UNROLL][4];
#pragma unroll
      for (int u = 0; u < S_UNROLL; ++u)
        load4<T, VEC>(we + (long long)(d + u * S_TY) * w_sd, col, F, wv[u]);
#pragma unroll
      for (int u = 0; u < S_UNROLL; ++u)
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) {
            const float xv = to_f(xe[c * x_sc + d + u * S_TY]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[c][j] = fmaf(xv, wv[u][j], acc[c][j]);
          }
    }
    for (; d < D; d += S_TY) {
      float wv[4];
      load4<T, VEC>(we + (long long)d * w_sd, col, F, wv);
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) {
          const float xv = to_f(xe[c * x_sc + d]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][j] = fmaf(xv, wv[j], acc[c][j]);
        }
    }
  }

  // Sum the 16 D-slices: lanes l and l + 16 of a warp hold neighbouring
  // slices of the same columns, then the 8 warps meet in shared memory.
  constexpr int WARPS = S_THREADS / 32;
  __shared__ float red[WARPS][CMAX][BF];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 16);
      if (lane < 16) red[warp][c][tx * 4 + j] = acc[c][j];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < C * BF; i += S_THREADS) {
    const int c = i / BF, f = i % BF;
    const int gf = blockIdx.x * BF + f;
    if (gf >= F) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[k][c][f];
    store(y + ((long long)e * C + c) * F + gf, s);
  }
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
        bf16* __restrict__ y, int C, int D, int F, int tile_rows,
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

  // slice [d0, d0 + 64) of the tile's x rows and w columns into stage st
  auto load_slice = [&](int st, int d0) {
    bf16* xd = xs + st * X_ELEMS;
    bf16* wd = ws + st * W_ELEMS;
    for (int i = tid; i < XR * (M_BK / 8); i += M_THREADS) {
      const int r = i / (M_BK / 8), c = i % (M_BK / 8);
      const int d = d0 + c * 8;
      const int n = r < rows ? max(0, min(8, D - d)) : 0;
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
          float* __restrict__ y, int C, int D, int F, int tile_rows,
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

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += BD) {
    // x slice: consecutive threads read consecutive d of a row
    for (int i = threadIdx.x; i < BC * BD; i += T_THREADS) {
      const int r = i / BD, k = i % BD;
      xs[k][r] = (r < rows && d0 + k < D) ? xe[r * x_sc + d0 + k] : 0.f;
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

template <typename T, bool VEC>
cudaError_t launch_small(const T* x, const T* w, T* y, int E, int C, int D,
                         int F, long long x_se, long long x_sc, long long w_se,
                         long long w_sd, cudaStream_t s) {
  const dim3 grid((unsigned)((F + BF - 1) / BF), (unsigned)E);
#define SMALL(CM)                                                         \
  gmm_small_c<T, CM, VEC><<<grid, S_THREADS, 0, s>>>(x, w, y, C, D, F, \
                                                      x_se, x_sc, w_se, w_sd)
  if (C <= 1)
    SMALL(1);
  else if (C <= 2)
    SMALL(2);
  else if (C <= 4)
    SMALL(4);
  else
    SMALL(8);
#undef SMALL
  return cudaGetLastError();
}

// balanced C tiles of at most `max_rows` rows: (number of tiles, rows each)
inline void c_tiles(int C, int max_rows, int* n_ct, int* tile_rows) {
  *n_ct = (C + max_rows - 1) / max_rows;
  *tile_rows = (C + *n_ct - 1) / *n_ct;
}

template <bool VEC>
cudaError_t launch_tiled(const float* x, const float* w, float* y, int E,
                         int C, int D, int F, long long x_se, long long x_sc,
                         long long w_se, long long w_sd, cudaStream_t s) {
  int n_ct, tile_rows;
  c_tiles(C, MAX_RM * T_TY, &n_ct, &tile_rows);
  const int rm = (tile_rows + T_TY - 1) / T_TY;    // rows per thread
  const long long n_blocks = (long long)n_ct * ((F + BF - 1) / BF);
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_blocks, (unsigned)E);
#define TILED(R)                                                          \
  gmm_tiled<R, VEC><<<grid, T_THREADS, 0, s>>>(x, w, y, C, D, F,          \
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
cudaError_t launch_mma_mt(const bf16* x, const bf16* w, bf16* y, dim3 grid,
                          int C, int D, int F, int tile_rows, long long x_se,
                          long long x_sc, long long w_se, long long w_sd,
                          cudaStream_t s) {
  const int smem = mma_smem_bytes<MT>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_mma<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gmm_mma<MT, VEC><<<grid, M_THREADS, smem, s>>>(x, w, y, C, D, F, tile_rows,
                                                 x_se, x_sc, w_se, w_sd);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_mma(const bf16* x, const bf16* w, bf16* y, int E, int C,
                       int D, int F, long long x_se, long long x_sc,
                       long long w_se, long long w_sd, cudaStream_t s) {
  int n_ct, tile_rows;
  c_tiles(C, M_MAX_MT * 16, &n_ct, &tile_rows);
  const int mt = (tile_rows + 15) / 16;   // pad rows to 16, not to 128
  const long long n_blocks = (long long)n_ct * ((F + M_BN - 1) / M_BN);
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_blocks, (unsigned)E);
#define MMA(M)                                                           \
  return launch_mma_mt<M, VEC>(x, w, y, grid, C, D, F, tile_rows, x_se, \
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
cudaError_t launch(const void* xv, const void* wv, void* yv, int E, int C,
                   int D, int F, long long x_se, long long x_sc,
                   long long w_se, long long w_sd, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  if (C <= 8) {
    // one vector load per four columns of w needs them aligned as a whole
    const bool vec = F % 4 == 0 && w_sd % 4 == 0 && w_se % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) == 0;
    return vec ? launch_small<T, true>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s)
               : launch_small<T, false>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    // 16-byte copies of 8 elements need 16-byte-aligned bases and rows
    const bool vec = x_se % 8 == 0 && x_sc % 8 == 0 && w_se % 8 == 0 &&
                     w_sd % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    return vec ? launch_mma<true>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s)
               : launch_mma<false>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s);
  } else {
    const bool vec = F % 4 == 0 && w_sd % 4 == 0 && w_se % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    return vec ? launch_tiled<true>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s)
               : launch_tiled<false>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s);
  }
}

}  // namespace

// dtype of x and w: 0 = float32, 1 = bfloat16.  Strides in elements.
// Returns a cudaError_t (0 = launched).
extern "C" int moe_gmm_fwd(int dtype, const void* x, const void* w, void* y,
                           int E, int C, int D, int F, long long x_se,
                           long long x_sc, long long w_se, long long w_sd,
                           void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D < 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s);
  if (dtype == 1)
    return launch<bf16>(x, w, y, E, C, D, F, x_se, x_sc, w_se, w_sd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
