// Prefill flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, wrapper repro.kernels.ops.flash_attention): online
// softmax over KV tiles with the running max m, denominator l and the
// accumulator in fp32; causal, sliding-window and prefix-LM masks; GQA maps
// query head h to kv head h / (H / Kv).
//
// Translation.  The Pallas grid (B, H, nQ, nKV) ran its KV axis in order on
// one core and carried (m, l, acc) in VMEM scratch.  Here one block owns a
// 64-row query tile of one (batch, head) and walks its KV tiles in a loop,
// carrying (m, l, acc) in registers.  Causal and window limits are loop
// bounds: the block visits the prefix tiles [0, n_prefix) and then the tiles
// [lo, hi) that can hold an unmasked key of one of its rows, so fully masked
// tiles cost nothing.  Inside a visited tile the element mask is the Pallas
// kernel's (kv padding, q padding, causal | prefix, window).  Masked scores
// are the finite -1e30 of the TPU kernel, never -inf, and rows are normalised
// by max(l, 1e-20): a row whose first visited tile is fully masked (window)
// then gets exp(-1e30 - m_real) = 0 weight on that tile instead of NaN.
// q, k and v are read in the model layout (B, S, heads, D) through strides,
// so no transposed copy is made.
//
// What bounds it.  Causal prefill does H S / (2 H + 2 Kv) flops per byte it
// must move (about 410 for llama3.2-1b at S = 1024), above the H100's 295
// flop/byte balance point: it is bound by operations.  This first version
// multiplies with scalar fp32 FMAs from shared memory (a 16 x 16 thread
// grid, each thread a 4 x 4 score tile and a 4 x D/16 output tile), so it
// runs far from the tensor-core bound; moving both products to wgmma is the
// next step.
//
// Element types: float and bfloat16 (math in fp32).  Head dims: 64, 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Kv, Sq, Skv;
  long long q_sb, q_ss, q_sh;   // strides in elements; the D stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;                   // <= 0: no sliding window
  int prefix_len;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  // qs [BQ][D+1], ks [BK][D+1], vs [BK][D], ps [BQ][BK+1], all fp32
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Params p) {
  constexpr int DP = D + 1;     // padded rows: column reads hit 16 banks
  constexpr int PP = BK + 1;
  constexpr int NJ = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ps = vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;      // key / output column group
  const int ty = tid / 16;      // query row group; a row lives in 16 lanes
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Kv);
  const int q_start = blockIdx.x * BQ;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int s = q_start + r;
    qs[r * DP + c] = s < p.Sq ? to_float(q[s * p.q_ss + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Tiles that can hold an unmasked key for a real row of this block.
  const int n_kv = (p.Skv + BK - 1) / BK;
  const int q_last = min(q_start + BQ, p.Sq) - 1;
  const int hi = p.causal ? min(n_kv, q_last / BK + 1) : n_kv;
  const int lo = p.window > 0 ? max(0, q_start - p.window + 1) / BK : 0;
  const int n_prefix = min(n_kv, (p.prefix_len + BK - 1) / BK);
  // Visit [0, min(n_prefix, lo)) and then [lo, max(hi, n_prefix)).
  const int first_end = min(n_prefix, lo);
  const int second_end = max(hi, n_prefix);

  for (int pass = 0; pass < 2; ++pass) {
    const int j0 = pass == 0 ? 0 : lo;
    const int j1 = pass == 0 ? first_end : second_end;
    for (int jt = j0; jt < j1; ++jt) {
      const int k_start = jt * BK;
      __syncthreads();          // the previous tile's ks / vs / ps are read
      for (int i = tid; i < BK * D; i += THREADS) {
        const int r = i / D, c = i % D;
        const int s = k_start + r;
        const bool in = s < p.Skv;
        ks[r * DP + c] = in ? to_float(k[s * p.k_ss + c]) : 0.f;
        vs[r * D + c] = in ? to_float(v[s * p.v_ss + c]) : 0.f;
      }
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = ks[(tx + 16 * jj) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sc[i][jj] = fmaf(a[i], bv[jj], sc[i][jj]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qpos = q_start + r;
        float row_max = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kpos = k_start + tx + 16 * jj;
          bool ok = kpos < p.Skv && qpos < p.Sq;
          if (p.causal)
            ok = ok && (qpos >= kpos || kpos < p.prefix_len);
          if (p.window > 0) ok = ok && (qpos - kpos < p.window);
          const float x = ok ? sc[i][jj] * p.scale : NEG_INF;
          sc[i][jj] = x;
          row_max = fmaxf(row_max, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
        const float m_new = fmaxf(m[i], row_max);
        const float corr = expf(m[i] - m_new);
        float row_sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float pv = expf(sc[i][jj] - m_new);
          ps[r * PP + tx + 16 * jj] = pv;
          row_sum += pv;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
        l[i] = l[i] * corr + row_sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      }
      __syncthreads();          // ps complete

#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float pr[4], vv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + ty + 16 * i;
    if (qpos < p.Sq) {
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        o[qpos * p.o_ss + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes<D>());
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    int dtype, int head_dim,
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int Kv, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int prefix_len, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.Kv = Kv; p.Sq = Sq; p.Skv = Skv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.prefix_len = prefix_len;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
