// Decode attention (one query token per head against the KV cache) for
// Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_bhd, wrapper repro.kernels.ops.flash_decode): scores of one
// query row against every cache slot, an int8 / bool (B, S) validity mask
// (cache occupancy, sliding-window ring slots), online softmax with m, l and
// the accumulator in fp32.
//
// Translation.  The Pallas grid (B, H, nKV) reduced the KV axis in order on
// one core, one query head per program, so each K/V block was read G = H/Kv
// times.  Here one block owns (batch, kv head, split of S) and holds the G
// query heads that share that kv head, so each K/V row is read once.  At
// batch 1 with 8 kv heads there would be only 8 blocks for 132 SMs, so S is
// cut into splits; every block writes its split's (m, l, acc) to fp32
// scratch and a second small kernel merges the splits by log-sum-exp.  Masked
// slots score the finite -1e30 of the TPU kernel, so a split with no valid
// slot carries m = -1e30 and its weight exp(-1e30 - m) is 0 as soon as any
// split saw a valid slot; rows are normalised by max(l, 1e-20).  The cache
// is read in the model layout (B, S, Kv, D) through strides, so there is no
// per-step transposed copy of the cache.
//
// What bounds it.  Decode reads the cache once per token and does about G
// flops per byte it reads (4 for llama3.2-1b), far below the H100's 295
// flop/byte balance point: it is bound by bytes.  Within a block each warp
// walks its own keys with one D-slice per lane (coalesced 2-4 element loads)
// and an online softmax per key; the split count makes the grid fill the
// SMs.
//
// Element types: float and bfloat16 (math in fp32).  Head dims: 64, 128.
// Query heads per kv head: at most MAX_G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_G = 8;
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
  const void* q;                // (B, 1, H, D)
  const void* k;                // (B, S, Kv, D)
  const void* v;
  const uint8_t* valid;         // (B, S), nonzero = valid
  void* o;                      // (B, 1, H, D)
  float* part_m;                // (B * H, splits)
  float* part_l;                // (B * H, splits)
  float* part_acc;              // (B * H, splits, D)
  int B, H, Kv, S, splits, chunk;
  long long q_sb, q_sh;         // strides in elements; the D stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long valid_sb;           // the S stride is 1
  long long o_sb, o_sh;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const Params p) {
  constexpr int E = D / 32;     // elements of a row per lane
  __shared__ float wm[WARPS][MAX_G];
  __shared__ float wl[WARPS][MAX_G];
  __shared__ float wacc[WARPS][MAX_G][D];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int G = p.H / p.Kv;
  const int s0 = split * p.chunk;
  const int s1 = min(p.S, s0 + p.chunk);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (kvh * G) * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* valid = p.valid + b * p.valid_sb;

  float qv[MAX_G][E], m[MAX_G], l[MAX_G], acc[MAX_G][E];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qv[g][e] = g < G ? to_float(q[g * p.q_sh + lane * E + e]) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int s = s0 + warp; s < s1; s += WARPS) {
    float kr[E], vr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kr[e] = to_float(k[s * p.k_ss + lane * E + e]);
      vr[e] = to_float(v[s * p.v_ss + lane * E + e]);
    }
    const bool ok = valid[s] != 0;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {              // uniform across the warp
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[g][e], kr[e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float x = ok ? dot * p.scale : NEG_INF;
        const float m_new = fmaxf(m[g], x);
        const float corr = expf(m[g] - m_new);
        const float pv = expf(x - m_new);
        l[g] = l[g] * corr + pv;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * corr + pv * vr[e];
        m[g] = m_new;
      }
    }
  }

  // Merge the warps of this block, then write the split's partials.
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      if (lane == 0) {
        wm[warp][g] = m[g];
        wl[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) wacc[warp][g][lane * E + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w][g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(wm[w][g] - mx);
      ls += wl[w][g] * wt;
      as += wacc[w][g][d] * wt;
    }
    const long long row = (long long)(b * p.H + kvh * G + g) * p.splits + split;
    p.part_acc[row * D + d] = as;
    if (d == 0) {
      p.part_m[row] = mx;
      p.part_l[row] = ls;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D) flash_decode_merge_kernel(const Params p) {
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int d = threadIdx.x;
  const float* pm = p.part_m + (long long)bh * p.splits;
  const float* pl = p.part_l + (long long)bh * p.splits;
  const float* pa = p.part_acc + (long long)bh * p.splits * D;
  float mx = NEG_INF;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, pm[s]);
  float ls = 0.f, as = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float wt = expf(pm[s] - mx);
    ls += pl[s] * wt;
    as += pa[s * D + d] * wt;
  }
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  o[d] = from_float<T>(as / fmaxf(ls, 1e-20f));
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.splits, p.Kv, p.B);
  flash_decode_split_kernel<T, D><<<grid, THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<T, D><<<p.B * p.H, D, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_decode_fwd(
    int dtype, int head_dim,
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part_m, void* part_l, void* part_acc,
    int B, int H, int Kv, int S, int splits, int chunk,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long valid_sb, long long o_sb, long long o_sh,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.valid = static_cast<const uint8_t*>(valid);
  p.o = o;
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_acc = static_cast<float*>(part_acc);
  p.B = B; p.H = H; p.Kv = Kv; p.S = S; p.splits = splits; p.chunk = chunk;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.valid_sb = valid_sb;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = scale;
  if (H % Kv != 0 || H / Kv > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
