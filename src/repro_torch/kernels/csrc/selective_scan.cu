// Selective scan (the Mamba-1 within-chunk recurrence) for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py
// (selective_scan_bqcn, wrapper repro.kernels.ops.selective_scan): for every
// (b, c, n) element, h_t = a_t * h_{t-1} + b_t over the Q steps of a chunk,
// starting from h0, every h_t written out in fp32.
//
// Translation.  The Pallas grid (B, C / block_c) gave one program a
// (block_c, N) plane held in VMEM scratch and walked t with fori_loop; the
// plane was the TPU's vector tile.  Here one thread owns one (b, c, n)
// element, keeps h in an fp32 register and walks t = 0..Q-1.  Threads of a
// block sit on neighbouring (c, n) addresses with N innermost, so every load
// of a_t, b_t and every store of h_t is one coalesced 128-byte line per warp.
// At falcon-mamba-7b's width (C = d_inner = 8192, N = 16) and batch 1 that is
// 131,072 threads, 512 blocks, about four per SM on 132 SMs.  No block_c
// tiling is needed: any C, N and Q are taken.
//
// What bounds it.  It reads a and b once, reads h0, writes every h_t, and does
// one FMA (2 flops) per element and step: 0.17 flop per byte, far below the
// H100's balance point, so it is bound by bytes.  The loads of a chunk of
// UNROLL steps do not depend on h and are issued together before the FMA
// chain, so each thread keeps 2 * UNROLL loads in flight; streaming cache
// hints (__ldcs on the fp32 loads, __stcs on every store) mark the
// once-read inputs and once-written outputs as not worth keeping in L2.
//
// Layout: a, b (B, Q, C, N) with arbitrary B and Q strides (a chunk sliced
// out of a (B, S, C, N) tensor launches with no copy) and a unit-stride
// (C, N) plane; h0 (B, C, N) fp32 with a unit-stride plane; out (B, Q, C, N)
// fp32, contiguous.  Element types of a and b: float or bfloat16 (math in
// fp32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float load_f(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ out,
                      int Q, long long CN, long long a_sb, long long a_sq,
                      long long b_sb, long long b_sq, long long h0_sb) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= CN) return;
  const long long bi = blockIdx.y;
  const T* ap = a + bi * a_sb + e;
  const T* bp = b + bi * b_sb + e;
  float* op = out + bi * Q * CN + e;
  float h = h0[bi * h0_sb + e];

  int t = 0;
  for (; t + UNROLL <= Q; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = load_f(ap + (t + u) * a_sq);
      bv[u] = load_f(bp + (t + u) * b_sq);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = fmaf(av[u], h, bv[u]);
      __stcs(op + (t + u) * CN, h);
    }
  }
  for (; t < Q; ++t) {
    h = fmaf(load_f(ap + t * a_sq), h, load_f(bp + t * b_sq));
    __stcs(op + t * CN, h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* out,
                   int B, int Q, long long CN, long long a_sb, long long a_sq,
                   long long b_sb, long long b_sq, long long h0_sb,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((CN + THREADS - 1) / THREADS), (unsigned)B);
  selective_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), Q, CN, a_sb,
      a_sq, b_sb, b_sq, h0_sb);
  return cudaGetLastError();
}

}  // namespace

// dtype of a and b: 0 = float32, 1 = bfloat16.  Strides in elements.
// Returns a cudaError_t (0 = launched).
extern "C" int selective_scan_fwd(int dtype, const void* a, const void* b,
                                  const void* h0, void* out, int B, int Q,
                                  long long CN, long long a_sb, long long a_sq,
                                  long long b_sb, long long b_sq,
                                  long long h0_sb, void* stream) {
  if (B <= 0 || B > 65535 || Q < 0 || CN <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h0, out, B, Q, CN, a_sb, a_sq, b_sb, b_sq,
                         h0_sb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, out, B, Q, CN, a_sb, a_sq, b_sb,
                                 b_sq, h0_sb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
