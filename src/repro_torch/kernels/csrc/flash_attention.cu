// Prefill flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:121
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
// flop/byte balance point: it is bound by operations, and only the tensor
// cores reach that bound.
//
// bf16 (the served path): the FA2 form on Hopper's warpgroup products (wgmma,
// bf16 in, fp32 sums; helpers in mma_sm90.cuh).  A block is one warpgroup (4
// warps) owning 64 query rows, each warp 16 of them, with its Q fragments in
// registers for the whole KV loop (loaded once by ldmatrix).  K and V tiles of
// 64 keys stream through a 3-stage cp.async ring of 16-byte copies (ragged rows
// zero-filled with src-size 0) into shared memory in the 128-byte swizzle that
// wgmma's descriptors name: Q.K^T reads K as a K-major operand, P.V reads V as
// an MN-major one, so no ldmatrix of K or V is issued.  The score accumulator
// is scaled to the log2 domain, masked where the tile needs it, exponentiated
// on the special-function unit and packed to bf16 in registers, where it is
// already laid out as the register A operand of the P.V product, so P never
// goes through shared memory.  The loop is software-pipelined: tile t + 1's
// Q.K^T runs on the tensor cores while tile t's softmax runs, two tiles per
// pass so the score buffers swap without a copy.  P is rounded to bf16 before
// P.V (the denominator sums the fp32 P), as every tensor-core flash kernel
// does; the error against the fp32-P reference stays within its 2e-2 bf16
// tolerance (tests/test_torch_kernels.py emulates the rounding).  The query
// tile is the grid's slowest axis, last tile first, so the long causal blocks
// start first.  Registers (ptxas, sm_90a): 163 a thread at D = 64 (three blocks
// per SM), 234 / 238 / 240 at 112 / 120 / 128 (two), no spill.  What is left
// between this kernel and SDPA is the per-tile softmax, which only other
// blocks' products overlap.
//
// bf16 at D = 256 (paligemma-3b): a warp-specialised kernel.  The 64 x 256
// fp32 output accumulator alone takes 128 registers a thread, so Q cannot
// stay in registers beside it, and a 64 x 256 K or V tile is 32 KiB.  A
// block is three warpgroups on one 64-row query tile: two consumers and a
// producer of which one thread issues TMA loads.  The tensor maps are
// built on the host from the model-layout strides (B, S, heads, D), one
// 64 x 64 box per 128-byte row chunk, so there is still no transposed
// copy, and TMA zero-fills rows past S.  Q (32 KiB) is loaded once; K and
// V tiles of BK = 64 keys stream through a 3-stage ring (64 KiB a stage:
// 224 KiB in all with Q, under the 227 KiB a block may use) guarded by
// full and empty mbarriers.  setmaxnreg moves registers from the producer
// (40) to the consumers (232): each keeps its 128-register accumulator,
// its score tile and P in registers and reads Q by descriptor (the SS form
// of wgmma, as K).  The walk's tiles alternate between the two consumers,
// each with its own running (m, l, acc) of the same rows, so one's softmax
// overlaps the other's products on the SM's tensor cores, and a causal
// block's longest walk is split in two; at the end the second hands its
// partial over through shared memory and the first merges them by
// log-sum-exp.  Consumers owning different query tiles (the short and the
// long end of the causal triangle paired in one block, so every block had
// the same work) measured slower at paligemma's prefill: the long tile's
// consumer then walked most of its tiles alone, with nothing to overlap its
// softmax.  Issuing the next tile's Q.K^T before this tile's softmax (a
// second score buffer) also measured slower: at 232-240 registers a thread
// there is no room for it beside the accumulator.  Registers (ptxas,
// sm_90a): 168 at entry, no spill.
//
// fp32: the scalar form (a 16 x 16 thread grid, each thread a 4 x 4 score
// tile and a 4 x D/16 output tile, fp32 FMAs from shared memory).  TF32
// tensor cores keep only about three decimal digits, which would break the
// reference's fp32 tolerance of 2e-5; fp32 attention only carries the
// fp32 logits check, not the served path.
//
// Head widths: every D >= 1, in fp32 and bf16 (the Pallas kernel carries D
// whole).  bf16 rows of whole aligned 16-byte chunks (D a multiple of 8,
// every row start 16-byte aligned) up to 256 run width classes: a class is a
// tile width, and the head width D rides beside it.  bf16 takes the tile
// widths 64 (D = 8 .. 64) and 128 (72 .. 128) on the one-warpgroup kernel
// and 192 (136 .. 192) and 256 (200 .. 256) on the warp-specialised one;
// fp32 the classes 64, 128 and 256, which size each thread's columns.  The
// served models' widths (64, 112, 120, 128, 256 in bf16) keep their own
// instantiations, whose template constants fold every run-time bound into
// the code they had; any other width runs its class's, which reads D at
// run time.  The rule that keeps a padded tile exact: each row's D / 8
// chunks of 16 bytes are copied from global memory (TMA: the tensor map's
// rows are D long, so the copy engine zero-fills the columns past them);
// the chunks past them are zero in shared memory, zeroed once where
// cp.async never writes them; Q.K^T takes the k16 steps that hold data
// (the last one at D = 8 (mod 16) reads one zero chunk of Q and of K, so
// 0 x 0 and never NaN); P.V keeps the class's product (its columns past D
// are zeros times P and never stored); the stores stop at D.  At 112 that
// is 1/7 more tensor-core work in P.V and no more bytes from HBM.
//
// Any other bf16 row (D off a multiple of 8, or a view whose base or
// strides are not 16-byte multiples; the wrapper passes the largest of 16,
// 8, 4 and 2 bytes that divides them all) is read where it lies by
// copy_chunk (mma_sm90.cuh): pieces of that size by cp.async, src-size 0
// past the row, or 2-byte element loads, into the same zero-padded,
// swizzled tiles, every stage of every tile written whole, so the last
// chunk's elements past D and the rows past S read as zero (element loads
// store the zeros themselves; stale shared memory would give 0 x NaN).  Up
// to 128 that is the one-warpgroup kernel (LOOSE), its stores an element at
// a time.  Past 128 (where TMA needs 16-byte strides) and at every width
// past 256 (where one warpgroup's accumulator would pass its registers) it
// is flash_attention_sliced, and fp32 past 256 flash_attention_f32_sliced:
// the output columns in slices of 256 on the grid, each slice's scores over
// all of D in chunks of 64.  fp32 up to 256 reads single elements at any
// alignment.  Query groups: any G = H / Kv; query head h reads kv head
// h / G.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Kv, Sq, Skv;
  int D;                        // the head width (>= 1)
  long long q_sb, q_ss, q_sh;   // strides in elements; the D stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;                   // <= 0: no sliding window
  int prefix_len;
  float scale;
  int align;                    // bytes dividing every q, k, v row start and D x the element
};

// The KV tiles a block with query rows [q_start, q_start + rows) visits, in
// order: the prefix tiles [0, min(n_prefix, lo)) first, then [lo,
// max(hi, n_prefix)), where [lo, hi) can hold an unmasked key of a real row.
struct TileRange {
  int first_end, lo, n;

  __device__ TileRange(const Params& p, int q_start, int rows) {
    const int n_kv = (p.Skv + BK - 1) / BK;
    const int q_last = min(q_start + rows, p.Sq) - 1;
    const int hi = p.causal ? min(n_kv, q_last / BK + 1) : n_kv;
    lo = p.window > 0 ? max(0, q_start - p.window + 1) / BK : 0;
    const int n_prefix = min(n_kv, (p.prefix_len + BK - 1) / BK);
    first_end = min(n_prefix, lo);
    n = first_end + max(0, max(hi, n_prefix) - lo);
  }
  __device__ int tile(int t) const {
    return t < first_end ? t : lo + (t - first_end);
  }
};

// The Pallas kernel's element mask as a key range: query qpos sees the
// keys [lo, hi) (causal | prefix, window, Skv).  Rows past Sq are computed
// but never written.
struct VisibleKeys {
  int lo, hi;

  __device__ VisibleKeys(const Params& p, int qpos) {
    hi = p.Skv;
    lo = 0;
    if (p.causal) hi = min(hi, max(qpos + 1, p.prefix_len));
    if (p.window > 0) lo = qpos - p.window + 1;
  }
  __device__ bool operator()(int kpos) const { return kpos >= lo && kpos < hi; }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // one warpgroup: 4 warps x 16 query rows
constexpr int STAGES = 3;         // the one-warpgroup kernel's K/V ring
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int mma_smem_bytes() {
  // the Q tile, then the stages' tiles of K and of V, all bf16
  return static_cast<int>(sizeof(bf16)) * (BQ * D + 2 * STAGES * BK * D);
}

// 2^x on the special-function unit; -1e30 gives 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax and P.V of one KV tile for one warp's 16 query rows
// [w_q0, w_q0 + 16) of its warpgroup's 64: s holds the warp's scores (mma C
// layout) against keys [k_start, k_start + BK), vt the tile's V in shared
// memory (64-column SW128 blocks, BK * 64 elements apart), acc the 64 x D
// output (D / 8 n8 blocks), m and l the rows' running max and this thread's
// share of their sums (rows g and g + 8).  P.V's wait ends every product of
// the warpgroup still in flight.
template <int D>
__device__ __forceinline__ void softmax_pv(const Params& p, int k_start, int w_q0,
                                           float s[BK / 2], float acc[D / 2],
                                           float m[2], float l[2], const bf16* vt) {
  using namespace mma_sm90;
  constexpr int NK = BK / 8;    // n8 blocks of the scores
  constexpr int ND = D / 8;     // n8 blocks of the output tile
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const float scale_log2 = p.scale * LOG2E;

  // scale to the log2 domain; mask only where a key of this tile can be
  // invisible to a row of this warp (the diagonal tile of a causal walk, a
  // window's edge, the ragged end): a per-element test compiled into every
  // tile was the kernel's largest cost after the products
#pragma unroll
  for (int j = 0; j < NK * 4; ++j) s[j] *= scale_log2;
  const bool need_mask =
      k_start + BK > p.Skv ||
      (p.causal && k_start + BK - 1 > w_q0 && k_start + BK > p.prefix_len) ||
      (p.window > 0 && w_q0 + 15 - k_start >= p.window);
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const VisibleKeys visible(p, w_q0 + g + i * 8);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!visible(k_start + j * 8 + t4 * 2 + e)) s[j * 4 + 2 * i + e] = NEG_INF;
    }
  }

  // running max of each row: a tree over this thread's 16 scores, then
  // over the 4 lanes of the quad holding the row
  float mx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float r[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) r[j] = fmaxf(s[j * 4 + 2 * i], s[j * 4 + 2 * i + 1]);
#pragma unroll
    for (int w = NK / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) r[j] = fmaxf(r[j], r[j + w]);
    mx[i] = fmaxf(m[i], r[0]);
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  const float corr[2] = {fast_exp2(m[0] - mx[0]), fast_exp2(m[1] - mx[1])};
  m[0] = mx[0];
  m[1] = mx[1];
  l[0] *= corr[0];
  l[1] *= corr[1];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    acc[j * 4 + 0] *= corr[0];
    acc[j * 4 + 1] *= corr[0];
    acc[j * 4 + 2] *= corr[1];
    acc[j * 4 + 3] *= corr[1];
  }

  // P = exp2(S - m) packed to bf16 as the A fragments of P.V: keys
  // [16 c, 16 c + 16) are score blocks 2c and 2c + 1
  uint32_t pf[NK / 2][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float p0 = fast_exp2(s[j * 4 + 0] - mx[0]), p1 = fast_exp2(s[j * 4 + 1] - mx[0]);
    const float p2 = fast_exp2(s[j * 4 + 2] - mx[1]), p3 = fast_exp2(s[j * 4 + 3] - mx[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pf[j / 2][(j & 1) * 2] = pack_bf16x2(p0, p1);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
  }

  // O += P V: V an MN-major operand, 16 keys per product; its 64-column
  // blocks lie BK * 64 elements apart; at D = 192 and 256 a second product
  // (m64n64, m64n128) takes columns 128 on into acc[64..]
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NK / 2; ++c) {
    const uint64_t dv = sw128_desc(vt + c * 16 * 64, BK * 64 * sizeof(bf16));
    if constexpr (D == 64) {
      wgmma_m64n64_mnmajor(acc, pf[c], dv, 1);
    } else {
      wgmma_m64n128_mnmajor(acc, pf[c], dv, 1);
      const uint64_t dv2 =
          sw128_desc(vt + 2 * BK * 64 + c * 16 * 64, BK * 64 * sizeof(bf16));
      if constexpr (D == 192) wgmma_m64n64_mnmajor(acc + 64, pf[c], dv2, 1);
      if constexpr (D == 256) wgmma_m64n128_mnmajor(acc + 64, pf[c], dv2, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers<ND * 4>(acc);
}

// The warp's 16 output rows from w_q0, normalised by max(l, 1e-20): the
// first nt (<= NT) n8 blocks of acc, rows past Sq not written; LOOSE, the
// first nt columns, an element at a time (a row may start at any even
// address).
template <int NT, bool LOOSE = false>
__device__ __forceinline__ void store_rows(const Params& p, bf16* o, int w_q0,
                                           const float* acc, float l[2], int nt) {
  using namespace mma_sm90;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qpos = w_q0 + g + i * 8;
    if (qpos < p.Sq) {
      const float denom = fmaxf(l[i], 1e-20f);
      bf16* orow = o + qpos * p.o_ss + t4 * 2;
      if constexpr (LOOSE) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j * 8 + t4 * 2 + e < nt)
              orow[j * 8 + e] = __float2bfloat16(acc[j * 4 + 2 * i + e] / denom);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt)
            *reinterpret_cast<uint32_t*>(orow + j * 8) =
                pack_bf16x2(acc[j * 4 + 2 * i] / denom, acc[j * 4 + 2 * i + 1] / denom);
      }
    }
  }
}

// D: the tile width (64 or 128); DT: the head width (a multiple of 8 in
// (D - 64, D]), or 0 for the width class, whose head width p.D is read at
// run time and bounds the same loops.  LOOSE (a class only): rows that are
// not whole aligned 16-byte chunks, copied by copy_chunk at p.align, the
// last chunk's elements past p.D and every chunk past it zero in every
// stage, and stored an element at a time.
template <int D, int DT, bool LOOSE>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma(const Params p) {
  using namespace mma_sm90;
  static_assert((D == 64 || D == 128) && DT % 8 == 0 && DT <= D &&
                (DT == 0 || D - DT < 64) && !(LOOSE && DT), "head width");
  constexpr int RC = D / 8;     // 16-byte chunks per tile row
  // k16 steps of Q.K^T: a width's own (at 120 the last reads one zero
  // chunk); a class's all of the tile, the chunks past the row zero-filled
  // by every copy (no run-time bound around a product: ptxas then
  // serialises the wgmma)
  constexpr int KD = DT ? (DT + 15) / 16 : D / 16;
  constexpr int ND = D / 8;     // n8 blocks of the output tile
  constexpr int NK = BK / 8;    // n8 blocks of the scores
  const int rt = (DT ? DT : p.D) / 8;   // chunks per row that hold data
  const int per_row = DT ? rt : RC;     // the copy loop's chunks a row
  // 64-row tiles in 64-column SW128 blocks (sw128_index), each 1024-byte
  // aligned: the layout the wgmma descriptors name
  extern __shared__ __align__(1024) unsigned char fa_mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_mma_smem);
  bf16* ks = qs + BQ * D;            // [STAGES][BK x D]
  bf16* vs = ks + STAGES * BK * D;   // [STAGES][BK x D]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (p.H / p.Kv);
  // the query tile is the grid's slowest axis, last tile first: the
  // longest causal blocks start first
  const int q_start = (gridDim.z - 1 - blockIdx.z) * BQ;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // rows [start, start + 64) of an (S, DT) operand into a tile; rows at or
  // past `limit` are zero-filled, and in a class every chunk past the head
  // width (the copy reads nothing there), so the copies are the same
  // instructions whatever the width
  auto load_rows = [&](bf16* dst, const bf16* src, long long ss, int start,
                       int limit) {
    for (int i = tid; i < 64 * per_row; i += MMA_THREADS) {
      const int r = i / per_row, c = i % per_row;
      const int s = start + r;
      if constexpr (LOOSE) {
        copy_chunk(dst + sw128_index<64>(r, c), src + (s < limit ? s * ss : 0), c * 8,
                   p.D, s < limit, p.align);
      } else {
        const bool in = s < limit && (DT != 0 || c < rt);
        cp_async16(dst + sw128_index<64>(r, c), src + (in ? s * ss + c * 8 : 0),
                   in ? 16 : 0);
      }
    }
  };
  const TileRange tiles(p, q_start, BQ);
  auto load_kv = [&](int t) {   // tile t of the walk into stage t % STAGES
    const int k0 = tiles.tile(t) * BK, st = t % STAGES;
    load_rows(ks + st * BK * D, k, p.k_ss, k0, p.Skv);
    load_rows(vs + st * BK * D, v, p.v_ss, k0, p.Skv);
  };

  // Q fragments, in registers for the whole KV loop
  uint32_t qf[KD][4];
  // issue s = Q K^T of the tile in stage st: the warpgroup's 64 rows x 64
  // keys, K a K-major operand, 16 of D per product
  auto issue_qk = [&](int st, float s[NK * 4]) {
    const bf16* kt = ks + st * BK * D;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      wgmma_m64n64_kmajor(s, qf[kd],
                          sw128_desc(kt + (kd / 4) * 64 * 64 + (kd % 4) * 16, 16),
                          kd > 0);
  };

  if (DT != 0 && rt < RC) {
    // the columns past the head width, zero once: load_rows never writes
    // them.  P.V reads V's in every stage; Q.K^T reads Q's and K's up to
    // 16 KD (at 120 one chunk; at 112 none)
    const int zv = RC - rt, zq = 2 * KD - rt;
    for (int i = tid; i < STAGES * 64 * zv; i += MMA_THREADS) {
      const int st = i / (64 * zv), r = i / zv % 64, c = rt + i % zv;
      *reinterpret_cast<uint4*>(vs + st * BK * D + sw128_index<64>(r, c)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    if (zq > 0) {
      for (int i = tid; i < (STAGES + 1) * 64 * zq; i += MMA_THREADS) {
        const int st = i / (64 * zq), r = i / zq % 64, c = rt + i % zq;
        bf16* tile = st == STAGES ? qs : ks + st * BK * D;
        *reinterpret_cast<uint4*>(tile + sw128_index<64>(r, c)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  load_rows(qs, q, p.q_ss, q_start, p.Sq);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles.n) load_kv(t);
    cp_async_commit();
  }

  float acc[ND * 4];            // O: acc[4 j + e] is C fragment e of block j
#pragma unroll
  for (int j = 0; j < ND * 4; ++j) acc[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // rows g and g + 8 of the warp's 16
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums
  const int w_q0 = q_start + warp * 16;

  // Software pipeline: the scores of tile t + 1 are multiplied on the
  // tensor cores while the softmax of tile t runs.
  float s[NK * 4];
  cp_async_wait<STAGES - 2>();
  fence_proxy_async();
  __syncthreads();              // Q and tile 0 landed
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldmatrix_x4(qf[kd], qs + sw128_index<64>(warp * 16 + (lane & 15),
                                             kd * 2 + (lane >> 4)));
  if (tiles.n > 0) {
    wgmma_fence();
    issue_qk(0, s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers<NK * 4>(s);
  }

  // one KV tile: s holds its scores, sn receives the next tile's
  auto step = [&](int t, float s[NK * 4], float sn[NK * 4]) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();          // tile t+1 landed; tile t-1 is read by all
    if (t + STAGES - 1 < tiles.n) load_kv(t + STAGES - 1);
    cp_async_commit();
    // the next tile's scores, in flight during this tile's softmax (its
    // stage holds stale data after the last tile; they are then never
    // read)
    wgmma_fence();
    issue_qk((t + 1) % STAGES, sn);
    wgmma_commit();
    softmax_pv<D>(p, tiles.tile(t) * BK, w_q0, s, acc, m, l,
                  vs + (t % STAGES) * BK * D);
    fence_registers<NK * 4>(sn);
  };
  // two steps per pass, so the score buffers swap roles without a copy
  float s2[NK * 4];
  for (int t = 0; t < tiles.n; t += 2) {
    step(t, s, s2);
    if (t + 1 < tiles.n) step(t + 1, s2, s);
  }
  cp_async_wait<0>();
  store_rows<ND, LOOSE>(p, o, w_q0, acc, l, LOOSE ? p.D : rt);
}

// ---------------------------------------------------------------------------
// bf16 past D = 128: warp-specialised (two consumer warpgroups, a TMA
// producer, an mbarrier ring)
// ---------------------------------------------------------------------------

constexpr int WS_STAGES = 3;          // K/V ring stages: 64 KiB each at 256
constexpr int WS_CONSUMERS = 2;       // warpgroups on one 64-row query tile
constexpr int WS_THREADS = 128 * (WS_CONSUMERS + 1);   // and the producer's
constexpr int WS_PRODUCER_REGS = 40;  // setmaxnreg: 128 x 40 + 256 x 232 <= 64 Ki
constexpr int WS_CONSUMER_REGS = 232;
constexpr int WS_MERGE_BAR = 1;       // named barrier of the consumers' merge
static_assert(BQ == BK, "a Q tile and a K or V tile are one TMA box shape");

template <int D>
constexpr int ws_smem_bytes() {
  // the Q tile, then the stages' K and V tiles (bf16), then the full and
  // empty barriers and Q's
  return static_cast<int>(sizeof(bf16)) * D * BK * (1 + 2 * WS_STAGES) +
         8 * (2 * WS_STAGES + 1);
}

// D: the tile width (192 or 256); DT: the head width, or 0 for the width
// class, whose head width p.D (in (D - 64, D]) is read at run time.  The
// tensor maps' rows are the head width, so TMA zero-fills the tile's
// columns past it: Q.K^T's k16 steps past it add 0 x 0 and P.V's columns
// past it are zeros, never stored.
template <int D, int DT>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_attention_ws(const Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv) {
  using namespace mma_sm90;
  static_assert((D == 192 || D == 256) && (DT == 0 || DT == D), "head width");
  constexpr int ND = D / 8;     // n8 blocks of the output tile
  constexpr int NK = BK / 8;    // n8 blocks of the scores
  constexpr int CB = D / 64;    // 64-column SW128 blocks of a row: TMA boxes
  const int nt = (DT ? DT : p.D) / 8;      // n8 blocks of the output stored
  extern __shared__ __align__(1024) unsigned char fa_ws_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_ws_smem);   // [BQ x D]
  bf16* ks = qs + BQ * D;                           // [WS_STAGES][BK x D]
  bf16* vs = ks + WS_STAGES * BK * D;               // [WS_STAGES][BK x D]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + WS_STAGES * BK * D);
  uint64_t* empty = full + WS_STAGES;
  uint64_t* qfull = empty + WS_STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (p.H / p.Kv);
  // the query tile is the grid's slowest axis, last tile first: the
  // longest causal blocks start first
  const int q_start = (gridDim.z - 1 - blockIdx.z) * BQ;
  const TileRange tiles(p, q_start, BQ);

  if (threadIdx.x == 0) {
    for (int i = 0; i < WS_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * WS_CONSUMERS);
    }
    mbar_init(qfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == WS_CONSUMERS) {
    // the producer: one thread keeps the ring full
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (warp == 4 * WS_CONSUMERS && lane == 0) {
      mbar_arrive_expect_tx(qfull, BQ * D * sizeof(bf16));
      for (int j = 0; j < CB; ++j)
        tma_load_4d(qs + j * BQ * 64, &tq, qfull, j * 64, h, q_start, b);
      for (int i = 0; i < tiles.n; ++i) {
        const int st = i % WS_STAGES, k0 = tiles.tile(i) * BK;
        mbar_wait(&empty[st], ((i / WS_STAGES) & 1) ^ 1);   // both consumers done
        mbar_arrive_expect_tx(&full[st], 2 * BK * D * sizeof(bf16));
        for (int j = 0; j < CB; ++j) {
          tma_load_4d(ks + st * BK * D + j * BK * 64, &tk, &full[st], j * 64, kvh, k0, b);
          tma_load_4d(vs + st * BK * D + j * BK * 64, &tv, &full[st], j * 64, kvh, k0, b);
        }
      }
    }
  } else {
    // a consumer: the walk's tiles alternate between the two, each with
    // its own running (m, l, acc) of the same 64 rows.  Both wait for every
    // stage and hand every stage back (a parity wait tells a phase only
    // from the one before it, so no consumer may let a stage's phases run
    // ahead of it); only the tile's own consumer computes on it.
    setmaxnreg_inc<WS_CONSUMER_REGS>();
    const int w_q0 = q_start + (warp % 4) * 16;
    float acc[ND * 4];
#pragma unroll
    for (int j = 0; j < ND * 4; ++j) acc[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};
    float s[NK * 4];
    mbar_wait(qfull, 0);
    for (int i = 0; i < tiles.n; ++i) {
      const int st = i % WS_STAGES;
      mbar_wait(&full[st], (i / WS_STAGES) & 1);
      if (i % WS_CONSUMERS == wg) {
        // s = Q K^T: both K-major operands in shared memory, 16 of D per
        // product
        const bf16* kt = ks + st * BK * D;
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int at = (kd / 4) * 64 * 64 + (kd % 4) * 16;
          wgmma_m64n64_ss_kmajor(s, sw128_desc(qs + at, 16), sw128_desc(kt + at, 16),
                                 kd > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers<NK * 4>(s);
        softmax_pv<D>(p, tiles.tile(i) * BK, w_q0, s, acc, m, l, vs + st * BK * D);
      }
      mbar_arrive(&empty[st]);
    }

    // merge the consumers' partials of the same rows: the second hands its
    // (acc, m, l) over through the ring, free once both walks are done
    // ([ND * 4 + 4][128] floats, a column per thread), the first combines
    // them by log-sum-exp and writes the rows
    float* xch = reinterpret_cast<float*>(ks);
    const int tid = threadIdx.x % 128;
    fence_proxy_async();
    bar_sync(WS_MERGE_BAR, 128 * WS_CONSUMERS);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < ND * 4; ++j) xch[j * 128 + tid] = acc[j];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xch[(ND * 4 + r) * 128 + tid] = m[r];
        xch[(ND * 4 + 2 + r) * 128 + tid] = l[r];
      }
    }
    bar_sync(WS_MERGE_BAR, 128 * WS_CONSUMERS);
    if (wg == 0) {
      float c0[2], c1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xch[(ND * 4 + r) * 128 + tid];
        const float mx = fmaxf(m[r], m1);
        c0[r] = fast_exp2(m[r] - mx);
        c1[r] = fast_exp2(m1 - mx);
        l[r] = l[r] * c0[r] + xch[(ND * 4 + 2 + r) * 128 + tid] * c1[r];
      }
#pragma unroll
      for (int j = 0; j < ND * 4; ++j) {
        const int r = (j % 4) / 2;      // C fragment e: row g (e < 2) or g + 8
        acc[j] = acc[j] * c0[r] + xch[j * 128 + tid] * c1[r];
      }
      bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
      store_rows<ND>(p, o, w_q0, acc, l, nt);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 past the classes: head widths past 256, and rows past 128 that are
// not whole aligned 16-byte chunks (TMA needs 16-byte global strides)
// ---------------------------------------------------------------------------

constexpr int SL_WIDTH = 256;         // output columns of a slice
constexpr int SL_CHUNK = 64;          // columns of Q and K a score step reads

constexpr int sliced_smem_bytes() {
  // two stages of a Q and a K chunk, then the V slice, all bf16
  return static_cast<int>(sizeof(bf16)) * (2 * 2 * BQ * SL_CHUNK + BK * SL_WIDTH);
}

// One warpgroup owns 64 query rows and one slice of SL_WIDTH output columns
// (the grid's third axis is query tile x slice).  Q.K^T runs over all of D
// in chunks of 64 columns, Q's and K's chunk staged together through a
// two-stage cp.async ring (copy_chunk: any alignment, zeros past D and past
// the rows) and multiplied from shared memory (wgmma SS); the slice of V
// lands once a tile beside them, and P.V (softmax_pv<256>, the
// warp-specialised kernel's consumer step) runs on it alone.  A slice
// recomputes the scores: at D = 512 two slices do 1.5 times the products of
// one pass, at 1024 four do 2.5 times, and Q is read again for every KV tile
// (from L2).  No bound on D: shared memory (64 KiB) and registers (the
// 128-register accumulator of a 256-column slice) do not grow with it.
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_attention_sliced(const Params p) {
  using namespace mma_sm90;
  constexpr int ND = SL_WIDTH / 8;    // n8 blocks of the slice's accumulator
  constexpr int NK = BK / 8;
  constexpr int QK = BQ * SL_CHUNK;   // elements of a Q or K chunk
  extern __shared__ __align__(1024) unsigned char fa_sl_smem[];
  bf16* ring = reinterpret_cast<bf16*>(fa_sl_smem);   // [2][Q chunk | K chunk]
  bf16* vs = ring + 2 * 2 * QK;                        // [BK x SL_WIDTH]

  const int tid = threadIdx.x, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (p.H / p.Kv);
  const int n_sl = (p.D + SL_WIDTH - 1) / SL_WIDTH;
  const int sl = blockIdx.z % n_sl;
  // the query tile is the grid's slowest axis, last tile first
  const int q_start = (gridDim.z / n_sl - 1 - blockIdx.z / n_sl) * BQ;
  const int c0 = sl * SL_WIDTH;
  const int n_ch = (p.D + SL_CHUNK - 1) / SL_CHUNK;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + c0;

  // rows [start, start + 64) and columns [col, col + 8 nc) of an (S, D)
  // operand into 64-column SW128 blocks, zeros past `limit` and past D
  auto load = [&](bf16* dst, const bf16* src, long long ss, int start, int limit,
                  int col, int nc) {
    for (int i = tid; i < 64 * nc; i += MMA_THREADS) {
      const int r = i / nc, c = i % nc, s = start + r;
      copy_chunk(dst + sw128_index<64>(r, c), src + (s < limit ? s * ss : 0),
                 col + c * 8, p.D, s < limit, p.align);
    }
  };
  auto load_chunk = [&](int st, int k0, int ch) {
    load(ring + st * 2 * QK, q, p.q_ss, q_start, p.Sq, ch * SL_CHUNK, SL_CHUNK / 8);
    load(ring + st * 2 * QK + QK, k, p.k_ss, k0, p.Skv, ch * SL_CHUNK, SL_CHUNK / 8);
  };

  const TileRange tiles(p, q_start, BQ);
  float acc[ND * 4];
#pragma unroll
  for (int j = 0; j < ND * 4; ++j) acc[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float s[NK * 4];
  const int w_q0 = q_start + warp * 16;
  for (int t = 0; t < tiles.n; ++t) {
    const int k0 = tiles.tile(t) * BK;
    load(vs, v, p.v_ss, k0, p.Skv, c0, SL_WIDTH / 8);
    load_chunk(0, k0, 0);
    cp_async_commit();
    for (int ch = 0; ch < n_ch; ++ch) {
      if (ch + 1 < n_ch) load_chunk((ch + 1) % 2, k0, ch + 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();        // chunk ch landed (with the first, the V slice)
      const bf16* qt = ring + (ch % 2) * 2 * QK;
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < SL_CHUNK / 16; ++kd)
        wgmma_m64n64_ss_kmajor(s, sw128_desc(qt + kd * 16, 16),
                               sw128_desc(qt + QK + kd * 16, 16), ch > 0 || kd > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers<NK * 4>(s);
      __syncthreads();        // stage ch % 2 is read by all
    }
    softmax_pv<SL_WIDTH>(p, k0, w_q0, s, acc, m, l, vs);
    __syncthreads();          // the V slice is read by all
  }
  cp_async_wait<0>();
  store_rows<ND, true>(p, o, w_q0, acc, l, min(SL_WIDTH, p.D - c0));
}

// cuTensorMapEncodeTiled, from libcuda through the runtime's entry-point
// query (the library links the runtime alone); null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a (B, S, heads, D) bf16 tensor (strides in elements,
// D's 1) in 64 x 64 boxes (one row chunk of 128 bytes, 64 rows of one head
// and batch) under the 128-byte swizzle, rows past S and columns past D
// zero-filled; false where libcuda refuses it.  A dimension of extent 1 is
// never stepped: it gets a stride TMA accepts whatever the tensor's own.
bool tile_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D,
              long long sb, long long ss, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  strides[0] = heads > 1 ? sh * e : D * e;
  strides[1] = S > 1 ? ss * e : strides[0] * heads;
  strides[2] = B > 1 ? sb * e : strides[1] * S;
  const cuuint32_t box[4] = {64, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;    // 16 x 16 thread grid

inline size_t smem_bytes(int D) {
  // qs [BQ][D+1], ks [BK][D+1], vs [BK][D], ps [BQ][BK+1], all fp32
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// DC: the width class (64, 128 or 256) that sizes each thread's output
// columns; the head width p.D <= DC bounds every loop at run time.
template <int DC>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32(const Params p) {
  const int D = p.D;
  const int DP = D + 1;         // padded rows: column reads hit 16 banks
  constexpr int PP = BK + 1;
  constexpr int NJ = DC / 16;   // output columns per thread (below D)
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int s = q_start + r;
    qs[r * DP + c] = s < p.Sq ? q[s * p.q_ss + c] : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const TileRange tiles(p, q_start, BQ);
  for (int t = 0; t < tiles.n; ++t) {
    const int k_start = tiles.tile(t) * BK;
    __syncthreads();            // the previous tile's ks / vs / ps are read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int s = k_start + r;
      const bool in = s < p.Skv;
      ks[r * DP + c] = in ? k[s * p.k_ss + c] : 0.f;
      vs[r * D + c] = in ? v[s * p.v_ss + c] : 0.f;
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
      const VisibleKeys visible(p, q_start + r);
      float row_max = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float x = visible(k_start + tx + 16 * jj) ? sc[i][jj] * p.scale
                                                        : NEG_INF;
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
    __syncthreads();            // ps complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        vv[j] = tx + 16 * j < D ? vs[c * D + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + ty + 16 * i;
    if (qpos < p.Sq) {
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < D) o[qpos * p.o_ss + tx + 16 * j] = acc[i][j] / denom;
    }
  }
}

// fp32 past 256: the scalar kernel's form with its output columns in
// slices of F32_WIDTH (the grid's third axis is batch x slice) and Q.K^T
// over D in chunks of F32_CHUNK, Q's and K's chunk read into shared memory
// at each KV tile (so nothing grows with D).
constexpr int F32_WIDTH = 256;
constexpr int F32_CHUNK = 64;

inline size_t f32_sliced_smem_bytes() {
  // qs [BQ][F32_CHUNK+1], ks [BK][F32_CHUNK+1], vs [BK][F32_WIDTH], ps [BQ][BK+1]
  return sizeof(float) * (BQ * (F32_CHUNK + 1) + BK * (F32_CHUNK + 1) +
                          BK * F32_WIDTH + BQ * (BK + 1));
}

__global__ void __launch_bounds__(THREADS)
flash_attention_f32_sliced(const Params p) {
  constexpr int CP = F32_CHUNK + 1;   // padded chunk rows
  constexpr int PP = BK + 1;
  constexpr int NJ = F32_WIDTH / 16;
  extern __shared__ float smem_sl[];
  float* qs = smem_sl;
  float* ks = qs + BQ * CP;
  float* vs = ks + BK * CP;
  float* ps = vs + BK * F32_WIDTH;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_sl = (p.D + F32_WIDTH - 1) / F32_WIDTH;
  const int h = blockIdx.y, b = blockIdx.z / n_sl, sl = blockIdx.z % n_sl;
  const int kvh = h / (p.H / p.Kv);
  const int q_start = blockIdx.x * BQ;
  const int c0 = sl * F32_WIDTH, nc = min(F32_WIDTH, p.D - c0);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + c0;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const TileRange tiles(p, q_start, BQ);
  for (int t = 0; t < tiles.n; ++t) {
    const int k_start = tiles.tile(t) * BK;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int d0 = 0; d0 < p.D; d0 += F32_CHUNK) {
      const int w = min(F32_CHUNK, p.D - d0);
      __syncthreads();          // the previous chunk (and tile's V, P) is read
      for (int i = tid; i < BQ * w; i += THREADS) {
        const int r = i / w, c = i % w;
        const int sq = q_start + r, sk = k_start + r;
        qs[r * CP + c] = sq < p.Sq ? q[sq * p.q_ss + d0 + c] : 0.f;
        ks[r * CP + c] = sk < p.Skv ? k[sk * p.k_ss + d0 + c] : 0.f;
      }
      if (d0 == 0) {
        for (int i = tid; i < BK * F32_WIDTH; i += THREADS) {
          const int r = i / F32_WIDTH, c = i % F32_WIDTH;
          const int s = k_start + r;
          vs[i] = s < p.Skv && c < nc ? v[s * p.v_ss + c0 + c] : 0.f;
        }
      }
      __syncthreads();
      for (int d = 0; d < w; ++d) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * CP + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = ks[(tx + 16 * jj) * CP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(a[i], bv[jj], sc[i][jj]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const VisibleKeys visible(p, q_start + r);
      float row_max = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float x = visible(k_start + tx + 16 * jj) ? sc[i][jj] * p.scale
                                                        : NEG_INF;
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
    __syncthreads();            // ps complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[c * F32_WIDTH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + ty + 16 * i;
    if (qpos < p.Sq) {
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < nc) o[qpos * p.o_ss + tx + 16 * j] = acc[i][j] / denom;
    }
  }
}

// `asked`: the wrapper's number (flash_attention.py smem_bytes); a launch
// whose number is not the kernel's is refused.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, int asked,
                   const Params& p, cudaStream_t stream) {
  if (asked != smem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch_f32(const Params& p, int asked, cudaStream_t s) {
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  return launch(flash_attention_f32<DC>, grid, THREADS,
                static_cast<int>(smem_bytes(p.D)), asked, p, s);
}

template <int D, int DT, bool LOOSE = false>
cudaError_t launch_mma(const Params& p, int asked, cudaStream_t s) {
  const dim3 grid(p.H, p.B, (p.Sq + BQ - 1) / BQ);
  return launch(flash_attention_mma<D, DT, LOOSE>, grid, MMA_THREADS,
                mma_smem_bytes<D>(), asked, p, s);
}

cudaError_t launch_sliced(const Params& p, int asked, cudaStream_t s) {
  const int n_sl = (p.D + SL_WIDTH - 1) / SL_WIDTH;
  const dim3 grid(p.H, p.B, (p.Sq + BQ - 1) / BQ * n_sl);
  return launch(flash_attention_sliced, grid, MMA_THREADS, sliced_smem_bytes(),
                asked, p, s);
}

cudaError_t launch_f32_sliced(const Params& p, int asked, cudaStream_t s) {
  const int n_sl = (p.D + F32_WIDTH - 1) / F32_WIDTH;
  if (static_cast<long long>(p.B) * n_sl > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B * n_sl);
  return launch(flash_attention_f32_sliced, grid, THREADS,
                static_cast<int>(f32_sliced_smem_bytes()), asked, p, s);
}

template <int D, int DT>
cudaError_t launch_ws(const Params& p, int asked, cudaStream_t s) {
  constexpr int smem = ws_smem_bytes<D>();
  if (asked != smem) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb, p.q_ss, p.q_sh) ||
      !tile_map(&tk, p.k, p.B, p.Skv, p.Kv, p.D, p.k_sb, p.k_ss, p.k_sh) ||
      !tile_map(&tv, p.v, p.B, p.Skv, p.Kv, p.D, p.v_sb, p.v_ss, p.v_sh))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_ws<D, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Sq + BQ - 1) / BQ);
  flash_attention_ws<D, DT><<<grid, WS_THREADS, smem, s>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor cores).
// head_dim: any width >= 1.  smem: the dynamic shared memory the wrapper
// computed.  align: a power of two (2 to 16) dividing the byte address of
// every row start of q, k and v and head_dim times the element size; below
// 16 a bf16 input runs the kernels that copy at any alignment.  Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    int dtype, int head_dim,
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int Kv, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int prefix_len, float scale, void* stream,
    int smem, int align) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.Kv = Kv; p.Sq = Sq; p.Skv = Skv;
  p.D = head_dim;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.prefix_len = prefix_len;
  p.scale = scale;
  p.align = align;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int unit = dtype == 0 ? 4 : 2;
  if (head_dim < 1 || Kv <= 0 || H % Kv != 0 || align < unit || align > 16 ||
      (align & (align - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {     // scalar loads: any alignment
    if (head_dim <= 64) return launch_f32<64>(p, smem, s);
    if (head_dim <= 128) return launch_f32<128>(p, smem, s);
    if (head_dim <= 256) return launch_f32<256>(p, smem, s);
    return launch_f32_sliced(p, smem, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (align < 16 || head_dim > 256) {   // rows that are not whole aligned chunks
    if (head_dim > 128) return launch_sliced(p, smem, s);
    if (head_dim <= 64) return launch_mma<64, 0, true>(p, smem, s);
    return launch_mma<128, 0, true>(p, smem, s);
  }
  switch (head_dim) {   // the served models' widths keep their own code
    case 64: return launch_mma<64, 64>(p, smem, s);
    case 112: return launch_mma<128, 112>(p, smem, s);
    case 120: return launch_mma<128, 120>(p, smem, s);
    case 128: return launch_mma<128, 128>(p, smem, s);
    case 256: return launch_ws<256, 256>(p, smem, s);
    default: break;
  }
  if (head_dim <= 64) return launch_mma<64, 0>(p, smem, s);
  if (head_dim <= 128) return launch_mma<128, 0>(p, smem, s);
  if (head_dim <= 192) return launch_ws<192, 0>(p, smem, s);
  return launch_ws<256, 0>(p, smem, s);
}
