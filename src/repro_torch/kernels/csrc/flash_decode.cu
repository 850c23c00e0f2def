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
// times.  Here one block owns (batch, kv head, split) and holds the query
// heads that share that kv head (up to a group tile of them), so each K/V
// row is read once a tile.  At batch 1 with 8 kv heads there would be only
// 8 blocks for 132 SMs, so the work is split; the splits are merged by
// log-sum-exp in the same launch.  The cache
// is read in the model layout (B, S, Kv, D) through strides, so there is no
// per-step transposed copy of the cache.
//
// What bounds it.  Decode does about G flops per byte it reads (4 for
// llama3.2-1b), far below the H100's 295 flop/byte balance point, so the
// bound is bytes: the K/V rows of the tiles that hold a valid slot.  At the
// sizes decode runs (600 valid slots of 2048, 1.2 MB) that bound is well
// under a microsecond, so what the launch really costs is latency: the mask
// read, one round trip for the tiles, the merge.  The design:
//
// * Only tiles that hold data are read.  S is cut into tiles of 64 slots.
//   Every block first reads its batch row of the mask (16-byte loads, one
//   tile per thread, a ballot per 32 tiles) and compacts the tiles that hold
//   at least one valid slot into a list in shared memory.  Masked slots
//   score the finite -1e30 of the TPU kernel, so in a row with a valid slot
//   a fully masked tile has weight exp(-1e30 - m) = 0 exactly in fp32, and
//   skipping it changes no bit.  A row with no valid slot at all averages V
//   over every slot (the reference's result), so there the list is every
//   tile.  The blocks of a (batch, kv head) divide the listed tiles among
//   themselves, whole tiles each, so no block walks only masked slots.  The
//   split count is chosen on the host from (B, Kv, S) and the SM count; the
//   mask is never read back to the host.
// * Whole tiles move.  A tile's K and V rows go into shared memory through
//   16-byte cp.async, double-buffered, so tile t + 1 is in flight while tile
//   t is computed.  Each warp takes 16 slots of a tile and keeps its own
//   online softmax (one max and one rescale per 16 slots, not per key).  In
//   bf16 a block's query heads (a group tile, below) are the rows of
//   mma.sync.m16n8k16, padded to 16, for both Q.K^T (K through ldmatrix) and
//   P.V (V through ldmatrix.trans; P rounded to bf16, l summed from the
//   unrounded P, as the prefill kernel does).  fp32 stays on scalar FMAs
//   from shared memory.
// * One launch.  Each block writes its split's (m, l, acc) to fp32 scratch
//   and takes a ticket from a per-(batch, kv head) counter; the last block
//   to arrive merges the splits in split order, so the result is the same
//   every run, and sets the counter back to 0 for the next launch.  The
//   ticket is the only atomic: no sum goes through one.
// * Slot shards.  A cache sharded over its slots (context-parallel decode)
//   is attended shard by shard and merged by the same log-sum-exp rule
//   across devices.  So the merging block can also write each row's
//   log-sum-exp, mx + log(sum of l), and the output in fp32, to be cast
//   once after the cross-shard merge.  Both are written only by the merge:
//   the tile loop is the same with or without them.
//
// Element types: float and bfloat16 (math in fp32).  Head widths: every
// D >= 1.  Rows of whole aligned 16-byte chunks up to 256 run width classes
// (a class is the shared row pitch and the most k16 steps; the head width D
// rides beside it): bf16 rows in 64, 128, 192 or 256 elements (whole
// 8-chunk swizzle groups), fp32 the classes 64, 128 and 256 of each lane's
// columns lane + 32 j below D.  The served models' bf16 widths (64, 112,
// 120, 128, 256) at G <= 8 keep their own instantiations, whose constants
// fold the run-time bounds into the code they had; any other shape runs
// its class's, which reads D at run time.  The chunks past a row are never
// loaded; where D / 8 is odd, the last k16 step of Q.K^T takes one chunk
// past the row: Q's fragment is zero there and K's chunk is set to zero
// once, so the scores stay exact, and P.V's last 8 columns land in an
// accumulator block that is never written out.  fp32 rows wider than 128
// take one ring stage (two would pass the 200 KiB this kernel allows
// itself at 256), so the next tile is loaded after this one is done.  The
// bf16 kernels past 192 (the class of 256) turn both products around so
// that no accumulator row is padding: S^T = K Q^T puts a warp's 16 slots
// on the m16 rows and 8 heads on the n8 columns (Q^T's B fragments, 32
// registers for all of D), and O^T = V^T P^T puts the head width on the
// rows (V^T through ldmatrix.trans), P^T's B fragments coming from the
// score fragments by one movmatrix transpose per 8 slots.  The padded
// form's accumulator took 128 registers at 256, half of them padding, and
// the thread 255 with a 16-byte spill; the transposed one takes 64 (a
// warp's 16 slots into all 256 columns).  Its query rows reach shared
// memory by asynchronous copies that the mask scan does not wait for,
// where 64 scalar loads a thread had held the scan up.  Tiles stay 64
// slots: 32-slot tiles (two warps' column halves per group of 16 slots)
// give 19 blocks instead of 10 at 600 valid slots of 2048, but measured
// slower on the H100, the last block merging twice the partials.
//
// Other rows (mode ANY: D off whole 16-byte chunks, a view whose base or
// strides are not 16-byte multiples, fp32 rows below 8 floats) run the
// classes' kernels with copy_chunk's copies (mma_sm90.cuh) at the largest
// of 16, 8, 4 and 2 bytes that divides them, into the same tiles (fp32 rows
// padded to whole chunks), every chunk of every stage written whole, so
// the elements past D and the slots past S read as zero; the partials'
// rows are padded to whole float4s and the output is stored an element at
// a time.  Past 256 (mode SLICED, both dtypes, any alignment) the output
// columns go in slices of 256 on the grid (kv head x group tile x slice):
// a block's scores run over all of D in chunks of 256 columns of K and of
// its query rows through one ring stage, then P.V over its slice of V (the
// wide form's products in bf16), so nothing grows with D; each slice
// re-reads K (from L2 after the first) and writes its own m and l.
//
// Query groups: any G = H / Kv.  A block holds a group tile of one kv
// head's query heads, and a kv head's G heads take ceil(G / tile) blocks
// (the grid's second coordinate is kv head x group tile), each with its
// own splits, partials and arrival counter; every tile re-reads the head's
// K/V tiles, from L2 after the first.  The tile is 16 heads on the bf16
// classes up to 192 (the 16 rows of mma.sync.m16n8k16), and 8 elsewhere:
// the served widths' own kernels, the class of 256 (8 n8 columns) and fp32
// (two 16-lane halves of 4 heads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 64;                  // cache slots per tile
constexpr int WARP_KEYS = TILE / WARPS;   // slots of a tile per warp
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;                // (B, 1, H, D)
  const void* k;                // (B, S, Kv, D)
  const void* v;
  const uint8_t* valid;         // (B, S), nonzero = valid
  void* o;                      // (B, 1, H, D)
  float* part;                  // (B * H, splits, D) acc, then (B * H, splits) m, then l
  int* tickets;                 // (B * Kv * group tiles), zero between launches
  int B, H, Kv, S, D, splits, n_tiles, vec_mask;
  long long q_sb, q_sh;         // strides in elements; the D stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long valid_sb;           // the S stride is 1
  long long o_sb, o_sh;
  float scale;
  float* lse;                   // (B, H) log-sum-exp of the scaled scores, or null
  int o_f32;                    // the output in fp32 (else T)
  int align;                    // bytes dividing every q, k, v row start and D x the element
};

// How a kernel copies rows: WHOLE, in aligned 16-byte chunks (every width
// the served models take); ANY, at any alignment (copy_chunk), the partial
// buffer's rows padded to 4 floats; SLICED, past 256: the output columns in
// slices of 256 on the grid, each block's scores over all of D in chunks of
// 256 (the same copies as ANY).
constexpr int WHOLE = 0, ANY = 1, SLICED = 2;

// The kernel of element type T, width class DC, head width DT (0: the
// class's, read from p.D at run time) and copy mode MODE.  bf16 at DC = 256
// is the wide form (a slice of SLICED too).
template <typename T, int DC>
__host__ __device__ constexpr bool wide() {
  return std::is_same<T, bf16>::value && DC == 256;
}

// Query heads of one kv head a block holds: the served widths' kernels 8,
// the narrow bf16 classes 16 (the m16 rows of the products), the wide form
// 8 (its n8 columns), fp32 8 (two halves of a warp, 4 each).
template <typename T, int DC, int DT>
__host__ __device__ constexpr int group_tile() {
  return std::is_same<T, bf16>::value && !wide<T, DC>() && DT == 0 ? 16 : 8;
}

// Stages of the K/V ring: two, or one for fp32 rows past 128 (two tiles of
// K and V would pass 160 KiB at 256) and for slices (a K chunk and the V
// slice).
template <typename T, int DC, int MODE>
__host__ __device__ constexpr int ring_stages() {
  return (std::is_same<T, float>::value && DC > 128) || MODE == SLICED ? 1 : STAGES;
}

// The K/V ring's bytes at head width D: bf16 rows and slices take the class
// width (whole 8-chunk swizzle groups), fp32 rows D (ANY: D rounded up to 4,
// whole 16-byte chunks).
template <typename T, int DC, int MODE>
__host__ __device__ int ring_bytes(int D) {
  const int pitch = std::is_same<T, bf16>::value || MODE == SLICED ? DC
                    : MODE == ANY ? (D + 3) / 4 * 4 : D;
  return ring_stages<T, DC, MODE>() * 2 * TILE * pitch * static_cast<int>(sizeof(T));
}

// Dynamic shared memory: the K/V ring, then the tile bitmap and the list,
// and at least the last block's per-split weights and sums ([group tile]
// [splits] each), which reuse the ring and the list once the tiles are done.
template <typename T, int DC, int DT, int MODE>
size_t smem_bytes(int D, int splits, int n_tiles) {
  const int merge = 8 * group_tile<T, DC, DT>() * splits;
  const int ring = ring_bytes<T, DC, MODE>(D);
  const int n_words = (n_tiles + 31) / 32;
  return static_cast<size_t>(ring > merge ? ring : merge) +
         4 * static_cast<size_t>(n_words + n_tiles);
}

// Blocks an SM must hold: three for the narrow bf16 kernels up to 128 (at
// most 168 registers a thread), so a grid of up to 396 blocks (zamba2-7b's
// 32 kv heads x 9 splits) runs in one wave.
template <typename T, int DC, int DT, int MODE>
__host__ __device__ constexpr int min_blocks() {
  return std::is_same<T, bf16>::value && !wide<T, DC>() && DC <= 128 && MODE != SLICED ? 3 : 1;
}

// The last block's merge: N4 float4 of the output a thread, MERGE splits'
// accumulators in flight at once, at most 32 float4 (the served widths'
// kernels), at most 16 in a class (registers for its three blocks an SM).
template <int N4, int DT>
__host__ __device__ constexpr int merge_depth() {
  return DT ? (N4 <= 4 ? 8 : 32 / N4) : (N4 >= 16 ? 1 : 16 / N4 > 8 ? 8 : 16 / N4);
}

// SLICED: columns [col0, col0 + DC) of a tile's K rows into ks (one ring
// stage: bf16 rows swizzled, fp32 at pitch DC) and of the block's query
// rows into qrows (pitch QP; rows past Gt zero), zeros past D and past S;
// the caller commits and waits.  A function of its own: as a lambda in
// the kernel, even unused, it changed the whole-chunk kernels' code.
template <typename T, int DC, int GT, int QP>
__device__ __forceinline__ void load_chunk(T* ks, T* qrows, const T* k, const T* q,
                                           const Params& p, int tile, int col0, int Gt) {
  using namespace mma_sm90;
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr int EPC = 16 / static_cast<int>(sizeof(T)), RC = DC / EPC;
  for (int i = threadIdx.x; i < TILE * RC; i += THREADS) {
    const int r = i / RC, c = i % RC, s = tile * TILE + r;
    copy_chunk(ks + (BF16 ? swizzle<DC / 8>(r, c) : r * DC + c * EPC),
               k + (s < p.S ? s * p.k_ss : 0), col0 + c * EPC, p.D, s < p.S, p.align);
  }
  if constexpr (BF16) {
    for (int i = threadIdx.x; i < GT * RC; i += THREADS) {
      const int g = i / RC, c = i % RC;
      copy_chunk(qrows + g * QP + c * EPC, q + (g < Gt ? g * p.q_sh : 0), col0 + c * EPC,
                 p.D, g < Gt, p.align);
    }
  } else {
    for (int i = threadIdx.x; i < GT * DC; i += THREADS) {
      const int g = i / DC, d = i % DC;
      qrows[g * QP + d] = g < Gt && col0 + d < p.D ? q[g * p.q_sh + col0 + d] : 0.f;
    }
  }
}

template <typename T, int DC, int DT, int MODE>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, DC, DT, MODE>()))
flash_decode_kernel(const Params p) {
  using namespace mma_sm90;
  static_assert(MODE == WHOLE || DT == 0, "the served widths copy whole chunks");
  static_assert(MODE != SLICED || DC == 256, "slices of 256 columns");
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));      // elements per chunk
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr bool WIDE = wide<T, DC>();                       // the transposed products
  constexpr bool LOOSE = MODE != WHOLE;                      // copy_chunk's copies
  constexpr bool SL = MODE == SLICED;
  // a class's narrow bf16 kernel: Q by cp.async and ldmatrix (16 rows of
  // scalar loads a thread would hold the mask scan up)
  constexpr bool QN = BF16 && !WIDE && DT == 0;
  constexpr int GT = group_tile<T, DC, DT>();                // heads a block holds
  constexpr int RH = BF16 && !WIDE ? GT / 8 : 1;             // narrow: row halves held
  constexpr int SW = DC / 8;                                 // bf16: swizzled row chunks
  constexpr int NJ = DC / 32;                                // fp32: columns per lane, at most
  // bf16 k16 steps: a width's own (at 120 the last reads one zero chunk);
  // a class's all of the row, its chunks past the head width zero
  constexpr int KQ = DT ? (DT + 15) / 16 : DC / 16;
  constexpr int ST = ring_stages<T, DC, MODE>();             // K/V ring stages
  constexpr int WIDE_MT = DC / 16;                           // wide: m16 tiles of P.V
  const int D = DT ? DT : p.D;                               // the head width
  // chunks per row (ANY: the last one may be partial)
  const int CH = LOOSE ? (D * static_cast<int>(sizeof(T)) + 15) / 16
                       : D * static_cast<int>(sizeof(T)) / 16;
  // shared row pitch; ANY fp32 rows padded to whole chunks
  const int DP = BF16 || SL ? DC : LOOSE ? (D + 3) / 4 * 4 : D;
  // SLICED: this block's slice of the output columns [c0, c0 + DV)
  const int n_sl = SL ? (D + DC - 1) / DC : 1;
  const int si = SL ? static_cast<int>(blockIdx.y) % n_sl : 0;
  const int c0 = si * DC;
  const int DV = SL ? min(DC, D - c0) : D;
  // the pitch of the warps' accumulators and of the partials' rows (ANY:
  // whole float4s)
  const int WP = LOOSE ? (DV + 3) / 4 * 4 : D;
  const int PP = LOOSE ? (D + 3) / 4 * 4 : D;
  // the loops over a row's chunks and a block's columns step by the class
  // (constant divisors), the rest masked
  const int row_chunks = DT ? CH : DC * static_cast<int>(sizeof(T)) / 16;
  const int row_cols = DT ? D : DC;
  extern __shared__ __align__(128) unsigned char fd_smem[];
  T* ring = reinterpret_cast<T*>(fd_smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(fd_smem + ring_bytes<T, DC, MODE>(D));
  const int n_words = (p.n_tiles + 31) / 32;
  int* list = reinterpret_cast<int*>(words + n_words);
  // the merge of the warps reuses the ring once the tiles are done
  float* wacc = reinterpret_cast<float*>(fd_smem);          // [WARPS][GT][WP]
  __shared__ float wm[WARPS][GT], wl[WARPS][GT];
  __shared__ float qs[BF16 ? 1 : GT][BF16 ? 1 : DC];        // fp32: the query rows
  __shared__ float ps[BF16 ? 1 : WARPS][GT][WARP_KEYS];     // fp32: a warp's P
  __shared__ float rowc[BF16 ? 1 : WARPS][3][GT];           // fp32: m, corr, sum
  // wide: the GT query rows, each padded by 16 bytes so the eight rows one
  // ldmatrix matrix reads lie in distinct bank groups; a class's narrow
  // kernel the same for its A fragments
  __shared__ __align__(16) bf16 qw[WIDE || QN ? GT : 1][WIDE || QN ? DC + 8 : 8];
  __shared__ int s_n, s_last;

  // blockIdx.y: a kv head's group tiles, GT of its G query heads each (the
  // served widths' kernels run at G <= GT: one tile)
  const int split = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.H / p.Kv;
  const int n_gt = DT ? 1 : (G + GT - 1) / GT;
  const unsigned by = SL ? blockIdx.y / n_sl : blockIdx.y;   // kv head x group tile
  const int kvh = by / n_gt, g0 = (by % n_gt) * GT;
  const int Gt = min(GT, G - g0);             // query heads of this block
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (kvh * G + g0) * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* valid = p.valid + b * p.valid_sb;

  // The query rows: bf16 as mma A fragments (rows g < Gt, the rest zero), fp32
  // into shared memory; issued first, so they arrive during the scan.  Wide
  // and a class's narrow kernel, into shared memory by 16-byte asynchronous
  // copies (rows g >= Gt and the chunks past the row zero), which the scan
  // does not wait for; the B fragments of Q^T (wide) or the A fragments are
  // read from there once the first tile has landed.
  uint32_t qa[BF16 && !WIDE ? KQ : 1][4];
  uint32_t qb[WIDE && !SL ? KQ : 1][2];
  if constexpr (SL) {
    // slices read Q a chunk at a time beside K's (below)
  } else if constexpr (WIDE || QN) {
    constexpr int QCH = 2 * KQ;
    for (int i = tid; i < GT * QCH; i += THREADS) {
      const int g = i / QCH, c = i % QCH;
      if constexpr (LOOSE) {
        copy_chunk(&qw[g][c * EPC], q + (g < Gt ? g * p.q_sh : 0), c * EPC, D, g < Gt,
                   p.align);
      } else {
        const bool in = g < Gt && c < CH;
        cp_async16(&qw[g][c * EPC], in ? q + g * p.q_sh + c * EPC : q, in ? 16 : 0);
      }
    }
    cp_async_commit();
  } else if constexpr (BF16) {     // the served widths: rows g < 8
    const int g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < Gt) {
        const T* qr = q + g * p.q_sh + kk * 16 + c;
        f[0] = to_float(qr[0]);
        f[1] = to_float(qr[1]);
        if (D % 16 == 0 || kk * 16 + 8 < D) {   // columns past D stay zero
          f[2] = to_float(qr[8]);
          f[3] = to_float(qr[9]);
        }
      }
      qa[kk][0] = pack_bf16x2(f[0], f[1]);
      qa[kk][1] = 0u;
      qa[kk][2] = pack_bf16x2(f[2], f[3]);
      qa[kk][3] = 0u;
    }
  } else {
    for (int i = tid; i < GT * DC; i += THREADS) {
      const int g = i / DC, d = i % DC;
      if (d < D) qs[g][d] = g < Gt ? to_float(q[g * p.q_sh + d]) : 0.f;
    }
  }

  // 1. The tiles of this batch row that hold a valid slot: one tile per
  //    thread, a ballot per 32 tiles.
  for (int t0 = 0; t0 < n_words * 32; t0 += THREADS) {
    const int t = t0 + tid;
    bool any = false;
    if (t < p.n_tiles) {
      const int s0 = t * TILE, s1 = min(p.S, s0 + TILE);
      if (p.vec_mask && s1 - s0 == TILE) {
        const uint4* m4 = reinterpret_cast<const uint4*>(valid + s0);
        uint32_t acc = 0;
#pragma unroll
        for (int j = 0; j < TILE / 16; ++j) {
          const uint4 x = __ldg(m4 + j);
          acc |= x.x | x.y | x.z | x.w;
        }
        any = acc != 0;
      } else {
        for (int s = s0; s < s1; ++s) any |= __ldg(valid + s) != 0;
      }
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, any);
    const int w = t0 / 32 + warp;
    if (lane == 0 && w < n_words) words[w] = bits;
  }
  __syncthreads();
  if (warp == 0) {      // compact, in tile order
    int n = 0;
    for (int w = 0; w < n_words; ++w) {
      const uint32_t bits = words[w];
      if ((bits >> lane) & 1u) list[n + __popc(bits & ((1u << lane) - 1u))] = w * 32 + lane;
      n += __popc(bits);
    }
    if (n == 0) {       // no valid slot: the row averages V over every slot
      for (int t = lane; t < p.n_tiles; t += 32) list[t] = t;
      n = p.n_tiles;
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();

  // 2. This split's run of listed tiles.
  const int n = s_n;
  const int per = (n + p.splits - 1) / p.splits;
  const int active = (n + per - 1) / per;     // splits that hold a tile
  const int r0 = split * per, r1 = min(n, r0 + per);
  const int row0 = b * p.H + kvh * G + g0;    // first (b, h) row of this block

  if (r0 < r1) {
    auto load_tile = [&](int st, int tile) {
      T* ks = ring + st * 2 * TILE * DP;
      T* vs = ks + TILE * DP;
      // bf16 classes copy every chunk of the shared row, zero-filling
      // those past the head width (so K's add 0 x 0 against Q's zero
      // columns and V's land in columns never stored); fp32 rows are D long
      // (ANY: the last chunk's elements past D zero).  A slice's ring takes
      // its V columns here, K's chunks in the tile's loop.
      for (int i = tid; i < TILE * row_chunks; i += THREADS) {
        const int r = i / row_chunks, c = i % row_chunks;
        const int s = tile * TILE + r;
        const int dst = BF16 ? swizzle<SW>(r, c) : r * DP + c * EPC;
        if constexpr (SL) {
          copy_chunk(vs + dst, v + (s < p.S ? s * p.v_ss : 0), c0 + c * EPC, D, s < p.S,
                     p.align);
        } else if constexpr (LOOSE) {
          if (BF16 || c < CH) {
            copy_chunk(ks + dst, k + (s < p.S ? s * p.k_ss : 0), c * EPC, D, s < p.S,
                       p.align);
            copy_chunk(vs + dst, v + (s < p.S ? s * p.v_ss : 0), c * EPC, D, s < p.S,
                       p.align);
          }
        } else {
          const bool in = s < p.S && (DT != 0 || c < CH);
          if (BF16 || c < CH) {
            cp_async16(ks + dst, in ? k + s * p.k_ss + c * EPC : k, in ? 16 : 0);
            cp_async16(vs + dst, in ? v + s * p.v_ss + c * EPC : v, in ? 16 : 0);
          }
        }
      }
    };
    // per-warp online softmax state: narrow bf16 in mma C layout (rows
    // lane / 4 and + 8), fp32 warp-uniform per row with the columns split
    // over the lanes
    float m_b[2] = {NEG_INF, NEG_INF}, l_b[2] = {0.f, 0.f};
    float acc_b[BF16 && !WIDE ? 2 * KQ : 1][4];
    // wide: per warp the heads 2 (lane % 4) and + 1 over its 16 slots, and
    // the P.V accumulator of its WIDE_MT x 16 columns (C layout: column
    // lane / 4 (+ 8) of each m16 tile, heads 2 (lane % 4) ..)
    float m_w[2] = {NEG_INF, NEG_INF}, l_w[2] = {0.f, 0.f};
    float acc_w[WIDE ? WIDE_MT : 1][4];
#pragma unroll
    for (int i = 0; i < (WIDE ? WIDE_MT : 1); ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_w[i][j] = 0.f;
    float m_f[GT], l_f[GT], acc_f[BF16 ? 1 : GT][BF16 ? 1 : NJ];
#pragma unroll
    for (int i = 0; i < (BF16 && !WIDE ? 2 * KQ : 1); ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_b[i][j] = 0.f;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m_f[g] = NEG_INF;
      l_f[g] = 0.f;
#pragma unroll
      for (int j = 0; j < (BF16 ? 1 : NJ); ++j) acc_f[BF16 ? 0 : g][j] = 0.f;
    }

    if constexpr (BF16 && DT != 0) {      // a class's copies zero-fill instead
      if (CH < 2 * KQ) {
        // K's chunk past an odd row of chunks, read by the last k16 step
        // against Q's zero columns: zero in every stage, so 0 x 0 and never NaN
        for (int i = tid; i < ST * TILE; i += THREADS)
          *reinterpret_cast<uint4*>(ring + (i / TILE) * 2 * TILE * DP +
                                    swizzle<SW>(i % TILE, CH)) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    load_tile(0, list[r0]);
    cp_async_commit();

    if constexpr (QN) {
      cp_async_wait<1>();                     // Q landed (tile 0 may not have)
      __syncthreads();
      // ldmatrix.x4 of rows 0-15 at chunks 2 kk, 2 kk + 1: A's a0..a3
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        ldmatrix_x4(qa[kk], &qw[lane & 15][(kk * 2 + (lane >> 4)) * EPC]);
    }
    if constexpr (WIDE && !SL) {
      cp_async_wait<1>();                     // Q landed (tile 0 may not have)
      __syncthreads();
      // ldmatrix.x4 of rows 0-7 at chunks 2 kk .. 2 kk + 3: the b0, b1 of
      // k16 steps kk and kk + 1
#pragma unroll
      for (int kk = 0; kk < KQ; kk += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, &qw[lane & 7][(kk * 2 + (lane >> 3)) * EPC]);
        qb[kk][0] = r[0];
        qb[kk][1] = r[1];
        qb[kk + 1][0] = r[2];
        qb[kk + 1][1] = r[3];
      }
    }
    for (int i = 0; i < r1 - r0; ++i) {
      if (ST > 1 && r0 + i + 1 < r1) load_tile((i + 1) % ST, list[r0 + i + 1]);
      cp_async_commit();
      cp_async_wait<ST - 1>();
      __syncthreads();                        // tile i landed
      const int tile = list[r0 + i];
      const T* ks = ring + (i % ST) * 2 * TILE * DP;
      const T* vs = ks + TILE * DP;

      if constexpr (WIDE) {
        // S^T = K Q^T: this warp's 16 slots (its key group) are the rows,
        // the GT heads the n8 columns, over all of D
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (SL) {
          // a chunk of 256 columns at a time, Q^T's fragments read from
          // shared memory at each
          for (int ch = 0; ch * DC < D; ++ch) {
            load_chunk<T, DC, GT, DC + 8>(ring, &qw[0][0], k, q, p, tile, ch * DC, Gt);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
#pragma unroll 4
            for (int kk = 0; kk < KQ; kk += 2) {
              uint32_t r[4], a[4];
              ldmatrix_x4(r, &qw[lane & 7][(kk * 2 + (lane >> 3)) * EPC]);
              ldmatrix_x4(a, ks + swizzle<SW>(warp * WARP_KEYS + (lane & 7) +
                                                  (((lane >> 3) & 1) << 3),
                                              kk * 2 + (lane >> 4)));
              mma_bf16(c, a, r[0], r[1]);
              ldmatrix_x4(a, ks + swizzle<SW>(warp * WARP_KEYS + (lane & 7) +
                                                  (((lane >> 3) & 1) << 3),
                                              kk * 2 + 2 + (lane >> 4)));
              mma_bf16(c, a, r[2], r[3]);
            }
            __syncthreads();                  // K's and Q's chunk are read
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KQ; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, ks + swizzle<SW>(warp * WARP_KEYS + (lane & 7) +
                                                (((lane >> 3) & 1) << 3),
                                            kk * 2 + (lane >> 4)));
            mma_bf16(c, a, qb[kk][0], qb[kk][1]);
          }
        }
        // c[e]: slot g (e < 2) or g + 8, head 2 (lane % 4) + (e & 1)
        const int key0 = tile * TILE + warp * WARP_KEYS + lane / 4;
        float s[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e >> 1) * 8;
          // slots past S do not exist: weight exactly 0, even in a row
          // with no valid slot
          s[e] = key >= p.S ? -CUDART_INF_F
                 : __ldg(valid + key) ? c[e] * p.scale : NEG_INF;
        }
        float corr[2], pr[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mt = fmaxf(s[hh], s[hh + 2]);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          const float m_new = fmaxf(m_w[hh], mt);
          corr[hh] = expf(m_w[hh] - m_new);
          pr[hh] = expf(s[hh] - m_new);
          pr[hh + 2] = expf(s[hh + 2] - m_new);
          l_w[hh] = l_w[hh] * corr[hh] + pr[hh] + pr[hh + 2];
          m_w[hh] = m_new;
        }
        // P^T as the B fragments of O^T = V^T P^T: each 8 x 8 block of P
        // (rows slots, columns heads) transposed in registers
        const uint32_t b0 = movmatrix_trans(pack_bf16x2(pr[0], pr[1]));
        const uint32_t b1 = movmatrix_trans(pack_bf16x2(pr[2], pr[3]));
#pragma unroll
        for (int mt = 0; mt < WIDE_MT; ++mt) {
          acc_w[mt][0] *= corr[0];
          acc_w[mt][1] *= corr[1];
          acc_w[mt][2] *= corr[0];
          acc_w[mt][3] *= corr[1];
          uint32_t a[4];
          ldmatrix_x4_trans(a, vs + swizzle<SW>(warp * WARP_KEYS + (lane & 7) +
                                                    ((lane >> 4) << 3),
                                                mt * 2 + ((lane >> 3) & 1)));
          mma_bf16(acc_w[mt], a, b0, b1);
        }
      } else if constexpr (BF16) {
        // scores of this warp's 16 slots, rows = query heads (c[j][0..1]
        // row lane / 4, c[j][2..3] row lane / 4 + 8)
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
          uint32_t r[4];
          ldmatrix_x4(r, ks + swizzle<SW>(
                                  warp * WARP_KEYS + (lane & 7) + ((lane >> 4) << 3),
                                  kk * 2 + ((lane >> 3) & 1)));
          mma_bf16(c[0], qa[kk], r[0], r[1]);
          mma_bf16(c[1], qa[kk], r[2], r[3]);
        }
        const int key0 = tile * TILE + warp * WARP_KEYS + 2 * (lane % 4);
        float s[2][2][2], mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + j * 8 + e;
            // slots past S do not exist: weight exactly 0, even in a row
            // with no valid slot
            const bool in = key < p.S, ok = in && __ldg(valid + key);
#pragma unroll
            for (int h = 0; h < RH; ++h) {
              s[h][j][e] = !in ? -CUDART_INF_F : ok ? c[j][2 * h + e] * p.scale : NEG_INF;
              mt[h] = fmaxf(mt[h], s[h][j][e]);
            }
          }
        float corr[2], pr[2][2][2];
#pragma unroll
        for (int h = 0; h < RH; ++h) {
          mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
          mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
          const float m_new = fmaxf(m_b[h], mt[h]);
          corr[h] = expf(m_b[h] - m_new);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) pr[h][j][e] = expf(s[h][j][e] - m_new);
          l_b[h] = l_b[h] * corr[h] + pr[h][0][0] + pr[h][0][1] + pr[h][1][0] +
                   pr[h][1][1];
          m_b[h] = m_new;
        }
        const uint32_t a[4] = {
            pack_bf16x2(pr[0][0][0], pr[0][0][1]),
            RH > 1 ? pack_bf16x2(pr[1][0][0], pr[1][0][1]) : 0u,
            pack_bf16x2(pr[0][1][0], pr[0][1][1]),
            RH > 1 ? pack_bf16x2(pr[1][1][0], pr[1][1][1]) : 0u};
#pragma unroll
        for (int nb = 0; nb < 2 * KQ; ++nb) {
          acc_b[nb][0] *= corr[0];
          acc_b[nb][1] *= corr[0];
          if (RH > 1) {
            acc_b[nb][2] *= corr[1];
            acc_b[nb][3] *= corr[1];
          }
        }
#pragma unroll
        for (int db = 0; db < KQ; ++db) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vs + swizzle<SW>(
                                        warp * WARP_KEYS + (lane & 7) + (((lane >> 3) & 1) << 3),
                                        db * 2 + (lane >> 4)));
          mma_bf16(acc_b[2 * db], a, r[0], r[1]);
          mma_bf16(acc_b[2 * db + 1], a, r[2], r[3]);
        }
      } else {
        // lane: slot kk of the warp's 16, heads half * 4 .. half * 4 + 3
        const int kk = lane & 15, half = lane >> 4;
        const int key = tile * TILE + warp * WARP_KEYS + kk;
        const float* kr = reinterpret_cast<const float*>(ks) + (warp * WARP_KEYS + kk) * DP;
        float s[4];
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) s[i2] = 0.f;
        if constexpr (LOOSE) {
          // ANY: any width (D may be below 6); SLICED: a chunk at a time,
          // Q's chunk in qs
          for (int ch = 0; ch * (SL ? DC : D) < D; ++ch) {
            const int w = SL ? min(DC, D - ch * DC) : D;
            if constexpr (SL) {
              load_chunk<T, DC, GT, DC>(ring, &qs[0][0], k, q, p, tile, ch * DC, Gt);
              cp_async_commit();
              cp_async_wait<0>();
              __syncthreads();
            }
            for (int dd = 0; dd < w; ++dd) {
              const int d = (dd + kk) % w;      // rotated by the slot, as below
              const float kv = kr[d];   // SLICED: K's chunk (ks is the ring)
#pragma unroll
              for (int i2 = 0; i2 < 4; ++i2) s[i2] = fmaf(qs[half * 4 + i2][d], kv, s[i2]);
            }
            if constexpr (SL) __syncthreads();
          }
        } else {
          for (int dd = 0; dd < D; ++dd) {
            // rotated by the slot: no bank conflict on K (kk < 16 < 3 D)
            int d = dd + kk;
            d -= d >= D ? D : 0;
            d -= d >= D ? D : 0;
            const float kv = kr[d];
#pragma unroll
            for (int i2 = 0; i2 < 4; ++i2) s[i2] = fmaf(qs[half * 4 + i2][d], kv, s[i2]);
          }
        }
        const bool in = key < p.S;
        const bool ok = in && __ldg(valid + key) != 0;
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          const int g = half * 4 + i2;
          float x = !in || g >= Gt ? -CUDART_INF_F : ok ? s[i2] * p.scale : NEG_INF;
          float mt = x;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          const float m_old = half ? m_f[4 + i2] : m_f[i2];
          const float m_new = fmaxf(m_old, mt);
          const float pv = expf(x - m_new);
          float sum = pv;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          ps[warp][g][kk] = pv;
          if (kk == 0) {
            rowc[warp][0][g] = m_new;
            rowc[warp][1][g] = expf(m_old - m_new);
            rowc[warp][2][g] = sum;
          }
        }
        __syncwarp();
        const float* vr = reinterpret_cast<const float*>(vs) + warp * WARP_KEYS * DP;
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g < Gt) {                       // uniform across the warp
            const float corr = rowc[warp][1][g];
            m_f[g] = rowc[warp][0][g];
            l_f[g] = l_f[g] * corr + rowc[warp][2][g];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int col = lane + 32 * j;
              if (col >= DV) break;
              float a = acc_f[BF16 ? 0 : g][j] * corr;
#pragma unroll
              for (int kk2 = 0; kk2 < WARP_KEYS; ++kk2)
                a = fmaf(ps[warp][g][kk2], vr[kk2 * DP + col], a);
              acc_f[BF16 ? 0 : g][j] = a;
            }
          }
        }
        __syncwarp();
      }
      __syncthreads();                        // stage i % ST is free
      if (ST == 1 && r0 + i + 1 < r1) load_tile(0, list[r0 + i + 1]);
    }
    cp_async_wait<0>();
    __syncthreads();

    // 3. Merge the warps of this block; write the split's partials.
    if constexpr (WIDE) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          l_w[hh] += __shfl_xor_sync(0xffffffffu, l_w[hh], off);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int g = 2 * (lane % 4) + hh;
        if (g < Gt && lane < 4) {
          wm[warp][g] = m_w[hh];
          wl[warp][g] = l_w[hh];
        }
      }
#pragma unroll
      for (int mt = 0; mt < WIDE_MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 2 * (lane % 4) + (e & 1);
          const int d = mt * 16 + lane / 4 + (e >> 1) * 8;
          if (g < Gt && (DT != 0 || d < DV)) wacc[(warp * GT + g) * WP + d] = acc_w[mt][e];
        }
    } else if constexpr (BF16) {
#pragma unroll
      for (int h = 0; h < RH; ++h) {
        l_b[h] += __shfl_xor_sync(0xffffffffu, l_b[h], 1);
        l_b[h] += __shfl_xor_sync(0xffffffffu, l_b[h], 2);
        const int g = lane / 4 + 8 * h;
        if (g < Gt) {
          if (lane % 4 == 0) {
            wm[warp][g] = m_b[h];
            wl[warp][g] = l_b[h];
          }
#pragma unroll
          for (int nb = 0; nb < 2 * KQ; ++nb) {
            if constexpr (LOOSE) {
              const int d = nb * 8 + 2 * (lane % 4);
              float* dst = wacc + (warp * GT + g) * WP + d;
              if (d < D) dst[0] = acc_b[nb][2 * h];
              if (d + 1 < D) dst[1] = acc_b[nb][2 * h + 1];
            } else if (nb < D / 8) {
              float* dst = wacc + (warp * GT + g) * D + nb * 8 + 2 * (lane % 4);
              dst[0] = acc_b[nb][2 * h];
              dst[1] = acc_b[nb][2 * h + 1];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < Gt) {
          if (lane == 0) {
            wm[warp][g] = m_f[g];
            wl[warp][g] = l_f[g];
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (lane + 32 * j < DV)
              wacc[(warp * GT + g) * WP + lane + 32 * j] = acc_f[BF16 ? 0 : g][j];
        }
      }
    }
    __syncthreads();
    if constexpr (DT == 0) {
      // a class: each row's max, sum and warp weights exp(m_w - max m) once
      // (in wm; the max and sum in wl's first two rows), not per column
      if (tid < Gt) {
        float mx = NEG_INF, ls = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w][tid]);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float wt = expf(wm[w][tid] - mx);
          wm[w][tid] = wt;
          ls += wl[w][tid] * wt;
        }
        wl[0][tid] = mx;
        wl[1][tid] = ls;
      }
      __syncthreads();
    }
    const long long n_rows = (long long)p.B * p.H * p.splits;
    if constexpr (WIDE) {
      // the split's partial, 4 columns a step: each warp's weight in a
      // row, exp(m_w - max m), once a step (GT x D is 8 times the narrow
      // widths' at most); the row's max and sum go out with its first
      // columns
      for (int i = tid; i < (DT ? Gt : GT) * row_cols / 4; i += THREADS) {
        const int g = i / (row_cols / 4), d = 4 * (i % (row_cols / 4));
        if (DT == 0 && (g >= Gt || d >= DV)) continue;
        float mx = NEG_INF;
        if constexpr (DT != 0) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w][g]);
        }
        float ls = 0.f;
        float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float wt = DT ? expf(wm[w][g] - mx) : wm[w][g];
          const float4 a = *reinterpret_cast<const float4*>(wacc + (w * GT + g) * WP + d);
          if (DT != 0) ls += wl[w][g] * wt;
          as.x += a.x * wt;
          as.y += a.y * wt;
          as.z += a.z * wt;
          as.w += a.w * wt;
        }
        if constexpr (DT == 0) {
          mx = wl[0][g];
          ls = wl[1][g];
        }
        const long long row = (long long)(row0 + g) * p.splits + split;
        *reinterpret_cast<float4*>(p.part + row * PP + c0 + d) = as;
        if (d == 0) {
          if constexpr (LOOSE) {    // a slice's m and l rows, n_sl of each
            p.part[n_rows * PP + si * n_rows + row] = mx;
            p.part[n_rows * (PP + n_sl) + si * n_rows + row] = ls;
          } else {
            p.part[n_rows * D + row] = mx;
            p.part[n_rows * (D + 1) + row] = ls;
          }
        }
      }
    } else {
      for (int i = tid; i < (DT ? Gt : GT) * row_cols; i += THREADS) {
        const int g = i / row_cols, d = i % row_cols;
        if (DT == 0 && (g >= Gt || d >= DV)) continue;
        float mx = NEG_INF;
        if constexpr (DT != 0) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w][g]);
        }
        float ls = 0.f, as = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float wt = DT ? expf(wm[w][g] - mx) : wm[w][g];
          if (DT != 0) ls += wl[w][g] * wt;
          as += wacc[(w * GT + g) * WP + d] * wt;
        }
        if constexpr (DT == 0) {
          mx = wl[0][g];
          ls = wl[1][g];
        }
        const long long row = (long long)(row0 + g) * p.splits + split;
        p.part[row * PP + c0 + d] = as;
        if (d == 0) {
          if constexpr (LOOSE) {
            p.part[n_rows * PP + si * n_rows + row] = mx;
            p.part[n_rows * (PP + n_sl) + si * n_rows + row] = ls;
          } else {
            p.part[n_rows * D + row] = mx;
            p.part[n_rows * (D + 1) + row] = ls;
          }
        }
      }
    }
  }

  // 4. The last block of this (batch, kv head, group tile) merges the
  //    splits in order.
  if constexpr (WIDE || QN) cp_async_wait<0>();   // a block without a tile: Q's copy
  int* ticket_at = p.tickets + b * p.Kv * n_gt * n_sl + blockIdx.y;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(ticket_at, 1);
    s_last = ticket == p.splits - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // (a) each row's weight per split, exp(m_s - max m) / sum_s l_s exp(..),
  //     in shared memory (the ring is free): a warp per row, lanes over the
  //     splits, m and l fetched in one round trip, sums in a fixed order
  const long long n_rows = (long long)p.B * p.H * p.splits;
  const float* pm = LOOSE ? p.part + n_rows * PP + si * n_rows : p.part + n_rows * D;
  const float* pl = LOOSE ? pm + n_sl * n_rows : pm + n_rows;
  // the accumulators, MERGE splits at a time (4 columns per thread,
  // 16-byte loads, at most 32 in flight); wide, the first MERGE are
  // fetched before the weights are known, so their round trip overlaps (a)'s
  constexpr int N4 = (GT * DC / 4 + THREADS - 1) / THREADS;   // float4 per thread
  constexpr int MERGE = merge_depth<N4, DT>();
  // thread tid + i THREADS takes float4 d4 of row g: rows of row4 float4
  // (the class's, constant, in a class), those past Gt or D idle
  // D4: float4 a partial row (its pitch), V4: those this block merges
  const int D4 = PP / 4, V4 = LOOSE ? (DV + 3) / 4 : D4, row4 = row_cols / 4;
  const float4* pacc = reinterpret_cast<const float4*>(p.part + c0) +
                       (long long)row0 * p.splits * D4;
  float4 a[MERGE][N4];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int u = 0; u < MERGE; ++u)
#pragma unroll
      for (int i = 0; i < N4; ++i) {
        const int j = tid + i * THREADS, g = j / row4, d4 = j % row4;
        a[u][i] = s0 + u < active && g < Gt && (DT != 0 || d4 < V4)
                      ? __ldcg(pacc + ((long long)g * p.splits + s0 + u) * D4 + d4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  };
  constexpr bool PREFETCH = WIDE || DT == 0;
  if constexpr (PREFETCH) fetch(0);
  float* sw = reinterpret_cast<float*>(fd_smem);            // [GT][active]
  float* sl = sw + GT * active;
  if constexpr (DT == 0) {
    // a class: every row's m and l in one round trip, all threads at once
    for (int i = tid; i < Gt * active; i += THREADS) {
      const int g = i / active, s = i % active;
      const long long row = (long long)(row0 + g) * p.splits;
      sw[g * active + s] = __ldcg(pm + row + s);
      sl[g * active + s] = __ldcg(pl + row + s);
    }
    __syncthreads();
  }
  for (int g = warp; g < Gt; g += WARPS) {
    const long long row = (long long)(row0 + g) * p.splits;
    float mx = NEG_INF;
    for (int s = lane; s < active; s += 32) {
      float m;
      if constexpr (DT == 0) {
        m = sw[g * active + s];
      } else {
        m = __ldcg(pm + row + s);
        const float l = __ldcg(pl + row + s);
        sw[g * active + s] = m;
        sl[g * active + s] = l;
      }
      mx = fmaxf(mx, m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float ls = 0.f;
    for (int s = lane; s < active; s += 32) {
      const float wt = expf(sw[g * active + s] - mx);
      sw[g * active + s] = wt;
      ls += sl[g * active + s] * wt;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    // the row's log-sum-exp in the units of the scaled scores: a row with
    // no valid slot gives -1e30 + log(count) = -1e30, finite, so a merge
    // over slot shards weighs it exp(-1e30 - m) = 0 beside any valid shard
    if (p.lse != nullptr && lane == 0 && si == 0) p.lse[row0 + g] = mx + logf(ls);
    const float inv = 1.f / fmaxf(ls, 1e-20f);
    for (int s = lane; s < active; s += 32) sw[g * active + s] *= inv;
  }
  __syncthreads();
  // (b) the output: 4 columns per thread and MERGE splits' accumulators in
  //     flight at once, added in split order
  float4 out[N4];
#pragma unroll
  for (int i = 0; i < N4; ++i) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < active; s0 += MERGE) {
    if (!PREFETCH || s0 > 0) fetch(s0);
#pragma unroll
    for (int u = 0; u < MERGE; ++u)
#pragma unroll
      for (int i = 0; i < N4; ++i) {
        const int g = (tid + i * THREADS) / row4;
        if (s0 + u < active && g < Gt) {
          const float wt = sw[g * active + s0 + u];
          out[i].x = fmaf(a[u][i].x, wt, out[i].x);
          out[i].y = fmaf(a[u][i].y, wt, out[i].y);
          out[i].z = fmaf(a[u][i].z, wt, out[i].z);
          out[i].w = fmaf(a[u][i].w, wt, out[i].w);
        }
      }
  }
  const int head0 = kvh * G + g0;
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    const int j = tid + i * THREADS, g = j / row4, d = 4 * (j % row4);
    if (DT == 0 && d >= DV) continue;
    if constexpr (LOOSE) {      // the columns below DV, an element at a time
      const float x[4] = {out[i].x, out[i].y, out[i].z, out[i].w};
      if (g < Gt && p.o_f32) {
        float* o = static_cast<float*>(p.o) + b * p.o_sb + (head0 + g) * p.o_sh + c0 + d;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < DV) o[e] = x[e];
      } else if (g < Gt) {
        T* o = static_cast<T*>(p.o) + b * p.o_sb + (head0 + g) * p.o_sh + c0 + d;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < DV) o[e] = from_float<T>(x[e]);
      }
      continue;
    }
    if (g < Gt && p.o_f32) {    // a partial of a slot shard: cast once, after the merge
      float* o = static_cast<float*>(p.o) + b * p.o_sb + (head0 + g) * p.o_sh + d;
      o[0] = out[i].x;
      o[1] = out[i].y;
      o[2] = out[i].z;
      o[3] = out[i].w;
    } else if (g < Gt) {
      T* o = static_cast<T*>(p.o) + b * p.o_sb + (head0 + g) * p.o_sh + d;
      o[0] = from_float<T>(out[i].x);
      o[1] = from_float<T>(out[i].y);
      o[2] = from_float<T>(out[i].z);
      o[3] = from_float<T>(out[i].w);
    }
  }
  if (tid == 0) *ticket_at = 0;
}

// `tile`, `group` and `smem` are the wrapper's numbers (flash_decode.py
// TILE, group_tile and smem_bytes): a launch whose numbers are not the
// kernel's is refused.
template <typename T, int DC, int DT, int MODE = WHOLE>
cudaError_t launch(Params p, int tile, int group, int smem_asked, cudaStream_t stream) {
  static size_t attr_bytes = 0;   // the dynamic shared memory allowed so far
  constexpr int GT = group_tile<T, DC, DT>();
  if (tile != TILE || group != GT) return cudaErrorInvalidValue;
  const int n_gt = (p.H / p.Kv + GT - 1) / GT;
  const int n_sl = MODE == SLICED ? (p.D + DC - 1) / DC : 1;
  if (static_cast<long long>(p.Kv) * n_gt * n_sl > 65535 || (DT != 0 && n_gt > 1))
    return cudaErrorInvalidValue;
  p.n_tiles = (p.S + TILE - 1) / TILE;
  const size_t smem = smem_bytes<T, DC, DT, MODE>(p.D, p.splits, p.n_tiles);
  if (smem != static_cast<size_t>(smem_asked) || smem > 200 * 1024)
    return cudaErrorInvalidValue;
  if (smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, DC, DT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_bytes = smem;
  }
  const dim3 grid(p.splits, p.Kv * n_gt * n_sl, p.B);
  flash_decode_kernel<T, DC, DT, MODE><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: any width >= 1.  part:
// B * H * splits * (P + 2 n) floats of scratch, 16-byte aligned, where P
// is head_dim (whole aligned chunks) or head_dim rounded up to 4 (the
// other kernels) and n the slices, ceil(head_dim / 256) past 256, else 1;
// tickets: B * Kv * ceil(G / group) * n ints, zero before the launch and
// zero after it.  align: a power of two (2 to 16) dividing the byte address
// of every row start of q, k and v and head_dim times the element size;
// below 16 (or an fp32 row below 8 elements) the kernels that copy at any
// alignment run.  lse: null, or (B, H) contiguous floats that receive each row's
// log-sum-exp of its scaled, masked scores.  out_f32: o holds floats
// (strides in floats) whatever the input dtype.  tile: cache slots per
// tile, group: query heads a block holds, and smem: the dynamic shared
// memory, as the wrapper computed them.  Returns a cudaError_t (0 =
// launched).
extern "C" int flash_decode_fwd(
    int dtype, int head_dim,
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part, void* tickets,
    int B, int H, int Kv, int S, int splits, int vec_mask,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long valid_sb, long long o_sb, long long o_sh,
    float scale, void* stream, void* lse, int out_f32, int tile, int smem,
    int group, int align) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.valid = static_cast<const uint8_t*>(valid);
  p.o = o;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.B = B; p.H = H; p.Kv = Kv; p.S = S; p.D = head_dim; p.splits = splits;
  p.vec_mask = vec_mask;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.valid_sb = valid_sb;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = scale;
  p.lse = static_cast<float*>(lse);
  p.o_f32 = out_f32;
  p.align = align;
  const int unit = dtype == 0 ? 4 : 2;
  if (Kv <= 0 || H % Kv != 0 || S <= 0 || splits <= 0 || B > 65535 || head_dim < 1 ||
      align < unit || align > 16 || (align & (align - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool any = align < 16 || (dtype == 0 && head_dim < 8);
  if (head_dim > 256) {
    if (dtype == 0) return launch<float, 256, 0, SLICED>(p, tile, group, smem, s);
    if (dtype == 1) return launch<bf16, 256, 0, SLICED>(p, tile, group, smem, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && any) {
    if (head_dim <= 64) return launch<float, 64, 0, ANY>(p, tile, group, smem, s);
    if (head_dim <= 128) return launch<float, 128, 0, ANY>(p, tile, group, smem, s);
    return launch<float, 256, 0, ANY>(p, tile, group, smem, s);
  }
  if (dtype == 0) {
    if (head_dim <= 64) return launch<float, 64, 0>(p, tile, group, smem, s);
    if (head_dim <= 128) return launch<float, 128, 0>(p, tile, group, smem, s);
    return launch<float, 256, 0>(p, tile, group, smem, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (any) {
    if (head_dim <= 64) return launch<bf16, 64, 0, ANY>(p, tile, group, smem, s);
    if (head_dim <= 128) return launch<bf16, 128, 0, ANY>(p, tile, group, smem, s);
    if (head_dim <= 192) return launch<bf16, 192, 0, ANY>(p, tile, group, smem, s);
    return launch<bf16, 256, 0, ANY>(p, tile, group, smem, s);
  }
  if (H / Kv <= 8) {    // the served models' widths keep their own code
    switch (head_dim) {
      case 64: return launch<bf16, 64, 64>(p, tile, group, smem, s);
      case 112: return launch<bf16, 128, 112>(p, tile, group, smem, s);
      case 120: return launch<bf16, 128, 120>(p, tile, group, smem, s);
      case 128: return launch<bf16, 128, 128>(p, tile, group, smem, s);
      case 256: return launch<bf16, 256, 256>(p, tile, group, smem, s);
      default: break;
    }
  }
  if (head_dim <= 64) return launch<bf16, 64, 0>(p, tile, group, smem, s);
  if (head_dim <= 128) return launch<bf16, 128, 0>(p, tile, group, smem, s);
  if (head_dim <= 192) return launch<bf16, 192, 0>(p, tile, group, smem, s);
  return launch<bf16, 256, 0>(p, tile, group, smem, s);
}
