// Tensor-core building blocks shared by flash_attention.cu, flash_decode.cu
// and moe_gmm.cu: asynchronous 16-byte copies into shared memory, ldmatrix,
// movmatrix, the bf16 mma.sync m16n8k16 with fp32 accumulation, swizzled
// tile indices, bf16 packing, the warpgroup products (wgmma) with A in
// registers or shared memory and B described in shared memory, and the
// pieces of a warp-specialised pipeline: mbarriers, TMA tile loads and
// warpgroup register reallocation (setmaxnreg).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), two bf16 per 32-bit register, the lower column first:
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)    a1: (g+8, 2t..)
//                           a2: (g, 8+2t..)      a3: (g+8, 8+2t..)
//   B (16 x 8, "col")       b0: (k 2t..2t+1, n g) b1: (k 8+2t.., n g)
//   C (16 x 8, fp32)        c0, c1: (g, 2t..2t+1) c2, c3: (g+8, 2t..2t+1)
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives element pair (l/4, 2(l%4)..)
// of each, which is A's and (from a (n, k) row-major tile) B's layout.
// With .trans it receives the pair of the transposed matrix: B's layout
// from a (k, n) row-major tile.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global src to shared dst, asynchronously; only the
// first src_bytes (0..16) are read and the rest of dst is zero-filled.  Both
// addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 8 and 4 bytes (cp.async.ca: the narrower sizes go through
// L1); both addresses aligned to the size.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One 16-byte chunk of a tile row from a row in global memory at any
// alignment: dst (16-byte aligned shared memory) receives the row's
// elements [col, col + 16 / sizeof(T)) that lie below n (the row's
// width), and zeros past them; all zeros where !in (a row past the
// operand's end).  `align` (16, 8, 4 or 2) is a power of two that divides
// the address of every row start and the row's width in bytes, so a piece
// of that size is whole or wholly past n: pieces of 16, 8 or 4 bytes go by
// cp.async (src-size 0 past the row, which zero-fills), and 2-byte rows
// (odd bf16 widths or offsets) are read an element at a time and stored at
// once, synchronously.  col is a multiple of 16 / sizeof(T).
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* row, int col, int n,
                                           bool in, int align) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  if (align >= 16) {
    const bool ok = in && col < n;
    cp_async16(dst, ok ? row + col : row, ok ? 16 : 0);
  } else if (align == 8) {
#pragma unroll
    for (int e = 0; e < EPC; e += EPC / 2) {
      const bool ok = in && col + e < n;
      cp_async8(dst + e, ok ? row + col + e : row, ok ? 8 : 0);
    }
  } else if (sizeof(T) == 4 || align == 4) {
#pragma unroll
    for (int e = 0; e < EPC; e += EPC / 4) {
      const bool ok = in && col + e < n;
      cp_async4(dst + e, ok ? row + col + e : row, ok ? 4 : 0);
    }
  } else {
    const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col + 2 * j;
      const uint32_t lo = in && c < n ? r[c] : 0u;
      const uint32_t hi = in && c + 1 < n ? r[c + 1] : 0u;
      w[j] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The transpose of the 8 x 8 bf16 matrix whose rows the warp holds in
// the ldmatrix layout (lane l: row l / 4, columns 2 (l % 4) ..), in the
// same layout: lane l receives column l / 4, rows 2 (l % 4) ...
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// c += a (16 x 16) * b (16 x 8), bf16 products summed in fp32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk `chunk` (8 bf16) of row `row` in a tile of
// ROW_CHUNKS chunks per row (8 or 16: 128- or 256-byte rows).  The chunk
// index is XORed with the row's low three bits, so the eight rows one
// ldmatrix matrix reads at one logical chunk lie in eight distinct 16-byte
// bank groups: no bank conflict.  (For 256-byte rows this is not wgmma's
// layout; the grouped matmul's (64, 128) w slices measured faster in it
// than in two 64-column blocks.)
template <int ROW_CHUNKS>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  static_assert(ROW_CHUNKS % 8 == 0, "rows of 8 or 16 chunks");
  return row * ROW_CHUNKS * 8 + ((chunk ^ (row & 7)) << 3);
}

// Element offset of 16-byte chunk `chunk` (8 bf16) of row `row` in a tile
// of ROWS rows stored as 64-element (128-byte) column blocks, [chunk / 8]
// [ROWS][64], each in the 128-byte swizzle: the chunk's low three bits XOR
// the row's.  The eight rows one ldmatrix matrix reads at one chunk then lie
// in eight distinct 16-byte bank groups (no bank conflict), and a block
// whose base is 1024-byte aligned is the canonical layout a SW128 wgmma
// descriptor names.
template <int ROWS>
__device__ __forceinline__ int sw128_index(int row, int chunk) {
  return (chunk >> 3) * ROWS * 64 + row * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

// Two floats as one bf16x2 register, rounded to nearest even; lo in the
// lower half (the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma): the 4 warps of a warpgroup multiply a 64 x 16
// bf16 A, held in registers in the mma.sync A layout (warp w holds rows
// 16 w .. 16 w + 15) or read from shared memory through a descriptor, by a
// 16 x N B read from shared memory through a descriptor, into a 64 x N fp32
// accumulator in the mma.sync C layout over N / 8 blocks (d[4 j + e] is C
// fragment e of columns 8 j ..).  The product runs asynchronously: fence
// before it, commit, and wait before the accumulator or A registers are
// touched again.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Order this thread's earlier shared-memory writes (cp.async included)
// before later reads by wgmma, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across an in-flight
// product.
template <int N>
__device__ __forceinline__ void fence_registers(float r[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a bf16 operand in shared memory in the 128-byte swizzle
// (sw128_index blocks, 1024-byte aligned).  K-major (rows are N, 16
// k-elements advance the address by 32 bytes): stride 1024 bytes between
// 8-row groups, the leading offset unused.  MN-major (rows are K, read
// transposed): 1024 bytes between 8-row groups of K, `leading` bytes between
// 64-column blocks of N.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t leading) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFFull) >> 4) | (uint64_t((leading >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64) (+)= a (64 x 16) . B, B a K-major (64 n, 16 k) block.
__device__ __forceinline__ void wgmma_m64n64_kmajor(
    float d[32], const uint32_t a[4], uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// d (64 x 64) (+)= A . B, A a K-major (64 m, 16 k) block and B a K-major
// (64 n, 16 k) block, both in shared memory (sw128_desc).
__device__ __forceinline__ void wgmma_m64n64_ss_kmajor(
    float d[32], uint64_t a_desc, uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (64 x 64) (+)= a (64 x 16) . B, B an MN-major (16 k, 64 n) block.
__device__ __forceinline__ void wgmma_m64n64_mnmajor(
    float d[32], const uint32_t a[4], uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// d (64 x 128) (+)= a (64 x 16) . B, B an MN-major (16 k, 128 n) block.
__device__ __forceinline__ void wgmma_m64n128_mnmajor(
    float d[64], const uint32_t a[4], uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// ---------------------------------------------------------------------------
// A warp-specialised pipeline: producer and consumer warpgroups meet at
// mbarriers in shared memory.  A TMA load (one thread issues a whole tile,
// the copy engine computes the addresses, swizzles into shared memory and
// zero-fills rows past the tensor's edge) completes its bytes on a
// barrier; consumers wait on a barrier's phase parity and arrive on
// another to hand a stage back.
// ---------------------------------------------------------------------------

// A barrier that completes a phase when `count` threads have arrived (and
// the bytes an arrival announced have landed).  One thread initialises;
// fence, then synchronise the block, before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive, and announce `bytes` of TMA copies that complete on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: waiting on parity 1 returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra MBAR_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst (1024-byte aligned under the 128-byte swizzle),
// completing its bytes on `bar`.  `map` is a CUtensorMap in parameter,
// constant or global memory (a __grid_constant__ kernel parameter).
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Synchronise `count` threads (a multiple of 32) at named barrier `id`
// (1..15: 0 is __syncthreads'); their shared-memory writes before it are
// visible to each other after it.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Warpgroup register reallocation: every warp of the warpgroup executes it,
// on a path that never rejoins the other warpgroups' (else ptxas ignores
// it).  A producer gives registers back; consumers take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace mma_sm90
