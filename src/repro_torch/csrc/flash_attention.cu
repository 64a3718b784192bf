// Flash-attention forward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) and the jnp.repeat of its GQA
// wrapper src/repro/kernels/ops.py (flash_attention_bhsd).  They compute
// what the Pallas kernel computes:
//   * softmax(q k^T / sqrt(d)) v with fp32 scores, a running row max and
//     sum, the final divide clamping l at 1e-30, the output in q's dtype;
//   * masks k_pos < kv_len, q_pos >= k_pos when causal, and
//     q_pos - k_pos < window whenever a window is given (causal or not),
//     with the finite sentinel -1e30, never -inf.
// Positions are indices (0..S-1 and 0..T-1).
//
// Layout.  q and o are indexed [b, s, h, :], k and v [b, t, hk, :], each by
// its own element strides (the head dim is contiguous), so the model layout
// (B, S, H, d) and the flattened (B*H, S, d) layout both go in without a
// copy.  Query head h reads KV head h / (Hq / Hk): GQA without repeating K/V.
//
// Bound on an H100: 4 * (allowed q-k pairs) * d operations per head against
// q, k, v and o read or written once.  At the main paths' shapes (S = 128 or
// 512, d = 160, bf16, GQA 32/8; zamba2-2.7b's prefill, S = 1024, d = 80,
// 32/32 heads) that is ~50-260 operations a byte, below the card's ~295 at
// the bf16 tensor-core peak, so the bytes bound it.  Two kernels:
//
// bf16: flash_bf16_kernel, on the tensor cores.
//   * persistent: as many blocks as fit on the card, each walking work items
//     (a query head's 64 or 128 queries, the longest causal rows first); one
//     warpgroup per 64 queries, two per block at head dim 160 (where one
//     would be alone on its SM) sharing each K/V tile, one elsewhere (two
//     blocks per SM);
//   * TMA with mbarriers: thread 0 loads each Q tile once and keeps one K/V
//     tile of 64 keys ahead in a 2-stage ring, across items, so the next
//     item's Q and first K/V tile are in flight while this item's last tile
//     is computed; boxes of 64 rows x 128 bytes in the 128-byte swizzle, zero
//     past S, T and d (so 80 and 160, which fit no swizzle atom, pad to 128
//     and 192 columns in shared memory).  TMA moves a box one innermost row
//     at a time, so rows of 128 bytes, not the 16 of the no-swizzle layout,
//     keep the loads near the memory's rate;
//   * S = Q K^T by wgmma.m64n64k16 (bf16 in, fp32 accumulators), both
//     operands from shared memory; the 1/sqrt(d) scale (times log2 e, for
//     exp2) applied to the fp32 scores after the product, where the Pallas
//     kernel scales q in fp32 first: equal up to rounding;
//   * masks on the fp32 accumulators in registers, only on tiles that cross
//     a mask edge; tiles that the causal or window mask removes entirely
//     are skipped (exp(-1e30 - m) adds exactly nothing); the online max and
//     sum stay in registers;
//   * P rounded to bf16 in registers and fed as the register A operand of
//     O += P V (wgmma.m64nDk16, D the head dim): the wgmma accumulator
//     layout of S is the A-fragment layout of P, so no shuffle and no trip
//     through shared memory.  Rounding P to bf16 is the one place this
//     departs from the Pallas kernel's fp32 arithmetic; it is held to the
//     bf16 tolerance, 2e-2, like the output's own rounding;
//   * V is the B operand read MN-major (the transpose bit), as it lies;
//   * O stays fp32 in registers; the epilogue multiplies by 1 / max(l,
//     1e-30), one division a row, and stores bf16.
//
// fp32: flash_fp32_kernel, on the CUDA cores.  fp32 inputs are held to
// 2e-5, which TF32 (10 mantissa bits) cannot meet, so no tensor core
// serves them.  One block of 256 threads per (batch*head, 64-query tile);
// the scaled Q tile and each 64-key K/V tile staged in shared memory (Q and
// K transposed, padded by one column), a 4x4 register micro-tile of scores
// per thread, row max and sum by warp shuffles, P through shared memory
// into a 4 x (d/16) accumulator, fully masked KV tiles skipped.
//
// Warp specialisation (a producer warp, softmax overlapped with the next
// product) and one block per KV head's query group are later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, hq, hk, s, t;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

// KV tiles of `bk` keys that some query of [q0, q0 + bq) may attend to.
__device__ __forceinline__ void kv_tiles(const Args& a, int q0, int bq, int bk,
                                         int& begin, int& end) {
  const int q_last = min(q0 + bq, a.s) - 1;
  begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) begin = (q0 - a.window + 1) / bk;
  end = (a.t + bk - 1) / bk;
  if (a.causal) end = min(end, q_last / bk + 1);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBq = 64;        // queries per block
constexpr int kBk = 64;        // keys per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLd = kBq + 1;   // padded leading dim of qT, kT and p

static_assert(kBq == kBk, "the 16 x 16 thread grid covers a square score tile");

template <int D>
constexpr size_t smem_bytes() {
  // qT[D][kLd] + kT[D][kLd] + v[kBk][D] + p[kBq][kLd], all fp32
  return sizeof(float) * (2 * D * kLd + kBk * D + kBq * kLd);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fp32_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kCols = D / 16;  // accumulator columns per thread

  extern __shared__ float smem[];
  float* q_t = smem;               // [D][kLd], q_t[c][r] = scale * q[r][c]
  float* k_t = q_t + D * kLd;      // [D][kLd], k_t[c][j] = k[j][c]
  float* v_s = k_t + D * kLd;      // [kBk][D]
  float* p_s = v_s + kBk * D;      // [kBq][kLd]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx + 16 * c, head dims tx + 16 * j
  const int ty = tid / 16;  // query rows ty + 16 * r
  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int hk = h / (a.hq / a.hk);
  const int q0 = blockIdx.y * kBq;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Adjacent threads read adjacent head dims of one row (coalesced) and
  // write a column of the transposed tile (stride kLd: distinct banks).
  for (int l = tid; l < kBq * D; l += kThreads) {
    const int r = l / D;
    const int c = l % D;
    const int qi = q0 + r;
    q_t[c * kLd + r] = qi < a.s ? q[qi * a.q_ss + c] * a.scale : 0.0f;
  }

  float m[4], l_sum[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l_sum[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
  }

  int tile_begin, tile_end;
  kv_tiles(a, q0, kBq, kBk, tile_begin, tile_end);

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int kv0 = tile * kBk;
    __syncthreads();  // the previous tile's k_t, v_s and p_s are consumed
    for (int l = tid; l < kBk * D; l += kThreads) {
      const int r = l / D;
      const int c = l % D;
      const int ki = kv0 + r;
      const bool in = ki < a.t;
      k_t[c * kLd + r] = in ? k[ki * a.k_ss + c] : 0.0f;
      v_s[r * D + c] = in ? v[ki * a.v_ss + c] : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = q_t[c * kLd + ty + 16 * r];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) kb[cc] = k_t[c * kLd + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) sc[r][cc] = fmaf(qa[r], kb[cc], sc[r][cc]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q_pos = q0 + ty + 16 * r;
      float row_max = kNegInf;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int k_pos = kv0 + tx + 16 * cc;
        bool ok = k_pos < a.t;
        if (a.causal) ok = ok && q_pos >= k_pos;
        if (a.window > 0) ok = ok && (q_pos - k_pos) < a.window;
        sc[r][cc] = ok ? sc[r][cc] : kNegInf;
        row_max = fmaxf(row_max, sc[r][cc]);
      }
      // The 16 threads of a row are one half-warp: lanes differ in bits 0-3.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[r], row_max);
      const float alpha = expf(m[r] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float p = expf(sc[r][cc] - m_new);
        row_sum += p;
        p_s[(ty + 16 * r) * kLd + tx + 16 * cc] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_sum[r] = l_sum[r] * alpha + row_sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();  // p_s complete

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = p_s[(ty + 16 * r) * kLd + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(p[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= a.s) continue;
    const float denom = fmaxf(l_sum[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[qi * a.o_ss + tx + 16 * j] = acc[r][j] / denom;
  }
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.hq, (a.s + kBq - 1) / kBq);
  flash_fp32_kernel<D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace bf16 {

constexpr int kWg = 64;        // queries per warpgroup: one wgmma M
constexpr int kBk = 64;        // keys per ring stage: the N of S, 4 k-steps of P V
constexpr int kStages = 2;     // K/V ring
constexpr int kQBufs = 2;      // Q: this item's and the next's
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row bf16 tile of D columns in shared memory as TMA writes it (see
// make_map): ceil(D / 64) atoms of 64 rows x 128 bytes (64 columns), each
// in the 128-byte swizzle (the 16-byte piece c of row r at r * 128 +
// ((c ^ r % 8) * 16)), columns past D zero.  The wgmma descriptors read an
// atom K-major for Q and K (8-row groups 1024 bytes apart, k16 steps 32
// bytes apart inside the 128-byte row) and MN-major for V (8-key groups
// 1024 bytes apart, atoms of 64 head dims kAtomBytes apart).
template <int D>
struct Tile {
  static constexpr int kAtoms = (D + 63) / 64;
  static constexpr int kAtomBytes = 64 * 128;
  static constexpr int kBytes = kAtoms * kAtomBytes;
};

template <int D, int W>
constexpr size_t smem_bytes() {
  // kQBufs Q buffers of one tile per warpgroup, then kStages K tiles, then
  // kStages V tiles, and 1 KB to align the start to the swizzle's
  // 1024-byte period.
  return static_cast<size_t>(kQBufs * W + 2 * kStages) * Tile<D>::kBytes + 1024;
}

// Warpgroups per block, each with 64 queries of the same item and sharing
// its K/V tiles: two where a one-warpgroup block would already be alone on
// its SM (head dim 160: 145 KB of shared memory), so that one warpgroup's
// softmax and epilogue overlap the other's products; else one, so that two
// blocks share an SM.
template <int D>
constexpr int kWarpgroups = smem_bytes<D, 1>() > 227 * 1024 / 2 ? 2 : 1;

// The wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, each in 16-byte units, and the
// layout type (1: 128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One box of a tensor map (64 columns from col, 64 rows from row, one head
// of one batch row) into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(head), "r"(batch), "r"(smem_u32(bar))
      : "memory");
}

// A 64-row tile of all D columns: one box per atom.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head, int batch) {
#pragma unroll
  for (int at = 0; at < Tile<D>::kAtoms; ++at)
    tma_box(dst + at * Tile<D>::kAtomBytes, map, bar, 64 * at, row, head, batch);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The wgmma instructions, one per N.  Inline asm names every accumulator
// register.  _ss: A and B from shared memory, both K-major.  _rs: A (P) from
// registers, B (V) from shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79},"
      " {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, desc_b);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, desc_b);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, desc_b);
  else if constexpr (D == 80) wgmma_rs_n80(d, a, desc_b);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, desc_b);
  else wgmma_rs_n160(d, a, desc_b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower index
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Work item w of a launch: the kBq queries qt of query head h of batch row
// b, 64 per warpgroup, and the KV tiles that some warpgroup attends to.
// Items are numbered so that the queries with the most causal work come
// first: w / (batch * hq) counts query tiles down from the last.
struct Work {
  int b, h, hk, q0, begin, end;  // KV tiles [begin, end)
};

template <int kBq>
__device__ __forceinline__ Work work_item(const Args& a, int w) {
  const int heads = a.batch * a.hq;
  const int q_tiles = (a.s + kBq - 1) / kBq;
  Work x;
  const int bh = w % heads;
  x.b = bh / a.hq;
  x.h = bh % a.hq;
  x.hk = x.h / (a.hq / a.hk);
  x.q0 = (q_tiles - 1 - w / heads) * kBq;
  kv_tiles(a, x.q0, kBq, kBk, x.begin, x.end);
  x.end = max(x.end, x.begin + 1);  // rows without keys are refused by the wrapper
  return x;
}

// Persistent: block i takes work items i, i + gridDim.x, ...  Thread 0 keeps
// one K/V tile ahead of the two warpgroups across items, so the next item's
// Q and first K/V tile are in flight while this item's last tile is
// computed.  Both warpgroups share each K/V tile; one skips the products of
// a tile that its mask removes entirely, while the other computes it.
template <int D>
__global__ void __launch_bounds__(128 * kWarpgroups<D>)
flash_bf16_kernel(const Args a, const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map) {
  static_assert(D % 16 == 0 && D <= 256, "wgmma takes N a multiple of 8, at most 256");
  constexpr int kS = kBk / 2;   // score accumulators per thread
  constexpr int kO = D / 2;     // output accumulators per thread
  using T = Tile<D>;
  constexpr int W = kWarpgroups<D>;
  constexpr int kBq = kWg * W;  // queries per work item

  extern __shared__ __align__(128) unsigned char smem_raw[];
  // The swizzle repeats every 1024 bytes: atoms start on that period.
  unsigned char* q_s = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* k_s = q_s + kQBufs * W * T::kBytes;
  unsigned char* v_s = k_s + kStages * T::kBytes;
  __shared__ uint64_t q_bar[kQBufs], kv_bar[kStages];

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;  // accumulator rows g and g + 8 of the warp's 16
  const int qd = tid % 4;        // accumulator columns 2 qd and 2 qd + 1 of each 8
  const int n_items = a.batch * a.hq * ((a.s + kBq - 1) / kBq);

  // The producer (thread 0): the next K/V tile to load, of item pw, with
  // that item's Q before its first tile.  TMA zero-fills rows past S and T.
  int pw = blockIdx.x, p_tile = 0, p_q = 0, p_kv = 0;
  Work px{};
  auto load_next = [&]() {
    if (pw >= n_items) return;
    if (p_tile == px.begin) {
      const int qb = p_q++ % kQBufs;
      mbar_expect(&q_bar[qb], W * T::kBytes);
      for (int i = 0; i < W; ++i)
        tma_tile<D>(q_s + (qb * W + i) * T::kBytes, &q_map, &q_bar[qb],
                    px.q0 + kWg * i, px.h, px.b);
    }
    const int st = p_kv++ % kStages;
    mbar_expect(&kv_bar[st], 2 * T::kBytes);
    tma_tile<D>(k_s + st * T::kBytes, &k_map, &kv_bar[st], p_tile * kBk, px.hk, px.b);
    tma_tile<D>(v_s + st * T::kBytes, &v_map, &kv_bar[st], p_tile * kBk, px.hk, px.b);
    if (++p_tile == px.end) {
      pw += gridDim.x;
      if (pw < n_items) {
        px = work_item<kBq>(a, pw);
        p_tile = px.begin;
      }
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kQBufs; ++i) mbar_init(&q_bar[i]);
    for (int i = 0; i < kStages; ++i) mbar_init(&kv_bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (pw < n_items) {
      px = work_item<kBq>(a, pw);
      p_tile = px.begin;
    }
    for (int i = 0; i < kStages - 1; ++i) load_next();
  }
  __syncthreads();  // the barriers are initialised

  const float scale = a.scale * kLog2e;  // scores in log2 units: exp2 below
  int c_q = 0, c_kv = 0;  // Q tiles and K/V tiles consumed
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++c_q) {
    const Work x = work_item<kBq>(a, w);
    const int q0 = x.q0 + kWg * wg;  // this warpgroup's queries
    int wg_begin, wg_end;
    kv_tiles(a, q0, kWg, kBk, wg_begin, wg_end);
    if (q0 >= a.s) wg_end = wg_begin;  // past the last query: nothing to do
    const unsigned char* q_buf = q_s + ((c_q % kQBufs) * W + wg) * T::kBytes;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + x.b * a.o_sb + x.h * a.o_sh;
    const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
    float m[2] = {kNegInf, kNegInf};
    float l_part[2] = {0.0f, 0.0f};  // this thread's share of each row's sum
    float o_acc[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o_acc[i] = 0.0f;

    for (int tile = x.begin; tile < x.end; ++tile, ++c_kv) {
      const int stage = c_kv % kStages;
      if (tid == 0) load_next();  // into the stage freed by the last tile
      if (tile == x.begin) mbar_wait(&q_bar[c_q % kQBufs], (c_q / kQBufs) & 1);
      mbar_wait(&kv_bar[stage], (c_kv / kStages) & 1);  // this tile has landed
      if (tile >= wg_begin && tile < wg_end) {

        // S = Q K^T: D / 16 k-steps of m64n64k16.
        float s_acc[kS];
#pragma unroll
        for (int i = 0; i < kS; ++i) s_acc[i] = 0.0f;
        fence_regs(s_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * T::kAtomBytes + (kk % 4) * 32;  // atom, then 16 columns
          const uint64_t da = make_desc(q_buf + off, 16, 1024);
          const uint64_t db = make_desc(k_s + stage * T::kBytes + off, 16, 1024);
          wgmma_ss_n64(s_acc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s_acc);

        // Scale, mask, online softmax.  s_acc[4 i + e]: key kv0 + 8 i + 2 qd +
        // (e & 1) of row row_a + 8 (e >> 1).
        const int kv0 = tile * kBk;
        const bool edge = kv0 + kBk > a.t || (a.causal && kv0 + kBk - 1 > q0) ||
                          (a.window > 0 && q0 + kWg - 1 - kv0 >= a.window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < kS / 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float sc = s_acc[4 * i + e] * scale;
            if (edge) {
              const int k_pos = kv0 + 8 * i + 2 * qd + (e & 1);
              const int q_pos = row_a + 8 * (e >> 1);
              bool ok = k_pos < a.t;
              if (a.causal) ok = ok && q_pos >= k_pos;
              if (a.window > 0) ok = ok && (q_pos - k_pos) < a.window;
              sc = ok ? sc : kNegInf;
            }
            s_acc[4 * i + e] = sc;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // The 4 threads of a row are lanes 4 g .. 4 g + 3.
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          l_part[r] *= alpha[r];
        }
        uint32_t p_frag[kBk / 16][4];
#pragma unroll
        for (int i = 0; i < kS / 4; ++i) {
          const float p0 = exp2f(s_acc[4 * i + 0] - m[0]);
          const float p1 = exp2f(s_acc[4 * i + 1] - m[0]);
          const float p2 = exp2f(s_acc[4 * i + 2] - m[1]);
          const float p3 = exp2f(s_acc[4 * i + 3] - m[1]);
          l_part[0] += p0 + p1;
          l_part[1] += p2 + p3;
          // Keys 8 i .. 8 i + 7 are k-step i / 2, half i % 2: registers
          // {row g, row g + 8} of that half, the wgmma A-fragment layout.
          p_frag[i / 2][2 * (i % 2) + 0] = pack_bf16(p0, p1);
          p_frag[i / 2][2 * (i % 2) + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int i = 0; i < kO; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

        // O += P V: 4 k-steps of m64nDk16, P from registers.
        fence_regs(o_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBk / 16; ++kk) {
          // Keys 16 kk .. 16 kk + 15: two 8-key groups of 1024 bytes.
          const uint64_t db = make_desc(v_s + stage * T::kBytes + kk * 2048, T::kAtomBytes, 1024);
          wgmma_pv<D>(o_acc, p_frag[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o_acc);
      }
      __syncthreads();  // every thread is done with this stage before it refills
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = row_a + 8 * r;
      if (qi >= a.s) continue;
      const float inv = 1.0f / fmaxf(l, 1e-30f);  // one division per row, not per output
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(o_acc[4 * i + 2 * r] * inv,
                                                         o_acc[4 * i + 2 * r + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(o + qi * a.o_ss + 8 * i + 2 * qd) = val;
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so that
// the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (batch, rows, heads, d) bf16 tensor with element
// strides (sb, ss, sh): dimensions {d, rows, heads, batch}, innermost first,
// a box of {64, 64, 1, 1} in the 128-byte swizzle, so one box is one atom of
// Tile<D>.  Rows past `rows` and columns past d read as zeros.  Returns 0,
// or 1000 + the CUresult of the refusal.
int make_map(CUtensorMap* map, const void* base, int batch, int rows, int heads, int d,
             long long sb, long long ss, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 1000 + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  // Byte strides of dimensions 1-3; a dimension of size 1 takes any legal one.
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(rows > 1 ? 2 * ss : 16),
                                 static_cast<cuuint64_t>(heads > 1 ? 2 * sh : 16),
                                 static_cast<cuuint64_t>(batch > 1 ? 2 * sb : 16)};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, a.q, batch, a.s, a.hq, D, a.q_sb, a.q_ss, a.q_sh);
  if (err == 0) err = make_map(&k_map, a.k, batch, a.t, a.hk, D, a.k_sb, a.k_ss, a.k_sh);
  if (err == 0) err = make_map(&v_map, a.v, batch, a.t, a.hk, D, a.v_sb, a.v_ss, a.v_sh);
  if (err != 0) return err;
  constexpr int kThreads = 128 * kWarpgroups<D>;
  constexpr int kBq = kWg * kWarpgroups<D>;
  const size_t bytes = smem_bytes<D, kWarpgroups<D>>();
  // As many blocks as fit on the card at once, at most one per work item.
  // The attribute is set, and the occupancy found, once per device.
  constexpr int kDevices = 64;
  static int per_sm[kDevices] = {};
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && device >= kDevices) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && per_sm[device] == 0) {
    e = cudaFuncSetAttribute(flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[device], flash_bf16_kernel<D>,
                                                        kThreads, bytes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm[device] == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items = static_cast<long long>(batch) * a.hq * ((a.s + kBq - 1) / kBq);
  const int grid =
      static_cast<int>(std::min<long long>(items, static_cast<long long>(sms) * per_sm[device]));
  flash_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(a, q_map, k_map, v_map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

// fp32 on the CUDA cores, bf16 on the tensor cores.
template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) return f32::launch<D>(a, batch, stream);
  else return bf16::launch<D>(a, batch, stream);
}

template <typename T>
int dispatch_dim(const Args& a, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 80: return launch<T, 80>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    case 160: return launch<T, 160>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0 = fp32, 1 = bf16.  Strides are in elements, per tensor as
// (batch, sequence, head).  bf16 needs 16-byte aligned rows: every pointer
// 16-byte aligned and every stride a multiple of 8.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched); an unsupported dtype or
// head_dim, or unaligned bf16 rows, return cudaErrorInvalidValue without
// launching, and a refused tensor map 1000 + its CUresult.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int hq, int hk, int s, int t, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || s <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, batch, hq, hk, s, t,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
         causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(a, batch, d, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (long long x : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh})
    if (x % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dim<__nv_bfloat16>(a, batch, d, st);
}
