// Flash-attention kernels for Hopper (sm_90a): the forward and its backward.
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
//
// Backward (flash_attention_bwd): dQ, dK and dV from q, k, v, o, dO and the
// forward's natural-unit logsumexp, replacing XLA's autodiff of the
// reference's jnp attention src/repro/models/layers.py (attention_chunked;
// the Pallas kernel has no backward).  Three kernels, deterministic, no
// atomics: delta = rowsum(dO o O); dK/dV, a block per (batch, KV head,
// 64-key tile) walking the query heads of its GQA group in order; dQ, a
// block per (batch, query head, query tile).  S and dP are recomputed in
// both.  Bound on an H100: 10 (allowed pairs) d operations per head against
// q, k, v, o, dO, the logsumexp and the three gradients moved once; at the
// train shapes the bytes bound it.
//   * fp32 (bwd::): the CUDA cores, 4 x 4 register micro-tiles, tiles
//     staged transposed in fp32 (held to 1e-5, which TF32 cannot meet).
//     Head dims up to 160: at 192 (nemotron-4-340b, which trains in bf16)
//     the dK/dV kernel's four staged (192, 65) fp32 tiles pass the 227 KB
//     of shared memory a block may take.
//   * bf16 (bwd16::): the tensor cores.  Every product is a pattern of the
//     forward's: S^T = K Q^T and dP^T = V dO^T (dK/dV kernel), S = Q K^T and
//     dP = dO V^T (dQ kernel) by wgmma with both operands K-major; P and dS
//     in fp32 registers, rounded to bf16 and fed from the accumulator layout
//     as the register A operand of dV += P^T dO, dK += dS^T Q and dQ += dS K
//     (dO, Q and K read MN-major).  Rounding P and dS to bf16 is the one
//     departure from fp32, held to the bf16 tolerance of 1e-2.  Tiles arrive
//     by TMA in the 128-byte swizzle (d 80 and 160 pad to 128 and 192
//     columns): K and V stay resident in the dK/dV kernel while its Q/dO
//     tiles come through a 2-stage ring; Q and dO stay resident in the dQ
//     kernel while K/V come through one.  Masks are applied on the fp32
//     accumulators only on tiles that cross a mask edge, by a select;
//     fully masked tiles are skipped.  The dK/dV block splits its products
//     over two warpgroups, so that dK and dV (64 x d fp32 each) are held by
//     different threads: warpgroup 0 computes S^T, P^T and dV, warpgroup 1
//     dP^T, dS^T and dK, taking P^T through shared memory.  The dQ block runs
//     two warpgroups of 64 queries on shared K/V tiles.  The longest causal
//     walks start first (key tile 0; the last query tiles).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "hopper_tma_wgmma.cuh"

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
  float* lse;  // (batch * hq, s) fp32 logsumexp of each row's scaled scores, or null
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
    // Every thread of the row holds the same m and l (shuffle all-reduce).
    if (a.lse != nullptr && tx == 0) a.lse[static_cast<long long>(bh) * a.s + qi] = m[r] + logf(denom);
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

using namespace hopper;

constexpr int kWg = 64;        // queries per warpgroup: one wgmma M
constexpr int kBk = 64;        // keys per ring stage: the N of S, 4 k-steps of P V
constexpr int kStages = 2;     // K/V ring
constexpr int kQBufs = 2;      // Q: this item's and the next's
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Q, K and V tiles are Tiles of D columns (hopper_tma_wgmma.cuh): the wgmma
// descriptors read an atom K-major for Q and K (8-row groups 1024 bytes
// apart, k16 steps 32 bytes apart inside the 128-byte row) and MN-major
// for V (8-key groups 1024 bytes apart, atoms of 64 head dims kAtomBytes
// apart).
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
    mbar_fence_init();
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
          wgmma_rs<D>(o_acc, p_frag[kk], db);
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
      // m and l are in log2 units: the logsumexp in natural ones.
      if (a.lse != nullptr && qd == 0)
        a.lse[(static_cast<long long>(x.b) * a.hq + x.h) * a.s + qi] =
            (m[r] + log2f(fmaxf(l, 1e-30f))) * kLn2;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(o_acc[4 * i + 2 * r] * inv,
                                                         o_acc[4 * i + 2 * r + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(o + qi * a.o_ss + 8 * i + 2 * qd) = val;
      }
    }
  }
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
    case 192: return launch<T, 192>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The backward in fp32 on the CUDA cores (and its delta kernel, which the
// bf16 backward shares)
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int kB = 64;         // queries of a query tile, keys of a KV tile
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 score micro-tile each
constexpr int kLd = kB + 1;    // padded leading dim of the transposed tiles

// Tensors of the backward, in the order of their strides.
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Args {
  const void* ptr[kTensors];  // q, k, v, o, dO, then the dq, dk, dv outputs
  const float* lse;          // (batch * hq, s), natural units
  float* delta;              // (batch * hq, s) scratch: rowsum(dO * O)
  int batch, hq, hk, s, t;
  long long st[kTensors][3];  // (batch, sequence, head) element strides
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Row 0 of head h of batch row b of tensor i.
template <typename T>
__device__ __forceinline__ T* head(const Args& a, int i, int b, int h) {
  return static_cast<T*>(const_cast<void*>(a.ptr[i])) + b * a.st[i][0] + h * a.st[i][2];
}

__device__ __forceinline__ bool allowed(const Args& a, int q_pos, int k_pos) {
  bool ok = q_pos < a.s && k_pos < a.t;
  if (a.causal) ok = ok && q_pos >= k_pos;
  if (a.window > 0) ok = ok && (q_pos - k_pos) < a.window;
  return ok;
}

// Rows r0 .. r0 + kB - 1 of a (rows, D) tile with row stride `rs`, into
// dst[c * kLd + r] in fp32, zero past row n: coalesced reads, a column of
// the transposed tile written with stride kLd (distinct banks).
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long rs, int r0, int n) {
  for (int l = threadIdx.x; l < kB * D; l += kThreads) {
    const int r = l / D;
    const int c = l % D;
    const int i = r0 + r;
    dst[c * kLd + r] = i < n ? load(src + i * rs + c) : 0.0f;
  }
}

// Query tiles whose rows attend to some key of the KV tile at kv0: from the
// causal diagonal to the window's reach.
__device__ __forceinline__ void q_tiles(const Args& a, int kv0, int& begin, int& end) {
  begin = a.causal ? kv0 / kB : 0;
  int last = a.s - 1;
  if (a.window > 0) last = min(last, kv0 + kB - 1 + a.window - 1);
  end = last / kB + 1;
}

// KV tiles that some query of the n queries from q0 attends to (the
// forward's kv_tiles).
__device__ __forceinline__ void k_tiles(const Args& a, int q0, int n, int& begin, int& end) {
  const int q_last = min(q0 + n, a.s) - 1;
  begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) begin = (q0 - a.window + 1) / kB;
  end = (a.t + kB - 1) / kB;
  if (a.causal) end = min(end, q_last / kB + 1);
}

// For queries q0 + ty + 16 r and keys kv0 + tx + 16 c of the staged tiles:
// P = exp(scale * q k - lse), 0 where masked, and dS = P (dO v - delta).
template <int D>
__device__ __forceinline__ void probs(const Args& a, const float* q_t, const float* k_t,
                                      const float* do_t, const float* v_t,
                                      const float* lse_s, const float* dl_s, int q0, int kv0,
                                      float p[4][4], float ds[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = q_t[c * kLd + ty + 16 * r];
      da[r] = do_t[c * kLd + ty + 16 * r];
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      kb[cc] = k_t[c * kLd + tx + 16 * cc];
      vb[cc] = v_t[c * kLd + tx + 16 * cc];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        p[r][cc] = fmaf(qa[r], kb[cc], p[r][cc]);
        dp[r][cc] = fmaf(da[r], vb[cc], dp[r][cc]);
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const bool ok = allowed(a, q0 + i, kv0 + tx + 16 * cc);
      p[r][cc] = ok ? expf(p[r][cc] * a.scale - lse_s[i]) : 0.0f;
      ds[r][cc] = p[r][cc] * (dp[r][cc] - dl_s[i]);
    }
  }
}

// The query tile's dO, lse and delta rows, zero past S.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const Args& a, float* q_t, float* do_t, float* lse_s,
                                          float* dl_s, int b, int h, int q0) {
  load_t<T, D>(q_t, head<const T>(a, kQ, b, h), a.st[kQ][1], q0, a.s);
  load_t<T, D>(do_t, head<const T>(a, kDO, b, h), a.st[kDO][1], q0, a.s);
  const long long row = (static_cast<long long>(b) * a.hq + h) * a.s;
  if (threadIdx.x < kB) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < a.s ? a.lse[row + i] : 0.0f;
    dl_s[threadIdx.x] = i < a.s ? a.delta[row + i] : 0.0f;
  }
}

// delta = rowsum(dO * O) in fp32: one warp per (batch, head, query) row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(const Args a) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.batch) * a.hq * a.s) return;
  const int i = static_cast<int>(row % a.s);
  const int bh = static_cast<int>(row / a.s);
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const T* o = head<const T>(a, kO, b, h) + i * a.st[kO][1];
  const T* d_o = head<const T>(a, kDO, b, h) + i * a.st[kDO][1];
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc = fmaf(load(o + c), load(d_o + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // k_t, v_t, q_t, do_t [D][kLd]; p, ds [kB][kLd]; lse, delta [kB]
  return sizeof(float) * (4 * D * kLd + 2 * kB * kLd + 2 * kB);
}

// dK and dV of one KV tile of one KV head: the block walks every query head
// of the head's GQA group, in order, and each of its query tiles that
// attends to the tile, accumulating in registers: no atomics, one fixed
// order of summation.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* k_t = smem;
  float* v_t = k_t + D * kLd;
  float* q_t = v_t + D * kLd;
  float* do_t = q_t + D * kLd;
  float* p_s = do_t + D * kLd;   // [query][key]
  float* ds_s = p_s + kB * kLd;  // [query][key]
  float* lse_s = ds_s + kB * kLd;
  float* dl_s = lse_s + kB;

  const int tx = threadIdx.x % 16;  // head dims tx + 16 j
  const int ty = threadIdx.x / 16;  // keys ty + 16 r
  const int b = blockIdx.x / a.hk;
  const int hk = blockIdx.x % a.hk;
  const int rep = a.hq / a.hk;
  const int kv0 = blockIdx.y * kB;

  load_t<T, D>(k_t, head<const T>(a, kK, b, hk), a.st[kK][1], kv0, a.t);
  load_t<T, D>(v_t, head<const T>(a, kV, b, hk), a.st[kV][1], kv0, a.t);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk[r][j] = dv[r][j] = 0.0f;

  int begin, end;
  q_tiles(a, kv0, begin, end);
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    for (int qt = begin; qt < end; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the last tile's q_t, do_t, p_s and ds_s are consumed
      load_rows<T, D>(a, q_t, do_t, lse_s, dl_s, b, h, q0);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs<D>(a, q_t, k_t, do_t, v_t, lse_s, dl_s, q0, kv0, p, ds);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          p_s[(ty + 16 * r) * kLd + tx + 16 * cc] = p[r][cc];
          ds_s[(ty + 16 * r) * kLd + tx + 16 * cc] = ds[r][cc];
        }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's queries.
#pragma unroll 2
      for (int i = 0; i < kB; ++i) {
        float pr[4], dr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = p_s[i * kLd + ty + 16 * r];
          dr[r] = ds_s[i * kLd + ty + 16 * r];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float dov = do_t[(tx + 16 * j) * kLd + i];
          const float qv = q_t[(tx + 16 * j) * kLd + i];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv[r][j] = fmaf(pr[r], dov, dv[r][j]);
            dk[r][j] = fmaf(dr[r], qv, dk[r][j]);
          }
        }
      }
    }
  }

  T* d_k = head<T>(a, kDK, b, hk);
  T* d_v = head<T>(a, kDV, b, hk);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = kv0 + ty + 16 * r;
    if (j >= a.t) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(d_k + j * a.st[kDK][1] + tx + 16 * c, dk[r][c] * a.scale);
      store(d_v + j * a.st[kDV][1] + tx + 16 * c, dv[r][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q_t, do_t, k_t, v_t [D][kLd]; ds [kB][kLd]; lse, delta [kB]
  return sizeof(float) * (4 * D * kLd + kB * kLd + 2 * kB);
}

// dQ of one query tile of one query head: the block walks the KV tiles the
// tile attends to, in order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* q_t = smem;
  float* do_t = q_t + D * kLd;
  float* k_t = do_t + D * kLd;
  float* v_t = k_t + D * kLd;
  float* ds_s = v_t + D * kLd;  // [query][key]
  float* lse_s = ds_s + kB * kLd;
  float* dl_s = lse_s + kB;

  const int tx = threadIdx.x % 16;  // head dims tx + 16 j
  const int ty = threadIdx.x / 16;  // queries ty + 16 r
  const int b = blockIdx.x / a.hq;
  const int h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hk);
  const int q0 = blockIdx.y * kB;
  load_rows<T, D>(a, q_t, do_t, lse_s, dl_s, b, h, q0);

  float dq[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dq[r][j] = 0.0f;

  int begin, end;
  k_tiles(a, q0, kB, begin, end);
  for (int tile = begin; tile < end; ++tile) {
    const int kv0 = tile * kB;
    __syncthreads();  // the last tile's k_t, v_t and ds_s are consumed
    load_t<T, D>(k_t, head<const T>(a, kK, b, hk), a.st[kK][1], kv0, a.t);
    load_t<T, D>(v_t, head<const T>(a, kV, b, hk), a.st[kV][1], kv0, a.t);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs<D>(a, q_t, k_t, do_t, v_t, lse_s, dl_s, q0, kv0, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) ds_s[(ty + 16 * r) * kLd + tx + 16 * cc] = ds[r][cc];
    __syncthreads();
    // dQ += dS K over the tile's keys.
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float dr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dr[r] = ds_s[(ty + 16 * r) * kLd + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = k_t[(tx + 16 * c) * kLd + j];
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[r][c] = fmaf(dr[r], kv, dq[r][c]);
      }
    }
  }

  T* d_q = head<T>(a, kDQ, b, h);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= a.s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(d_q + i * a.st[kDQ][1] + tx + 16 * c, dq[r][c] * a.scale);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The three kernels in order on `stream`: delta, dK/dV, dQ.
template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.batch) * a.hq * a.s;
  const int rows_per_block = kThreads / 32;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
                                 kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t kv_bytes = dkdv_smem_bytes<D>();
  err = set_smem(flash_bwd_dkdv_kernel<T, D>, kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, D><<<dim3(a.batch * a.hk, (a.t + kB - 1) / kB), kThreads, kv_bytes,
                                stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_bytes = dq_smem_bytes<D>();
  err = set_smem(flash_bwd_dq_kernel<T, D>, q_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<dim3(a.batch * a.hq, (a.s + kB - 1) / kB), kThreads, q_bytes,
                              stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 160: return launch<T, 160>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The backward in bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace bwd16 {

using namespace hopper;
using bwd::Args;
using bwd::kQ;
using bwd::kK;
using bwd::kV;
using bwd::kDO;
using bwd::kDQ;
using bwd::kDK;
using bwd::kDV;

constexpr int kB = 64;         // rows of a tile: one wgmma M, one TMA box
constexpr int kStages = 2;     // the ring of Q/dO (dK/dV kernel) or K/V (dQ kernel) tiles
constexpr int kThreads = 256;  // two warpgroups
constexpr int kS = kB / 2;     // accumulators of a 64 x 64 score tile per thread
constexpr float kLog2e = 1.4426950408889634f;

// Whether a 64 x 64 tile of queries from q0 and keys from kv0 has a pair
// that the masks remove, or a query or key past the end.
__device__ __forceinline__ bool crosses_edge(const Args& a, int q0, int kv0) {
  return q0 + kB > a.s || kv0 + kB > a.t || (a.causal && kv0 + kB - 1 > q0) ||
         (a.window > 0 && q0 + kB - 1 - kv0 >= a.window);
}

template <int D>
constexpr size_t dkdv_smem() {
  // K, V, then kStages x {Q, dO}; the fp32 P^T hand-over tile; 1 KB to align.
  return static_cast<size_t>(2 + 2 * kStages) * Tile<D>::kBytes + kS * 128 * sizeof(float) + 1024;
}

// dK and dV of one 64-key tile of one KV head.  Items are the (query head
// of the GQA group, query tile) pairs that reach the key tile, in that
// order; their Q and dO tiles arrive by TMA through a kStages ring while K
// and V stay resident.  Warpgroup 0 computes S^T = K Q^T, P^T, and dV +=
// P^T dO; warpgroup 1 computes dP^T = V dO^T, takes P^T from warpgroup 0
// through shared memory (the same accumulator positions, so thread t reads
// what thread t of the other warpgroup wrote), dS^T = P^T o (dP^T - delta),
// and dK += dS^T Q.  Key tile 0, the longest causal walk, comes first.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const Args a, const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);
  unsigned char* v_s = k_s + T::kBytes;
  unsigned char* ring = v_s + T::kBytes;  // stage st: Q, then dO
  float* hand = reinterpret_cast<float*>(ring + 2 * kStages * T::kBytes);  // [kS][128]
  __shared__ uint64_t kv_bar, ring_bar[kStages];

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int ltid = tid % 128;
  const int warp = ltid / 32;
  const int g = (tid % 32) / 4;  // accumulator rows g and g + 8 of the warp's 16
  const int qd = tid % 4;        // accumulator columns 2 qd and 2 qd + 1 of each 8
  const int heads = a.batch * a.hk;
  const int kv0 = (blockIdx.x / heads) * kB;
  const int b = (blockIdx.x % heads) / a.hk;
  const int hk = blockIdx.x % a.hk;
  const int rep = a.hq / a.hk;
  int qb, qe;
  bwd::q_tiles(a, kv0, qb, qe);
  const int nq = max(qe - qb, 0);
  const int items = rep * nq;

  auto load_item = [&](int i) {
    const int st = i % kStages;
    unsigned char* dst = ring + 2 * st * T::kBytes;
    const int h = hk * rep + i / nq;
    const int q0 = (qb + i % nq) * kB;
    mbar_expect(&ring_bar[st], 2 * T::kBytes);
    tma_tile<D>(dst, &q_map, &ring_bar[st], q0, h, b);
    tma_tile<D>(dst + T::kBytes, &do_map, &ring_bar[st], q0, h, b);
  };
  if (tid == 0) {
    mbar_init(&kv_bar);
    for (int i = 0; i < kStages; ++i) mbar_init(&ring_bar[i]);
    mbar_fence_init();
    mbar_expect(&kv_bar, 2 * T::kBytes);
    tma_tile<D>(k_s, &k_map, &kv_bar, kv0, hk, b);
    tma_tile<D>(v_s, &v_map, &kv_bar, kv0, hk, b);
    for (int i = 0; i < min(kStages, items); ++i) load_item(i);
  }
  __syncthreads();  // the barriers are initialised
  mbar_wait(&kv_bar, 0);

  const float scale2 = a.scale * kLog2e;  // exp(scale s - lse) = exp2(scale2 s - lse log2 e)
  const unsigned char* mine = wg == 0 ? k_s : v_s;
  float acc[D / 2];  // dV (warpgroup 0) or dK / scale (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  const int key_a = kv0 + 16 * warp + g;  // this thread's keys: key_a, key_a + 8

  for (int it = 0; it < items; ++it) {
    const int st = it % kStages;
    const int h = hk * rep + it / nq;
    const int q0 = (qb + it % nq) * kB;
    const unsigned char* q_t = ring + 2 * st * T::kBytes;
    const unsigned char* do_t = q_t + T::kBytes;
    // The logsumexp (warpgroup 0, in log2 units) or delta (warpgroup 1) of
    // this thread's 16 query columns 8 c + 2 qd + e.
    const float* per_row = (wg == 0 ? a.lse : a.delta) + (static_cast<long long>(b) * a.hq + h) * a.s;
    float col[16];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * c + 2 * qd + e;
        const float v = qi < a.s ? per_row[qi] : 0.0f;
        col[2 * c + e] = wg == 0 ? v * kLog2e : v;
      }
    mbar_wait(&ring_bar[st], (it / kStages) & 1);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1).
    float sc[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
    mma_nt<D, kB>(sc, mine, wg == 0 ? q_t : do_t, false);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[4 i + e]: key key_a + 8 (e >> 1), query q0 + 8 i + 2 qd + (e & 1).
    const bool edge = crosses_edge(a, q0, kv0);
    uint32_t frag[4][4];
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(sc[4 * i + e] * scale2 - col[2 * i + (e & 1)]);
          if (edge && !bwd::allowed(a, q0 + 8 * i + 2 * qd + (e & 1), key_a + 8 * (e >> 1)))
            p = 0.0f;  // a select: exp2 of a masked score may overflow
          sc[4 * i + e] = p;
          hand[(4 * i + e) * 128 + ltid] = p;
        }
      bar_arrive(1, kThreads);
      to_frag(sc, frag);
    } else {
      bar_sync(1, kThreads);  // P^T is in `hand`
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * i + e] = hand[(4 * i + e) * 128 + ltid] * (sc[4 * i + e] - col[2 * i + (e & 1)]);
      to_frag(sc, frag);
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), dO and Q
    // read MN-major.
    fence_regs(acc);
    wgmma_fence();
    mma_fb<D>(acc, frag, wg == 0 ? do_t : q_t);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // both warpgroups are done with this stage and `hand`
    if (tid == 0 && it + kStages < items) load_item(it + kStages);
  }

  __nv_bfloat16* out = bwd::head<__nv_bfloat16>(a, wg == 0 ? kDV : kDK, b, hk);
  const long long ss = a.st[wg == 0 ? kDV : kDK][1];
  const float mul = wg == 0 ? 1.0f : a.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key_a + 8 * r;
    if (j >= a.t) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + j * ss + 8 * i + 2 * qd) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
  }
}

template <int D>
constexpr size_t dq_smem() {
  // Q and dO of both warpgroups, then kStages x {K, V}; 1 KB to align.
  return static_cast<size_t>(4 + 2 * kStages) * Tile<D>::kBytes + 1024;
}

// dQ of 128 queries of one query head, 64 per warpgroup: Q and dO resident,
// the K/V tiles that some of them attend to through a kStages TMA ring
// shared by both warpgroups.  Per tile: S = Q K^T and dP = dO V^T, P and
// dS = P o (dP - delta) in registers, dQ += dS K with K read MN-major.
// The last query tiles, the longest causal walks, come first.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const Args a, const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map) {
  using T = Tile<D>;
  constexpr int kBq = 2 * kB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);   // Q of warpgroups 0 and 1
  unsigned char* do_s = q_s + 2 * T::kBytes;  // dO of warpgroups 0 and 1
  unsigned char* ring = do_s + 2 * T::kBytes; // stage st: K, then V
  __shared__ uint64_t q_bar, ring_bar[kStages];

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int qd = tid % 4;
  const int heads = a.batch * a.hq;
  const int q_items = (a.s + kBq - 1) / kBq;
  const int q0 = (q_items - 1 - blockIdx.x / heads) * kBq;
  const int b = (blockIdx.x % heads) / a.hq;
  const int h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hk);
  int begin, end;
  bwd::k_tiles(a, q0, kBq, begin, end);
  const int tiles = max(end - begin, 0);

  auto load_tile = [&](int c) {
    const int st = c % kStages;
    unsigned char* dst = ring + 2 * st * T::kBytes;
    mbar_expect(&ring_bar[st], 2 * T::kBytes);
    tma_tile<D>(dst, &k_map, &ring_bar[st], (begin + c) * kB, hk, b);
    tma_tile<D>(dst + T::kBytes, &v_map, &ring_bar[st], (begin + c) * kB, hk, b);
  };
  if (tid == 0) {
    mbar_init(&q_bar);
    for (int i = 0; i < kStages; ++i) mbar_init(&ring_bar[i]);
    mbar_fence_init();
    mbar_expect(&q_bar, 4 * T::kBytes);
    for (int w = 0; w < 2; ++w) {
      tma_tile<D>(q_s + w * T::kBytes, &q_map, &q_bar, q0 + kB * w, h, b);
      tma_tile<D>(do_s + w * T::kBytes, &do_map, &q_bar, q0 + kB * w, h, b);
    }
    for (int c = 0; c < min(kStages, tiles); ++c) load_tile(c);
  }
  __syncthreads();  // the barriers are initialised

  const int qw = q0 + kB * wg;  // this warpgroup's queries
  int wb, we;
  bwd::k_tiles(a, qw, kB, wb, we);
  if (qw >= a.s) we = wb;  // past the last query: nothing to do
  const int row_a = qw + 16 * warp + g;  // this thread's queries: row_a, row_a + 8
  const long long row_base = (static_cast<long long>(b) * a.hq + h) * a.s;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_a + 8 * r;
    lse2[r] = qi < a.s ? a.lse[row_base + qi] * kLog2e : 0.0f;
    dl[r] = qi < a.s ? a.delta[row_base + qi] : 0.0f;
  }
  const float scale2 = a.scale * kLog2e;
  const unsigned char* q_t = q_s + wg * T::kBytes;
  const unsigned char* do_t = do_s + wg * T::kBytes;
  float acc[D / 2];  // dQ / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  mbar_wait(&q_bar, 0);

  for (int c = 0; c < tiles; ++c) {
    const int st = c % kStages;
    const int tile = begin + c;
    const unsigned char* k_t = ring + 2 * st * T::kBytes;
    const unsigned char* v_t = k_t + T::kBytes;
    mbar_wait(&ring_bar[st], (c / kStages) & 1);
    if (tile >= wb && tile < we) {
      float sc[kS], dp[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) sc[i] = dp[i] = 0.0f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      mma_nt<D, kB>(sc, q_t, k_t, false);
      mma_nt<D, kB>(dp, do_t, v_t, false);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // sc[4 i + e]: query row_a + 8 (e >> 1), key kv0 + 8 i + 2 qd + (e & 1).
      const int kv0 = tile * kB;
      const bool edge = crosses_edge(a, qw, kv0);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(sc[4 * i + e] * scale2 - lse2[r]);
          if (edge && !bwd::allowed(a, row_a + 8 * r, kv0 + 8 * i + 2 * qd + (e & 1))) p = 0.0f;
          sc[4 * i + e] = p * (dp[4 * i + e] - dl[r]);
        }
      uint32_t frag[4][4];
      to_frag(sc, frag);
      fence_regs(acc);
      wgmma_fence();
      mma_fb<D>(acc, frag, k_t);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // every thread is done with this stage before it refills
    if (tid == 0 && c + kStages < tiles) load_tile(c + kStages);
  }

  __nv_bfloat16* out = bwd::head<__nv_bfloat16>(a, kDQ, b, h);
  const long long ss = a.st[kDQ][1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_a + 8 * r;
    if (qi >= a.s) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + qi * ss + 8 * i + 2 * qd) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * a.scale, acc[4 * i + 2 * r + 1] * a.scale);
  }
}

// The three kernels in order on `stream`: delta (the CUDA-core kernel),
// dK/dV, dQ.  Returns the first error.
template <int D>
int launch(const Args& a, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = make_map(&q_map, a.ptr[kQ], a.batch, a.s, a.hq, D, a.st[kQ][0], a.st[kQ][1], a.st[kQ][2]);
  if (err == 0)
    err = make_map(&k_map, a.ptr[kK], a.batch, a.t, a.hk, D, a.st[kK][0], a.st[kK][1], a.st[kK][2]);
  if (err == 0)
    err = make_map(&v_map, a.ptr[kV], a.batch, a.t, a.hk, D, a.st[kV][0], a.st[kV][1], a.st[kV][2]);
  if (err == 0)
    err = make_map(&do_map, a.ptr[kDO], a.batch, a.s, a.hq, D, a.st[kDO][0], a.st[kDO][1],
                   a.st[kDO][2]);
  if (err != 0) return err;
  const long long rows = static_cast<long long>(a.batch) * a.hq * a.s;
  const int rows_per_block = bwd::kThreads / 32;
  bwd::flash_bwd_delta_kernel<__nv_bfloat16, D>
      <<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block), bwd::kThreads, 0,
         stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t kv_bytes = dkdv_smem<D>();
  e = bwd::set_smem(flash_bwd_dkdv_bf16_kernel<D>, kv_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_bf16_kernel<D><<<a.batch * a.hk * ((a.t + kB - 1) / kB), kThreads, kv_bytes,
                                  stream>>>(a, q_map, k_map, v_map, do_map);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t q_bytes = dq_smem<D>();
  e = bwd::set_smem(flash_bwd_dq_bf16_kernel<D>, q_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_bf16_kernel<D><<<a.batch * a.hq * ((a.s + 2 * kB - 1) / (2 * kB)), kThreads, q_bytes,
                                stream>>>(a, q_map, k_map, v_map, do_map);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dim(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(a, stream);
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 80: return launch<80>(a, stream);
    case 128: return launch<128>(a, stream);
    case 160: return launch<160>(a, stream);
    case 192: return launch<192>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bwd16

}  // namespace

// dtype 0 = fp32, 1 = bf16.  Strides are in elements, per tensor as
// (batch, sequence, head).  bf16 needs 16-byte aligned rows: every pointer
// 16-byte aligned and every stride a multiple of 8.  `lse`, when not null,
// receives each row's fp32 logsumexp of its scaled, masked scores in natural
// units, laid out (batch * hq, s): what the backward reads; null leaves the
// forward as it is without it.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); an unsupported dtype or head_dim, or
// unaligned bf16 rows, return cudaErrorInvalidValue without launching, and a
// refused tensor map 1000 + its CUresult.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
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
         causal, window, scale, lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(a, batch, d, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (long long x : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh})
    if (x % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dim<__nv_bfloat16>(a, batch, d, st);
}

// The backward of flash_attention_fwd: dq, dk and dv (in the inputs' dtype,
// 0 = fp32, 1 = bf16) from q, k, v, the output o, its gradient dout and the
// forward's logsumexp `lse` ((batch * hq, s) fp32).  `delta` is fp32
// scratch of the same shape.  `strides` holds 24 element strides, (batch,
// sequence, head) of q, k, v, o, dout, dq, dk and dv in that order; every
// head dim is contiguous.  Three kernels on `stream`: delta, dK/dV, dQ
// (bf16: on the tensor cores, reading q, k, v and dout by TMA, which needs
// each 16-byte aligned with strides a multiple of 8).  Returns 0 once all
// three are launched, else the first launch's cudaGetLastError(); an
// unsupported dtype or head_dim, or unaligned bf16 rows, return
// cudaErrorInvalidValue without launching, a refused tensor map 1000 + its
// CUresult.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* delta, int dtype,
    int batch, int hq, int hk, int s, int t, int d, const long long* strides,
    int causal, int window, float scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || s <= 0 || t <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Args a{};
  const void* tensors[bwd::kTensors] = {q, k, v, o, dout, dq, dk, dv};
  for (int i = 0; i < bwd::kTensors; ++i) {
    a.ptr[i] = tensors[i];
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  }
  a.lse = lse;
  a.delta = delta;
  a.batch = batch;
  a.hq = hq;
  a.hk = hk;
  a.s = s;
  a.t = t;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd::dispatch_dim<float>(a, d, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int i : {bwd::kQ, bwd::kK, bwd::kV, bwd::kDO}) {
    if (reinterpret_cast<uintptr_t>(a.ptr[i]) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < 3; ++j)
      if (a.st[i][j] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  return bwd16::dispatch_dim(a, d, st);
}
