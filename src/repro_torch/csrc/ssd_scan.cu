// Mamba2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _ssd_kernel) and its wrapper src/repro/kernels/ops.py (ssd_scan).
// It computes what the Pallas kernel computes, for each (batch, head) and
// each chunk of length Q in order:
//   * da = dt * a and its inclusive cumulative sum cum over the chunk;
//   * y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + (C_i . state) exp(cum_i);
//   * state <- state exp(cum_Q) + sum_j B_j (x) dt_j x_j exp(cum_Q - cum_j);
//   * the state is zero at chunk 0 and is written out, fp32, after the last
//     chunk; y is stored in x's dtype.
// exp(cum_i - cum_j) overflows for j > i (cum falls by up to |a| dt a
// step), so the upper triangle is discarded with a select, never by
// multiplying with a 0/1 mask (inf * 0 = NaN).  A ragged last chunk is
// masked on load: its missing rows read as zeros (dt = 0), which leaves the
// state unchanged, as the reference's zero padding does.
//
// Layout.  x is indexed [b, s, h, :], dt [b, s, h], B and C [b, s, :], each
// by its own element strides (the last dim contiguous), so x, B and C can be
// views of the model's one conv output without a copy.  y is written
// contiguous (B, S, H, P); the final state contiguous (B, H, P, N).
//
// Bound on an H100: B * nc * [2 Qc N + H (2 Qc P + 4 Q N P)] operations,
// Qc = Q (Q + 1) / 2, against x, dt, B, C read once and y and the final
// state written once.  At the model shapes (mamba2-780m: Q 64, N 128, 48
// heads; zamba2-2.7b: Q 256, N 64, 80 heads; bf16) that is ~130 operations a
// byte, under the card's ~295 at the bf16 tensor-core peak, so the bytes
// bound it.
//
// bf16: three kernels on the tensor cores, in the order of the plain
// version's phases (models/ssm.py::ssd_chunked; arXiv:2405.21060 section 7).
// Only the (P, N) state chain is serial; the chunk-local work is parallel
// over (batch, chunk, head):
//   1. ssd_chunk_state_kernel, a block per (batch, chunk, group of heads):
//      the chunk's cumsum of dt * a (stored, with exp(cum_Q)) and its own
//      state S_c = (x o dt exp(cum_Q - cum))^T B by wgmma, stored fp32;
//   2. ssd_state_pass_kernel, a thread per (batch, head, state element):
//      h_c = h_{c-1} exp(cum_Q,c-1) + S_{c-1} in fp32, storing the state
//      entering each chunk for phase 3 and the final state;
//   3. ssd_chunk_scan_kernel, a block per (batch, chunk, 64-row query
//      tile, group of heads): C B^T once for the whole group, then per
//      head y = exp(cum_i) C h_c^T + L x by wgmma, L = select(j <= i,
//      exp(cum_i - cum_j)) C B^T dt_j from phase 1's stored cum.
// TMA brings every x, B, C and state tile into shared memory in the
// 128-byte swizzle (hopper_tma_wgmma.cuh), through rings over the heads of
// a block (two stages in the chunk-state kernel, one per warpgroup in the
// chunk-scan kernel), so one head's loads overlap another's products.
// The computed operands (x o g, L and h_c) are bf16 hi + lo pairs, two
// products each: one bf16 rounding of any of them alone puts y beyond the
// 5e-2 abs + rel tolerance at the model shapes (an error of ~2^-9 |term|
// on outputs that cancel to near 0), the pair keeps ~16 bits.  x, B and C
// are bf16 already and go in as they are.  Every sum is in a fixed order
// and no atomics are used: two calls give the same bits.
//
// Backward (ssd_scan_bwd): the vector-Jacobian product of the chunked SSD
// from a zero state, replacing XLA's autodiff of the reference's jnp oracle
// src/repro/models/ssm.py::ssd_chunked (the Pallas kernel has no backward).
// Its math is kernels/ref.py::ssd_scan_bwd_ref's.  fp32 runs eight kernels
// on the CUDA cores (bwd::), fp32 throughout:
//   1. ssd_bwd_chunk_kernel, a block per (batch, chunk, head): cum, exp(cum_Q),
//      the chunk's own state S_c and U_c = sum_i exp(cum_i) dy_i (x) C_i;
//      and ssd_bwd_cb_kernel, a block per (batch, chunk, pair of 64-row
//      sub-tiles J <= I): C_I B_J^T, once for every head and both sides;
//   2. ssd_bwd_state_kernel, a thread per four state elements: the entering
//      states h_c forward and their cotangents G_c backward over the chunks,
//      in fp32 and in order (no state is saved by the forward: the backward
//      recomputes them from x, dt, a and B), and <G_c, h_c> per warp;
//   3. ssd_bwd_dkey_kernel and 4. ssd_bwd_dquery_kernel, a block per (batch,
//      chunk, head, 64-row tile), for the key and the query side of every
//      pair of sub-tiles j <= i: dx, the direct part of ddt, dB and dC per
//      head, and the cotangent of cum (both of its row and column sums);
//   5. ssd_bwd_cum_kernel: the cotangent of cum back through the cumsum to
//      ddt and each chunk's share of da;
//   6. ssd_bwd_reduce_kernel: dB and dC summed over heads in head order;
//   7. ssd_bwd_da_kernel: da summed over (batch, chunk) in order.
// No atomics: every sum over heads, positions or chunks has one order, so
// two calls give the same bits.  Bound on an H100: x, dy, B, C, dt read and
// dx, dB, dC, ddt written once (the bytes, at the model shapes), against
// which the scratch (the per-chunk states and cotangents) and the
// recomputation are this design's own work.
// bf16 (bwd16::) redoes phases 1, 3 and 4 on the tensor cores and drops 1b:
//   1. ssd_bwd_chunk_bf16_kernel, a block per (batch, chunk, group of
//      heads): cum and exp(cum_Q) as phase 1, then S_c and U_c by wgmma
//      with the computed A operands (x o w)^T and (dy o exp(cum))^T in bf16
//      hi + lo, the forward's chunk-state product;
//   3. ssd_bwd_dkey_bf16_kernel and 4. ssd_bwd_dquery_bf16_kernel, a block
//      per (batch, chunk, 64-row tile, group of up to 8 heads), as the
//      forward's chunk-scan kernel: the pair tiles C B^T computed once for
//      the group by wgmma (exact in fp32 from bf16), each head's x and dy
//      tiles through a TMA ring (one head's loads under another's
//      products), dy x^T by wgmma (exact), then A dy, Z C and Z' B, G_c B,
//      G_c^T x and h_c^T dy by wgmma, with the computed operands (A, Z, Z',
//      G_c, h_c, in fp32 registers or from the state pass) as bf16 hi + lo
//      pairs: one bf16 rounding of such an operand alone broke the
//      forward's 5e-2 (see the forward's note above), the pair keeps ~16
//      bits.  The upper triangle goes by a select on the exp; cum is phase
//      1's.  dB and dC are summed over the block's heads in registers in
//      head order, so phase 6 sums ceil(H / g3) partials instead of H.
//   The state pass, phase 5, 6 and 7 are bwd::'s kernels.  What bounds it
//   now: the fp32 states and cotangents (2 B nc H P N floats, written by
//   phase 1 and read and rewritten by the state pass) and the state pass's
//   serial chain over the chunks; the pair kernels hold one warpgroup and
//   up to ~200 KB of shared memory a block (zamba2's chunk of 256: four
//   query tiles' C rows and pair tiles), so latency is poorly hidden.
//
// fp32: the CUDA-core kernel ssd_scan_kernel, since TF32 cannot meet the
// fp32 tolerance of 2e-4.  One block of 256 threads owns one (batch, head),
// walks its chunks in order with its (P, N) fp32 state in shared memory,
// and cuts a chunk into 64-row sub-tiles: per query tile I, the
// inter-chunk term, then the score tiles C_I B_J^T for J <= I (4x4
// register micro-tiles over a 16 x 16 thread grid) times the decay and
// dt_j, then L . x_J; the diagonal tile adds its share of the state update.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "hopper_tma_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kTile = 64;        // rows of a sub-tile of the chunk
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLd = kTile + 1;   // padded leading dim of ct, bt and ls
constexpr int kMaxChunk = 256;

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* fin;
  int h, s, chunk;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

template <int P, int N>
constexpr size_t smem_bytes() {
  // ct[N][kLd] + bt[N][kLd] + xs[kTile][P] + ls[kTile][kLd] + st[N][P]
  // + cum, ecum, g, dts [kMaxChunk], all fp32
  return sizeof(float) *
         (2 * N * kLd + kTile * P + kTile * kLd + N * P + 4 * kMaxChunk);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Args a) {
  constexpr int kPC = (P + 15) / 16;  // columns p = tx + 16 c
  constexpr int kNR = (N + 15) / 16;  // state rows n = ty + 16 r

  extern __shared__ float smem[];
  float* ct = smem;               // [N][kLd], ct[n][i] = C[i][n]
  float* bt = ct + N * kLd;       // [N][kLd], bt[n][j] = B[j][n]
  float* xs = bt + N * kLd;       // [kTile][P], x of key tile J
  float* ls = xs + kTile * P;     // [kTile][kLd], L[i][j]
  float* st = ls + kTile * kLd;   // [N][P], the running state, st[n][p]
  float* cum = st + N * P;        // [kMaxChunk] inclusive cumsum of dt * a
  float* ecum = cum + kMaxChunk;  // exp(cum)
  float* g = ecum + kMaxChunk;    // dt_j exp(cum_Q - cum_j)
  float* dts = g + kMaxChunk;     // dt

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bi = blockIdx.x / a.h;
  const int h = blockIdx.x % a.h;
  const float a_h = a.a[h];

  const T* x = static_cast<const T*>(a.x) + bi * a.x_sb + h * a.x_sh;
  const float* dt = a.dt + bi * a.dt_sb + h * a.dt_sh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb;
  const long long y_ss = static_cast<long long>(a.h) * P;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(bi) * a.s * y_ss +
         static_cast<long long>(h) * P;

  // Rows of ct/bt beyond a short tile are read by the micro-tiles and
  // discarded by the select; start them finite.
  for (int l = tid; l < N * kLd; l += kThreads) {
    ct[l] = 0.0f;
    bt[l] = 0.0f;
  }
  for (int l = tid; l < N * P; l += kThreads) st[l] = 0.0f;

  const int q = a.chunk;
  const int tile = min(q, kTile);
  const int n_tiles = q / tile;
  const int n_chunks = (a.s + q - 1) / q;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * q;
    __syncthreads();  // the previous chunk's state update and arrays are done
    for (int l = tid; l < q; l += kThreads) {
      const int si = s0 + l;
      dts[l] = si < a.s ? dt[si * a.dt_ss] : 0.0f;
    }
    __syncthreads();
    if (tid < 32) {
      // Inclusive scan of dt * a by warp 0: each lane a serial run of
      // ceil(Q / 32) steps, then a shuffle scan of the runs' totals.
      const int per = (q + 31) / 32;
      const int lo = min(tid * per, q);
      const int hi = min(lo + per, q);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        run += dts[i] * a_h;
        cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      for (int i = lo; i < hi; ++i) cum[i] += excl;
    }
    __syncthreads();
    const float cum_end = cum[q - 1];
    for (int l = tid; l < q; l += kThreads) {
      ecum[l] = expf(cum[l]);
      g[l] = dts[l] * expf(cum_end - cum[l]);
    }

    float acc_s[kNR][kPC];  // this chunk's state update, st[n][p] layout
#pragma unroll
    for (int r = 0; r < kNR; ++r)
#pragma unroll
      for (int c = 0; c < kPC; ++c) acc_s[r][c] = 0.0f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * tile;
      if (s0 + i0 >= a.s) break;  // the ragged chunk's empty tail tiles
      __syncthreads();  // ecum and g written; the previous tile's ct read
      for (int l = tid; l < tile * N; l += kThreads) {
        const int i = l / N;
        const int n = l % N;
        const int si = s0 + i0 + i;
        ct[n * kLd + i] = si < a.s ? to_float(cp[si * a.c_ss + n]) : 0.0f;
      }
      __syncthreads();

      // Inter-chunk term: (C_I . state) exp(cum_i).
      float acc[4][kPC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ct[n * kLd + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          if (p < P) {
            const float sv = st[n * P + p];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(cv[r], sv, acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < tile ? ecum[i0 + i] : 0.0f;
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] *= e;
      }

      // Intra-chunk term over the key tiles J <= I.
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * tile;
        __syncthreads();  // the previous key tile's bt, xs and ls are read
        for (int l = tid; l < tile * N; l += kThreads) {
          const int j = l / N;
          const int n = l % N;
          const int sj = s0 + j0 + j;
          bt[n * kLd + j] = sj < a.s ? to_float(bp[sj * a.b_ss + n]) : 0.0f;
        }
        for (int l = tid; l < tile * P; l += kThreads) {
          const int j = l / P;
          const int p = l % P;
          const int sj = s0 + j0 + j;
          xs[j * P + p] = sj < a.s ? to_float(x[sj * a.x_ss + p]) : 0.0f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) sc[r][cc] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = ct[n * kLd + ty + 16 * r];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) bv[cc] = bt[n * kLd + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) sc[r][cc] = fmaf(cv[r], bv[cc], sc[r][cc]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int i = ty + 16 * r;
            const int j = tx + 16 * cc;
            const int gi = i0 + i;  // positions within the chunk
            const int gj = j0 + j;
            float v = 0.0f;  // a select: exp overflows above the diagonal
            if (i < tile && j < tile && gj <= gi)
              v = sc[r][cc] * expf(cum[gi] - cum[gj]) * dts[gj];
            ls[i * kLd + j] = v;
          }
        }
        __syncthreads();

        for (int j = 0; j < tile; ++j) {
          float lv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) lv[r] = ls[(ty + 16 * r) * kLd + j];
#pragma unroll
          for (int c = 0; c < kPC; ++c) {
            const int p = tx + 16 * c;
            if (p < P) {
              const float xv = xs[j * P + p];
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(lv[r], xv, acc[r][c]);
            }
          }
        }
      }

      // bt and xs hold tile I: its share of the state update.
      for (int j = 0; j < tile; ++j) {
        const float gj = g[i0 + j];
#pragma unroll
        for (int r = 0; r < kNR; ++r) {
          const int n = ty + 16 * r;
          if (n < N) {
            const float bv = bt[n * kLd + j] * gj;
#pragma unroll
            for (int c = 0; c < kPC; ++c) {
              const int p = tx + 16 * c;
              if (p < P) acc_s[r][c] = fmaf(bv, xs[j * P + p], acc_s[r][c]);
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const int si = s0 + i0 + i;
        if (i >= tile || si >= a.s) continue;
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          if (p < P) y[si * y_ss + p] = from_float<T>(acc[r][c]);
        }
      }
    }

    __syncthreads();  // every query tile has read the old state
    const float decay = expf(cum_end);
#pragma unroll
    for (int r = 0; r < kNR; ++r) {
      const int n = ty + 16 * r;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < kPC; ++c) {
        const int p = tx + 16 * c;
        if (p < P) st[n * P + p] = st[n * P + p] * decay + acc_s[r][c];
      }
    }
  }
  __syncthreads();

  float* fin = a.fin + (static_cast<long long>(bi) * a.h + h) * P * N;
  for (int l = tid; l < P * N; l += kThreads) {
    const int p = l / N;
    const int n = l % N;
    fin[l] = st[n * P + p];
  }
}

template <typename T, int P, int N>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, P, N><<<batch * a.h, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: three kernels in the order of ssd_chunked's phases
// ---------------------------------------------------------------------------
namespace bf16 {

using namespace hopper;

constexpr int kRows = 64;                 // rows of a tile: one wgmma M, one TMA box
constexpr int kThreads = 128;             // one warpgroup
constexpr int kPassThreads = 256;         // ssd_state_pass_kernel
constexpr int kMaxSmem = 232448;          // a block's dynamic shared memory on the H100
constexpr int kStashBytes = 32 * kThreads * 4;  // one 64 x 64 fp32 score tile
constexpr int kOutLd = 36;  // padded row of a warp's 32-column slice of S_c

// The wgmma N of a product whose output has `d` columns: 16 at least.
__host__ __device__ constexpr int wg_n(int d) { return d < 16 ? 16 : d; }

struct Args {
  int batch, s, h, p, n, chunk;
  int nc;      // chunks
  int nt;      // 64-row tiles of a chunk: ceil(chunk / 64)
  int g1, g3;  // heads per block of the chunk-state and chunk-scan kernels
  int nh;      // row length of the h scratch: N rounded up to 8
  const float* dt;
  long long dt_sb, dt_ss, dt_sh;
  const float* a;
  __nv_bfloat16* y;     // (B, S, H, P) contiguous
  float* fin;           // (B, H, P, N)
  float* states;        // (B, nc, H, P, N) S_c, fp32
  float* cum;           // (B, nc, H, Q) inclusive cumsum of dt * a
  float* decay;         // (B, nc, H) exp(cum_Q)
  __nv_bfloat16* h_hi;  // (B, nc, H, P, nh) state entering each chunk, hi part
  __nv_bfloat16* h_lo;  // the same, lo = bf16(h - hi)
};


// Phase 1.  Block = (batch row, chunk, group of g1 heads), one warpgroup.
// The chunk's B rows arrive once by TMA; each head's x rows arrive by TMA
// into a 2-stage ring, one head ahead.  Per head: the chunk's inclusive
// cumsum of dt * a (one warp, a fixed order), stored with exp(cum_Q); then
// S_c = (x o g)^T B with g_j = dt_j exp(cum_Q - cum_j): A = (x o g)^T, P x Q,
// built in registers from the swizzled x tile and split into bf16 hi + lo;
// B = the B rows read MN-major.  S_c is stored fp32.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const Args a, const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap b_map) {
  constexpr int kN = wg_n(N);
  constexpr int kAcc = kN / 2;
  using TX = Tile<P>;
  using TB = Tile<N>;
  constexpr int kStages = 2;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* b_s = align1024(smem_raw);             // nt tiles of B
  unsigned char* x_s = b_s + a.nt * TB::kBytes;         // kStages x nt tiles of x
  const int kr = a.nt * kRows;                          // rows held per head
  float* dt_s = reinterpret_cast<float*>(x_s + kStages * a.nt * TX::kBytes);  // [g1][kr]
  float* cum_s = dt_s + a.g1 * kr;                      // [g1][kr]
  __shared__ __align__(16) float out_s[4 * 16 * kOutLd];  // each warp's 16 rows of S_c
  __shared__ uint64_t b_bar, x_bar[kStages];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int groups = (a.h + a.g1 - 1) / a.g1;
  const int grp = blockIdx.x % groups;
  const int bc = blockIdx.x / groups;
  const int bi = bc / a.nc;
  const int c = bc % a.nc;
  const int h0 = grp * a.g1;
  const int nheads = min(a.g1, a.h - h0);
  const int q = a.chunk;
  const int s0 = c * q;

  auto load_x = [&](int k) {
    const int st = k % kStages;
    mbar_expect(&x_bar[st], a.nt * TX::kBytes);
    for (int t = 0; t < a.nt; ++t)
      tma_tile<P>(x_s + (st * a.nt + t) * TX::kBytes, &x_map, &x_bar[st], s0 + kRows * t,
                  h0 + k, bi);
  };
  if (tid == 0) {
    mbar_init(&b_bar);
    for (int i = 0; i < kStages; ++i) mbar_init(&x_bar[i]);
    mbar_fence_init();
    mbar_expect(&b_bar, a.nt * TB::kBytes);
    for (int t = 0; t < a.nt; ++t)
      tma_tile<N>(b_s + t * TB::kBytes, &b_map, &b_bar, s0 + kRows * t, 0, bi);
    for (int k = 0; k < min(kStages, nheads); ++k) load_x(k);
  }

  // The cumulative sums, one warp per head: serial runs of ceil(Q / 32)
  // steps, then a shuffle scan of the runs' totals.  dt is read as zero past
  // S (the ragged chunk); rows past Q (a chunk under 64 rows) have g = 0.
  for (int k = warp; k < nheads; k += kThreads / 32) {
    const int h = h0 + k;
    const float a_h = a.a[h];
    float* dts = dt_s + k * kr;
    float* cum = cum_s + k * kr;
    const float* dt = a.dt + bi * a.dt_sb + h * a.dt_sh;
    for (int l = lane; l < kr; l += 32) {
      const int si = s0 + l;
      dts[l] = (l < q && si < a.s) ? dt[si * a.dt_ss] : 0.0f;
    }
    __syncwarp();
    const int per = (q + 31) / 32;
    const int lo = min(lane * per, q);
    const int hi = min(lo + per, q);
    float run = 0.0f;
    for (int i = lo; i < hi; ++i) {
      run += dts[i] * a_h;
      cum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    for (int i = lo; i < hi; ++i) cum[i] += excl;
    __syncwarp();
    const float cum_end = cum[q - 1];
    float* cum_out = a.cum + ((static_cast<long long>(bi) * a.nc + c) * a.h + h) * q;
    for (int l = lane; l < kr; l += 32) {
      float g = 0.0f;
      if (l < q) {
        g = dts[l] * expf(cum_end - cum[l]);
        cum_out[l] = cum[l];
      }
      dts[l] = g;  // dts now holds g
    }
    if (lane == 0) a.decay[(static_cast<long long>(bi) * a.nc + c) * a.h + h] = expf(cum_end);
  }
  __syncthreads();
  mbar_wait(&b_bar, 0);

  const int g = lane / 4;
  const int qd = lane % 4;
  const int p0 = 16 * warp + g;  // this thread's rows of S_c: p0, p0 + 8
  for (int k = 0; k < nheads; ++k) {
    const int st = k % kStages;
    const int h = h0 + k;
    mbar_wait(&x_bar[st], (k / kStages) & 1);
    const float* gk = dt_s + k * kr;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int t = 0; t < a.nt; ++t) {
      const unsigned char* xt = x_s + (st * a.nt + t) * TX::kBytes;
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // columns j, j + 1 and j + 8, j + 9
          const int r = 16 * kk + 2 * qd + 8 * half;  // row of the x tile
          const float g0 = gk[kRows * t + r];
          const float g1 = gk[kRows * t + r + 1];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {  // rows p0 and p0 + 8
            const int pp = p0 + 8 * rr;
            const float v0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                                 xt + swizzled(r, pp))) * g0;
            const float v1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                                 xt + swizzled(r + 1, pp))) * g1;
            float h0v, l0v, h1v, l1v;
            split(v0, h0v, l0v);
            split(v1, h1v, l1v);
            fh[kk][2 * half + rr] = pack_bf16(h0v, h1v);
            fl[kk][2 * half + rr] = pack_bf16(l0v, l1v);
          }
        }
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // Rows 16 kk .. 16 kk + 15 of tile t: two 8-row groups of 1024 bytes.
        // Rows past the chunk have g = 0: their A columns are zero.
        const uint64_t db = make_desc(b_s + t * TB::kBytes + kk * 2048, TB::kAtomBytes, 1024);
        wgmma_rs<kN>(acc, fh[kk], db);
        wgmma_rs<kN>(acc, fl[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }

    // acc[4 i + e]: row p0 + 8 (e >> 1), column 8 i + 2 qd + (e & 1).  Each
    // warp stages its 16 rows, 32 columns at a time, in its own slice of
    // shared memory, then stores whole 128-byte rows with 16-byte stores.
    float* out = a.states + ((static_cast<long long>(bi) * a.nc + c) * a.h + h) * P * N;
    float* stage = out_s + warp * 16 * kOutLd;
#pragma unroll
    for (int cb = 0; cb < (kN + 31) / 32; ++cb) {
#pragma unroll
      for (int i = 4 * cb; i < min(4 * cb + 4, kAcc / 4); ++i) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(stage + (g + 8 * rr) * kOutLd + 8 * (i - 4 * cb) + 2 * qd) =
              make_float2(acc[4 * i + 2 * rr], acc[4 * i + 2 * rr + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * r + lane / 8;
        const int col = 4 * (lane % 8);
        const int pp = 16 * warp + row;
        const int n = 32 * cb + col;
        if (pp < P && n < N)
          *reinterpret_cast<float4*>(out + pp * N + n) =
              *reinterpret_cast<const float4*>(stage + row * kOutLd + col);
      }
      __syncwarp();
    }
    __syncthreads();  // every thread is done with this stage before it refills
    if (tid == 0 && k + kStages < nheads) load_x(k + kStages);
  }
}

// Phase 2.  Block = (batch row, head, 1024 state elements); a thread walks
// the chunks in order with four consecutive elements of one row of the (P,
// N) state in fp32: h_0 = 0, h_c = h_{c-1} exp(cum_Q,c-1) + S_{c-1}.  The
// state entering each chunk is stored as bf16 hi + lo (phase 3's operand);
// the chain itself stays fp32, and the final state is stored fp32.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const Args a) {
  const int pn = a.p * a.n;  // N is a multiple of 4: four elements share a row
  const int e = 4 * (blockIdx.y * kPassThreads + threadIdx.x);
  if (e >= pn) return;
  const int bi = blockIdx.x / a.h;
  const int h = blockIdx.x % a.h;
  const int p = e / a.n;
  const int n = e % a.n;
  const long long first = static_cast<long long>(bi) * a.nc * a.h + h;  // (bi, chunk 0, h)
  const float4* __restrict__ s_in = reinterpret_cast<const float4*>(a.states + first * pn + e);
  const float* __restrict__ dec = a.decay + first;
  const long long h_off = first * a.p * a.nh + p * a.nh + n;
  uint2* __restrict__ hi = reinterpret_cast<uint2*>(a.h_hi + h_off);
  uint2* __restrict__ lo = reinterpret_cast<uint2*>(a.h_lo + h_off);
  const long long s_step = static_cast<long long>(a.h) * pn / 4;       // in float4
  const long long h_step = static_cast<long long>(a.h) * a.p * a.nh / 4;  // in 4 x bf16
  float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int c = 0; c < a.nc; ++c) {
    float vh[4], vl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(st[i], vh[i], vl[i]);
    hi[c * h_step] = make_uint2(pack_bf16(vh[0], vh[1]), pack_bf16(vh[2], vh[3]));
    lo[c * h_step] = make_uint2(pack_bf16(vl[0], vl[1]), pack_bf16(vl[2], vl[3]));
    const float4 sv = s_in[c * s_step];
    const float d = dec[c * a.h];
    st[0] = fmaf(st[0], d, sv.x);
    st[1] = fmaf(st[1], d, sv.y);
    st[2] = fmaf(st[2], d, sv.z);
    st[3] = fmaf(st[3], d, sv.w);
  }
  *reinterpret_cast<float4*>(a.fin + (static_cast<long long>(bi) * a.h + h) * pn + e) =
      make_float4(st[0], st[1], st[2], st[3]);
}

// Phase 3.  Block = (batch row, chunk, 64-row query tile I, group of g3
// heads), two warpgroups; the heaviest query tiles are numbered first.  The
// C rows of I and the B rows of the key tiles J <= I arrive once by TMA;
// the score tiles C_I B_J^T (wgmma, fp32; warpgroup w computes the tiles
// J = w, w + 2) are computed once and kept in shared memory, over the B
// rows they were computed from, in the accumulator layout that both
// warpgroups share, for every head of the group.  Warpgroup w takes heads
// w, w + 2, ...; each head's x rows of the key tiles and its entering state
// h_c (hi and lo) arrive by TMA into the warpgroup's stage of the ring,
// while the other warpgroup computes.  Per head:
//   acc  = C_I (h_hi + h_lo)^T        (wgmma, both operands K-major)
//   acc *= exp(cum_i)                  (rows, on the accumulators)
//   acc += L_IJ x_J, J <= I            (wgmma, L from registers in bf16 hi + lo,
//                                       x MN-major)
// with L_ij = select(j <= i, exp(cum_i - cum_j)) C_i.B_j dt_j, and cum the
// values phase 1 stored; y is stored once in bf16.
template <int P, int N>
__global__ void __launch_bounds__(2 * kThreads)
ssd_chunk_scan_kernel(const Args a, const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap b_map,
                      const __grid_constant__ CUtensorMap c_map,
                      const __grid_constant__ CUtensorMap hi_map,
                      const __grid_constant__ CUtensorMap lo_map) {
  constexpr int kP = wg_n(P);
  constexpr int kAcc = kP / 2;
  constexpr int kNk = (N + 15) / 16;  // k-steps over the state dim
  using TX = Tile<P>;
  using TB = Tile<N>;
  static_assert(TB::kBytes <= kStashBytes, "a score tile stashes over its B rows");

  const int kr = a.nt * kRows;
  const int stage_bytes = a.nt * TX::kBytes + 2 * TB::kBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* c_s = align1024(smem_raw);              // C rows of I
  unsigned char* b_s = c_s + TB::kBytes;                 // nt tiles of B, then the stash
  float* stash = reinterpret_cast<float*>(b_s);          // [nt][32][128]
  unsigned char* ring = b_s + a.nt * kStashBytes;        // 2 x {nt x tiles, h_hi, h_lo}
  float* cum_s = reinterpret_cast<float*>(ring + 2 * stage_bytes);  // [g3][kr]
  float* dt_s = cum_s + a.g3 * kr;                       // [g3][kr]
  __shared__ uint64_t cb_bar, ring_bar[2];

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int ltid = tid % kThreads;  // thread of the warpgroup
  const int warp = ltid / 32;
  const int lane = tid % 32;
  const int groups = (a.h + a.g3 - 1) / a.g3;
  const int per_tile = a.batch * a.nc * groups;
  const int it = a.nt - 1 - blockIdx.x / per_tile;
  const int rest = blockIdx.x % per_tile;
  const int grp = rest % groups;
  const int bc = rest / groups;
  const int bi = bc / a.nc;
  const int c = bc % a.nc;
  const int h0 = grp * a.g3;
  const int nheads = min(a.g3, a.h - h0);
  const int q = a.chunk;
  const int s0 = c * q;
  const int rows = min(q, a.s - s0);  // valid rows of this chunk
  const int nk = it + 1;              // key tiles J <= I

  // Head k into stage k % 2, the stage of warpgroup k % 2.
  auto load_head = [&](int k) {
    const int st = k % 2;
    unsigned char* dst = ring + st * stage_bytes;
    mbar_expect(&ring_bar[st], nk * TX::kBytes + 2 * TB::kBytes);
    for (int t = 0; t < nk; ++t)
      tma_tile<P>(dst + t * TX::kBytes, &x_map, &ring_bar[st], s0 + kRows * t, h0 + k, bi);
    unsigned char* hs = dst + a.nt * TX::kBytes;
    tma_tile<N>(hs, &hi_map, &ring_bar[st], 0, h0 + k, bi * a.nc + c);
    tma_tile<N>(hs + TB::kBytes, &lo_map, &ring_bar[st], 0, h0 + k, bi * a.nc + c);
  };
  if (tid == 0) {
    mbar_init(&cb_bar);
    for (int i = 0; i < 2; ++i) mbar_init(&ring_bar[i]);
    mbar_fence_init();
    mbar_expect(&cb_bar, (1 + nk) * TB::kBytes);
    tma_tile<N>(c_s, &c_map, &cb_bar, s0 + kRows * it, 0, bi);
    for (int t = 0; t < nk; ++t)
      tma_tile<N>(b_s + t * TB::kBytes, &b_map, &cb_bar, s0 + kRows * t, 0, bi);
    for (int k = 0; k < min(2, nheads); ++k) load_head(k);
  }
  __syncthreads();  // the barriers are initialised
  // Phase 1's cumsums and dt of the group's heads (zero past the chunk).
  for (int l = tid; l < nheads * nk * kRows; l += 2 * kThreads) {
    const int k = l / (nk * kRows);
    const int j = l % (nk * kRows);
    const int h = h0 + k;
    const long long row = (static_cast<long long>(bi) * a.nc + c) * a.h + h;
    cum_s[k * kr + j] = j < q ? a.cum[row * q + j] : 0.0f;
    dt_s[k * kr + j] = j < rows ? a.dt[bi * a.dt_sb + (s0 + j) * a.dt_ss + h * a.dt_sh] : 0.0f;
  }
  mbar_wait(&cb_bar, 0);

  // Score tiles C_I B_J^T into registers (at most two per warpgroup), then,
  // once every B row is read, into the stash: stash[(J * 32 + e) * 128 + ltid].
  float sc[2][32];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int jt = wg + 2 * u;
    if (jt < nk) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[u][i] = 0.0f;
      fence_regs(sc[u]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNk; ++kk) {
        const int off = (kk / 4) * TB::kAtomBytes + (kk % 4) * 32;  // atom, then 16 columns
        wgmma_ss<64>(sc[u], make_desc(c_s + off, 16, 1024),
                     make_desc(b_s + jt * TB::kBytes + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc[u]);
    }
  }
  __syncthreads();  // every B row is read; cum_s and dt_s are written
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int jt = wg + 2 * u;
    if (jt < nk) {
#pragma unroll
      for (int e = 0; e < 32; ++e) stash[(jt * 32 + e) * kThreads + ltid] = sc[u][e];
    }
  }
  __syncthreads();  // the stash is complete

  const int g = lane / 4;
  const int qd = lane % 4;
  const int r0 = kRows * it + 16 * warp + g;  // this thread's rows in the chunk: r0, r0 + 8
  const unsigned char* xs = ring + wg * stage_bytes;
  const unsigned char* hs = xs + a.nt * TX::kBytes;
  for (int k = wg; k < nheads; k += 2) {
    const int h = h0 + k;
    const float* cum = cum_s + k * kr;
    const float* dt = dt_s + k * kr;
    mbar_wait(&ring_bar[wg], (k / 2) & 1);

    float acc[kAcc];  // y of this head's 64 rows
    // L_IJ in registers, bf16 hi + lo, in the wgmma A-fragment layout.
    auto build_l = [&](int jt, uint32_t (&fh)[4][4], uint32_t (&fl)[4][4]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // keys 8 i .. 8 i + 7 of tile J
        float lh[4], ll[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = r0 + 8 * (e >> 1);
          const int j = kRows * jt + 8 * i + 2 * qd + (e & 1);
          const float sc = stash[(jt * 32 + 4 * i + e) * kThreads + ltid];
          // A select: exp overflows above the diagonal.
          const float v = (j <= ri && ri < rows) ? __expf(cum[ri] - cum[j]) * sc * dt[j] : 0.0f;
          split(v, lh[e], ll[e]);
        }
        // Keys 8 i .. 8 i + 7 are k-step i / 2, half i % 2.
        fh[i / 2][2 * (i % 2) + 0] = pack_bf16(lh[0], lh[1]);
        fh[i / 2][2 * (i % 2) + 1] = pack_bf16(lh[2], lh[3]);
        fl[i / 2][2 * (i % 2) + 0] = pack_bf16(ll[0], ll[1]);
        fl[i / 2][2 * (i % 2) + 1] = pack_bf16(ll[2], ll[3]);
      }
    };
    // acc += L_IJ x_J, started and committed; the caller waits.
    auto start_lx = [&](int jt, const uint32_t (&fh)[4][4], const uint32_t (&fl)[4][4]) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = make_desc(xs + jt * TX::kBytes + kk * 2048, TX::kAtomBytes, 1024);
        wgmma_rs<kP>(acc, fh[kk], db);
        wgmma_rs<kP>(acc, fl[kk], db);
      }
      wgmma_commit();
    };

    // The inter-chunk term, computed while L_I0 is built; then its row
    // scale exp(cum_i).
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int kk = 0; kk < kNk; ++kk) {
        const int off = (kk / 4) * TB::kAtomBytes + (kk % 4) * 32;
        wgmma_ss<kP>(acc, make_desc(c_s + off, 16, 1024),
                     make_desc(hs + part * TB::kBytes + off, 16, 1024), part + kk > 0);
      }
    }
    wgmma_commit();
    uint32_t ah[4][4], al[4][4], bh[4][4], bl[4][4];
    build_l(0, ah, al);
    wgmma_wait_all();
    fence_regs(acc);
    const float e0 = expf(cum[r0]);
    const float e1 = expf(cum[r0 + 8]);
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) {
      acc[4 * i + 0] *= e0;
      acc[4 * i + 1] *= e0;
      acc[4 * i + 2] *= e1;
      acc[4 * i + 3] *= e1;
    }
    fence_regs(acc);

    // The intra-chunk term over the key tiles J <= I: the next tile's L is
    // built while this tile's products run.
    for (int jt = 0; jt < nk; jt += 2) {
      start_lx(jt, ah, al);
      if (jt + 1 < nk) build_l(jt + 1, bh, bl);
      wgmma_wait_all();
      fence_regs(acc);
      if (jt + 1 < nk) {
        start_lx(jt + 1, bh, bl);
        if (jt + 2 < nk) build_l(jt + 2, ah, al);
        wgmma_wait_all();
        fence_regs(acc);
      }
    }

    // acc[4 i + e]: row r0 + 8 (e >> 1), column 8 i + 2 qd + (e & 1).
    __nv_bfloat16* y = a.y + (static_cast<long long>(bi) * a.s + s0) * a.h * P +
                       static_cast<long long>(h) * P;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int ri = r0 + 8 * rr;
      if (ri >= rows) continue;
#pragma unroll
      for (int i = 0; i < kAcc / 4; ++i) {
        const int pp = 8 * i + 2 * qd;
        if (pp < P)
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(ri) * a.h * P + pp) =
              __floats2bfloat162_rn(acc[4 * i + 2 * rr], acc[4 * i + 2 * rr + 1]);
      }
    }
    // This warpgroup is done with its stage before it refills.
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "r"(kThreads) : "memory");
    if (ltid == 0 && k + 2 < nheads) load_head(k + 2);
  }
}

// Dynamic shared memory of each kernel, 1 KB of alignment included.
template <int P, int N>
size_t state_smem(const Args& a) {
  return 1024 + static_cast<size_t>(a.nt) * (Tile<N>::kBytes + 2 * Tile<P>::kBytes) +
         2 * sizeof(float) * a.g1 * a.nt * kRows;
}

template <int P, int N>
size_t scan_smem(const Args& a) {
  return 1024 + static_cast<size_t>(Tile<N>::kBytes) + static_cast<size_t>(a.nt) * kStashBytes +
         2 * static_cast<size_t>(a.nt * Tile<P>::kBytes + 2 * Tile<N>::kBytes) +
         2 * sizeof(float) * a.g3 * a.nt * kRows;
}

template <int P, int N>
int launch(Args a, const void* x, long long x_sb, long long x_ss, long long x_sh,
           const void* b, long long b_sb, long long b_ss,
           const void* c, long long c_sb, long long c_ss, cudaStream_t stream) {
  const dim3 pass_grid(a.batch * a.h, (a.p * a.n + 4 * kPassThreads - 1) / (4 * kPassThreads));
  if (a.nc == 0) {  // an empty sequence: the final state is zero
    ssd_state_pass_kernel<<<pass_grid, kPassThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap x_map, b_map, c_map, hi_map, lo_map;
  const long long h_rows = static_cast<long long>(a.p) * a.nh;
  int err = make_map(&x_map, x, a.batch, a.s, a.h, P, x_sb, x_ss, x_sh);
  if (err == 0) err = make_map(&b_map, b, a.batch, a.s, 1, N, b_sb, b_ss, 0);
  if (err == 0) err = make_map(&c_map, c, a.batch, a.s, 1, N, c_sb, c_ss, 0);
  if (err == 0)
    err = make_map(&hi_map, a.h_hi, a.batch * a.nc, P, a.h, N, a.h * h_rows, a.nh, h_rows);
  if (err == 0)
    err = make_map(&lo_map, a.h_lo, a.batch * a.nc, P, a.h, N, a.h * h_rows, a.nh, h_rows);
  if (err != 0) return err;

  const size_t smem1 = state_smem<P, N>(a);
  const size_t smem3 = scan_smem<P, N>(a);
  if (smem1 > static_cast<size_t>(kMaxSmem) || smem3 > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ssd_chunk_state_kernel<P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem1));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_scan_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem3));
  if (e != cudaSuccess) return static_cast<int>(e);

  const int groups1 = (a.h + a.g1 - 1) / a.g1;
  const int groups3 = (a.h + a.g3 - 1) / a.g3;
  ssd_chunk_state_kernel<P, N><<<a.batch * a.nc * groups1, kThreads, smem1, stream>>>(
      a, x_map, b_map);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_pass_kernel<<<pass_grid, kPassThreads, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_scan_kernel<P, N><<<a.batch * a.nc * a.nt * groups3, 2 * kThreads, smem3, stream>>>(
      a, x_map, b_map, c_map, hi_map, lo_map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// The backward: the vector-Jacobian product of the chunked SSD on the CUDA
// cores, fp32 and bf16 inputs alike (bf16 widened on load, fp32 throughout)
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int kTile = 64;        // rows of a sub-tile of the chunk
constexpr int kThreads = 256;    // 16 x 16 threads: rows ty + 16 r, columns tx + 16 c
constexpr int kLd = kTile + 1;   // padded row of a 64 x 64 pair tile
constexpr int kMaxChunk = 256;
constexpr int kPassThreads = 256;
constexpr int kPartElems = 128;  // state elements of one <G, h> partial: a warp's 32 x 4
constexpr int kReduceThreads = 256;
constexpr int kStateBatch = 4;   // chunks whose loads the state pass keeps in flight

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const void* dy;
  const float* dfin;  // (B, H, P, N) or null (zero)
  void* dx;           // (B, S, H, P) contiguous, x's dtype
  float* ddt;         // (B, S, H) contiguous
  float* da;          // (H,)
  void* db;           // (B, S, N) contiguous, B's dtype
  void* dc;           // (B, S, N) contiguous
  float* cum;         // (B, nc, H, Q) inclusive cumsum of dt * a over the chunk
  float* decay;       // (B, nc, H) exp(cum_Q)
  float* hs;          // (B, nc, H, P, N) S_c, then the state entering chunk c
  float* gs;          // (B, nc, H, P, N) U_c, then G_c (cotangent of the state after c)
  float* hg;          // (B, nc, H, nparts) partials of <G_c, h_c>
  float* ddt_x;       // (B, nc, H, Q) x_j . v_j
  float* dcum_k;      // (B, nc, H, Q) -(sum_i M_ij) - T_j
  float* tj;          // (B, nc, H, Q) T_j
  float* dcum_q;      // (B, nc, H, Q) sum_j M_ij + exp(cum_i) C_i . (h_c^T dy_i)
  float* db_h;        // (B, S, parts, N) dB of each head (fp32) or head group (bf16)
  float* dc_h;        // (B, S, parts, N) dC likewise
  float* da_p;        // (B, nc, H) sum over the chunk of dt d(dt a)
  float* cb;          // (B, nc, npairs, 64, 64) C_I B_J^T of each pair of sub-tiles J <= I (fp32)
  int batch, s, h, p, n, chunk, nc, nt, nparts, npairs;
  int parts;          // dB / dC partials per position: H (fp32), head groups (bf16)
  int g1, g3;         // bf16: heads per block of the chunk kernel and of the pair kernels
  int st1, st3;       // bf16: TMA ring stages of the chunk kernel and of the pair kernels
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long dy_sb, dy_ss, dy_sh;
};

template <typename T> __device__ __forceinline__ float load(const T* p);
template <> __device__ __forceinline__ float load<float>(const float* p) { return *p; }
template <typename T> __device__ __forceinline__ T store_as(float v);
template <> __device__ __forceinline__ float store_as<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 columns at least, padded to an odd row length: a column operand read
// as (tx + 16 c) * ld + k then hits 16 different banks.
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// dst[r][col] (row length ld) = scale[r] * src[s0 + r][col] as fp32 for the
// first `rows` rows that lie before s_total and the first `width` columns;
// every other entry of the 64 x wpad tile is 0.  src points at the (batch,
// head) and is strided by `stride` per position, its last dim contiguous.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, int wpad, const T* src,
                                          long long stride, int width, int s0, int rows,
                                          int s_total, const float* scale) {
  for (int l = threadIdx.x; l < kTile * wpad; l += kThreads) {
    const int r = l / wpad;
    const int col = l % wpad;
    const int si = s0 + r;
    float v = 0.0f;
    if (r < rows && si < s_total && col < width) {
      v = load(src + si * stride + col);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ld + col] = v;
  }
}

// acc[r][c] += sum_{k < kdim} A(ty + 16 r, k) B(tx + 16 c, k), with
// A(row, k) = a[row * a_r + k * a_k] and B(col, k) = b[col * b_c + k * b_k]
// in shared memory.  Within a warp A is read at two rows (a broadcast) and
// B at 16 columns, so b_c is 1 or odd.
template <int RT, int CT>
__device__ __forceinline__ void mma(float (&acc)[RT][CT], const float* a, int a_r, int a_k,
                                    const float* b, int b_c, int b_k, int kdim, int tx,
                                    int ty) {
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    float av[RT], bv[CT];
#pragma unroll
    for (int r = 0; r < RT; ++r) av[r] = a[(ty + 16 * r) * a_r + k * a_k];
#pragma unroll
    for (int c = 0; c < CT; ++c) bv[c] = b[(tx + 16 * c) * b_c + k * b_k];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int RT, int CT>
__device__ __forceinline__ void zero(float (&acc)[RT][CT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.0f;
}

// Row of the (batch, chunk, head) scratch.
__device__ __forceinline__ long long row_of(const Args& a, int bi, int c, int h) {
  return (static_cast<long long>(bi) * a.nc + c) * a.h + h;
}

// The chunk's dt (0 past S) into dts[0, q).
__device__ __forceinline__ void load_dt(const Args& a, float* dts, int bi, int h, int s0) {
  const float* dt = a.dt + bi * a.dt_sb + h * a.dt_sh;
  for (int l = threadIdx.x; l < a.chunk; l += kThreads) {
    const int si = s0 + l;
    dts[l] = si < a.s ? dt[si * a.dt_ss] : 0.0f;
  }
}

// Phase 1.  Block = (batch, chunk, head).  The chunk's inclusive cumsum of
// dt * a (warp 0, the forward's order), stored with exp(cum_Q); its own
// state S_c = sum_j exp(cum_Q - cum_j) dt_j x_j (x) B_j and U_c = sum_i
// exp(cum_i) dy_i (x) C_i, each (P, N) fp32, over 64-row sub-tiles.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const Args a) {
  constexpr int kP = pad16(P), kN = pad16(N), kLp = kP + 1, kLn = kN + 1;
  constexpr int kPR = kP / 16, kNC = kN / 16;
  extern __shared__ float smem[];
  float* xs = smem;                 // [64][kLp] weighted x, then weighted dy
  float* bs = xs + kTile * kLp;     // [64][kLn] B, then C
  float* cum = bs + kTile * kLn;    // [kMaxChunk]
  float* dts = cum + kMaxChunk;     // [kMaxChunk]
  float* wt = dts + kMaxChunk;      // [kMaxChunk] dt_j exp(cum_Q - cum_j)
  float* ec = wt + kMaxChunk;       // [kMaxChunk] exp(cum_i)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int h = blockIdx.x % a.h;
  const int c = (blockIdx.x / a.h) % a.nc;
  const int bi = blockIdx.x / (a.h * a.nc);
  const long long row = row_of(a, bi, c, h);
  const int q = a.chunk;
  const int s0 = c * q;
  const float a_h = a.a[h];

  load_dt(a, dts, bi, h, s0);
  __syncthreads();
  if (tid < 32) {
    // Inclusive scan of dt * a by warp 0: each lane a serial run of
    // ceil(Q / 32) steps, then a shuffle scan of the runs' totals.
    const int per = (q + 31) / 32;
    const int lo = min(tid * per, q);
    const int hi = min(lo + per, q);
    float run = 0.0f;
    for (int i = lo; i < hi; ++i) {
      run += dts[i] * a_h;
      cum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.0f;
    for (int i = lo; i < hi; ++i) cum[i] += excl;
  }
  __syncthreads();
  const float cum_end = cum[q - 1];
  for (int l = tid; l < q; l += kThreads) {
    a.cum[row * q + l] = cum[l];
    wt[l] = dts[l] * expf(cum_end - cum[l]);
    ec[l] = expf(cum[l]);
  }
  if (tid == 0) a.decay[row] = expf(cum_end);

  const T* x = static_cast<const T*>(a.x) + bi * a.x_sb + h * a.x_sh;
  const T* dy = static_cast<const T*>(a.dy) + bi * a.dy_sb + h * a.dy_sh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb;
  const int tile = min(q, kTile);
  float acc_s[kPR][kNC], acc_u[kPR][kNC];
  zero(acc_s);
  zero(acc_u);
  for (int i0 = 0; i0 < q && s0 + i0 < a.s; i0 += tile) {
    __syncthreads();  // wt written; the previous sub-tile's xs and bs read
    load_rows(xs, kLp, kP, x, a.x_ss, P, s0 + i0, tile, a.s, wt + i0);
    load_rows(bs, kLn, kN, bp, a.b_ss, N, s0 + i0, tile, a.s, nullptr);
    __syncthreads();
    // S[p][n] += sum_j (wt_j x_j[p]) B_j[n]
    mma(acc_s, xs, 1, kLp, bs, 1, kLn, tile, tx, ty);
    __syncthreads();
    load_rows(xs, kLp, kP, dy, a.dy_ss, P, s0 + i0, tile, a.s, ec + i0);
    load_rows(bs, kLn, kN, cp, a.c_ss, N, s0 + i0, tile, a.s, nullptr);
    __syncthreads();
    // U[p][n] += sum_i (exp(cum_i) dy_i[p]) C_i[n]
    mma(acc_u, xs, 1, kLp, bs, 1, kLn, tile, tx, ty);
  }
  float* s_out = a.hs + row * P * N;
  float* u_out = a.gs + row * P * N;
#pragma unroll
  for (int r = 0; r < kPR; ++r) {
    const int p = ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc < kNC; ++cc) {
      const int n = tx + 16 * cc;
      if (p < P && n < N) {
        s_out[p * N + n] = acc_s[r][cc];
        u_out[p * N + n] = acc_u[r][cc];
      }
    }
  }
}

// The (I, J) pair's C_I B_J^T tile of chunk c: rows i of I, columns j of J.
__device__ __forceinline__ const float* cb_tile(const Args& a, int bi, int c, int it, int jt) {
  const long long pair = (static_cast<long long>(bi) * a.nc + c) * a.npairs +
                         it * (it + 1) / 2 + jt;
  return a.cb + pair * kTile * kTile;
}

// A thread's 4 x 4 micro-tile (rows ty + 16 r, columns tx + 16 c) of a
// 64 x 64 tile in device memory.
__device__ __forceinline__ void load_tile(float (&t)[4][4], const float* src, int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) t[r][c] = src[(ty + 16 * r) * kTile + tx + 16 * c];
}

// Phase 1b.  Block = (batch, chunk, pair of 64-row sub-tiles J <= I): C_I
// B_J^T over N (4 x 4 register micro-tiles), computed once for every head
// and for both the key and the query side of phases 3 and 4.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const Args a) {
  constexpr int kN = pad16(N), kLn = kN + 1;
  extern __shared__ float smem[];
  float* ci = smem;               // [64][kLn]
  float* bj = ci + kTile * kLn;   // [64][kLn]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int pair = blockIdx.x % a.npairs;
  const int c = (blockIdx.x / a.npairs) % a.nc;
  const int bi = blockIdx.x / (a.npairs * a.nc);
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int s0 = c * a.chunk;
  const int tile = min(a.chunk, kTile);
  load_rows(ci, kLn, kN, static_cast<const T*>(a.c) + bi * a.c_sb, a.c_ss, N, s0 + it * tile,
            tile, a.s, nullptr);
  load_rows(bj, kLn, kN, static_cast<const T*>(a.b) + bi * a.b_sb, a.b_ss, N, s0 + jt * tile,
            tile, a.s, nullptr);
  __syncthreads();
  float cb[4][4];
  zero(cb);
  mma(cb, ci, kLn, 1, bj, kLn, 1, kN, tx, ty);
  float* out = a.cb + ((static_cast<long long>(bi) * a.nc + c) * a.npairs + pair) * kTile * kTile;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) out[(ty + 16 * r) * kTile + tx + 16 * cc] = cb[r][cc];
}

// Phase 2.  Block = (batch row and head, 1024 state elements); a thread
// owns four consecutive elements of the (P, N) state and walks the chunks in
// order in fp32: forward, h_0 = 0, h_{c+1} = exp(cum_Q,c) h_c + S_c, storing
// h_c over S_c; then backward, G_{nc-1} = d_final, G_{c-1} = exp(cum_Q,c)
// G_c + U_c, storing G_c over U_c, and one partial of <G_c, h_c> per warp
// (a shuffle tree: a fixed order).
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_kernel(const Args a) {
  const int pn = a.p * a.n;  // N is a multiple of 4: four elements share a row
  const int t = blockIdx.y * kPassThreads + threadIdx.x;
  if (4 * (t & ~31) >= pn) return;  // the whole warp is past the state
  const bool active = 4 * t < pn;
  const int e = active ? 4 * t : 0;
  const int part = t / 32;
  const int bi = blockIdx.x / a.h;
  const int h = blockIdx.x % a.h;
  auto at = [&](float* base, int c) {
    return reinterpret_cast<float4*>(base + row_of(a, bi, c, h) * pn + e);
  };
  // Forward, kStateBatch chunks at a time: their loads first, then the
  // chain (each slot is read before this thread overwrites it).
  float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < a.nc; c0 += kStateBatch) {
    float4 sv[kStateBatch];
    float d[kStateBatch];
#pragma unroll
    for (int u = 0; u < kStateBatch; ++u) {
      sv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      d[u] = 0.0f;
      if (active && c0 + u < a.nc) {
        sv[u] = *at(a.hs, c0 + u);
        d[u] = a.decay[row_of(a, bi, c0 + u, h)];
      }
    }
#pragma unroll
    for (int u = 0; u < kStateBatch; ++u) {
      if (!active || c0 + u >= a.nc) continue;
      *at(a.hs, c0 + u) = make_float4(st[0], st[1], st[2], st[3]);
      st[0] = fmaf(st[0], d[u], sv[u].x);
      st[1] = fmaf(st[1], d[u], sv[u].y);
      st[2] = fmaf(st[2], d[u], sv[u].z);
      st[3] = fmaf(st[3], d[u], sv[u].w);
    }
  }
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active && a.dfin != nullptr) {
    const float* df = a.dfin + (static_cast<long long>(bi) * a.h + h) * pn + e;
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = df[i];
  }
  // Backward, the same batching from the last chunk down.
  for (int c1 = a.nc - 1; c1 >= 0; c1 -= kStateBatch) {
    float4 uv[kStateBatch], hv[kStateBatch];
    float d[kStateBatch];
#pragma unroll
    for (int u = 0; u < kStateBatch; ++u) {
      uv[u] = hv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      d[u] = 0.0f;
      if (active && c1 - u >= 0) {
        uv[u] = *at(a.gs, c1 - u);
        hv[u] = *at(a.hs, c1 - u);
        d[u] = a.decay[row_of(a, bi, c1 - u, h)];
      }
    }
#pragma unroll
    for (int u = 0; u < kStateBatch; ++u) {
      const int c = c1 - u;
      if (c < 0) break;  // the same for the whole warp
      float dot = 0.0f;
      if (active) {
        *at(a.gs, c) = make_float4(g[0], g[1], g[2], g[3]);
        dot = g[0] * hv[u].x + g[1] * hv[u].y + g[2] * hv[u].z + g[3] * hv[u].w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (threadIdx.x % 32 == 0) a.hg[row_of(a, bi, c, h) * a.nparts + part] = dot;
      if (active) {
        g[0] = fmaf(g[0], d[u], uv[u].x);
        g[1] = fmaf(g[1], d[u], uv[u].y);
        g[2] = fmaf(g[2], d[u], uv[u].z);
        g[3] = fmaf(g[3], d[u], uv[u].w);
      }
    }
  }
}

// Phase 3.  Block = (batch, chunk, head, 64-row key tile J), the heaviest
// tiles (J = 0) numbered first.  B_J, x_J and G_c stay in shared memory;
// for each query tile I >= J the pair's C_I B_J^T (phase 1b's) and dy_I
// x_J^T (4 x 4 register micro-tiles) give, on j <= i with L_ij = exp(cum_i - cum_j) by a
// select, A_ij = (C_i.B_j) L_ij, Z_ij = L_ij (dy_i.x_j) and M_ij = A_ij dt_j
// (dy_i.x_j) in shared memory; then
//   v_j += sum_i A_ij dy_i,  zb_j += sum_i Z_ij C_i,  colM_j += sum_i M_ij.
// After the last I, with e_j = exp(cum_Q - cum_j):
//   v_j += e_j G_c B_j;  dx_j = dt_j v_j;  dB_j (this head) = dt_j (zb_j +
//   e_j G_c^T x_j);  x_j.v_j and T_j = dt_j e_j x_j.(G_c B_j) by thread j.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dkey_kernel(const Args a) {
  constexpr int kP = pad16(P), kN = pad16(N), kLp = kP + 1, kLn = kN + 1;
  constexpr int kPC = kP / 16, kNC = kN / 16;
  extern __shared__ float smem[];
  float* bj = smem;                 // [64][kLn]
  float* xj = bj + kTile * kLn;     // [64][kLp]
  float* ci = xj + kTile * kLp;     // [64][kLn]
  float* dyi = ci + kTile * kLn;    // [64][kLp]
  float* am = dyi + kTile * kLp;    // [64][kLd] A_ij, then v_j
  float* zm = am + kTile * kLd;     // [64][kLd] Z_ij, then (G_c B_j)
  float* mm = zm + kTile * kLd;     // [64][kLd] M_ij
  float* gsm = mm + kTile * kLd;    // [kP][kLn] G_c
  float* cum = gsm + kP * kLn;      // [kMaxChunk]
  float* dts = cum + kMaxChunk;     // [kMaxChunk]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int per_tile = a.batch * a.nc * a.h;
  const int jt = blockIdx.x / per_tile;
  const int rest = blockIdx.x % per_tile;
  const int h = rest % a.h;
  const int c = (rest / a.h) % a.nc;
  const int bi = rest / (a.h * a.nc);
  const long long row = row_of(a, bi, c, h);
  const int q = a.chunk;
  const int s0 = c * q;
  const int tile = min(q, kTile);
  const int j0 = jt * tile;
  if (s0 + j0 >= a.s) return;  // a key tile past the sequence: nothing to write

  load_dt(a, dts, bi, h, s0);
  for (int l = tid; l < q; l += kThreads) cum[l] = a.cum[row * q + l];
  for (int l = tid; l < kP * kN; l += kThreads) {
    const int p = l / kN;
    const int n = l % kN;
    gsm[p * kLn + n] = p < P && n < N ? a.gs[(row * P + p) * N + n] : 0.0f;
  }
  const T* x = static_cast<const T*>(a.x) + bi * a.x_sb + h * a.x_sh;
  const T* dy = static_cast<const T*>(a.dy) + bi * a.dy_sb + h * a.dy_sh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb;
  load_rows(bj, kLn, kN, bp, a.b_ss, N, s0 + j0, tile, a.s, nullptr);
  load_rows(xj, kLp, kP, x, a.x_ss, P, s0 + j0, tile, a.s, nullptr);

  float acc_v[4][kPC], acc_b[4][kNC];
  zero(acc_v);
  zero(acc_b);
  float col_m = 0.0f;  // thread j < 64: sum_i M_ij
  for (int i0 = j0; i0 < q && s0 + i0 < a.s; i0 += tile) {
    __syncthreads();  // the previous pair's tiles are read (and the first loads done)
    load_rows(ci, kLn, kN, cp, a.c_ss, N, s0 + i0, tile, a.s, nullptr);
    load_rows(dyi, kLp, kP, dy, a.dy_ss, P, s0 + i0, tile, a.s, nullptr);
    __syncthreads();
    float cb[4][4], dx[4][4];
    load_tile(cb, cb_tile(a, bi, c, i0 / tile, jt), tx, ty);  // rows i, columns j
    zero(dx);
    mma(dx, dyi, kLp, 1, xj, kLp, 1, kP, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ty + 16 * r;
        const int j = tx + 16 * cc;
        const int gi = i0 + i;  // positions within the chunk
        const int gj = j0 + j;
        // A select: exp overflows above the diagonal.
        const float l = (i < tile && j < tile && gj <= gi) ? expf(cum[gi] - cum[gj]) : 0.0f;
        const float av = cb[r][cc] * l;
        am[i * kLd + j] = av;
        zm[i * kLd + j] = l * dx[r][cc];
        mm[i * kLd + j] = l == 0.0f ? 0.0f : av * dx[r][cc] * dts[gj];
      }
    }
    __syncthreads();
    if (tid < kTile)
      for (int i = 0; i < tile; ++i) col_m += mm[i * kLd + tid];
    mma(acc_v, am, 1, kLd, dyi, 1, kLp, tile, tx, ty);  // rows j, columns p
    mma(acc_b, zm, 1, kLd, ci, 1, kLn, tile, tx, ty);   // rows j, columns n
  }

  float ej[4], dtj[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gj = j0 + ty + 16 * r;
    const bool ok = ty + 16 * r < tile;
    ej[r] = ok ? expf(cum[q - 1] - cum[gj]) : 0.0f;
    dtj[r] = ok ? dts[gj] : 0.0f;
  }
  {
    float gb[4][kPC];  // G_c B_j: rows j, columns p
    zero(gb);
    mma(gb, bj, kLn, 1, gsm, kLn, 1, kN, tx, ty);
    __syncthreads();  // every thread is done with am and zm
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < kPC; ++cc) {
        const int p = tx + 16 * cc;
        acc_v[r][cc] = fmaf(ej[r], gb[r][cc], acc_v[r][cc]);
        am[j * kLd + p] = acc_v[r][cc];
        zm[j * kLd + p] = gb[r][cc];
      }
    }
  }
  {
    float gx[4][kNC];  // G_c^T x_j: rows j, columns n
    zero(gx);
    mma(gx, xj, kLp, 1, gsm, 1, kLn, kP, tx, ty);
    float* db = a.db_h;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      const int sj = s0 + j0 + j;
      if (j >= tile || sj >= a.s) continue;
      const long long base = ((static_cast<long long>(bi) * a.s + sj) * a.h + h) * N;
#pragma unroll
      for (int cc = 0; cc < kNC; ++cc) {
        const int n = tx + 16 * cc;
        if (n < N) db[base + n] = dtj[r] * fmaf(ej[r], gx[r][cc], acc_b[r][cc]);
      }
    }
  }
  T* dxo = static_cast<T*>(a.dx);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    const int sj = s0 + j0 + j;
    if (j >= tile || sj >= a.s) continue;
    const long long base = ((static_cast<long long>(bi) * a.s + sj) * a.h + h) * P;
#pragma unroll
    for (int cc = 0; cc < kPC; ++cc) {
      const int p = tx + 16 * cc;
      if (p < P) dxo[base + p] = store_as<T>(dtj[r] * acc_v[r][cc]);
    }
  }
  __syncthreads();  // v_j and G_c B_j are in am and zm
  if (tid < tile && s0 + j0 + tid < a.s) {
    const int j = tid;
    float xv = 0.0f, xg = 0.0f;
    for (int p = 0; p < P; ++p) {
      xv = fmaf(xj[j * kLp + p], am[j * kLd + p], xv);
      xg = fmaf(xj[j * kLp + p], zm[j * kLd + p], xg);
    }
    const float t_j = dts[j0 + j] * expf(cum[q - 1] - cum[j0 + j]) * xg;
    const long long at = row * q + j0 + j;
    a.ddt_x[at] = xv;
    a.tj[at] = t_j;
    a.dcum_k[at] = -(col_m + t_j);
  }
}

// Phase 4.  Block = (batch, chunk, head, 64-row query tile I), the heaviest
// (last) tiles first.  C_I, dy_I and h_c stay in shared memory; for each key
// tile J <= I the pair (with phase 1b's C_I B_J^T) gives Z'_ij = L_ij dt_j (dy_i.x_j) and M_ij = (C_i.B_j)
// Z'_ij; then zc_i += sum_j Z'_ij B_j and rowM_i += sum_j M_ij.  After the
// last J, hd_i = h_c^T dy_i: dC_i (this head) = zc_i + exp(cum_i) hd_i, and
// thread i adds exp(cum_i) C_i.hd_i to rowM_i.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dquery_kernel(const Args a) {
  constexpr int kP = pad16(P), kN = pad16(N), kLp = kP + 1, kLn = kN + 1;
  constexpr int kNC = kN / 16;
  extern __shared__ float smem[];
  float* ci = smem;                 // [64][kLn]
  float* dyi = ci + kTile * kLn;    // [64][kLp]
  float* bj = dyi + kTile * kLp;    // [64][kLn] B_J, then hd
  float* xj = bj + kTile * kLn;     // [64][kLp]
  float* zm = xj + kTile * kLp;     // [64][kLd] Z'_ij
  float* mm = zm + kTile * kLd;     // [64][kLd] M_ij
  float* hsm = mm + kTile * kLd;    // [kP][kLn] h_c
  float* cum = hsm + kP * kLn;      // [kMaxChunk]
  float* dts = cum + kMaxChunk;     // [kMaxChunk]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int per_tile = a.batch * a.nc * a.h;
  const int it = a.nt - 1 - blockIdx.x / per_tile;
  const int rest = blockIdx.x % per_tile;
  const int h = rest % a.h;
  const int c = (rest / a.h) % a.nc;
  const int bi = rest / (a.h * a.nc);
  const long long row = row_of(a, bi, c, h);
  const int q = a.chunk;
  const int s0 = c * q;
  const int tile = min(q, kTile);
  const int i0 = it * tile;
  if (s0 + i0 >= a.s) return;  // a query tile past the sequence

  load_dt(a, dts, bi, h, s0);
  for (int l = tid; l < q; l += kThreads) cum[l] = a.cum[row * q + l];
  for (int l = tid; l < kP * kN; l += kThreads) {
    const int p = l / kN;
    const int n = l % kN;
    hsm[p * kLn + n] = p < P && n < N ? a.hs[(row * P + p) * N + n] : 0.0f;
  }
  const T* x = static_cast<const T*>(a.x) + bi * a.x_sb + h * a.x_sh;
  const T* dy = static_cast<const T*>(a.dy) + bi * a.dy_sb + h * a.dy_sh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb;
  load_rows(ci, kLn, kN, cp, a.c_ss, N, s0 + i0, tile, a.s, nullptr);
  load_rows(dyi, kLp, kP, dy, a.dy_ss, P, s0 + i0, tile, a.s, nullptr);

  float acc_c[4][kNC];
  zero(acc_c);
  float row_m = 0.0f;  // thread i < 64: sum_j M_ij
  for (int j0 = 0; j0 <= i0; j0 += tile) {
    __syncthreads();  // the previous pair's tiles are read (and the first loads done)
    load_rows(bj, kLn, kN, bp, a.b_ss, N, s0 + j0, tile, a.s, nullptr);
    load_rows(xj, kLp, kP, x, a.x_ss, P, s0 + j0, tile, a.s, nullptr);
    __syncthreads();
    float cb[4][4], dx[4][4];
    load_tile(cb, cb_tile(a, bi, c, it, j0 / tile), tx, ty);  // rows i, columns j
    zero(dx);
    mma(dx, dyi, kLp, 1, xj, kLp, 1, kP, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ty + 16 * r;
        const int j = tx + 16 * cc;
        const int gi = i0 + i;
        const int gj = j0 + j;
        const float l = (i < tile && j < tile && gj <= gi) ? expf(cum[gi] - cum[gj]) : 0.0f;
        const float zv = l * dts[j < tile ? gj : 0] * dx[r][cc];
        zm[i * kLd + j] = zv;
        mm[i * kLd + j] = zv * cb[r][cc];
      }
    }
    __syncthreads();
    if (tid < kTile)
      for (int j = 0; j < tile; ++j) row_m += mm[tid * kLd + j];
    mma(acc_c, zm, kLd, 1, bj, 1, kLn, tile, tx, ty);  // rows i, columns n
  }

  float hd[4][kNC];  // h_c^T dy_i: rows i, columns n
  zero(hd);
  mma(hd, dyi, kLp, 1, hsm, 1, kLn, kP, tx, ty);
  __syncthreads();  // every thread is done with bj
  float* dch = a.dc_h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const int si = s0 + i0 + i;
    const float e = i < tile ? expf(cum[i0 + i]) : 0.0f;
    const long long base = ((static_cast<long long>(bi) * a.s + si) * a.h + h) * N;
#pragma unroll
    for (int cc = 0; cc < kNC; ++cc) {
      const int n = tx + 16 * cc;
      bj[i * kLn + n] = hd[r][cc];
      if (i < tile && si < a.s && n < N) dch[base + n] = fmaf(e, hd[r][cc], acc_c[r][cc]);
    }
  }
  __syncthreads();
  if (tid < tile && s0 + i0 + tid < a.s) {
    const int i = tid;
    float chd = 0.0f;
    for (int n = 0; n < N; ++n) chd = fmaf(ci[i * kLn + n], bj[i * kLn + n], chd);
    a.dcum_q[row * q + i0 + i] = fmaf(expf(cum[i0 + i]), chd, row_m);
  }
}

// Phase 5.  A thread per (batch, chunk, head), in a fixed order: dcum_i =
// dcum_q_i + dcum_k_i on the chunk's real positions, and at position Q
// also sum_j T_j + exp(cum_Q) <G_c, h_c>; a reverse cumsum gives d(dt a)_i,
// so ddt_i = x_i.v_i + a d(dt a)_i, and the chunk's share of da, sum_i dt_i
// d(dt a)_i.
__global__ void ssd_bwd_cum_kernel(const Args a) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<long long>(a.batch) * a.nc * a.h) return;
  const int h = static_cast<int>(row % a.h);
  const int c = static_cast<int>((row / a.h) % a.nc);
  const int bi = static_cast<int>(row / (static_cast<long long>(a.h) * a.nc));
  const int q = a.chunk;
  const int s0 = c * q;
  const int real = min(q, a.s - s0);
  const long long at = row * q;
  float extra = 0.0f;
  for (int i = 0; i < real; ++i) extra += a.tj[at + i];
  float dot = 0.0f;
  for (int k = 0; k < a.nparts; ++k) dot += a.hg[row * a.nparts + k];
  extra = fmaf(a.decay[row], dot, extra);
  const float a_h = a.a[h];
  const float* dt = a.dt + bi * a.dt_sb + h * a.dt_sh;
  float run = 0.0f, da = 0.0f;
  for (int i = q - 1; i >= 0; --i) {
    float dcum = i < real ? a.dcum_q[at + i] + a.dcum_k[at + i] : 0.0f;
    if (i == q - 1) dcum += extra;
    run += dcum;
    if (i < real) {
      const int si = s0 + i;
      a.ddt[(static_cast<long long>(bi) * a.s + si) * a.h + h] = fmaf(a_h, run, a.ddt_x[at + i]);
      da = fmaf(dt[si * a.dt_ss], run, da);
    }
  }
  a.da_p[row] = da;
}

// Phase 6.  dB and dC: a thread per (batch, position, state element) sums
// the partials (the heads' shares, or the bf16 path's head groups') in
// order and rounds once to the output's dtype.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const Args a) {
  const long long total = static_cast<long long>(a.batch) * a.s * a.n;
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= total) return;
  const long long bs = l / a.n;
  const int n = static_cast<int>(l % a.n);
  const long long base = bs * a.parts * a.n + n;
  float sb = 0.0f, sc = 0.0f;
  for (int h = 0; h < a.parts; ++h) {
    sb += a.db_h[base + static_cast<long long>(h) * a.n];
    sc += a.dc_h[base + static_cast<long long>(h) * a.n];
  }
  static_cast<T*>(a.db)[l] = store_as<T>(sb);
  static_cast<T*>(a.dc)[l] = store_as<T>(sc);
}

// Phase 7.  da: a thread per head sums the chunks' shares in (batch, chunk)
// order.
__global__ void ssd_bwd_da_kernel(const Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.h) return;
  float da = 0.0f;
  const long long rows = static_cast<long long>(a.batch) * a.nc;
  for (long long r = 0; r < rows; ++r) da += a.da_p[r * a.h + h];
  a.da[h] = da;
}

template <int N>
constexpr size_t cb_smem() {
  return sizeof(float) * 2 * kTile * (pad16(N) + 1);
}

template <int P, int N>
constexpr size_t chunk_smem() {
  return sizeof(float) * (kTile * (pad16(P) + 1) + kTile * (pad16(N) + 1) + 4 * kMaxChunk);
}

template <int P, int N>
constexpr size_t dkey_smem() {
  return sizeof(float) * (2 * kTile * (pad16(N) + 1) + 2 * kTile * (pad16(P) + 1) +
                          3 * kTile * kLd + pad16(P) * (pad16(N) + 1) + 2 * kMaxChunk);
}

template <int P, int N>
constexpr size_t dquery_smem() {
  return sizeof(float) * (2 * kTile * (pad16(N) + 1) + 2 * kTile * (pad16(P) + 1) +
                          2 * kTile * kLd + pad16(P) * (pad16(N) + 1) + 2 * kMaxChunk);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int P, int N>
int launch(const Args& a, cudaStream_t stream) {
  int err = set_smem(ssd_bwd_chunk_kernel<T, P, N>, chunk_smem<P, N>());
  if (err == 0) err = set_smem(ssd_bwd_cb_kernel<T, N>, cb_smem<N>());
  if (err == 0) err = set_smem(ssd_bwd_dkey_kernel<T, P, N>, dkey_smem<P, N>());
  if (err == 0) err = set_smem(ssd_bwd_dquery_kernel<T, P, N>, dquery_smem<P, N>());
  if (err != 0) return err;
  const int rows = a.batch * a.nc * a.h;
  ssd_bwd_chunk_kernel<T, P, N><<<rows, kThreads, chunk_smem<P, N>(), stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_bwd_cb_kernel<T, N><<<a.batch * a.nc * a.npairs, kThreads, cb_smem<N>(), stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 pass_grid(a.batch * a.h, (a.p * a.n + 4 * kPassThreads - 1) / (4 * kPassThreads));
  ssd_bwd_state_kernel<<<pass_grid, kPassThreads, 0, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_bwd_dkey_kernel<T, P, N><<<rows * a.nt, kThreads, dkey_smem<P, N>(), stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_bwd_dquery_kernel<T, P, N><<<rows * a.nt, kThreads, dquery_smem<P, N>(), stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_bwd_cum_kernel<<<(rows + 127) / 128, 128, 0, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long elems = static_cast<long long>(a.batch) * a.s * a.n;
  ssd_bwd_reduce_kernel<T><<<static_cast<unsigned>((elems + kReduceThreads - 1) / kReduceThreads),
                             kReduceThreads, 0, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_bwd_da_kernel<<<(a.h + 127) / 128, 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The backward in bf16 on the tensor cores: the chunk kernel and the two
// pair kernels of bwd:: redone with wgmma; the state pass, the cumsum's
// cotangent, the sums over head groups and da are bwd::'s kernels
// ---------------------------------------------------------------------------
namespace bwd16 {

using namespace hopper;
using bf16::kOutLd;
using bf16::wg_n;
using bwd::Args;
using bwd::row_of;

constexpr int kRows = 64;                       // rows of a tile: one wgmma M, one TMA box
constexpr int kThreads = 128;                   // one warpgroup
constexpr int kStashTile = 32 * kThreads;       // floats of a 64 x 64 fp32 tile, accumulator layout
constexpr int kMaxSmem = 232448;                // a block's shared memory on the H100
constexpr int kChunkStatic = 4 * 16 * kOutLd * 4 + 64;  // the chunk kernel's out_s and barriers

template <int M>
__device__ __forceinline__ void zero(float (&x)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = 0.0f;
}

// acc (= or +=) A B over KD: A a 64-row Tile read K-major, B a Tile whose
// first KD rows are read MN-major (NN columns).
template <int KD, int NN>
__device__ __forceinline__ void mma_nn(float (&acc)[NN / 2], const unsigned char* a_t,
                                       const unsigned char* b_t, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < (KD + 15) / 16; ++kk)
    wgmma_sst<NN>(acc, make_desc(a_t + kstep<KD>(kk), 16, 1024),
                  make_desc(b_t + kk * 2048, Tile<NN>::kAtomBytes, 1024), accumulate || kk > 0);
}

__device__ __forceinline__ void commit_wait() {
  wgmma_commit();
  wgmma_wait_all();
}

// The hi (part 0) or lo (part 1) bf16 part of the fp32 (P, N) state at
// src, row-major, as a Tile<N> (rows p, columns n), then the fence that
// lets wgmma read it.  Entries past (P, N) are left as they are (zero).
template <int P, int N>
__device__ __forceinline__ void stage_state(unsigned char* dst, const float* src, int part) {
  for (int l = threadIdx.x; l < P * N / 4; l += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(src)[l];
    float h[4], w[4];
    split(v.x, h[0], w[0]);
    split(v.y, h[1], w[1]);
    split(v.z, h[2], w[2]);
    split(v.w, h[3], w[3]);
    const float* o = part == 0 ? h : w;
    *reinterpret_cast<uint2*>(dst + tile_off(4 * l / N, 4 * l % N)) =
        make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]));
  }
  fence_proxy_async();
}

// Zeroes `bytes` of shared memory (a multiple of 16).
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int l = threadIdx.x; l < bytes / 16; l += kThreads)
    reinterpret_cast<uint4*>(p)[l] = make_uint4(0, 0, 0, 0);
}

// For this thread's two accumulator rows r0 and r0 + 8 of a 64 x NN tile:
// sum over the row of t[row][col] v[col] (t a bf16 Tile, zero past its
// columns), this thread's columns in order, then the row's four threads by
// a fixed shuffle tree.
template <int NN>
__device__ __forceinline__ void row_dot(const float (&v)[NN / 2], const unsigned char* t, int r0,
                                        float (&out)[2]) {
  const int qd = threadIdx.x % 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < NN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc = fmaf(tile_at(t, r0 + 8 * rr, 8 * i + 2 * qd + e), v[4 * i + 2 * rr + e], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    out[rr] = acc;
  }
}

// The same fixed shuffle tree over a row's four threads.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [0, kr) of the chunk's cum and dt for head h: cum past Q and dt past
// the chunk's real rows read as zero.
__device__ __forceinline__ void load_cum_dt(const Args& a, float* cum_s, float* dt_s, long long row,
                                            int bi, int h, int s0, int rows, int kr) {
  const float* dt = a.dt + bi * a.dt_sb + h * a.dt_sh;
  for (int l = threadIdx.x; l < kr; l += kThreads) {
    cum_s[l] = l < a.chunk ? a.cum[row * a.chunk + l] : 0.0f;
    dt_s[l] = l < rows ? dt[(s0 + l) * a.dt_ss] : 0.0f;
  }
}

// Phase 1.  Block = (batch, chunk, group of g1 heads), one warpgroup.  The
// chunk's B and C rows arrive once by TMA, each head's x and dy rows through
// a ring of st1 stages.  Per head (one warp each): the chunk's cumsum of
// dt * a (bwd::ssd_bwd_chunk_kernel's order), stored with exp(cum_Q); then
// S_c = (x o w)^T B with w_j = dt_j exp(cum_Q - cum_j) and U_c = (dy o
// exp(cum))^T C, each by wgmma with the computed A operand in bf16 hi + lo
// (the forward's chunk-state product) and B or C read MN-major, stored fp32.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_bf16_kernel(const Args a, const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap dy_map,
                          const __grid_constant__ CUtensorMap b_map,
                          const __grid_constant__ CUtensorMap c_map) {
  constexpr int kN = wg_n(N);
  constexpr int kAcc = kN / 2;
  using TX = Tile<P>;
  using TB = Tile<N>;
  const int nt = a.nt;
  const int kr = nt * kRows;
  const int q = a.chunk;
  const int stage_bytes = 2 * nt * TX::kBytes;  // x tiles, then dy tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* b_s = align1024(smem_raw);      // nt tiles of B
  unsigned char* c_s = b_s + nt * TB::kBytes;    // nt tiles of C
  unsigned char* ring = c_s + nt * TB::kBytes;   // st1 stages
  float* w_s = reinterpret_cast<float*>(ring + a.st1 * stage_bytes);  // [g1][kr] dt, then w
  float* e_s = w_s + a.g1 * kr;                                        // [g1][kr] cum, then exp(cum)
  __shared__ __align__(16) float out_s[4 * 16 * kOutLd];
  __shared__ uint64_t bc_bar, ring_bar[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int groups = (a.h + a.g1 - 1) / a.g1;
  const int grp = blockIdx.x % groups;
  const int bc = blockIdx.x / groups;
  const int bi = bc / a.nc;
  const int c = bc % a.nc;
  const int h0 = grp * a.g1;
  const int nheads = min(a.g1, a.h - h0);
  const int s0 = c * q;

  auto load_head = [&](int k) {
    const int st = k % a.st1;
    unsigned char* dst = ring + st * stage_bytes;
    mbar_expect(&ring_bar[st], stage_bytes);
    for (int t = 0; t < nt; ++t) {
      tma_tile<P>(dst + t * TX::kBytes, &x_map, &ring_bar[st], s0 + kRows * t, h0 + k, bi);
      tma_tile<P>(dst + (nt + t) * TX::kBytes, &dy_map, &ring_bar[st], s0 + kRows * t, h0 + k, bi);
    }
  };
  if (tid == 0) {
    mbar_init(&bc_bar);
    for (int i = 0; i < 2; ++i) mbar_init(&ring_bar[i]);
    mbar_fence_init();
    mbar_expect(&bc_bar, 2 * nt * TB::kBytes);
    for (int t = 0; t < nt; ++t) {
      tma_tile<N>(b_s + t * TB::kBytes, &b_map, &bc_bar, s0 + kRows * t, 0, bi);
      tma_tile<N>(c_s + t * TB::kBytes, &c_map, &bc_bar, s0 + kRows * t, 0, bi);
    }
    for (int k = 0; k < min(a.st1, nheads); ++k) load_head(k);
  }

  // The cumulative sums, one warp per head: serial runs of ceil(Q / 32)
  // steps, then a shuffle scan of the runs' totals.  Rows past Q (a chunk
  // under 64 rows: the next chunk's rows of the tile) get w = exp(cum) = 0.
  for (int k = warp; k < nheads; k += kThreads / 32) {
    const int h = h0 + k;
    const long long row = row_of(a, bi, c, h);
    const float a_h = a.a[h];
    float* dts = w_s + k * kr;
    float* cum = e_s + k * kr;
    const float* dt = a.dt + bi * a.dt_sb + h * a.dt_sh;
    for (int l = lane; l < kr; l += 32) {
      const int si = s0 + l;
      dts[l] = (l < q && si < a.s) ? dt[si * a.dt_ss] : 0.0f;
    }
    __syncwarp();
    const int per = (q + 31) / 32;
    const int lo = min(lane * per, q);
    const int hi = min(lo + per, q);
    float run = 0.0f;
    for (int i = lo; i < hi; ++i) {
      run += dts[i] * a_h;
      cum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    for (int i = lo; i < hi; ++i) cum[i] += excl;
    __syncwarp();
    const float cum_end = cum[q - 1];
    __syncwarp();  // every lane has read cum_end before cum is overwritten
    for (int l = lane; l < kr; l += 32) {
      float w = 0.0f, e = 0.0f;
      if (l < q) {
        a.cum[row * q + l] = cum[l];
        w = dts[l] * expf(cum_end - cum[l]);
        e = expf(cum[l]);
      }
      dts[l] = w;
      cum[l] = e;
    }
    if (lane == 0) a.decay[row] = expf(cum_end);
  }
  __syncthreads();
  mbar_wait(&bc_bar, 0);

  const int g = lane / 4;
  const int qd = lane % 4;
  const int p0 = 16 * warp + g;  // this thread's rows of S_c and U_c: p0, p0 + 8
  // acc = (tiles o wk)^T rhs over the chunk's rows, stored fp32 at out.
  auto product = [&](const unsigned char* tiles, const float* wk, const unsigned char* rhs,
                     float* out) {
    float acc[kAcc];
    zero(acc);
    for (int t = 0; t < nt; ++t) {
      const unsigned char* xt = tiles + t * TX::kBytes;
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows j, j + 1 and j + 8, j + 9 of the tile
          const int r = 16 * kk + 2 * qd + 8 * half;
          const float w0 = wk[kRows * t + r];
          const float w1 = wk[kRows * t + r + 1];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {  // rows p0 and p0 + 8 of the product
            float h0v, l0v, h1v, l1v;
            split(tile_at(xt, r, p0 + 8 * rr) * w0, h0v, l0v);
            split(tile_at(xt, r + 1, p0 + 8 * rr) * w1, h1v, l1v);
            fh[kk][2 * half + rr] = pack_bf16(h0v, h1v);
            fl[kk][2 * half + rr] = pack_bf16(l0v, l1v);
          }
        }
      }
      fence_regs(acc);
      wgmma_fence();
      mma_fb<kN>(acc, fh, rhs + t * TB::kBytes);
      mma_fb<kN>(acc, fl, rhs + t * TB::kBytes);
      commit_wait();
      fence_regs(acc);
    }
    // acc[4 i + e]: row p0 + 8 (e >> 1), column 8 i + 2 qd + (e & 1).  Each
    // warp stages its 16 rows, 32 columns at a time, then stores whole rows.
    float* stage = out_s + warp * 16 * kOutLd;
#pragma unroll
    for (int cb = 0; cb < (kN + 31) / 32; ++cb) {
#pragma unroll
      for (int i = 4 * cb; i < min(4 * cb + 4, kAcc / 4); ++i) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(stage + (g + 8 * rr) * kOutLd + 8 * (i - 4 * cb) + 2 * qd) =
              make_float2(acc[4 * i + 2 * rr], acc[4 * i + 2 * rr + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * r + lane / 8;
        const int col = 4 * (lane % 8);
        const int pp = 16 * warp + row;
        const int n = 32 * cb + col;
        if (pp < P && n < N)
          *reinterpret_cast<float4*>(out + pp * N + n) =
              *reinterpret_cast<const float4*>(stage + row * kOutLd + col);
      }
      __syncwarp();
    }
  };

  for (int k = 0; k < nheads; ++k) {
    const int st = k % a.st1;
    const long long row = row_of(a, bi, c, h0 + k);
    mbar_wait(&ring_bar[st], (k / a.st1) & 1);
    const unsigned char* xs = ring + st * stage_bytes;
    product(xs, w_s + k * kr, b_s, a.hs + row * P * N);
    product(xs + nt * TX::kBytes, e_s + k * kr, c_s, a.gs + row * P * N);
    __syncthreads();  // every thread is done with this stage before it refills
    if (tid == 0 && k + a.st1 < nheads) load_head(k + a.st1);
  }
}

// Phase 3.  Block = (batch, chunk, 64-row key tile J, group of g3 heads),
// one warpgroup; the tiles J = 0, which pair with the most query tiles,
// first.  B_J and the C rows of every query tile I >= J arrive once by TMA,
// and the pair tiles B_J C_I^T are computed once for the group's heads
// (wgmma, exact in fp32 from the bf16 inputs) into shared memory.  Each
// head's x_J and dy_I tiles arrive through a TMA ring of st3 stages, and its
// cotangent G_c (fp32 from the state pass) is split into bf16 hi + lo tiles.
// Per head, with rows j of J (L_ji = select(j <= i, exp(cum_i - cum_j)),
// e_j = exp(cum_Q - cum_j)):
//   v  = e_j G_c B_j                       (wgmma, B_J K-major, G_c hi + lo)
//   dB += dt_j e_j G_c^T x_j               (wgmma, x_J K-major, G_c MN-major)
//   per I >= J:  DX^T = x_J dy_I^T          (wgmma, exact)
//                v  += A^T dy_I, A^T = B_J C_I^T o L^T   (A in hi + lo)
//                dB += (dt o Z^T) C_I, Z^T = L^T o DX^T  (likewise)
//                colM_j += sum_i (B_j . C_i) L_ji dt_j DX_ji
// then dx_j = dt_j v_j, x_j . v_j, T_j = dt_j e_j x_j . (G_c B_j) and
// -(colM_j + T_j).  dB is summed over the group's heads in registers, in
// head order, and stored once per group.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dkey_bf16_kernel(const Args a, const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap dy_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap c_map) {
  constexpr int kP = wg_n(P);
  constexpr int kN = wg_n(N);
  using TX = Tile<P>;
  using TB = Tile<N>;
  const int nt = a.nt;
  const int kr = nt * kRows;
  const int q = a.chunk;
  const int groups = (a.h + a.g3 - 1) / a.g3;
  const int per_tile = a.batch * a.nc * groups;
  const int jt = blockIdx.x / per_tile;
  const int rest = blockIdx.x % per_tile;
  const int grp = rest % groups;
  const int bi = (rest / groups) / a.nc;
  const int c = (rest / groups) % a.nc;
  const int h0 = grp * a.g3;
  const int nheads = min(a.g3, a.h - h0);
  const int s0 = c * q;
  const int rows = min(q, a.s - s0);  // real rows of this chunk
  const int j0 = kRows * jt;
  if (j0 >= rows) return;  // a key tile past the sequence: nothing to write
  const int n_i = (rows + kRows - 1) / kRows - jt;  // query tiles I = jt .. jt + n_i - 1

  const int stage_bytes = (1 + nt) * TX::kBytes;  // x_J, then dy_I
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* b_s = align1024(smem_raw);                        // B_J
  unsigned char* c_s = b_s + TB::kBytes;                           // C_I, I - jt
  float* stash = reinterpret_cast<float*>(c_s + nt * TB::kBytes);  // B_J C_I^T, I - jt
  unsigned char* ring = reinterpret_cast<unsigned char*>(stash + nt * kStashTile);
  unsigned char* g_s = ring + a.st3 * stage_bytes;  // G_c's hi, then lo part: rows p, columns n
  float* cum_s = reinterpret_cast<float*>(g_s + TB::kBytes);  // [kr]
  float* dt_s = cum_s + kr;                                      // [kr]
  __shared__ uint64_t bc_bar, ring_bar[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int qd = tid % 4;

  auto load_head = [&](int k) {
    const int st = k % a.st3;
    unsigned char* dst = ring + st * stage_bytes;
    mbar_expect(&ring_bar[st], (1 + n_i) * TX::kBytes);
    tma_tile<P>(dst, &x_map, &ring_bar[st], s0 + j0, h0 + k, bi);
    for (int u = 0; u < n_i; ++u)
      tma_tile<P>(dst + (1 + u) * TX::kBytes, &dy_map, &ring_bar[st], s0 + kRows * (jt + u), h0 + k, bi);
  };
  if (tid == 0) {
    mbar_init(&bc_bar);
    for (int i = 0; i < 2; ++i) mbar_init(&ring_bar[i]);
    mbar_fence_init();
    mbar_expect(&bc_bar, (1 + n_i) * TB::kBytes);
    tma_tile<N>(b_s, &b_map, &bc_bar, s0 + j0, 0, bi);
    for (int u = 0; u < n_i; ++u)
      tma_tile<N>(c_s + u * TB::kBytes, &c_map, &bc_bar, s0 + kRows * (jt + u), 0, bi);
    for (int k = 0; k < min(a.st3, nheads); ++k) load_head(k);
  }
  if (P < 64 || N % 64 != 0) zero_smem(g_s, TB::kBytes);  // the padding of G_c's tile
  __syncthreads();  // the barriers are initialised
  mbar_wait(&bc_bar, 0);

  // The pair tiles B_J C_I^T, kept in the accumulator layout: each thread
  // reads back only what it wrote.
  for (int u = 0; u < n_i; ++u) {
    float sc[32];
    zero(sc);
    fence_regs(sc);
    wgmma_fence();
    mma_nt<N, 64>(sc, b_s, c_s + u * TB::kBytes, false);
    commit_wait();
    fence_regs(sc);
#pragma unroll
    for (int e = 0; e < 32; ++e) stash[(u * 32 + e) * kThreads + tid] = sc[e];
  }

  const int r0 = 16 * warp + g;  // this thread's rows of J: r0, r0 + 8
  const int jp[2] = {j0 + r0, j0 + r0 + 8};  // their positions in the chunk
  float db[kN / 2];  // dB of rows j, summed over the group's heads
  zero(db);
  for (int k = 0; k < nheads; ++k) {
    const int h = h0 + k;
    const long long row = row_of(a, bi, c, h);
    const int st = k % a.st3;
    load_cum_dt(a, cum_s, dt_s, row, bi, h, s0, rows, kr);
    stage_state<P, N>(g_s, a.gs + row * P * N, 0);
    __syncthreads();  // cum, dt and G_c's hi part are in shared memory
    mbar_wait(&ring_bar[st], (k / a.st3) & 1);
    const unsigned char* xs = ring + st * stage_bytes;
    const unsigned char* dys = xs + TX::kBytes;
    float ej[2], dtj[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ej[r] = jp[r] < q ? expf(cum_s[q - 1] - cum_s[jp[r]]) : 0.0f;
      dtj[r] = dt_s[jp[r]];
    }

    // v = G_c B_j (then scaled by e_j), dB += dt_j e_j G_c^T x_j: G_c's hi
    // part, then its lo part through the same tile.
    float v[kP / 2];
    float xg[2];
    {
      float gx[kN / 2];
      zero(v);
      zero(gx);
#pragma unroll 1
      for (int part = 0; part < 2; ++part) {
        if (part == 1) {
          __syncthreads();  // every product has read the hi part
          stage_state<P, N>(g_s, a.gs + row * P * N, 1);
          __syncthreads();
        }
        fence_regs(v);
        fence_regs(gx);
        wgmma_fence();
        mma_nt<N, kP>(v, b_s, g_s, part == 1);
        mma_nn<P, kN>(gx, xs, g_s, part == 1);
        commit_wait();
        fence_regs(v);
        fence_regs(gx);
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int r = (i >> 1) & 1;
        db[i] = fmaf(dtj[r] * ej[r], gx[i], db[i]);
      }
    }
    row_dot<kP>(v, xs, r0, xg);  // x_j . (G_c B_j)
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) v[i] *= ej[(i >> 1) & 1];

    float col_m[2] = {0.0f, 0.0f};
    for (int u = 0; u < n_i; ++u) {
      const int i0 = kRows * (jt + u);
      const unsigned char* dyt = dys + u * TX::kBytes;
      float dx[32];  // DX^T: rows j, columns i
      zero(dx);
      fence_regs(dx);
      wgmma_fence();
      mma_nt<P, 64>(dx, xs, dyt, false);
      commit_wait();
      fence_regs(dx);
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int ip = i0 + 8 * i + 2 * qd + (e & 1);
          // A select: exp overflows above the diagonal.
          const float l = (jp[r] <= ip && ip < rows) ? expf(cum_s[ip] - cum_s[jp[r]]) : 0.0f;
          const float cb = stash[(u * 32 + 4 * i + e) * kThreads + tid];
          const float z = l * dtj[r] * dx[4 * i + e];
          col_m[r] = fmaf(cb, z, col_m[r]);
          split(cb * l, ah[e], al[e]);
          dx[4 * i + e] = z;
        }
        fh[i / 2][2 * (i % 2) + 0] = pack_bf16(ah[0], ah[1]);
        fh[i / 2][2 * (i % 2) + 1] = pack_bf16(ah[2], ah[3]);
        fl[i / 2][2 * (i % 2) + 0] = pack_bf16(al[0], al[1]);
        fl[i / 2][2 * (i % 2) + 1] = pack_bf16(al[2], al[3]);
      }
      fence_regs(v);
      wgmma_fence();
      mma_fb<kP>(v, fh, dyt);
      mma_fb<kP>(v, fl, dyt);
      commit_wait();
      fence_regs(v);
      to_frags(dx, fh, fl);
      fence_regs(db);
      wgmma_fence();
      mma_fb<kN>(db, fh, c_s + u * TB::kBytes);
      mma_fb<kN>(db, fl, c_s + u * TB::kBytes);
      commit_wait();
      fence_regs(db);
    }

    float xv[2];
    row_dot<kP>(v, xs, r0, xv);  // x_j . v_j
    __nv_bfloat16* dxo = static_cast<__nv_bfloat16*>(a.dx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float cm = quad_sum(col_m[r]);
      if (jp[r] >= rows) continue;
      const long long base = ((static_cast<long long>(bi) * a.s + s0 + jp[r]) * a.h + h) * P;
#pragma unroll
      for (int i = 0; i < kP / 8; ++i) {
        const int p = 8 * i + 2 * qd;
        if (p < P)
          *reinterpret_cast<__nv_bfloat162*>(dxo + base + p) =
              __floats2bfloat162_rn(dtj[r] * v[4 * i + 2 * r], dtj[r] * v[4 * i + 2 * r + 1]);
      }
      if (qd == 0) {
        const long long at = row * q + jp[r];
        const float t_j = dtj[r] * ej[r] * xg[r];
        a.ddt_x[at] = xv[r];
        a.tj[at] = t_j;
        a.dcum_k[at] = -(cm + t_j);
      }
    }
    __syncthreads();  // every thread is done with this stage, cum, dt and G_c
    if (tid == 0 && k + a.st3 < nheads) load_head(k + a.st3);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (jp[r] >= rows) continue;
    float* out = a.db_h + ((static_cast<long long>(bi) * a.s + s0 + jp[r]) * groups + grp) * N;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      const int n = 8 * i + 2 * qd;
      if (n < N) *reinterpret_cast<float2*>(out + n) = make_float2(db[4 * i + 2 * r], db[4 * i + 2 * r + 1]);
    }
  }
}

// Phase 4.  Block = (batch, chunk, 64-row query tile I, group of g3 heads),
// one warpgroup; the last tiles, which pair with the most key tiles, first.
// C_I and the B rows of every key tile J <= I arrive once by TMA, and the
// pair tiles C_I B_J^T are computed once for the group's heads.  Each
// head's dy_I and x_J tiles arrive through the ring, and its entering state
// h_c (fp32 from the state pass) is split into bf16 hi + lo tiles.  Per
// head, with rows i of I:
//   hd  = h_c^T dy_i                        (wgmma, dy_I K-major, h_c MN-major)
//   dC += exp(cum_i) hd_i
//   per J <= I:  DX = dy_I x_J^T             (wgmma, exact)
//                dC += Z' B_J, Z' = L o dt_j o DX  (Z' in hi + lo)
//                rowM_i += sum_j (C_i . B_j) Z'_ij
// then rowM_i + exp(cum_i) C_i . hd_i.  dC is summed over the group's heads
// in registers, in head order, and stored once per group.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dquery_bf16_kernel(const Args a, const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap dy_map,
                           const __grid_constant__ CUtensorMap b_map,
                           const __grid_constant__ CUtensorMap c_map) {
  constexpr int kN = wg_n(N);
  using TX = Tile<P>;
  using TB = Tile<N>;
  const int nt = a.nt;
  const int kr = nt * kRows;
  const int q = a.chunk;
  const int groups = (a.h + a.g3 - 1) / a.g3;
  const int per_tile = a.batch * a.nc * groups;
  const int it = nt - 1 - blockIdx.x / per_tile;
  const int rest = blockIdx.x % per_tile;
  const int grp = rest % groups;
  const int bi = (rest / groups) / a.nc;
  const int c = (rest / groups) % a.nc;
  const int h0 = grp * a.g3;
  const int nheads = min(a.g3, a.h - h0);
  const int s0 = c * q;
  const int rows = min(q, a.s - s0);
  const int i0 = kRows * it;
  if (i0 >= rows) return;  // a query tile past the sequence
  const int n_j = it + 1;  // key tiles J = 0 .. it

  const int stage_bytes = (1 + nt) * TX::kBytes;  // dy_I, then x_J
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* c_s = align1024(smem_raw);                        // C_I
  unsigned char* b_s = c_s + TB::kBytes;                           // B_J
  float* stash = reinterpret_cast<float*>(b_s + nt * TB::kBytes);  // C_I B_J^T
  unsigned char* ring = reinterpret_cast<unsigned char*>(stash + nt * kStashTile);
  unsigned char* h_s = ring + a.st3 * stage_bytes;  // h_c's hi, then lo part: rows p, columns n
  float* cum_s = reinterpret_cast<float*>(h_s + TB::kBytes);
  float* dt_s = cum_s + kr;
  __shared__ uint64_t bc_bar, ring_bar[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int qd = tid % 4;

  auto load_head = [&](int k) {
    const int st = k % a.st3;
    unsigned char* dst = ring + st * stage_bytes;
    mbar_expect(&ring_bar[st], (1 + n_j) * TX::kBytes);
    tma_tile<P>(dst, &dy_map, &ring_bar[st], s0 + i0, h0 + k, bi);
    for (int jt = 0; jt < n_j; ++jt)
      tma_tile<P>(dst + (1 + jt) * TX::kBytes, &x_map, &ring_bar[st], s0 + kRows * jt, h0 + k, bi);
  };
  if (tid == 0) {
    mbar_init(&bc_bar);
    for (int i = 0; i < 2; ++i) mbar_init(&ring_bar[i]);
    mbar_fence_init();
    mbar_expect(&bc_bar, (1 + n_j) * TB::kBytes);
    tma_tile<N>(c_s, &c_map, &bc_bar, s0 + i0, 0, bi);
    for (int jt = 0; jt < n_j; ++jt)
      tma_tile<N>(b_s + jt * TB::kBytes, &b_map, &bc_bar, s0 + kRows * jt, 0, bi);
    for (int k = 0; k < min(a.st3, nheads); ++k) load_head(k);
  }
  if (P < 64 || N % 64 != 0) zero_smem(h_s, TB::kBytes);
  __syncthreads();
  mbar_wait(&bc_bar, 0);

  for (int jt = 0; jt < n_j; ++jt) {
    float sc[32];
    zero(sc);
    fence_regs(sc);
    wgmma_fence();
    mma_nt<N, 64>(sc, c_s, b_s + jt * TB::kBytes, false);
    commit_wait();
    fence_regs(sc);
#pragma unroll
    for (int e = 0; e < 32; ++e) stash[(jt * 32 + e) * kThreads + tid] = sc[e];
  }

  const int r0 = 16 * warp + g;
  const int ip[2] = {i0 + r0, i0 + r0 + 8};
  float dc[kN / 2];  // dC of rows i, summed over the group's heads
  zero(dc);
  for (int k = 0; k < nheads; ++k) {
    const int h = h0 + k;
    const long long row = row_of(a, bi, c, h);
    const int st = k % a.st3;
    load_cum_dt(a, cum_s, dt_s, row, bi, h, s0, rows, kr);
    stage_state<P, N>(h_s, a.hs + row * P * N, 0);
    __syncthreads();
    mbar_wait(&ring_bar[st], (k / a.st3) & 1);
    const unsigned char* dys = ring + st * stage_bytes;
    const unsigned char* xs = dys + TX::kBytes;
    float ei[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ei[r] = ip[r] < q ? expf(cum_s[ip[r]]) : 0.0f;

    float chd[2];
    {
      float hd[kN / 2];  // h_c^T dy_i: rows i, columns n; h_c's hi part, then lo
      zero(hd);
#pragma unroll 1
      for (int part = 0; part < 2; ++part) {
        if (part == 1) {
          __syncthreads();
          stage_state<P, N>(h_s, a.hs + row * P * N, 1);
          __syncthreads();
        }
        fence_regs(hd);
        wgmma_fence();
        mma_nn<P, kN>(hd, dys, h_s, part == 1);
        commit_wait();
        fence_regs(hd);
      }
      row_dot<kN>(hd, c_s, r0, chd);  // C_i . hd_i
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) dc[i] = fmaf(ei[(i >> 1) & 1], hd[i], dc[i]);
    }

    float row_m[2] = {0.0f, 0.0f};
    for (int jt = 0; jt < n_j; ++jt) {
      float dx[32];  // DX: rows i, columns j
      zero(dx);
      fence_regs(dx);
      wgmma_fence();
      mma_nt<P, 64>(dx, dys, xs + jt * TX::kBytes, false);
      commit_wait();
      fence_regs(dx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int j = kRows * jt + 8 * i + 2 * qd + (e & 1);
          const float l = (j <= ip[r] && ip[r] < rows) ? expf(cum_s[ip[r]] - cum_s[j]) : 0.0f;
          const float z = l * dt_s[j] * dx[4 * i + e];
          row_m[r] = fmaf(z, stash[(jt * 32 + 4 * i + e) * kThreads + tid], row_m[r]);
          dx[4 * i + e] = z;
        }
      uint32_t fh[4][4], fl[4][4];
      to_frags(dx, fh, fl);
      fence_regs(dc);
      wgmma_fence();
      mma_fb<kN>(dc, fh, b_s + jt * TB::kBytes);
      mma_fb<kN>(dc, fl, b_s + jt * TB::kBytes);
      commit_wait();
      fence_regs(dc);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rm = quad_sum(row_m[r]);
      if (qd == 0 && ip[r] < rows) a.dcum_q[row * q + ip[r]] = fmaf(ei[r], chd[r], rm);
    }
    __syncthreads();
    if (tid == 0 && k + a.st3 < nheads) load_head(k + a.st3);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ip[r] >= rows) continue;
    float* out = a.dc_h + ((static_cast<long long>(bi) * a.s + s0 + ip[r]) * groups + grp) * N;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      const int n = 8 * i + 2 * qd;
      if (n < N) *reinterpret_cast<float2*>(out + n) = make_float2(dc[4 * i + 2 * r], dc[4 * i + 2 * r + 1]);
    }
  }
}

// Dynamic shared memory of the kernels at `stages` ring stages, 1 KB of
// alignment included.
template <int P, int N>
size_t chunk_smem(const Args& a, int stages) {
  return 1024 + 2 * static_cast<size_t>(a.nt) * Tile<N>::kBytes +
         static_cast<size_t>(stages) * 2 * a.nt * Tile<P>::kBytes +
         2 * sizeof(float) * a.g1 * a.nt * kRows;
}

template <int P, int N>
size_t pair_smem(const Args& a, int stages) {
  return 1024 + static_cast<size_t>(1 + a.nt) * Tile<N>::kBytes +
         static_cast<size_t>(a.nt) * kStashTile * sizeof(float) +
         static_cast<size_t>(stages) * (1 + a.nt) * Tile<P>::kBytes + Tile<N>::kBytes +
         2 * sizeof(float) * a.nt * kRows;
}

// Two ring stages where they fit, else one.
inline int stages_for(size_t two, size_t one, int& stages) {
  if (two <= static_cast<size_t>(kMaxSmem)) stages = 2;
  else if (one <= static_cast<size_t>(kMaxSmem)) stages = 1;
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The seven kernels in order on `stream`: chunk, state pass, dkey, dquery,
// the cumsum's cotangent, the sums over head groups, da.
template <int P, int N>
int launch(Args a, const void* x, const void* dy, const void* b, const void* c,
           cudaStream_t stream) {
  CUtensorMap x_map, dy_map, b_map, c_map;
  int err = make_map(&x_map, x, a.batch, a.s, a.h, P, a.x_sb, a.x_ss, a.x_sh);
  if (err == 0) err = make_map(&dy_map, dy, a.batch, a.s, a.h, P, a.dy_sb, a.dy_ss, a.dy_sh);
  if (err == 0) err = make_map(&b_map, b, a.batch, a.s, 1, N, a.b_sb, a.b_ss, 0);
  if (err == 0) err = make_map(&c_map, c, a.batch, a.s, 1, N, a.c_sb, a.c_ss, 0);
  // The chunk kernel also holds kChunkStatic bytes of static shared memory.
  if (err == 0)
    err = stages_for(chunk_smem<P, N>(a, 2) + kChunkStatic, chunk_smem<P, N>(a, 1) + kChunkStatic,
                     a.st1);
  if (err == 0) err = stages_for(pair_smem<P, N>(a, 2), pair_smem<P, N>(a, 1), a.st3);
  if (err != 0) return err;
  const size_t smem1 = chunk_smem<P, N>(a, a.st1);
  const size_t smem3 = pair_smem<P, N>(a, a.st3);
  // Each launch sets its kernel's dynamic shared memory limit, as every
  // launch of the port does: no state outlives the call.
  err = bwd::set_smem(ssd_bwd_chunk_bf16_kernel<P, N>, smem1);
  if (err == 0) err = bwd::set_smem(ssd_bwd_dkey_bf16_kernel<P, N>, smem3);
  if (err == 0) err = bwd::set_smem(ssd_bwd_dquery_bf16_kernel<P, N>, smem3);
  if (err != 0) return err;

  const int groups1 = (a.h + a.g1 - 1) / a.g1;
  const int groups3 = (a.h + a.g3 - 1) / a.g3;
  ssd_bwd_chunk_bf16_kernel<P, N><<<a.batch * a.nc * groups1, kThreads, smem1, stream>>>(
      a, x_map, dy_map, b_map, c_map);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 pass_grid(a.batch * a.h,
                       (a.p * a.n + 4 * bwd::kPassThreads - 1) / (4 * bwd::kPassThreads));
  bwd::ssd_bwd_state_kernel<<<pass_grid, bwd::kPassThreads, 0, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int pair_blocks = a.batch * a.nc * groups3 * a.nt;
  ssd_bwd_dkey_bf16_kernel<P, N><<<pair_blocks, kThreads, smem3, stream>>>(a, x_map, dy_map,
                                                                            b_map, c_map);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_bwd_dquery_bf16_kernel<P, N><<<pair_blocks, kThreads, smem3, stream>>>(a, x_map, dy_map,
                                                                              b_map, c_map);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows = a.batch * a.nc * a.h;
  bwd::ssd_bwd_cum_kernel<<<(rows + 127) / 128, 128, 0, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long elems = static_cast<long long>(a.batch) * a.s * a.n;
  bwd::ssd_bwd_reduce_kernel<__nv_bfloat16>
      <<<static_cast<unsigned>((elems + bwd::kReduceThreads - 1) / bwd::kReduceThreads),
         bwd::kReduceThreads, 0, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd::ssd_bwd_da_kernel<<<(a.h + 127) / 128, 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd16

// The (P, N) pairs taken: the model shapes, the smoke configs' and the
// reference sweep's.  kernels/ssd_scan.py lists the same pairs.
#define SSD_SHAPES(X)                                                    \
  X(64, 128) X(64, 64) X(32, 16)                                         \
  X(4, 4) X(4, 8) X(4, 16) X(8, 4) X(8, 8) X(8, 16) X(16, 4) X(16, 8) X(16, 16)

int dispatch_f32(const f32::Args& a, int batch, int p, int n, cudaStream_t stream) {
#define SSD_CASE(P_, N_) \
  if (p == P_ && n == N_) return f32::launch<float, P_, N_>(a, batch, stream);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_bf16(const bf16::Args& a, const void* x, long long x_sb, long long x_ss,
                  long long x_sh, const void* b, long long b_sb, long long b_ss,
                  const void* c, long long c_sb, long long c_ss, cudaStream_t stream) {
#define SSD_CASE(P_, N_)                                                                  \
  if (a.p == P_ && a.n == N_)                                                             \
    return bf16::launch<P_, N_>(a, x, x_sb, x_ss, x_sh, b, b_sb, b_ss, c, c_sb, c_ss, stream);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_bwd(const bwd::Args& a, int dtype, cudaStream_t stream) {
#define SSD_CASE(P_, N_)                                                              \
  if (a.p == P_ && a.n == N_)                                                         \
    return dtype == 0 ? bwd::launch<float, P_, N_>(a, stream)                         \
                      : bwd16::launch<P_, N_>(a, a.x, a.dy, a.b, a.c, stream);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0 = fp32, 1 = bf16 (x, B, C and y); dt and a are fp32.  Strides are
// in elements: x (batch, seq, head), dt (batch, seq, head), B and C (batch,
// seq).  bf16 needs x, B and C 16-byte aligned with every stride a multiple
// of 8 (TMA), and scratch from the caller, each contiguous: states (B, nc,
// H, P, N) fp32, h_hi and h_lo (B, nc, H, P, round_up(N, 8)) bf16, cum (B,
// nc, H, Q) and decay (B, nc, H) fp32; g1 and g3 are the heads per block of
// the chunk-state and chunk-scan kernels.  fp32 ignores the scratch.
// Launches on `stream` and returns the first error of its launches (0 =
// launched); an unsupported dtype, shape, chunk or alignment returns
// cudaErrorInvalidValue without launching, a refused tensor map 1000 + its
// CUresult.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* a, const void* b, const void* c,
    void* y, void* fin, int dtype, int batch, int s, int h, int p, int n, int chunk,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* states, void* h_hi, void* h_lo, void* cum, void* decay, int g1, int g3,
    void* stream) {
  if (batch <= 0 || h <= 0 || s < 0 || chunk <= 0 || chunk > f32::kMaxChunk ||
      (chunk > f32::kTile && chunk % f32::kTile != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    f32::Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c, y,
                   static_cast<float*>(fin), h, s, chunk,
                   x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};
    return dispatch_f32(args, batch, p, n, st);
  }
  if (dtype != 1 || g1 <= 0 || g3 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {x, b, c})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (long long v : {x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss})
    if (v % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  bf16::Args args{};
  args.batch = batch;
  args.s = s;
  args.h = h;
  args.p = p;
  args.n = n;
  args.chunk = chunk;
  args.nc = (s + chunk - 1) / chunk;
  args.nt = (chunk + bf16::kRows - 1) / bf16::kRows;
  args.g1 = g1;
  args.g3 = g3;
  args.nh = (n + 7) / 8 * 8;
  args.dt = static_cast<const float*>(dt);
  args.dt_sb = dt_sb;
  args.dt_ss = dt_ss;
  args.dt_sh = dt_sh;
  args.a = static_cast<const float*>(a);
  args.y = static_cast<__nv_bfloat16*>(y);
  args.fin = static_cast<float*>(fin);
  args.states = static_cast<float*>(states);
  args.cum = static_cast<float*>(cum);
  args.decay = static_cast<float*>(decay);
  args.h_hi = static_cast<__nv_bfloat16*>(h_hi);
  args.h_lo = static_cast<__nv_bfloat16*>(h_lo);
  return dispatch_bf16(args, x, x_sb, x_ss, x_sh, b, b_sb, b_ss, c, c_sb, c_ss, st);
}

// The backward of ssd_scan_fwd (from a zero state): dy (B, S, H, P) in x's
// dtype and dfin (B, H, P, N) fp32 or null in; dx (B, S, H, P) in x's
// dtype, ddt (B, S, H) fp32, da (H,) fp32, dB and dC (B, S, N) in B's dtype
// out, each contiguous.  dtype 0 = fp32, 1 = bf16 (x, B, C, dy, dx, dB,
// dC); dt and a are fp32.  strides: x (batch, seq, head), dt (batch, seq,
// head), B (batch, seq), C (batch, seq), dy (batch, seq, head), in
// elements, the last dims contiguous.  scratch: fp32 buffers from the
// caller, each contiguous, in the order of kernels/ssd_scan.py's
// backward_scratch_shapes: cum (B, nc, H, Q), decay (B, nc, H), states and
// cotangents (B, nc, H, P, N), state_dots (B, nc, H, ceil(P N / 128)),
// ddt_x, dcum_k, t, dcum_q (B, nc, H, Q), the dB and dC partials (B, S,
// parts, N), da_chunks (B, nc, H), and for fp32 cb_pairs (B, nc, nt (nt +
// 1) / 2, 64, 64) with nt = ceil(Q / 64).  parts is H for fp32 (eight
// CUDA-core kernels) and ceil(H / g3) for bf16 (seven kernels, three on the
// tensor cores, g1 and g3 the heads per block of the chunk kernel and of
// the pair kernels; x, B, C and dy read by TMA, so each 16-byte aligned
// with strides a multiple of 8).  Launches on `stream` and returns the
// first error of its launches (0 = launched); an unsupported dtype, shape,
// chunk or alignment returns cudaErrorInvalidValue without launching, a
// refused tensor map 1000 + its CUresult.
extern "C" int ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b, const void* c,
    const void* dy, const void* dfin, void* dx, void* ddt, void* da, void* db, void* dc,
    int dtype, int batch, int s, int h, int p, int n, int chunk, int g1, int g3,
    const long long* strides, void* const* scratch, void* stream) {
  if (batch <= 0 || h <= 0 || s <= 0 || chunk <= 0 || chunk > bwd::kMaxChunk ||
      (chunk > bwd::kTile && chunk % bwd::kTile != 0) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (g1 <= 0 || g3 <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Args args{};
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.dy = dy;
  args.dfin = static_cast<const float*>(dfin);
  args.dx = dx;
  args.ddt = static_cast<float*>(ddt);
  args.da = static_cast<float*>(da);
  args.db = db;
  args.dc = dc;
  float* const* f = reinterpret_cast<float* const*>(scratch);
  args.cum = f[0];
  args.decay = f[1];
  args.hs = f[2];
  args.gs = f[3];
  args.hg = f[4];
  args.ddt_x = f[5];
  args.dcum_k = f[6];
  args.tj = f[7];
  args.dcum_q = f[8];
  args.db_h = f[9];
  args.dc_h = f[10];
  args.da_p = f[11];
  args.cb = dtype == 0 ? f[12] : nullptr;
  args.batch = batch;
  args.s = s;
  args.h = h;
  args.p = p;
  args.n = n;
  args.chunk = chunk;
  args.nc = (s + chunk - 1) / chunk;
  args.nt = (chunk + bwd::kTile - 1) / bwd::kTile;
  args.nparts = (p * n + bwd::kPartElems - 1) / bwd::kPartElems;
  args.npairs = args.nt * (args.nt + 1) / 2;
  args.g1 = g1;
  args.g3 = g3;
  args.parts = dtype == 0 ? h : (h + g3 - 1) / g3;
  args.x_sb = strides[0];
  args.x_ss = strides[1];
  args.x_sh = strides[2];
  args.dt_sb = strides[3];
  args.dt_ss = strides[4];
  args.dt_sh = strides[5];
  args.b_sb = strides[6];
  args.b_ss = strides[7];
  args.c_sb = strides[8];
  args.c_ss = strides[9];
  args.dy_sb = strides[10];
  args.dy_ss = strides[11];
  args.dy_sh = strides[12];
  if (dtype == 1) {
    for (const void* ptr : {x, b, c, dy})
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int i : {0, 1, 2, 6, 7, 8, 9, 10, 11, 12})
      if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_bwd(args, dtype, static_cast<cudaStream_t>(stream));
}
