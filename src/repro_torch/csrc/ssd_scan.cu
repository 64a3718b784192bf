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
//     chunk; all arithmetic is fp32 and y is stored in x's dtype.
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
// bound it.  Design, simple and right first:
//   * the Pallas grid step holds all H heads and an (H, P, N) VMEM state
//     (1.5 MB at mamba2's shape), which no SM holds; here one block of 256
//     threads owns one (batch, head), walks its chunks in order and keeps
//     its (P, N) fp32 state in shared memory.  No block depends on another;
//   * a chunk is cut into sub-tiles of T = min(Q, 64) rows.  For each query
//     tile I: the inter-chunk term C_I . state, then for each key tile
//     J <= I the score tile C_I B_J^T (4x4 register micro-tiles over a
//     16 x 16 thread grid), times the decay and dt_j, into shared memory,
//     then L . x_J.  The diagonal tile J = I, still in shared memory, adds
//     its share of the chunk's state update into registers; the state in
//     shared memory is updated once the chunk's queries have read it;
//   * the cumulative sum is one warp's scan (serial runs of Q/32, then
//     shuffles); C and B tiles are staged transposed with a padded leading
//     dim, loads masked at the ragged edge, fp32 FMAs on the CUDA cores,
//     expf (not __expf) throughout.
// C_I B_J^T is recomputed by every head of a batch row; tensor cores,
// sharing it across heads and a pipelined ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast in PyTorch
}

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

// The (P, N) pairs taken: the model shapes, the smoke configs' and the
// reference sweep's.  kernels/ssd_scan.py lists the same pairs.
#define SSD_SHAPES(X)                                                    \
  X(64, 128) X(64, 64) X(32, 16)                                         \
  X(4, 4) X(4, 8) X(4, 16) X(8, 4) X(8, 8) X(8, 16) X(16, 4) X(16, 8) X(16, 16)

template <typename T>
int dispatch_shape(const Args& a, int batch, int p, int n, cudaStream_t stream) {
#define SSD_CASE(P_, N_) \
  if (p == P_ && n == N_) return launch<T, P_, N_>(a, batch, stream);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0 = fp32, 1 = bf16 (x, B, C and y); dt and a are fp32.  Strides are
// in elements: x (batch, seq, head), dt (batch, seq, head), B and C (batch,
// seq).  Launches on `stream` and returns cudaGetLastError() (0 = launched);
// an unsupported dtype, (P, N) or chunk returns cudaErrorInvalidValue
// without launching.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* a, const void* b, const void* c,
    void* y, void* fin, int dtype, int batch, int s, int h, int p, int n, int chunk,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* stream) {
  if (batch <= 0 || h <= 0 || s < 0 || chunk <= 0 || chunk > kMaxChunk ||
      (chunk > kTile && chunk % kTile != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c, y,
            static_cast<float*>(fin), h, s, chunk,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_shape<float>(args, batch, p, n, st);
  if (dtype == 1) return dispatch_shape<__nv_bfloat16>(args, batch, p, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
