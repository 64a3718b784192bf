// Flash-attention forward kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) and the jnp.repeat of its GQA
// wrapper src/repro/kernels/ops.py (flash_attention_bhsd).  It computes what
// the Pallas kernel computes:
//   * q scaled by 1/sqrt(d) in fp32, fp32 scores;
//   * masks k_pos < kv_len, q_pos >= k_pos when causal, and
//     q_pos - k_pos < window whenever a window is given (causal or not),
//     with the finite sentinel -1e30, never -inf;
//   * a running row max and sum, the final divide clamping l at 1e-30;
//   * the output cast to q's dtype.
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
// the bf16 tensor-core peak, so the bytes bound it; the
// kernel, on the CUDA cores, is far from either.  Design, simple and right
// first:
//   * one block of 256 threads per (batch*head, 64-query tile), batch*head
//     on grid x (up to 2^31 - 1) and query tiles on grid y;
//   * the scaled Q tile and each 64-key K/V tile staged in shared memory as
//     fp32 (Q and K transposed, padded by one column against bank
//     conflicts), loads masked at the ragged S and T edges, no padding;
//   * a 4x4 register micro-tile of scores per thread, fp32 FMAs on the CUDA
//     cores (fp32 inputs are held to 2e-5, so no TF32 or bf16 tensor cores);
//   * row max and sum across the 16 threads sharing a row by warp shuffles;
//     P goes through shared memory into a 4 x (d/16) fp32 accumulator;
//   * KV tiles that the causal or window mask removes entirely are skipped:
//     they add exactly nothing (exp(-1e30 - m) is 0).
// wgmma, TMA and a pipelined ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;        // queries per block
constexpr int kBk = 64;        // keys per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLd = kBq + 1;   // padded leading dim of qT, kT and p
constexpr float kNegInf = -1e30f;

static_assert(kBq == kBk, "the 16 x 16 thread grid covers a square score tile");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hk, s, t;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast in PyTorch
}

template <int D>
constexpr size_t smem_bytes() {
  // qT[D][kLd] + kT[D][kLd] + v[kBk][D] + p[kBq][kLd], all fp32
  return sizeof(float) * (2 * D * kLd + kBk * D + kBq * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
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

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Adjacent threads read adjacent head dims of one row (coalesced) and
  // write a column of the transposed tile (stride kLd: distinct banks).
  for (int l = tid; l < kBq * D; l += kThreads) {
    const int r = l / D;
    const int c = l % D;
    const int qi = q0 + r;
    q_t[c * kLd + r] = qi < a.s ? to_float(q[qi * a.q_ss + c]) * a.scale : 0.0f;
  }

  float m[4], l_sum[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l_sum[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
  }

  // KV tiles that some query of this tile may attend to.
  const int q_last = min(q0 + kBq, a.s) - 1;
  int tile_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) tile_begin = (q0 - a.window + 1) / kBk;
  int tile_end = (a.t + kBk - 1) / kBk;
  if (a.causal) tile_end = min(tile_end, q_last / kBk + 1);

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int kv0 = tile * kBk;
    __syncthreads();  // the previous tile's k_t, v_s and p_s are consumed
    for (int l = tid; l < kBk * D; l += kThreads) {
      const int r = l / D;
      const int c = l % D;
      const int ki = kv0 + r;
      const bool in = ki < a.t;
      k_t[c * kLd + r] = in ? to_float(k[ki * a.k_ss + c]) : 0.0f;
      v_s[r * D + c] = in ? to_float(v[ki * a.v_ss + c]) : 0.0f;
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
      o[qi * a.o_ss + tx + 16 * j] = from_float<T>(acc[r][j] / denom);
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.hq, (a.s + kBq - 1) / kBq);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
// (batch, sequence, head).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); an unsupported dtype or head_dim
// returns cudaErrorInvalidValue without launching.
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
  Args a{q, k, v, o, hq, hk, s, t,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
         causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(a, batch, d, st);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(a, batch, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
