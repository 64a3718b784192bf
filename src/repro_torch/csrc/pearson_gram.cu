// Pearson Gram kernel for Hopper (sm_90a): out = 1 - Z Z^T.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pearson_affinity.py
// (pearson_dissimilarity, body _gram_kernel).  Z is (K, F) fp32, row-major,
// rows already centred and scaled to unit L2 norm by the caller; out is
// (K, K) fp32.
//
// Bound: 2*K*K*F fp32 operations against K*F*4 + K*K*4 bytes.  At the main
// path's K = 512, F = 1568 that is 0.82 GFLOP over 4.3 MB, so the CUDA-core
// fp32 rate bounds it (the reference tolerance is 1e-5, so neither TF32 nor
// bf16 tensor cores may be used).  Design, simple and right first:
//   * one 64x64 output tile per block of 256 threads, a 4x4 register
//     micro-tile per thread, F walked in 16-wide slices staged in shared
//     memory (k-major, padded against bank conflicts);
//   * loads masked at the ragged K and F edges instead of zero padding;
//   * an fp32 FMA accumulator with the 1 - acc epilogue fused;
//   * only tiles with row-tile <= column-tile do work, and each off-diagonal
//     tile writes its mirror too, so out[i][j] and out[j][i] are bit-equal
//     (Spearman ranks the profile's ties, which a one-bit asymmetry breaks).
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output rows/columns per block
constexpr int kSlice = 16;    // features per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
pearson_gram_kernel(const float* __restrict__ z, float* __restrict__ out,
                    int k, int f) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;  // lower tiles are written as mirrors of upper ones

  __shared__ float a_s[kSlice][kTile + 1];
  __shared__ float b_s[kSlice][kTile + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = bi * kTile;
  const int col0 = bj * kTile;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int f0 = 0; f0 < f; f0 += kSlice) {
    // 64 rows x 16 features per operand: 4 elements per thread, adjacent
    // threads on adjacent features of one row.
    for (int l = tid; l < kTile * kSlice; l += kThreads) {
      const int r = l / kSlice;
      const int s = l % kSlice;
      const int fi = f0 + s;
      const int gi = row0 + r;
      const int gj = col0 + r;
      a_s[s][r] = (gi < k && fi < f) ? z[(size_t)gi * f + fi] : 0.0f;
      b_s[s][r] = (gj < k && fi < f) ? z[(size_t)gj * f + fi] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlice; ++s) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = a_s[s][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = b_s[s][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = col0 + tx + 16 * c;
      if (i < k && j < k) {
        const float v = 1.0f - acc[r][c];
        out[(size_t)i * k + j] = v;
        if (bi != bj) out[(size_t)j * k + i] = v;
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int pearson_gram(const void* z, void* out, int k, int f,
                            void* stream) {
  const int tiles = (k + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles);
  pearson_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float*>(out), k, f);
  return static_cast<int>(cudaGetLastError());
}
