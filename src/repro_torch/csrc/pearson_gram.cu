// Pearson Gram kernel for Hopper (sm_90a): out = 1 - Z Z^T.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pearson_affinity.py
// (pearson_dissimilarity, body _gram_kernel).  Z is (K, F) fp32, row-major,
// rows already centred and scaled to unit L2 norm by the caller; out is
// (K, K) fp32.
//
// Bound: K*(K+1)*F fp32 operations (the upper triangle of Z Z^T, diagonal
// included) against K*F*4 + K*K*4 bytes.  At the transformer profile's
// K = 256, F = 655,360 that is 43 GFLOP over 0.67 GB, and at the LeNet
// path's K = 512, F = 1568 0.41 GFLOP over 4.3 MB: both bound by the
// CUDA-core fp32 rate.  The reference tolerance is 1e-5, so neither TF32
// nor bf16 tensor cores may be used.  Design:
//   * two passes.  Pass 1 runs one block per (upper 64x64 tile pair, split
//     of F); each writes its fp32 partial tile to scratch.  Pass 2 runs one
//     thread per output of the upper tiles: it sums that output's partials
//     in split order, applies 1 - x and writes it and its mirror.  No
//     atomics: the result is bit-identical from run to run, and the split
//     plan comes from (K, F) alone (kernels/pearson_affinity.py::split_plan),
//     never from the card, so it is the same on every card;
//   * each split is a whole number of 256-feature chunks; inside a split,
//     fp32 FMAs are summed in two levels, a partial over each chunk added to
//     the split's total once per chunk, so no chain of additions is longer
//     than F / 256 (one flat chain lost 2.6e-4 against cuBLAS at
//     F = 655,360);
//   * 128 threads a block, a 4x8 register micro-tile per thread; F walked in
//     32-feature slices through a 3-stage cp.async ring, so the copy of
//     slice s + 2 overlaps the FMAs on slice s; tiles are row-major in
//     shared memory (rows padded to 36 floats, conflict-free) and read as
//     float4 along F: 12 16-byte loads feed 128 FMAs;
//   * loads masked (zero-filled) at the ragged K and F edges; 16-byte copies
//     where F % 4 == 0 and Z is 16-byte aligned, 4-byte copies otherwise;
//   * only tiles with row-tile <= column-tile are computed; a diagonal tile
//     reads its rows once, and fmaf(a, b, c) == fmaf(b, a, c), so its
//     (i, j) and (j, i) agree bit for bit; off-diagonal tiles write their
//     mirror.  out is exactly symmetric (Spearman ranks the profile's ties,
//     which a one-bit asymmetry breaks).
// wgmma cannot serve fp32 at 1e-5; a persistent schedule is later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // output rows/columns per tile
constexpr int kSlice = 32;     // features per ring stage
constexpr int kLd = kSlice + 4;  // padded row of a stage, in floats
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 16 x 8 threads, 4 x 8 outputs each
constexpr int kMinBlocks = 3;  // per SM: 170 registers a thread at most
constexpr int kTy = kThreads / 8;  // thread rows: rows ty + kTy * i
constexpr int kRows = kTile / kTy;  // rows per thread (columns: 8)
constexpr int kChunk = 256;    // features per partial sum
constexpr int kSlicesPerChunk = kChunk / kSlice;
constexpr int kSlots = kRows * 8;  // outputs per thread
constexpr size_t kStageFloats = static_cast<size_t>(kTile) * kLd;
constexpr size_t kSmemBytes = 2 * kStages * kStageFloats * sizeof(float);

static_assert(kChunk % kSlice == 0, "a chunk is a whole number of slices");

__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Upper tile pair p (row-major over row-tile <= column-tile) -> (bi, bj).
__device__ __forceinline__ void pair_tiles(int p, int tiles, int& bi, int& bj) {
  bi = 0;
  while (p >= tiles - bi) {
    p -= tiles - bi;
    ++bi;
  }
  bj = bi + p;
}

// One 64-row x 32-feature slice of Z into a stage, zero-filled outside
// rows [0, k) and features [0, f_end).
template <int kVec>
__device__ __forceinline__ void load_slice(float* dst, const float* z, int row0, int k,
                                           int f0, int f_end, int f) {
  constexpr int kPerRow = kSlice / kVec;
  for (int l = threadIdx.x; l < kTile * kPerRow; l += kThreads) {
    const int r = l / kPerRow;
    const int c = (l % kPerRow) * kVec;
    const int gi = row0 + r;
    const int fi = f0 + c;
    const bool in = gi < k && fi < f_end;
    const float* src = in ? z + static_cast<size_t>(gi) * f + fi : z;
    if constexpr (kVec == 4)
      cp_async_16(dst + r * kLd + c, src, in);
    else
      cp_async_4(dst + r * kLd + c, src, in);
  }
}

// Pass 1: block x = split * pairs + pair (the pairs of one split run side by
// side and share its slice of Z in L2).  Writes the split's partial tile to
// partial[split][pair][slot][thread].
template <int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pearson_partial_kernel(const float* __restrict__ z, float* __restrict__ partial,
                       int k, int f, int tiles, int pairs, int span) {
  extern __shared__ __align__(16) float smem[];
  const int pair = blockIdx.x % pairs;
  const int split = blockIdx.x / pairs;
  int bi, bj;
  pair_tiles(pair, tiles, bi, bj);
  const bool diag = bi == bj;
  const int row0 = bi * kTile;
  const int col0 = bj * kTile;
  const int f_begin = split * span;
  const int f_end = min(f_begin + span, f);
  const int n_slices = f_end > f_begin ? (f_end - f_begin + kSlice - 1) / kSlice : 0;

  float* a_s = smem;                          // [kStages][kTile][kLd]
  float* b_s = diag ? smem : smem + kStages * kStageFloats;

  const int tid = threadIdx.x;
  const int tx = tid % 8;  // columns tx + 8 * j
  const int ty = tid / 8;  // rows ty + kTy * i

  auto load = [&](int s) {
    const int st = s % kStages;
    const int f0 = f_begin + s * kSlice;
    load_slice<kVec>(a_s + st * kStageFloats, z, row0, k, f0, f_end, f);
    if (!diag) load_slice<kVec>(b_s + st * kStageFloats, z, col0, k, f0, f_end, f);
  };

  float acc[kRows][8], part[kRows][8];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s landed for all; slice s - 1's stage is free
    if (s + kStages - 1 < n_slices) load(s + kStages - 1);
    cp_async_commit();

    const float* a_st = a_s + (s % kStages) * kStageFloats;
    const float* b_st = b_s + (s % kStages) * kStageFloats;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 4) {
      float4 a[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_st + (ty + kTy * i) * kLd + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(b_st + (tx + 8 * j) * kLd + kk);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          part[i][j] = fmaf(a[i].x, b.x, part[i][j]);
          part[i][j] = fmaf(a[i].y, b.y, part[i][j]);
          part[i][j] = fmaf(a[i].z, b.z, part[i][j]);
          part[i][j] = fmaf(a[i].w, b.w, part[i][j]);
        }
      }
    }
    if ((s + 1) % kSlicesPerChunk == 0 || s + 1 == n_slices) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.0f;
        }
    }
  }
  cp_async_wait<0>();

  float* out = partial + (static_cast<size_t>(split) * pairs + pair) * kSlots * kThreads;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(i * 8 + j) * kThreads + tid] = acc[i][j];
}

// Pass 2: block (pair, slot), one thread per output, sums the pair's
// partials in split order, applies 1 - x and writes the output and, off the
// diagonal, its mirror.
__global__ void __launch_bounds__(kThreads)
pearson_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                      int k, int tiles, int pairs, int splits) {
  const int pair = blockIdx.x;
  const int slot = blockIdx.y;
  int bi, bj;
  pair_tiles(pair, tiles, bi, bj);
  const int tid = threadIdx.x;
  const size_t stride = static_cast<size_t>(pairs) * kSlots * kThreads;
  const float* p = partial + (static_cast<size_t>(pair) * kSlots + slot) * kThreads + tid;
  float v = p[0];
  for (int sp = 1; sp < splits; ++sp) v += p[sp * stride];
  const int i = bi * kTile + tid / 8 + kTy * (slot / 8);
  const int j = bj * kTile + tid % 8 + 8 * (slot % 8);
  if (i < k && j < k) {
    const float d = 1.0f - v;
    out[static_cast<size_t>(i) * k + j] = d;
    if (bi != bj) out[static_cast<size_t>(j) * k + i] = d;
  }
}

template <int kVec>
int launch_partial(const float* z, float* partial, int k, int f, int tiles, int pairs,
                   int splits, int span, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pearson_partial_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  pearson_partial_kernel<kVec><<<pairs * splits, kThreads, kSmemBytes, stream>>>(
      z, partial, k, f, tiles, pairs, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both passes on `stream`.  `partial` holds splits * pairs * 4096 floats,
// pairs = T (T + 1) / 2 for T = ceil(k / 64); split s covers features
// [s * span, min((s + 1) * span, f)), span a multiple of 256.  Returns
// cudaGetLastError() (0 = launched); bad arguments return
// cudaErrorInvalidValue without launching.
extern "C" int pearson_gram(const void* z, void* partial, void* out, int k, int f,
                            int splits, int span, void* stream) {
  const int tiles = (k + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  if (k <= 0 || f < 0 || splits <= 0 || span <= 0 || span % kChunk != 0 ||
      static_cast<long long>(splits) * span < f)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* pf = static_cast<float*>(partial);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const int err = vec ? launch_partial<4>(zf, pf, k, f, tiles, pairs, splits, span, st)
                      : launch_partial<1>(zf, pf, k, f, tiles, pairs, splits, span, st);
  if (err != 0) return err;
  pearson_reduce_kernel<<<dim3(pairs, kSlots), kThreads, 0, st>>>(
      pf, static_cast<float*>(out), k, tiles, pairs, splits);
  return static_cast<int>(cudaGetLastError());
}
