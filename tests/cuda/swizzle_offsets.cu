// hopper::tile_off (src/repro_torch/csrc/hopper_tma_wgmma.cuh) at the index
// patterns the port's kernels address their swizzled tiles with, compiled
// as the kernels are and written out for tests/test_torch_cuda.py to hold
// against the 128-byte swizzle.  nvcc 12.9 at -O3 once miscompiled an
// earlier form of the offset at the row-dot pattern.
#include "hopper_tma_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 64;

__global__ void __launch_bounds__(kThreads) offsets_kernel(int* out) {
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int g = (t % 32) / 4;
  const int qd = t % 4;
  // The row dot: accumulator rows r0 and r0 + 8, columns 8 i + 2 qd + e of
  // a 128-column (two-atom) tile.
  int* o = out + t * kPerThread;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[(rr * 16 + i) * 2 + e] = hopper::tile_off(16 * warp + g + 8 * rr, 8 * i + 2 * qd + e);
  // The chunk kernels' A fragments: rows 16 kk + 2 qd + 8 half + e, columns
  // 16 warp + g + 8 rr.
  o += kThreads * kPerThread;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          o[((kk * 2 + half) * 2 + e) * 2 + rr] =
              hopper::tile_off(16 * kk + 2 * qd + 8 * half + e, 16 * warp + g + 8 * rr);
  // The state staging: element 4 l of a row-major (64, 128) state.
  o += kThreads * kPerThread;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int l = t + kThreads * k;
    o[k] = hopper::tile_off(4 * l / 128, 4 * l % 128);
  }
}

}  // namespace

// Writes 3 x 128 x 64 offsets to `out` (device memory, entries a pattern
// does not use left as they are) on the default stream and returns the
// launch's error.
extern "C" int swizzle_offsets(int* out) {
  offsets_kernel<<<1, kThreads>>>(out);
  return static_cast<int>(cudaGetLastError());
}
