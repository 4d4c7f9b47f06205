// Decode-side unbiasing: out[r, j] = counts[r] > 0
//                                    ? y[r, j] * (total / max(counts[r], 1))
//                                    : 0
//
// Replaces the Pallas kernel `masked_unbias_pallas`
// (src/repro/kernels/unbias.py, body `_unbias_kernel`).
//
// What bounds it on the H100: bytes.  One multiply per element read and
// written, so the floor is one read of y and one write of out.
//
// What the design does about it: one elementwise pass over a 2-D grid.
// grid.y walks rows and computes the row's factor once; grid.x tiles the
// row itself, because the coded KV decode hands it rows of 208,896
// values that are no power of two (the TPU kernel took whole rows per
// block).  Neighbouring threads touch neighbouring addresses, and the
// ragged end of a row is masked here.  The factor uses IEEE division,
// as the plain version does, so the two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr unsigned kMaxGridY = 65535;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unbias_kernel(const T* __restrict__ y, const float* __restrict__ counts,
              T* __restrict__ out, int64_t rows, int64_t n, float total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float c = counts[r];
    const float f = total / fmaxf(c, 1.0f);
    const T* yr = y + r * n;
    T* orow = out + r * n;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         j < n; j += stride) {
      store_f32(orow + j, c > 0.0f ? load_f32(yr + j) * f : 0.0f);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (y and out); counts are float32.
// Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int unbias_launch(const void* y, const void* counts, void* out,
                             long long rows, long long n, float total,
                             int dtype, void* stream) {
  if (rows <= 0 || n <= 0) return cudaErrorInvalidValue;
  const long long per_block = static_cast<long long>(kThreads) * kPerThread;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(counts);
  if (dtype == 0) {
    unbias_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(y), c, static_cast<float*>(out), rows, n,
        total);
  } else if (dtype == 1) {
    unbias_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), c,
        static_cast<__nv_bfloat16*>(out), rows, n, total);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
