// Fast Walsh-Hadamard transform along the last axis of a (rows, n) array.
//
// Replaces the Pallas kernel `fwht_pallas` (src/repro/kernels/fwht.py,
// body `_fwht_kernel`): out = H_n (x * signs) * scale per row, n a power
// of two from 2 to 4096, float32 or bfloat16 in and out, float32 inside.
//
// What bounds it on the H100: bytes.  A row of n values takes n*log2(n)
// additions, at most 12 per element read and written, far below the
// ~20 float32 operations per byte that the card's 67 TFLOP/s over
// 3.35 TB/s would need before arithmetic became the limit.  So the
// floor is one read of x and one write of out.
//
// What the design does about it: every element crosses device memory
// exactly once each way.  A block loads a 4096-element tile (whole rows:
// 4096/n of them) with coalesced loads, applies the sign pre-multiply on
// the way in, runs all log2(n) butterfly stages on the tile in shared
// memory, and applies the scale on the way out.  The TPU kernel's two
// Hadamard-factor matmuls for the MXU are not carried over: a butterfly
// moves no more bytes and needs no matrix operands.  The stage order and
// float32 arithmetic are those of the plain version
// (repro_torch/kernels/ref.py), so the two agree bit for bit.
// The ragged last tile is masked here; no padding copy is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogTile = 12;
constexpr int kTile = 1 << kLogTile;  // 16 KB of float32 shared memory
constexpr int kThreads = 256;

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
fwht_kernel(const T* __restrict__ x, T* __restrict__ out,
            const float* __restrict__ signs, int64_t rows, int log_n,
            float scale) {
  __shared__ float tile[kTile];
  const int n = 1 << log_n;
  const int64_t rows_per_tile = kTile >> log_n;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_tile;
  const int64_t rows_here =
      rows - row0 < rows_per_tile ? rows - row0 : rows_per_tile;
  const int valid = static_cast<int>(rows_here << log_n);
  const T* src = x + (row0 << log_n);
  T* dst = out + (row0 << log_n);

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    float v = i < valid ? load_f32(src + i) : 0.0f;
    if (signs != nullptr) v *= signs[i & (n - 1)];
    tile[i] = v;
  }
  __syncthreads();

  // stage h pairs element i with i + h inside each run of 2h; runs never
  // straddle two rows because rows start on multiples of n >= 2h
  for (int h = 1; h < n; h <<= 1) {
    for (int p = threadIdx.x; p < kTile / 2; p += kThreads) {
      const int lo = p & (h - 1);
      const int i = ((p - lo) << 1) + lo;
      const float a = tile[i];
      const float b = tile[i + h];
      tile[i] = a + b;
      tile[i + h] = a - b;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < valid; i += kThreads) {
    store_f32(dst + i, scale == 1.0f ? tile[i] : tile[i] * scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  signs may be null.  Returns the
// cudaError_t of the launch (0 when it was accepted).
extern "C" int fwht_launch(const void* x, void* out, const void* signs,
                           long long rows, int log_n, float scale, int dtype,
                           void* stream) {
  if (rows <= 0 || log_n < 1 || log_n > kLogTile) return cudaErrorInvalidValue;
  const long long rows_per_tile = kTile >> log_n;
  const unsigned blocks =
      static_cast<unsigned>((rows + rows_per_tile - 1) / rows_per_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(signs);
  if (dtype == 0) {
    fwht_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), sg, rows,
        log_n, scale);
  } else if (dtype == 1) {
    fwht_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), sg, rows, log_n, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
