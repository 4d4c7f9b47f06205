// Fast Walsh-Hadamard transform along the last axis of a (rows, n) array,
// and the same transform fused with per-row int8 quantization.
//
// `fwht_launch` replaces the Pallas kernel `fwht_pallas`
// (src/repro/kernels/fwht.py, body `_fwht_kernel`): out = H_n (x * signs)
// * scale per row, n a power of two from 2 to 4096, float32 or bfloat16
// in and out, float32 inside.
//
// `fwht_quantize_launch` replaces `fwht_quantize_pallas` (same file, body
// `_fwht_quant_kernel`): the rotation above on float32 x, then per row
// s = absmax / 127 (1 if 0) and q = clamp(floor(y / s + noise), -127, 127)
// as int8, with the uniform [0, 1) noise passed in as an operand.
//
// What bounds them on the H100: bytes.  A row of n values takes n*log2(n)
// additions, at most 12 per element read and written, far below the
// ~20 float32 operations per byte that the card's 67 TFLOP/s over
// 3.35 TB/s would need before arithmetic became the limit.  So the
// floor is one read of x and one write of out (fused: one read of x and
// of noise, one int8 write and one scale per row).
//
// What the design does about it: every element crosses device memory
// exactly once each way.  A block loads a 4096-element tile (whole rows:
// 4096/n of them) with coalesced loads, applies the sign pre-multiply on
// the way in, runs all log2(n) butterfly stages on the tile in shared
// memory, and applies the scale on the way out.  The fused kernel keeps
// the rotated tile in shared memory instead: it reduces each row's
// absmax there (warp shuffles over runs of up to 32 values, then a short
// tree over the per-run maxima) and quantizes straight from the tile,
// so the float32 rotation never goes to device memory, which is the
// Pallas kernel's point.  The TPU kernels' two Hadamard-factor matmuls
// for the MXU are not carried over: a butterfly moves no more bytes and
// needs no matrix operands.  The stage order and float32 arithmetic are
// those of the plain versions (repro_torch/kernels/ref.py), and the
// quotients and the noise add are IEEE intrinsics, so kernel and plain
// version agree bit for bit, and the fused kernel equals `fwht_launch`
// followed by the quantize kernel (csrc/quantize.cu).  The ragged last
// tile is masked here; no padding copy is needed.
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

// Loads the tile of `rows_per_tile` whole rows that starts at row0
// (zeros past the last row), multiplies the signs in, and runs every
// butterfly stage.  Ends with the block synchronized.
template <typename T>
__device__ __forceinline__ void rotate_tile(float* tile, const T* src,
                                            const float* signs, int n,
                                            int valid) {
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
  rotate_tile(tile, x + (row0 << log_n), signs, n, valid);

  T* dst = out + (row0 << log_n);
  for (int i = threadIdx.x; i < valid; i += kThreads) {
    store_f32(dst + i, scale == 1.0f ? tile[i] : tile[i] * scale);
  }
}

__global__ void __launch_bounds__(kThreads)
fwht_quantize_kernel(const float* __restrict__ x,
                     const float* __restrict__ noise,
                     const float* __restrict__ signs,
                     int8_t* __restrict__ q, float* __restrict__ scales,
                     int64_t rows, int log_n, float scale) {
  __shared__ float tile[kTile];
  // per-run maxima; a run is min(n, 32) values, so at most kTile / 2
  __shared__ float run_max[kTile / 2];
  const int n = 1 << log_n;
  const int64_t rows_per_tile = kTile >> log_n;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_tile;
  const int64_t rows_here =
      rows - row0 < rows_per_tile ? rows - row0 : rows_per_tile;
  const int valid = static_cast<int>(rows_here << log_n);
  rotate_tile(tile, x + (row0 << log_n), signs, n, valid);

  // scale, and the absmax of each aligned run of `run` values: neighbour
  // lanes hold neighbour elements and runs start on multiples of `run`,
  // so a run lies in one row and in one warp
  const int log_run = log_n < 5 ? log_n : 5;
  const int run = 1 << log_run;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const float y = scale == 1.0f ? tile[i] : tile[i] * scale;
    tile[i] = y;
    float m = fabsf(y);
    for (int off = 1; off < run; off <<= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if ((i & (run - 1)) == 0) run_max[i >> log_run] = m;
  }
  __syncthreads();

  // tree over the n / run maxima of each row; run_max[r * per_row] ends
  // holding row r's absmax
  const int per_row = n >> log_run;
  const int n_runs = kTile >> log_run;
  for (int h = per_row >> 1; h > 0; h >>= 1) {
    for (int j = threadIdx.x; j < n_runs; j += kThreads) {
      if ((j & (per_row - 1)) < h) {
        run_max[j] = fmaxf(run_max[j], run_max[j + h]);
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < rows_per_tile; r += kThreads) {
    const float absmax = run_max[r * per_row];
    const float s = absmax > 0.0f ? __fdiv_rn(absmax, 127.0f) : 1.0f;
    run_max[r * per_row] = s;
    if (r < rows_here) scales[row0 + r] = s;
  }
  __syncthreads();

  const float* nz = noise + (row0 << log_n);
  int8_t* dst = q + (row0 << log_n);
  for (int i = threadIdx.x; i < valid; i += kThreads) {
    const float s = run_max[(i >> log_n) * per_row];
    float v = floorf(__fadd_rn(__fdiv_rn(tile[i], s), nz[i]));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    dst[i] = static_cast<int8_t>(static_cast<int>(v));
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

// x, noise: (rows, n) float32; q: (rows, n) int8; scales: (rows,)
// float32; signs may be null.  Returns the cudaError_t of the launch.
extern "C" int fwht_quantize_launch(const void* x, const void* noise,
                                    const void* signs, void* q, void* scales,
                                    long long rows, int log_n, float scale,
                                    void* stream) {
  if (rows <= 0 || log_n < 1 || log_n > kLogTile) return cudaErrorInvalidValue;
  const long long rows_per_tile = kTile >> log_n;
  const unsigned blocks =
      static_cast<unsigned>((rows + rows_per_tile - 1) / rows_per_tile);
  fwht_quantize_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(signs), static_cast<int8_t*>(q),
      static_cast<float*>(scales), rows, log_n, scale);
  return static_cast<int>(cudaGetLastError());
}
