// Per-row absmax int8 stochastic quantization of a (rows, n) float32
// array:  s = absmax > 0 ? absmax / 127 : 1,
//         q = clamp(floor(x / s + noise), -127, 127)  as int8.
//
// Replaces the Pallas kernel `quantize_int8_pallas`
// (src/repro/kernels/quantize.py, body `_quant_kernel`).  The uniform
// [0, 1) rounding noise is an operand, as there, so the kernel and its
// plain version (repro_torch/kernels/ref.py) consume the same bits.
//
// What bounds it on the H100: bytes.  A handful of operations per
// element against 9 bytes moved (float32 x and noise in, int8 out).
//
// What the design does about it: one block per row.  The block reads its
// row once to reduce the absmax (a strided max per thread, then warp
// shuffles, then one value per warp through shared memory) and once more
// to quantize; the second read of a row (16 KB at n = 4096) finds it in
// L1/L2, so device memory sees x about once.  Any n is taken; the TPU
// kernel's row padding is not needed.  The quotients and the add are
// IEEE intrinsics (no fast math, no FMA contraction), so codes and scales
// equal the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                int8_t* __restrict__ q, float* __restrict__ scales,
                int64_t n) {
  __shared__ float warp_max[kWarps];
  const int64_t row = blockIdx.x;
  const float* xr = x + row * n;
  const float* nr = noise + row * n;
  int8_t* qr = q + row * n;

  float m = 0.0f;
  for (int64_t j = threadIdx.x; j < n; j += kThreads) {
    m = fmaxf(m, fabsf(xr[j]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float absmax = warp_max[0];
  for (int w = 1; w < kWarps; ++w) absmax = fmaxf(absmax, warp_max[w]);

  const float s = absmax > 0.0f ? __fdiv_rn(absmax, 127.0f) : 1.0f;
  if (threadIdx.x == 0) scales[row] = s;
  for (int64_t j = threadIdx.x; j < n; j += kThreads) {
    float v = floorf(__fadd_rn(__fdiv_rn(xr[j], s), nr[j]));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    qr[j] = static_cast<int8_t>(static_cast<int>(v));
  }
}

}  // namespace

// x, noise: (rows, n) float32; q: (rows, n) int8; scales: (rows,)
// float32.  Returns the cudaError_t of the launch (0 when accepted).
extern "C" int quantize_launch(const void* x, const void* noise, void* q,
                               void* scales, long long rows, long long n,
                               void* stream) {
  if (rows <= 0 || n <= 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<int8_t*>(q), static_cast<float*>(scales), n);
  return static_cast<int>(cudaGetLastError());
}
