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
// once each way, and the butterfly stays out of shared memory.  A block
// of 256 threads takes a tile of 4096 elements (4096/n whole rows); each
// thread owns 16 contiguous elements, loaded as 16-byte vectors with the
// signs multiplied in.  Stages h = 1..8 run in the thread's registers
// (all stages when n <= 16), stages h = 16..256 across the lanes of a
// warp by `__shfl_xor_sync` (lane mask h/16; a row of n <= 512 lies in
// one warp and needs nothing else).  A row of n >= 1024 spans 2..8
// warps: the registers go once into a swizzled shared tile (16-byte
// stores and loads without bank conflicts), one barrier, and each thread
// reads back C = 16/K contiguous columns at K = n/512 rows of stride
// 512, runs the last log2(K) stages in registers and stores from that
// layout, so neighbouring threads still write neighbouring addresses.
// One shared-memory pass and one barrier replace the log2(n) passes and
// barriers of a butterfly staged in shared memory.  The fused kernel
// scales in registers, takes each row's absmax by thread, warp shuffle
// and (n >= 1024) one small shared array, and quantizes from registers
// with the noise read in the layout the codes are stored in, so the
// float32 rotation never reaches device memory, which is the Pallas
// kernel's point.  The TPU kernels' two
// Hadamard-factor matmuls are not carried over: on the card they would
// be TF32 tensor-core products, which break equality with the float32
// plain version, and a butterfly moves no more bytes.  Templates on
// log2(n) and the dtype unroll every stage.
//
// Why it equals the plain versions (repro_torch/kernels/ref.py) bit for
// bit: the stages run in their order, h = 1, 2, ..., n/2, each pair as
// (a + b, a - b) in float32.  Across lanes the lower lane keeps own +
// partner (= a + b, addition commutes exactly) and the upper partner -
// own (= a - b, never b - a).  Every multiply, add and subtract is an
// `__f*_rn` intrinsic, so nvcc contracts nothing into an FMA whatever
// the signs hold; the quotients and the noise add are `__fdiv_rn` /
// `__fadd_rn`.  So the fused kernel also equals `fwht_launch` followed
// by the quantize kernel (csrc/quantize.cu).  The ragged last tile
// (rows * n not a multiple of 16 when n < 16) is masked here; nothing
// is padded.  Every pointer must be 16-byte aligned (the wrappers check).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                   // contiguous elements a thread owns
constexpr int kLogTile = 12;
constexpr int kTile = kThreads * kPer;     // 4096 elements a block
constexpr int kWarpSpan = 32 * kPer;       // elements a warp owns: 512
constexpr unsigned kFull = 0xffffffffu;

template <int LOG_N>
struct Layout {
  static constexpr int kN = 1 << LOG_N;
  static constexpr int kRun = kN < kPer ? kN : kPer;  // a thread's run of a row
  static constexpr bool kExchange = kN > kWarpSpan;   // n >= 1024
  static constexpr int kK = kExchange ? kN / kWarpSpan : 1;  // strided rows
  static constexpr int kC = kPer / kK;                // their contiguous columns
  static constexpr int kLanes = kN / kRun;            // threads a row spans
};

// ---- vector access: N contiguous elements, 16-byte aligned at N = 16 ----

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
}

// bf16 -> float32 is exact: the bf16 bits are the top half of the float
__device__ __forceinline__ void unpack_bf16(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (N == 2) {
    unpack_bf16(*reinterpret_cast<const uint32_t*>(p), v);
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    unpack_bf16(t.x, v); unpack_bf16(t.y, v + 2);
  } else {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[i];
      unpack_bf16(t.x, v + 8 * i); unpack_bf16(t.y, v + 8 * i + 2);
      unpack_bf16(t.z, v + 8 * i + 4); unpack_bf16(t.w, v + 8 * i + 6);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const float* w = v + 8 * i;
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]),
                     pack_bf16(w[4], w[5]), pack_bf16(w[6], w[7]));
    }
  }
}

__device__ __forceinline__ uint32_t pack_i8(const int* c) {
  return (static_cast<uint32_t>(c[0]) & 0xffu) |
         ((static_cast<uint32_t>(c[1]) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c[2]) & 0xffu) << 16) |
         (static_cast<uint32_t>(c[3]) << 24);
}

template <int N>
__device__ __forceinline__ void store_codes(int8_t* p, const int* c) {
  if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(
        (static_cast<uint32_t>(c[0]) & 0xffu) |
        ((static_cast<uint32_t>(c[1]) & 0xffu) << 8));
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = pack_i8(c);
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_i8(c), pack_i8(c + 4));
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_i8(c), pack_i8(c + 4),
                                              pack_i8(c + 8), pack_i8(c + 12));
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---- the rotation ----

__device__ __forceinline__ void butterfly(float& a, float& b) {
  const float s = __fadd_rn(a, b);
  b = __fsub_rn(a, b);
  a = s;
}

// Shared tile index of tile element f: the 16-byte chunk f / 4 has its
// low three bits XORed with the next three, so that 8 lanes storing or
// loading a 16-byte chunk each hit 8 different chunks of a 128-byte line.
__device__ __forceinline__ int swizzle(int f) {
  const int c = f >> 2;
  return ((c ^ ((c >> 3) & 7)) << 2) | (f & 3);
}

// Tile element of this thread's v[0] after the exchange; v[k * kC + c]
// is element exchanged_base + c + k * 512.
template <int LOG_N>
__device__ __forceinline__ int exchanged_base() {
  using L = Layout<LOG_N>;
  const int t = threadIdx.x;
  return (t / L::kLanes) * L::kN + (t % L::kLanes) * L::kC;
}

// Loads this thread's 16 elements of the tile at src (`valid` elements,
// zeros past them), multiplies the signs in and runs every stage.  Ends
// with v in the load layout (v[j] = element 16 t + j) when n <= 512, else
// in the exchanged layout.  Every thread of the block must call it.
template <int LOG_N, typename T>
__device__ __forceinline__ void rotate(const T* __restrict__ src,
                                       const float* __restrict__ signs,
                                       int valid, float (&v)[kPer],
                                       float* tile) {
  using L = Layout<LOG_N>;
  const int e0 = threadIdx.x * kPer;
  if (e0 + kPer <= valid) {
    load_vec<kPer>(src + e0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = e0 + j < valid ? to_f32(src[e0 + j]) : 0.0f;
    }
  }
  if (signs != nullptr) {
    float s[L::kRun];
    load_vec<L::kRun>(signs + (e0 & (L::kN - 1)), s);
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = __fmul_rn(v[j], s[j % L::kRun]);
  }

  // h = 1 .. kRun/2 in registers: a thread's runs start on multiples of
  // kRun, so a pair never straddles two rows
#pragma unroll
  for (int h = 1; h < L::kRun; h <<= 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!(j & h)) butterfly(v[j], v[j + h]);
    }
  }

  // h = 16 .. min(n/2, 256): the partner element sits in lane ^ (h / 16)
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 1; m < L::kLanes && m < 32; m <<= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float p = __shfl_xor_sync(kFull, v[j], m);
      v[j] = upper ? __fsub_rn(p, v[j]) : __fadd_rn(v[j], p);
    }
  }

  if constexpr (L::kExchange) {
    // h = 512 .. n/2 pair warps: one pass through shared memory, after
    // which each thread holds kC columns at kK rows of stride 512
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      *reinterpret_cast<float4*>(tile + swizzle(e0 + 4 * q)) = make_float4(
          v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncthreads();
    constexpr int kVec = L::kC < 4 ? L::kC : 4;
    const int base = exchanged_base<LOG_N>();
#pragma unroll
    for (int k = 0; k < L::kK; ++k) {
#pragma unroll
      for (int c = 0; c < L::kC; c += kVec) {
        load_vec<kVec>(tile + swizzle(base + k * kWarpSpan + c),
                       v + k * L::kC + c);
      }
    }
#pragma unroll
    for (int s = 1; s < L::kK; s <<= 1) {
#pragma unroll
      for (int k = 0; k < L::kK; ++k) {
        if (k & s) continue;
#pragma unroll
        for (int c = 0; c < L::kC; ++c) {
          butterfly(v[k * L::kC + c], v[(k + s) * L::kC + c]);
        }
      }
    }
  }
}

__device__ __forceinline__ int quantize(float y, float s, float u) {
  const float v = floorf(__fadd_rn(__fdiv_rn(y, s), u));
  return static_cast<int>(fminf(fmaxf(v, -127.0f), 127.0f));
}

__device__ __forceinline__ float scale_of(float absmax) {
  return absmax > 0.0f ? __fdiv_rn(absmax, 127.0f) : 1.0f;
}

template <int LOG_N, typename T>
__global__ void __launch_bounds__(kThreads)
fwht_kernel(const T* __restrict__ x, T* __restrict__ out,
            const float* __restrict__ signs, int64_t total, float scale) {
  using L = Layout<LOG_N>;
  __shared__ __align__(16) float tile[L::kExchange ? kTile : 4];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int valid =
      total - start < kTile ? static_cast<int>(total - start) : kTile;
  float v[kPer];
  rotate<LOG_N>(x + start, signs, valid, v, tile);
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = __fmul_rn(v[j], scale);

  T* dst = out + start;
  if constexpr (L::kExchange) {
    // a row lies in the tile whole or not at all
    const int base = exchanged_base<LOG_N>();
    if (base < valid) {
#pragma unroll
      for (int k = 0; k < L::kK; ++k) {
        store_vec<L::kC>(dst + base + k * kWarpSpan, v + k * L::kC);
      }
    }
  } else {
    const int e0 = threadIdx.x * kPer;
    if (e0 + kPer <= valid) {
      store_vec<kPer>(dst + e0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (e0 + j < valid) from_f32(dst + e0 + j, v[j]);
      }
    }
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
fwht_quantize_kernel(const float* __restrict__ x,
                     const float* __restrict__ noise,
                     const float* __restrict__ signs,
                     int8_t* __restrict__ q, float* __restrict__ scales,
                     int64_t total, float scale) {
  using L = Layout<LOG_N>;
  constexpr int N = L::kN;
  __shared__ __align__(16) float tile[L::kExchange ? kTile : 4];
  __shared__ float warp_max[kThreads / 32];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int valid =
      total - start < kTile ? static_cast<int>(total - start) : kTile;
  const int e0 = threadIdx.x * kPer;
  const int base = L::kExchange ? exchanged_base<LOG_N>() : e0;
  const float* nz_src = noise + start;

  // the noise, in the layout the codes leave in; loaded before the
  // rotation so that its bytes are in flight together with x's
  float nz[kPer];
  if constexpr (L::kExchange) {
    if (base < valid) {
#pragma unroll
      for (int k = 0; k < L::kK; ++k) {
        load_vec<L::kC>(nz_src + base + k * kWarpSpan, nz + k * L::kC);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) nz[j] = 0.0f;
    }
  } else if (e0 + kPer <= valid) {
    load_vec<kPer>(nz_src + e0, nz);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      nz[j] = e0 + j < valid ? nz_src[e0 + j] : 0.0f;
    }
  }

  float v[kPer];
  rotate<LOG_N>(x + start, signs, valid, v, tile);
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = __fmul_rn(v[j], scale);

  int c[kPer];
  int8_t* dst = q + start;
  const int64_t row0 = start >> LOG_N;         // tiles hold whole rows
  if constexpr (N < kPer) {
    // the thread holds 16 / n whole rows
#pragma unroll
    for (int r = 0; r < kPer / N; ++r) {
      float m = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(v[r * N + j]));
      const float s = scale_of(m);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        c[r * N + j] = quantize(v[r * N + j], s, nz[r * N + j]);
      }
      if (e0 + r * N < valid) scales[row0 + ((e0 + r * N) >> LOG_N)] = s;
    }
    if (e0 + kPer <= valid) {
      store_codes<kPer>(dst + e0, c);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (e0 + j < valid) dst[e0 + j] = static_cast<int8_t>(c[j]);
      }
    }
  } else {
    // absmax: the thread's 16 values, the row's lanes of the warp, and
    // for n >= 1024 the row's warps through shared memory
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) m = fmaxf(m, fabsf(v[j]));
#pragma unroll
    for (int o = 1; o < L::kLanes && o < 32; o <<= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    }
    if constexpr (L::kExchange) {
      constexpr int kRowWarps = N / kWarpSpan;
      if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
      __syncthreads();
      const int w0 = (threadIdx.x >> 5) & ~(kRowWarps - 1);
      m = warp_max[w0];
#pragma unroll
      for (int w = 1; w < kRowWarps; ++w) m = fmaxf(m, warp_max[w0 + w]);
    }
    const float s = scale_of(m);
#pragma unroll
    for (int j = 0; j < kPer; ++j) c[j] = quantize(v[j], s, nz[j]);
    if (base < valid) {
      if constexpr (L::kExchange) {
#pragma unroll
        for (int k = 0; k < L::kK; ++k) {
          store_codes<L::kC>(dst + base + k * kWarpSpan, c + k * L::kC);
        }
      } else {
        store_codes<kPer>(dst + base, c);
      }
      if (threadIdx.x % L::kLanes == 0) scales[row0 + (base >> LOG_N)] = s;
    }
  }
}

#define FWHT_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

// Blocks for rows x 2^log_n elements, 0 if the shape is not taken.
unsigned blocks_for(long long rows, int log_n) {
  if (rows <= 0 || log_n < 1 || log_n > kLogTile) return 0;
  if (rows > (0x7fffffffLL << (kLogTile - log_n))) return 0;
  return static_cast<unsigned>(((rows << log_n) + kTile - 1) / kTile);
}

template <typename T>
void launch_fwht(const void* x, void* out, const float* signs,
                 long long rows, int log_n, float scale, unsigned blocks,
                 cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int64_t total = static_cast<int64_t>(rows) << log_n;
  switch (log_n) {
#define FWHT_CASE(L)                                                   \
  case L:                                                              \
    fwht_kernel<L, T><<<blocks, kThreads, 0, s>>>(xt, ot, signs, total, \
                                                   scale);             \
    break;
    FWHT_CASES(FWHT_CASE)
#undef FWHT_CASE
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  signs may be null.  Returns the
// cudaError_t of the launch (0 when it was accepted).
extern "C" int fwht_launch(const void* x, void* out, const void* signs,
                           long long rows, int log_n, float scale, int dtype,
                           void* stream) {
  const unsigned blocks = blocks_for(rows, log_n);
  if (blocks == 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(signs);
  if (dtype == 0) {
    launch_fwht<float>(x, out, sg, rows, log_n, scale, blocks, s);
  } else {
    launch_fwht<__nv_bfloat16>(x, out, sg, rows, log_n, scale, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, noise: (rows, n) float32; q: (rows, n) int8; scales: (rows,)
// float32; signs may be null.  Returns the cudaError_t of the launch.
extern "C" int fwht_quantize_launch(const void* x, const void* noise,
                                    const void* signs, void* q, void* scales,
                                    long long rows, int log_n, float scale,
                                    void* stream) {
  const unsigned blocks = blocks_for(rows, log_n);
  if (blocks == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xt = static_cast<const float*>(x);
  const float* nt = static_cast<const float*>(noise);
  const float* sg = static_cast<const float*>(signs);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  const int64_t total = static_cast<int64_t>(rows) << log_n;
  switch (log_n) {
#define FWHT_QUANT_CASE(L)                                              \
  case L:                                                               \
    fwht_quantize_kernel<L><<<blocks, kThreads, 0, s>>>(xt, nt, sg, qt, \
                                                        st, total, scale); \
    break;
    FWHT_CASES(FWHT_QUANT_CASE)
#undef FWHT_QUANT_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
