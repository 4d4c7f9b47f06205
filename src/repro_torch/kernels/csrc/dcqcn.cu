// DCQCN rate recurrence over a block of engine steps, every seed and flow
// at once.
//
// Replaces the scan that the JAX engine runs with `lax.scan`
// (src/repro/core/transport/engine_jax.py, `_dcqcn_scan`); the JAX
// package has no Pallas kernel here.  The numpy form is
// src/repro/core/transport/dcqcn.py `rate_trace`.
//
// Per (seed s, flow j) the state is (rate, target, alpha) in float64 and
// good_stages in int32.  A step i is *active* when any flow of seed s has
// a CNP there (any_t[s, i]).  At an active step every flow advances its
// anchor (the last materialized state) over the calm gap of L steps since
// it in closed form (calm_ramp in f64, alpha times (1 - alpha_g)^L,
// good + L), emits that rate cast to f32, and applies the update rule
// with its own mark.  A calm step emits the f32 calm ramp from the
// f32-cast anchor at its index in the gap (rate_trace's gap fill).  The
// trailing gap is materialized into the state handed back, so the next
// block starts from it.
//
// What bounds it on the H100.  Only the active steps are a chain: each
// waits for the state the one before left.  A calm cell is a closed form
// of its gap's anchor and its index, independent of every other calm
// cell, and (1 - alpha_g)^L depends only on the gap, known from any_t
// before the walk.  So the floor is the larger of the bytes (1 B of cnp
// in and 4 B of rates out a cell) and the dependent latency of one
// active step's update times the most active steps of any seed.  What
// the walk reaches is set by its instruction path: a step is a long run
// of dependent instructions (a double fmin/fmax compiles to a compare,
// two selects and a NaN fix-up), and with one warp per scheduler nothing
// hides their latencies.
//
// What the design does about it: three kernels on the stream.
//   1. compact (one block per seed): a block-wide ballot and prefix sum
//      over any_t give the seed's active steps, each row's count of
//      active steps up to it, and (1 - alpha_g)^L of every gap, all pows
//      at once and off the chain (libdevice's double pow, the one
//      PyTorch's CUDA pow calls);
//   2. walk (one thread per (seed, flow), blocks of 128 flows of one
//      seed): over the active steps only, with the gap indices and pows
//      loaded two chunks of 8 ahead and the marks one chunk ahead, so the
//      dependent loads leave the chain, and the gap's ramp branched off
//      the chain where there is no gap.  It writes each active step's
//      rate, and after each active step that opens a calm gap the anchor
//      as the calm ramp reads it (f32 rate, f32 target, good), into the
//      workspace;
//   3. fill (across the card): every calm cell gets the f32 ramp from
//      its gap's anchor (the input state before the first active step),
//      four flows a thread with 16-byte stores where n % 4 == 0.
// Every float operation is an `__d*_rn` / `__f*_rn` intrinsic (no FMA
// contraction), so the kernel equals the plain version
// (kernels/ref.py `dcqcn_scan`) bit for bit.  The plain version halves
// alpha with a division by 2 and the walk with a multiply by 0.5: both
// are the correctly rounded a / 2.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCompactThreads = 1024;  // one block per seed
constexpr int kCompactPer = 4;         // steps a thread takes per pass
constexpr int kWalkThreads = 128;
constexpr int kChunk = 8;
constexpr int kFillThreads = 256;
constexpr int kFillPerBlock = 1024;    // cells (or 4-flow slots) a block

struct Params {
  double alpha_g, decay, rate_floor, ai, hi, min_rate;
  float ai32, hi32;
  int hyper_after;
};

// The workspace, carved from one allocation of dcqcn_scan_workspace_bytes
struct Work {
  int* act_idx;     // [S][tb + 1]: the active steps, then tb
  int* rank;        // [S][tb]: active steps in [0, i]
  int* n_act;       // [S]
  double* act_pow;  // [S][tb + 1]: (1 - alpha_g)^L of the gap before each
                    // active step (1 when L = 0), then the trailing gap's
  float* anc_r;     // [S][tb][n]: the state after active step k, as the
  float* anc_t;     //   calm ramp reads it (written where a gap follows)
  int* anc_g;
};

// calm_ramp in float64: the rate after i calm updates of (r, t, g)
__device__ __forceinline__ double ramp64(double r, double t, int g, int i,
                                         const Params& p) {
  const int k = min(max(p.hyper_after - g, 0), i);
  const double r_add =
      k > 0 ? fmin(t, __dadd_rn(r, __dmul_rn(p.ai, static_cast<double>(k))))
            : r;
  return i > k ? fmin(1.0, __dadd_rn(r_add, __dmul_rn(
                                                p.hi, static_cast<double>(
                                                          i - k))))
               : r_add;
}

// calm_ramp in float32, from the f32-cast anchor
__device__ __forceinline__ float ramp32(float r, float t, int g, int i,
                                        const Params& p) {
  const int k = min(max(p.hyper_after - g, 0), i);
  const float r_add =
      k > 0 ? fminf(t, __fadd_rn(r, __fmul_rn(p.ai32, static_cast<float>(k))))
            : r;
  return i > k ? fminf(1.0f, __fadd_rn(r_add, __fmul_rn(
                                                  p.hi32, static_cast<float>(
                                                              i - k))))
               : r_add;
}

// inclusive sum over a warp
__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kCompactThreads)
dcqcn_compact_kernel(const uint8_t* __restrict__ any_t, int tb,
                     double decay, Work w) {
  const int64_t s = blockIdx.x;
  const uint8_t* act = any_t + s * tb;
  int* idx = w.act_idx + s * (tb + 1);
  int* rank = w.rank + s * tb;
  double* pw = w.act_pow + s * (tb + 1);
  __shared__ int warp_sum[kCompactThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;  // active steps before this pass
  for (int i0 = 0; i0 < tb; i0 += kCompactThreads * kCompactPer) {
    const int i1 = i0 + threadIdx.x * kCompactPer;
    int f[kCompactPer];
    int c = 0;
#pragma unroll
    for (int u = 0; u < kCompactPer; ++u) {
      f[u] = (i1 + u < tb && act[i1 + u]) ? 1 : 0;
      c += f[u];
    }
    const int x = warp_inclusive(c, lane);
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sum[lane] = warp_inclusive(warp_sum[lane], lane);
    __syncthreads();
    int run = base + (warp > 0 ? warp_sum[warp - 1] : 0) + x - c;
#pragma unroll
    for (int u = 0; u < kCompactPer; ++u) {
      if (i1 + u >= tb) break;
      run += f[u];
      rank[i1 + u] = run;
      if (f[u]) idx[run - 1] = i1 + u;
    }
    base += warp_sum[kCompactThreads / 32 - 1];
    __syncthreads();  // warp_sum is rewritten by the next pass
  }
  if (threadIdx.x == 0) {
    w.n_act[s] = base;
    idx[base] = tb;
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= base; k += kCompactThreads) {
    const int L = idx[k] - (k > 0 ? idx[k - 1] : -1) - 1;
    pw[k] = L > 0 ? pow(decay, static_cast<double>(L)) : 1.0;
  }
}

__global__ void __launch_bounds__(kWalkThreads)
dcqcn_walk_kernel(const uint8_t* __restrict__ cnp,
                  const double* __restrict__ rate_in,
                  const double* __restrict__ target_in,
                  const double* __restrict__ alpha_in,
                  const int* __restrict__ good_in, float* __restrict__ rates,
                  double* __restrict__ rate_out,
                  double* __restrict__ target_out,
                  double* __restrict__ alpha_out, int* __restrict__ good_out,
                  int tb, int64_t n, Params p, Work w) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWalkThreads +
                    threadIdx.x;
  const int64_t s = blockIdx.y;
  if (j >= n) return;
  const int64_t sj = s * n + j;
  double r = rate_in[sj], t = target_in[sj], a = alpha_in[sj];
  int g = good_in[sj];
  const int K = w.n_act[s];
  const int* idx = w.act_idx + s * (tb + 1);
  const double* pw = w.act_pow + s * (tb + 1);
  const int64_t col = s * tb * n + j;
  const uint8_t* c_col = cnp + col;
  float* out_col = rates + col;
  float* anc_r = w.anc_r + col;
  float* anc_t = w.anc_t + col;
  int* anc_g = w.anc_g + col;

  // chunk k0: the active steps k0 .. k0 + 7 (tb past the end, which also
  // reads idx[K] = tb: the step after the last), their gaps' pows, and
  // the flow's marks
  int i_cur[kChunk], i_nxt[kChunk];
  double p_cur[kChunk], p_nxt[kChunk];
  uint8_t m_cur[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    i_cur[u] = u <= K ? idx[u] : tb;
    p_cur[u] = u < K ? pw[u] : 1.0;
    i_nxt[u] = kChunk + u <= K ? idx[kChunk + u] : tb;
    p_nxt[u] = kChunk + u < K ? pw[kChunk + u] : 1.0;
  }
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    m_cur[u] = u < K ? c_col[static_cast<int64_t>(i_cur[u]) * n] : 0;

  int prev = -1;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    // two chunks ahead: indices and pows; one chunk ahead: the marks
    int i_far[kChunk];
    double p_far[kChunk];
    uint8_t m_nxt[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = k0 + 2 * kChunk + u;
      i_far[u] = k <= K ? idx[k] : tb;
      p_far[u] = k < K ? pw[k] : 1.0;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      m_nxt[u] = k0 + kChunk + u < K
                     ? c_col[static_cast<int64_t>(i_nxt[u]) * n]
                     : 0;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = k0 + u;
      if (k >= K) break;
      const int i = i_cur[u];
      const int L = i - prev - 1;
      // materialize the anchor over the gap (the identity when L == 0:
      // most active steps follow another, and L is the seed's, the same
      // in the whole block, so this branch keeps the ramp off the chain
      // there), emit, then step_math
      double r64 = r, a_adv = a;
      int g_adv = g;
      if (L > 0) {
        r64 = ramp64(r, t, g, L, p);
        a_adv = __dmul_rn(a, p_cur[u]);
        g_adv = g + L;
      }
      out_col[static_cast<int64_t>(i) * n] = __double2float_rn(r64);
      const bool mark = m_cur[u] != 0;
      const double decayed = __dmul_rn(p.decay, a_adv);
      const double a_new = mark ? __dadd_rn(decayed, p.alpha_g) : decayed;
      const double t_new = mark ? r64 : t;
      const double r_cut = fmax(
          __dmul_rn(r64, __dsub_rn(1.0, __dmul_rn(a_new, 0.5))),
          p.rate_floor);
      const int g_new = mark ? 0 : g_adv + 1;
      const double add = fmin(t_new, __dadd_rn(r64, p.ai));
      const double hyper = fmin(1.0, __dadd_rn(r64, p.hi));
      const double r_up = g_new > p.hyper_after ? hyper : add;
      r = fmin(fmax(mark ? r_cut : r_up, p.min_rate), 1.0);
      t = fmin(fmax(t_new, p.min_rate), 1.0);
      a = a_new;
      g = g_new;
      const int next = u + 1 < kChunk ? i_cur[u + 1] : i_nxt[0];
      if (next > i + 1) {  // a calm gap follows: leave its anchor
        const int64_t o = static_cast<int64_t>(k) * n;
        anc_r[o] = __double2float_rn(r);
        anc_t[o] = __double2float_rn(t);
        anc_g[o] = g;
      }
      prev = i;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      i_cur[u] = i_nxt[u];
      p_cur[u] = p_nxt[u];
      m_cur[u] = m_nxt[u];
      i_nxt[u] = i_far[u];
      p_nxt[u] = p_far[u];
    }
  }
  // the trailing gap, materialized: the next block starts with L = 0
  const int L = tb - 1 - prev;
  rate_out[sj] = ramp64(r, t, g, L, p);
  target_out[sj] = t;
  alpha_out[sj] = L > 0 ? __dmul_rn(a, pw[K]) : a;
  good_out[sj] = g + L;
}

// One calm cell group a thread: kVec, four flows j0 .. j0 + 3 (n % 4 ==
// 0, 16-byte loads and stores); else one flow j0.
template <bool kVec>
__global__ void __launch_bounds__(kFillThreads)
dcqcn_fill_kernel(const uint8_t* __restrict__ any_t,
                  const double* __restrict__ rate_in,
                  const double* __restrict__ target_in,
                  const int* __restrict__ good_in, float* __restrict__ rates,
                  int rows, int tb, int n, int slots, int rows_per_block,
                  Params p, Work w) {
  constexpr int kW = kVec ? 4 : 1;
  const int row0 = blockIdx.x * rows_per_block;
  for (int e = threadIdx.x; e < rows_per_block * slots; e += kFillThreads) {
    const int rl = e / slots;
    const int row = row0 + rl;
    if (row >= rows) break;
    if (any_t[row]) continue;  // the walk wrote the active rows
    const int j0 = (e - rl * slots) * kW;
    const int s = row / tb;
    const int c = w.rank[row];
    float ar[kW], at[kW];
    int ag[kW];
    int L;
    if (c == 0) {  // before the seed's first active step: the input state
      L = row - s * tb;
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const int64_t sj = static_cast<int64_t>(s) * n + j0 + u;
        ar[u] = __double2float_rn(rate_in[sj]);
        at[u] = __double2float_rn(target_in[sj]);
        ag[u] = good_in[sj];
      }
    } else {
      const int k = c - 1;
      L = row - s * tb - 1 -
          w.act_idx[static_cast<int64_t>(s) * (tb + 1) + k];
      const int64_t o = (static_cast<int64_t>(s) * tb + k) * n + j0;
      if constexpr (kVec) {
        const float4 r4 = *reinterpret_cast<const float4*>(w.anc_r + o);
        const float4 t4 = *reinterpret_cast<const float4*>(w.anc_t + o);
        const int4 g4 = *reinterpret_cast<const int4*>(w.anc_g + o);
        ar[0] = r4.x, ar[1] = r4.y, ar[2] = r4.z, ar[3] = r4.w;
        at[0] = t4.x, at[1] = t4.y, at[2] = t4.z, at[3] = t4.w;
        ag[0] = g4.x, ag[1] = g4.y, ag[2] = g4.z, ag[3] = g4.w;
      } else {
        ar[0] = w.anc_r[o];
        at[0] = w.anc_t[o];
        ag[0] = w.anc_g[o];
      }
    }
    float v[kW];
#pragma unroll
    for (int u = 0; u < kW; ++u) v[u] = ramp32(ar[u], at[u], ag[u], L, p);
    float* out = rates + static_cast<int64_t>(row) * n + j0;
    if constexpr (kVec)
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    else
      out[0] = v[0];
  }
}

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The workspace layout for (S, tb, n); returns its size in bytes and,
// given a base pointer, the carved pointers.
size_t carve(long long S, long long tb, long long n, char* base, Work* w) {
  const size_t sizes[7] = {
      static_cast<size_t>(S * (tb + 1)) * sizeof(int),
      static_cast<size_t>(S * tb) * sizeof(int),
      static_cast<size_t>(S) * sizeof(int),
      static_cast<size_t>(S * (tb + 1)) * sizeof(double),
      static_cast<size_t>(S * tb * n) * sizeof(float),
      static_cast<size_t>(S * tb * n) * sizeof(float),
      static_cast<size_t>(S * tb * n) * sizeof(int)};
  char* ptrs[7];
  size_t off = 0;
  for (int q = 0; q < 7; ++q) {
    ptrs[q] = base + off;
    off += align256(sizes[q]);
  }
  if (w != nullptr) {
    w->act_idx = reinterpret_cast<int*>(ptrs[0]);
    w->rank = reinterpret_cast<int*>(ptrs[1]);
    w->n_act = reinterpret_cast<int*>(ptrs[2]);
    w->act_pow = reinterpret_cast<double*>(ptrs[3]);
    w->anc_r = reinterpret_cast<float*>(ptrs[4]);
    w->anc_t = reinterpret_cast<float*>(ptrs[5]);
    w->anc_g = reinterpret_cast<int*>(ptrs[6]);
  }
  return off;
}

}  // namespace

// Bytes of the workspace dcqcn_scan_launch needs for (S, tb, n).
extern "C" long long dcqcn_scan_workspace_bytes(long long S, long long tb,
                                                long long n) {
  return static_cast<long long>(carve(S, tb, n, nullptr, nullptr));
}

// cnp uint8/bool (S, tb, n), any_t uint8/bool (S, tb), the state (S, n):
// rate/target/alpha float64 and good int32, read from *_in and written to
// *_out; rates float32 (S, tb, n); workspace of
// dcqcn_scan_workspace_bytes(S, tb, n) bytes, 256-byte aligned.  Returns
// the cudaError_t of the launches (0 when all were accepted).
extern "C" int dcqcn_scan_launch(
    const void* cnp, const void* any_t, const void* rate_in,
    const void* target_in, const void* alpha_in, const void* good_in,
    void* rates, void* rate_out, void* target_out, void* alpha_out,
    void* good_out, long long S, long long tb, long long n, double alpha_g,
    double rate_floor, double additive_increase, double hyper_increase,
    double min_rate, int hyper_after, void* workspace, void* stream) {
  // int32 step and row indices: S * (tb + 1) plus a compaction pass fit
  if (S <= 0 || n <= 0 || tb < 0 || S > 65535 || n > INT_MAX ||
      S * (tb + 1) > INT_MAX - kCompactThreads * kCompactPer ||
      workspace == nullptr)
    return cudaErrorInvalidValue;
  Params p;
  p.alpha_g = alpha_g;
  p.decay = 1.0 - alpha_g;
  p.rate_floor = rate_floor;
  p.ai = additive_increase;
  p.hi = hyper_increase;
  p.min_rate = min_rate;
  p.ai32 = static_cast<float>(additive_increase);
  p.hi32 = static_cast<float>(hyper_increase);
  p.hyper_after = hyper_after;
  Work w;
  carve(S, tb, n, static_cast<char*>(workspace), &w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(any_t);
  const double* r_in = static_cast<const double*>(rate_in);
  const double* t_in = static_cast<const double*>(target_in);
  const int* g_in = static_cast<const int*>(good_in);
  float* out = static_cast<float*>(rates);

  dcqcn_compact_kernel<<<static_cast<unsigned>(S), kCompactThreads, 0, st>>>(
      act, static_cast<int>(tb), p.decay, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 walk_grid(static_cast<unsigned>((n + kWalkThreads - 1) /
                                             kWalkThreads),
                       static_cast<unsigned>(S));
  dcqcn_walk_kernel<<<walk_grid, kWalkThreads, 0, st>>>(
      static_cast<const uint8_t*>(cnp), r_in, t_in,
      static_cast<const double*>(alpha_in), g_in, out,
      static_cast<double*>(rate_out), static_cast<double*>(target_out),
      static_cast<double*>(alpha_out), static_cast<int*>(good_out),
      static_cast<int>(tb), n, p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = static_cast<int>(S * tb);
  if (rows == 0) return 0;
  const bool vec = n % 4 == 0;
  const int slots = static_cast<int>(vec ? n / 4 : n);
  const int rows_per_block = slots >= kFillPerBlock ? 1
                                                    : kFillPerBlock / slots;
  const unsigned blocks =
      static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  if (vec)
    dcqcn_fill_kernel<true><<<blocks, kFillThreads, 0, st>>>(
        act, r_in, t_in, g_in, out, rows, static_cast<int>(tb),
        static_cast<int>(n), slots, rows_per_block, p, w);
  else
    dcqcn_fill_kernel<false><<<blocks, kFillThreads, 0, st>>>(
        act, r_in, t_in, g_in, out, rows, static_cast<int>(tb),
        static_cast<int>(n), slots, rows_per_block, p, w);
  return static_cast<int>(cudaGetLastError());
}
