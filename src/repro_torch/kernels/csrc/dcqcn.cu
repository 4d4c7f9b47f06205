// DCQCN rate recurrence over a block of engine steps, every seed and flow
// at once.
//
// Replaces the scan that the JAX engine runs with `lax.scan`
// (src/repro/core/transport/engine_jax.py, `_dcqcn_scan`); the JAX
// package has no Pallas kernel here.  The numpy form is
// src/repro/core/transport/dcqcn.py `rate_trace`.
//
// Per (seed s, flow j) the state is (rate, target, alpha) in float64 and
// good_stages in int32, plus the calm-gap length L since the last
// materialized state (the anchor).  At step i:
//   - if any flow of seed s has a CNP at i (any_t[s, i]): advance the
//     anchor over the gap in closed form (calm_ramp in f64, alpha times
//     (1 - alpha_g)^L, good + L), emit that rate cast to f32, apply the
//     update rule with this flow's own CNP mark, and reset L.  The reset
//     keys on any_t, not on the flow's own mark: rate_trace materializes
//     every flow at every active step, and an additive ramp stepped one
//     step at a time does not round like its closed form;
//   - else emit the f32 calm ramp from the f32-cast anchor at gap index
//     L (rate_trace's gap fill), and bump L.
// At the end of the block the trailing gap is materialized, so the state
// handed back has L = 0 and the next block starts from it.
//
// What bounds it on the H100: the chain of dependent steps.  Each thread
// walks tb steps in order; there are only S * n threads (128 to 4096 on
// the engine's paths), far from filling 132 SMs, and every step waits
// for the one before.  Bytes (1 B of cnp in, 4 B of rates out per cell)
// are a small floor beside that.
//
// What the design does about it: one thread per (seed, flow), the state
// in registers, a block per (seed, 128 flows) so any_t[s, i] is one
// broadcast load and the branch is uniform in the block.  Loads of a
// chunk of 8 steps' marks are issued together ahead of their compute, so
// one memory latency covers 8 steps; cnp reads and rates writes are
// coalesced across a warp at each step.  Every float operation is an
// `__d*_rn` / `__f*_rn` intrinsic (no FMA contraction), and pow is the
// same libdevice pow PyTorch's CUDA pow calls, so the kernel equals the
// plain version (kernels/ref.py `dcqcn_scan`) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;

struct Params {
  double alpha_g, decay, rate_floor, ai, hi, min_rate;
  float ai32, hi32;
  int hyper_after;
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

__device__ __forceinline__ double decay_pow(double a, int L, const Params& p) {
  // a * (1 - alpha_g)^L; L = 0 leaves a as it is (a * 1.0)
  return L > 0 ? __dmul_rn(a, pow(p.decay, static_cast<double>(L))) : a;
}

__global__ void __launch_bounds__(kThreads)
dcqcn_scan_kernel(const uint8_t* __restrict__ cnp,
                  const uint8_t* __restrict__ any_t,
                  const double* __restrict__ rate_in,
                  const double* __restrict__ target_in,
                  const double* __restrict__ alpha_in,
                  const int* __restrict__ good_in,
                  float* __restrict__ rates, double* __restrict__ rate_out,
                  double* __restrict__ target_out,
                  double* __restrict__ alpha_out, int* __restrict__ good_out,
                  int64_t tb, int64_t n, Params p) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t s = blockIdx.y;
  if (j >= n) return;
  const int64_t sj = s * n + j;
  double r = rate_in[sj], t = target_in[sj], a = alpha_in[sj];
  int g = good_in[sj];
  int L = 0;
  const uint8_t* c_col = cnp + s * tb * n + j;
  const uint8_t* act_row = any_t + s * tb;
  float* out_col = rates + s * tb * n + j;

  for (int64_t i0 = 0; i0 < tb; i0 += kChunk) {
    uint8_t c[kChunk], act[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int64_t i = i0 + u;
      c[u] = i < tb ? c_col[i * n] : 0;
      act[u] = i < tb ? act_row[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int64_t i = i0 + u;
      if (i >= tb) break;
      if (!act[u]) {
        out_col[i * n] = ramp32(__double2float_rn(r), __double2float_rn(t),
                                g, L, p);
        ++L;
        continue;
      }
      // materialize the anchor over the gap, emit, then step_math
      const double r64 = ramp64(r, t, g, L, p);
      out_col[i * n] = __double2float_rn(r64);
      const double a_adv = decay_pow(a, L, p);
      const int g_adv = g + L;
      const bool mark = c[u] != 0;
      const double decayed = __dmul_rn(p.decay, a_adv);
      const double a_new = mark ? __dadd_rn(decayed, p.alpha_g) : decayed;
      const double t_new = mark ? r64 : t;
      const double r_cut = fmax(
          __dmul_rn(r64, __dsub_rn(1.0, __ddiv_rn(a_new, 2.0))),
          p.rate_floor);
      const int g_new = mark ? 0 : g_adv + 1;
      const double add = fmin(t_new, __dadd_rn(r64, p.ai));
      const double hyper = fmin(1.0, __dadd_rn(r64, p.hi));
      const double r_up = g_new > p.hyper_after ? hyper : add;
      r = fmin(fmax(mark ? r_cut : r_up, p.min_rate), 1.0);
      t = fmin(fmax(t_new, p.min_rate), 1.0);
      a = a_new;
      g = g_new;
      L = 0;
    }
  }
  // the trailing gap, materialized: the next block starts with L = 0
  rate_out[sj] = ramp64(r, t, g, L, p);
  target_out[sj] = t;
  alpha_out[sj] = decay_pow(a, L, p);
  good_out[sj] = g + L;
}

}  // namespace

// cnp uint8/bool (S, tb, n), any_t uint8/bool (S, tb), the state (S, n):
// rate/target/alpha float64 and good int32, read from *_in and written to
// *_out; rates float32 (S, tb, n).  Returns the cudaError_t of the launch
// (0 when it was accepted).
extern "C" int dcqcn_scan_launch(
    const void* cnp, const void* any_t, const void* rate_in,
    const void* target_in, const void* alpha_in, const void* good_in,
    void* rates, void* rate_out, void* target_out, void* alpha_out,
    void* good_out, long long S, long long tb, long long n, double alpha_g,
    double rate_floor, double additive_increase, double hyper_increase,
    double min_rate, int hyper_after, void* stream) {
  if (S <= 0 || n <= 0 || tb < 0 || S > 65535) return cudaErrorInvalidValue;
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
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(S));
  dcqcn_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cnp), static_cast<const uint8_t*>(any_t),
      static_cast<const double*>(rate_in),
      static_cast<const double*>(target_in),
      static_cast<const double*>(alpha_in),
      static_cast<const int*>(good_in), static_cast<float*>(rates),
      static_cast<double*>(rate_out), static_cast<double*>(target_out),
      static_cast<double*>(alpha_out), static_cast<int*>(good_out), tb, n, p);
  return static_cast<int>(cudaGetLastError());
}
