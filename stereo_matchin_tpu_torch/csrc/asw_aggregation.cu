// ASW cost aggregation on Hopper: kernels K1 (denominator) and K2 (one
// vertical or horizontal pass), in the port's (D, H, W) / (T, H, W) f32
// layouts.
//
// Replaces the TPU kernels of stereo_matchin_tpu/kernels/asw_aggregation_dres.py:
//   K1 asw_den_f32  <- asw_den_dres   (_den_kernel)
//   K2 asw_pass_f32 <- asw_vpass_dres (_v_kernel), axis 1
//                      asw_hpass_dres (_h_kernel), axis 2
// and, through d0, covers the (D, H, W) grid kernels of
// kernels/asw_aggregation.py (asw_den_pallas, asw_vpass_pallas,
// asw_hpass_pallas) once their callers are ported.
//
//   K1: den[d,y,x] = eps + sum_t wl[t,y,x] * wr[t,y,max(x-d0-d,0)]
//   K2: num = eps; num += (wl[t,y,x] * wr[t,y,max(x-d0-d,0)]) * cost[d, nb_t]
//       out = num / den          nb_t: y+t-R (axis 1) or x+t-R (axis 2), clamped
//
// Numerics: built with --fmad=false and without -use_fast_math, so every
// product and sum is rounded once, in t order, and the divide is IEEE --
// the same operations as ops/aggregation.py asw_den_plain / asw_pass_plain,
// which these kernels equal bit for bit.
//
// Bound: memory.  One thread per output element, x fastest so that every
// tap's loads are coalesced.  Each output reads 2T weights and T costs, but
// neighbouring threads share them, so DRAM traffic is about one read of the
// cost, den and weight strips and one write of the output per pass; the rest
// hits L1/L2.  Tiling the taps through shared memory is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void asw_den_kernel(const float* __restrict__ wl,
                               const float* __restrict__ wr,
                               float* __restrict__ den, int T, int H, int W,
                               int D, int d0, float eps) {
  const long long plane = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane * D) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int d = (int)(i / plane);
  const int xr = max(x - d0 - d, 0);
  const float* l = wl + (long long)y * W + x;
  const float* r = wr + (long long)y * W + xr;
  float acc = eps;
  for (int t = 0; t < T; ++t) {
    acc = acc + l[t * plane] * r[t * plane];
  }
  den[i] = acc;
}

template <int AXIS>
__global__ void asw_pass_kernel(const float* __restrict__ cost,
                                const float* __restrict__ wl,
                                const float* __restrict__ wr,
                                const float* __restrict__ den,
                                float* __restrict__ out, int T, int H, int W,
                                int D, int d0, float eps) {
  const long long plane = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane * D) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int d = (int)(i / plane);
  const int R = (T - 1) / 2;
  const int xr = max(x - d0 - d, 0);
  const float* l = wl + (long long)y * W + x;
  const float* r = wr + (long long)y * W + xr;
  const float* c = cost + (long long)d * plane;
  float num = eps;
  for (int t = 0; t < T; ++t) {
    const float ww = l[t * plane] * r[t * plane];
    int ny = y, nx = x;
    if (AXIS == 1) {
      ny = min(max(y + t - R, 0), H - 1);
    } else {
      nx = min(max(x + t - R, 0), W - 1);
    }
    num = num + ww * c[(long long)ny * W + nx];
  }
  out[i] = num / den[i];
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// wl, wr: (T, H, W); den: (D, H, W).  Returns cudaGetLastError().
extern "C" int asw_den_f32(const float* wl, const float* wr, float* den, int T,
                           int H, int W, int D, int d0, float eps,
                           void* stream) {
  const long long n = (long long)D * H * W;
  if (n > 0) {
    asw_den_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        wl, wr, den, T, H, W, D, d0, eps);
  }
  return (int)cudaGetLastError();
}

// cost, den, out: (D, H, W); wl, wr: (T, H, W); axis 1 = vertical taps,
// 2 = horizontal taps.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for any other axis.
extern "C" int asw_pass_f32(const float* cost, const float* wl,
                            const float* wr, const float* den, float* out,
                            int T, int H, int W, int D, int d0, float eps,
                            int axis, void* stream) {
  const long long n = (long long)D * H * W;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (axis == 1) {
      asw_pass_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(
          cost, wl, wr, den, out, T, H, W, D, d0, eps);
    } else {
      asw_pass_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(
          cost, wl, wr, den, out, T, H, W, D, d0, eps);
    }
  }
  return (int)cudaGetLastError();
}
