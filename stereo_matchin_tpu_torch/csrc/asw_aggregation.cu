// ASW cost aggregation on Hopper: kernels K1 (denominator) and K2 (one
// vertical or horizontal pass), in the port's (D, H, W) / (T, H, W) f32
// layouts.
//
// Replaces the TPU kernels of stereo_matchin_tpu/kernels/asw_aggregation_dres.py:
//   K1 asw_den_f32  <- asw_den_dres   (_den_kernel)
//   K2 asw_pass_f32 <- asw_vpass_dres (_v_kernel), axis 1
//                      asw_hpass_dres (_h_kernel), axis 2
//   K2 asw_pass_win_f32 <- asw_vpass_dres_win (_v_kernel over caller-supplied
//                          margin rows), the wavefront band driver's pass
// and, through d0 (a disparity chunk's offset), the (D, H, W) grid kernels
// of kernels/asw_aggregation.py (asw_den_pallas, asw_vpass_pallas,
// asw_hpass_pallas) on the d-chunked path of models/asw.py.
//
//   K1: den[d,y,x] = eps + sum_t wl[t,y,x] * wr[t,y,max(x-d0-d,0)]
//   K2: num = eps; num += (wl[t,y,x] * wr[t,y,max(x-d0-d,0)]) * cost[d, nb_t]
//       out = num / den          nb_t: y+t-R (axis 1) or x+t-R (axis 2), clamped
//       windowed: cost is (D, H+2R, W) of real rows, nb_t = row y+t, no clamp
//
// Numerics: built with --fmad=false and without -use_fast_math, so every
// product and sum is rounded once, in t order, and the divide is IEEE --
// the same operations as ops/aggregation.py asw_den_plain / asw_pass_plain /
// asw_pass_win_plain, which these kernels equal bit for bit.  Indices into a
// volume are 64-bit: a Middlebury-2014 volume holds 1.6e9 elements.
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

// MODE 1: vertical taps, rows clamped; 2: horizontal taps, columns clamped;
// 3: vertical taps over a cost window of H + T - 1 real rows, no clamp.
template <int MODE>
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
  const long long rows = MODE == 3 ? H + T - 1 : H;  // rows of a cost plane
  const float* c = cost + (long long)d * rows * W;
  float num = eps;
  for (int t = 0; t < T; ++t) {
    const float ww = l[t * plane] * r[t * plane];
    int ny = y, nx = x;
    if (MODE == 1) {
      ny = min(max(y + t - R, 0), H - 1);
    } else if (MODE == 2) {
      nx = min(max(x + t - R, 0), W - 1);
    } else {
      ny = y + t;
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

// cost_win: (D, H_out + T - 1, W) real rows; wl, wr: (T, H_out, W); den, out:
// (D, H_out, W).  out row y reads cost_win rows y .. y + T - 1.  Returns
// cudaGetLastError().
extern "C" int asw_pass_win_f32(const float* cost_win, const float* wl,
                                const float* wr, const float* den, float* out,
                                int T, int H_out, int W, int D, int d0,
                                float eps, void* stream) {
  const long long n = (long long)D * H_out * W;
  if (n > 0) {
    asw_pass_kernel<3><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        cost_win, wl, wr, den, out, T, H_out, W, D, d0, eps);
  }
  return (int)cudaGetLastError();
}
