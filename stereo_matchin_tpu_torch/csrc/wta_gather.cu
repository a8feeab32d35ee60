// Winner-take-all on Hopper: kernels K3 (reference-view two-min) and K4
// (target-view epipolar two-min), on the (D, H, W) f32 cost volume.
//
// Replaces the TPU kernels of stereo_matchin_tpu/kernels/wta_gather.py:
//   K3 two_min_f32  <- two_min_pallas  (_two_min_kernel)
//   K4 wta_diag_f32 <- wta_diag_pallas (_diag_wta_kernel)
// The TPU version of K4 reads a diagonally sheared (H, D, W+D-1) copy of the
// volume through one-hot matmuls split three ways in bf16; here each thread
// reads its diagonal straight from the volume, so no shear, pad or split
// exists.
//
// K3, per pixel, ascending d:  v = cost[d] (+ sc * |ct - d|); strict '<'
//   keeps the lowest d on ties; if no v < big: c1 = c2 = big, d1 = 0.
// K4, per pixel, b ascending over [max(1, d1-x), min(d1, D-1)]:
//   v = cost[b, y, clip(x-d1+b)] (+ sc * |ct - (d1-b)|), kept if v < big;
//   '<=' take keeps the largest b on ties; if nothing is kept:
//   c1 = c2 = big, b = d1.  Also base = cost[b0, y, clip(x-d1+b0)] with
//   b0 = max(d1-x, 0), the plane the clamped scan tail revisits.
//
// Numerics: built with --fmad=false and without -use_fast_math, so
// cost + sc * |ct - i| is two roundings in the order of
// ops/wta_fast.py _two_min_plain / _diag_two_min_plain, which these kernels
// equal bit for bit.
//
// Bound: memory.  One thread per pixel walks the disparity planes; K3 reads
// the volume once, coalesced along x.  K4 reads at most d1 planes per pixel
// along a diagonal, so neighbouring threads read neighbouring columns of a
// plane when their d1 agree.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void two_min_kernel(const float* __restrict__ cost,
                               const float* __restrict__ sc,
                               const float* __restrict__ ct,
                               float* __restrict__ c1_out,
                               float* __restrict__ c2_out,
                               int* __restrict__ d1_out, int D, int HW,
                               float big) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const bool pen = sc != nullptr;
  const float s = pen ? sc[p] : 0.0f;
  const float center = pen ? ct[p] : 0.0f;
  float c1 = INFINITY, c2 = INFINITY;
  int best = 0;
  for (int d = 0; d < D; ++d) {
    float v = cost[(long long)d * HW + p];
    if (pen) v = v + s * fabsf(center - (float)d);
    if (v < c1) {
      c2 = c1;
      c1 = v;
      best = d;
    } else if (v < c2) {
      c2 = v;
    }
  }
  const bool any = c1 < big;
  c1_out[p] = fminf(c1, big);
  c2_out[p] = any ? fminf(c2, big) : big;
  d1_out[p] = any ? best : 0;
}

__global__ void wta_diag_kernel(const float* __restrict__ cost,
                                const int* __restrict__ d1,
                                const float* __restrict__ sc,
                                const float* __restrict__ ct,
                                float* __restrict__ c1_out,
                                float* __restrict__ c2_out,
                                int* __restrict__ b_out,
                                float* __restrict__ base_out, int D, int H,
                                int W, float big) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const long long HW = (long long)H * W;
  const int x = p % W;
  const float* row = cost + (long long)(p / W) * W;
  const int dd = d1[p];
  const bool pen = sc != nullptr;
  const float s = pen ? sc[p] : 0.0f;
  const float center = pen ? ct[p] : 0.0f;
  const int lo = max(1, dd - x);
  const int hi = min(dd, D - 1);
  float c1 = INFINITY, c2 = INFINITY;
  int bw = 0;
  for (int b = lo; b <= hi; ++b) {
    const int col = min(max(x - dd + b, 0), W - 1);
    float v = row[b * HW + col];
    if (pen) v = v + s * fabsf(center - (float)(dd - b));
    if (!(v < big)) continue;
    if (v <= c1) {
      c2 = c1;
      c1 = v;
      bw = b;
    } else if (v < c2) {
      c2 = v;
    }
  }
  const bool any = c1 < big;
  c1_out[p] = fminf(c1, big);
  c2_out[p] = any ? fminf(c2, big) : big;
  b_out[p] = any ? bw : dd;
  // d1 lies in [0, D-1] on every caller's path; the clamp only keeps a bad
  // d1 from reading outside the volume.
  const int b0 = min(max(dd - x, 0), D - 1);
  base_out[p] = row[b0 * HW + min(max(x - dd + b0, 0), W - 1)];
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// cost: (D, H, W); sc, ct: (H, W) or both null (no penalty);
// c1, c2: (H, W) f32; d1: (H, W) int32.  Returns cudaGetLastError().
extern "C" int two_min_f32(const float* cost, const float* sc, const float* ct,
                           float* c1, float* c2, int* d1, int D, int H, int W,
                           float big, void* stream) {
  const long long n = (long long)H * W;
  if (n > 0) {
    two_min_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        cost, sc, ct, c1, c2, d1, D, H * W, big);
  }
  return (int)cudaGetLastError();
}

// cost: (D, H, W); d1: (H, W) int32 in [0, D-1]; sc, ct: (H, W) or null;
// outputs (H, W): c1, c2, base f32 and b int32.  Returns cudaGetLastError().
extern "C" int wta_diag_f32(const float* cost, const int* d1, const float* sc,
                            const float* ct, float* c1, float* c2, int* b,
                            float* base, int D, int H, int W, float big,
                            void* stream) {
  const long long n = (long long)H * W;
  if (n > 0) {
    wta_diag_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        cost, d1, sc, ct, c1, c2, b, base, D, H, W, big);
  }
  return (int)cudaGetLastError();
}
