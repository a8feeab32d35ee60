// SAD cost volume on Hopper: kernel K6, (H, W, 3) f32 pair -> (D, H, W) f32.
//
// Replaces the TPU kernel of stereo_matchin_tpu/kernels/sad_volume.py:
//   K6 sad_volume_f32 <- sad_volume_t_pallas (_sad_kernel)
// The TPU kernel emits a transposed (D, W, H) volume, staged through
// 3-block VMEM windows with 8-aligned sublane groups for the d-shift; the
// port's volume is (D, H, W) and the shift is an index, so none of that
// exists here.
//
//   cost[d,y,x] = (|l0*s - r0*s| + |l1*s - r1*s|) + |l2*s - r2*s|
//                 with r read at (y, max(x - d0 - d, 0)), s = scale
//
// Numerics: built with --fmad=false and without -use_fast_math, so each
// product is rounded before the difference and the channel sum runs in
// the reference's (.x + .y) + .z order -- the operations of
// ops/cost.py sad_cost_volume, which this kernel equals bit for bit.
//
// Bound: memory.  One thread per output element, x fastest: the writes
// are coalesced and the 6 loads per output hit L1/L2 (a row of the pair
// is 2 * 12 * W bytes, shared by all D planes of that row).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void sad_volume_kernel(const float* __restrict__ left,
                                  const float* __restrict__ right,
                                  float* __restrict__ cost, int D, int H,
                                  int W, int d0, float scale) {
  const long long plane = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane * D) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int d = (int)(i / plane);
  const int xr = max(x - d0 - d, 0);
  const float* l = left + ((long long)y * W + x) * 3;
  const float* r = right + ((long long)y * W + xr) * 3;
  const float t0 = fabsf(l[0] * scale - r[0] * scale);
  const float t1 = fabsf(l[1] * scale - r[1] * scale);
  const float t2 = fabsf(l[2] * scale - r[2] * scale);
  cost[i] = (t0 + t1) + t2;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// left, right: (H, W, 3); cost: (D, H, W).  Returns cudaGetLastError().
extern "C" int sad_volume_f32(const float* left, const float* right,
                              float* cost, int D, int H, int W, int d0,
                              float scale, void* stream) {
  const long long n = (long long)D * H * W;
  if (n > 0) {
    sad_volume_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        left, right, cost, D, H, W, d0, scale);
  }
  return (int)cudaGetLastError();
}
