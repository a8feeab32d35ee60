// 3x3 median on Hopper: kernel K12, per channel, clamp-to-edge reads.
//
// Replaces no pallas_call: it is the port's counterpart of the XLA fusion
// of stereo_matchin_tpu/ops/median.py median3x3 (:27), the 19-exchange
// selection network over the nine edge-clamped taps, which the JAX package
// runs inside its jitted frames (the ASW median and the cross method's
// three medians).  The plain version is ops/median.py median3x3_plain.
//
// The image is (H, W, C) f32 in the caller's layout, C = 1 for an (H, W)
// map: channel c of pixel (y, x) at (y * W + x) * C + c, so no channel-first
// copy is made.  One thread per output element e = (y * W + x) * C + c:
// neighbouring threads read and write neighbouring addresses.  Tap
// k = 3 * dy + dx reads (clamp(y + dy - 1), clamp(x + dx - 1)), as the
// plain version's edge pad and slices do, and the exchanges (i, j) leave
// min in slot i and max in slot j in the network's order; slot 4 is the
// median.  fminf / fmaxf are what torch.minimum / torch.maximum compute on
// the card for inputs that are not NaN, and the inputs (images in [0, 1],
// disparity maps) are finite, so K12 equals its plain version bit for bit.
//
// Bound: bytes, the image read once and the result written once.  The
// nine taps of a thread are served by L1 and L2 after the first read of
// each line, so HBM sees about one read of the image.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsK12 = 256;

__device__ __forceinline__ void exchange(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__global__ void median3x3_kernel(const float* __restrict__ img,
                                 float* __restrict__ out, int H, int W, int C,
                                 long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int c = (int)(e % C);
  const long long p = e / C;
  const int x = (int)(p % W), y = (int)(p / W);
  const long long rows[3] = {(long long)max(y - 1, 0) * W, (long long)y * W,
                             (long long)min(y + 1, H - 1) * W};
  const int cols[3] = {max(x - 1, 0), x, min(x + 1, W - 1)};
  float t[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      t[3 * dy + dx] = __ldg(img + (rows[dy] + cols[dx]) * C + c);
    }
  }
  // The network of ops/median.py _MED9_NET, in its order.
  exchange(t[1], t[2]);
  exchange(t[4], t[5]);
  exchange(t[7], t[8]);
  exchange(t[0], t[1]);
  exchange(t[3], t[4]);
  exchange(t[6], t[7]);
  exchange(t[1], t[2]);
  exchange(t[4], t[5]);
  exchange(t[7], t[8]);
  exchange(t[0], t[3]);
  exchange(t[5], t[8]);
  exchange(t[4], t[7]);
  exchange(t[3], t[6]);
  exchange(t[1], t[4]);
  exchange(t[2], t[5]);
  exchange(t[4], t[7]);
  exchange(t[4], t[2]);
  exchange(t[6], t[4]);
  exchange(t[4], t[2]);
  out[e] = t[4];
}

}  // namespace

// img, out: (H, W, C) f32, contiguous, C >= 1.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel cannot run.
extern "C" int median3x3_f32(const float* img, float* out, int H, int W,
                             int C, void* stream) {
  if (H < 0 || W < 0 || C < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)H * W * C;
  if (n == 0) return (int)cudaGetLastError();
  median3x3_kernel<<<(unsigned)((n + kThreadsK12 - 1) / kThreadsK12),
                     kThreadsK12, 0, (cudaStream_t)stream>>>(img, out, H, W,
                                                             C, n);
  return (int)cudaGetLastError();
}
