// Support-weight strips and refinement passes on Hopper: kernels K9
// (support_w) and K10 (refine_pass), f32, in the port's (T, H, W) strip
// and (H, W) map layouts.
//
// These replace no pallas_call.  In the JAX package the ASW frame is one
// XLA program (stereo_matchin_tpu/models/asw.py jits asw_pipeline_impl),
// and XLA fuses the per-tap chains of
//   ops/support.py:29    support_weights  (subtract, abs, sums, scales,
//                        the clamped distance, negate, exp, stack)
//   ops/refinement.py:46 refine_pass_v    (33 multiply-adds a pixel)
//   ops/refinement.py:62 refine_pass_h
// into loops over each output.  The port's plain ops (ops/support.py,
// ops/refinement.py) run them as one launch per elementwise op and tap:
// some 470 launches a strip and 400 a refinement round and view.  These
// kernels are those fusions written by hand:
//
//   K9  w[t, j, x] = expf(-c - dist), output row j = input row y_first + j:
//         p = img * 255 at the pixel, q = img * 255 at its neighbour at
//         offset t - R along the axis, clamped to the image;
//         c = ((|p0-q0| + |p1-q1|) + |p2-q2|) * inv_c;
//         dist = (float)|i - clamp(i + t - R, 0, last)| * inv_p, i the
//         FRAME coordinate (row0 + y on axis 0, x on axis 1) and last
//         h_glob - 1 on axis 0, W - 1 on axis 1.
//   K10 num = den = eps, then for t = 0 .. T-1 in order (wf = w[t] * F):
//         v, win: num = num + wf * D;             den = den + wf
//         h:      num = num + (wf * vv) * dv;     den = den + wf * dv
//       where F, D (or F, vv, dv) are read at the neighbour: row
//       clamp(y + t - R, 0, H - 1) in mode v, row y + t of a window of real
//       rows in mode win, column clamp(x + t - R, 0, W - 1) in mode h.
//       value = num / den; den is written too.
//
// Numerics: built with --fmad=false and without -use_fast_math, so every
// product and sum is rounded once, in the plain ops' order, and the
// divide is IEEE; expf is CUDA's accurate expf, which chip_smoke.py holds
// against torch.exp on every float32 in [-80, 0] before it compares K9 with
// its plain version.  So both kernels equal ops.support_weights and
// ops.refine_pass_* bit for bit.
//
// Bound: bytes.  K9 writes T H W floats and reads the (H, W, 3) image;
// K10 reads the T H W weights and writes two maps, its neighbours' maps
// coming from L1/L2.  Each is one pass over a strip: at 288x384, T = 33, a
// strip is 14.6 MB, 4.4 us at 3.35 TB/s.  The design is the simple one: a
// thread per output pixel, threads along x (coalesced strip rows), the
// taps unrolled where T is compiled in (kBakedTaps, the reference window
// 2 * 16 + 1), the weight planes addressed by a tap stride so that a
// cropped strip (a view of rows of a larger one) is read in place.  Block
// and grid are planned in Python (kernels/asw_refine.py, walked by
// tests/test_torch_refine_tiles.py).  Offsets into a strip are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBakedTaps = 33;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// AXIS 0: vertical taps (rows), 1: horizontal taps (columns).  TT > 0:
// the tap count compiled in.
template <int TT, int AXIS>
__global__ void support_w_kernel(const float* __restrict__ img,
                                 float* __restrict__ out, int T, int H_in,
                                 int W, int y_first, int H_out, int row0,
                                 int last, float inv_c, float inv_p) {
  const int taps = TT > 0 ? TT : T;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || j >= H_out) return;
  const int y = y_first + j;
  const int R = (taps - 1) / 2;
  const float* pc = img + ((long long)y * W + x) * 3;
  const float p0 = pc[0] * 255.0f;
  const float p1 = pc[1] * 255.0f;
  const float p2 = pc[2] * 255.0f;
  const int pos = AXIS == 0 ? y : x;         // the neighbour's image coordinate
  const int n_img = AXIS == 0 ? H_in : W;
  const int i = AXIS == 0 ? row0 + y : x;    // the frame coordinate
  const long long plane = (long long)H_out * W;
  float* o = out + (long long)j * W + x;
#pragma unroll
  for (int t = 0; t < taps; ++t) {
    const int off = t - R;
    const int q = clampi(pos + off, 0, n_img - 1);
    const float* qc = AXIS == 0 ? img + ((long long)q * W + x) * 3
                                : img + ((long long)y * W + q) * 3;
    const float a0 = fabsf(p0 - qc[0] * 255.0f);
    const float a1 = fabsf(p1 - qc[1] * 255.0f);
    const float a2 = fabsf(p2 - qc[2] * 255.0f);
    const float c = ((a0 + a1) + a2) * inv_c;
    const float dist = (float)abs(i - clampi(i + off, 0, last)) * inv_p;
    o[t * plane] = expf(-c - dist);
  }
}

// MODE 0: v (rows clamped), 1: win (rows of a window of real rows),
// 2: h (columns clamped).  a: D (modes 0, 1) or vv (mode 2); b: dv (mode 2).
template <int TT, int MODE>
__global__ void refine_kernel(const float* __restrict__ w, long long w_tap,
                              const float* __restrict__ a,
                              const float* __restrict__ b,
                              const float* __restrict__ conf,
                              float* __restrict__ value,
                              float* __restrict__ den_out, int T, int H,
                              int W, float eps) {
  const int taps = TT > 0 ? TT : T;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int R = (taps - 1) / 2;
  const long long px = (long long)y * W + x;
  const float* wp = w + px;
  float num = eps, den = eps;
#pragma unroll
  for (int t = 0; t < taps; ++t) {
    const float wt = wp[t * w_tap];
    if (MODE == 2) {
      const long long nb = (long long)y * W + clampi(x + t - R, 0, W - 1);
      const float wf = wt * conf[nb];
      const float dv = b[nb];
      num = num + (wf * a[nb]) * dv;
      den = den + wf * dv;
    } else {
      const int r = MODE == 0 ? clampi(y + t - R, 0, H - 1) : y + t;
      const long long nb = (long long)r * W + x;
      const float wf = wt * conf[nb];
      num = num + wf * a[nb];
      den = den + wf;
    }
  }
  value[px] = num / den;
  den_out[px] = den;
}

__global__ void expf_kernel(const float* __restrict__ x, float* __restrict__ y,
                            long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = expf(x[i]);
}

bool bad_block(int bx, int by, int gx, int gy, int W, int H) {
  return bx < 1 || by < 1 || bx * by > 1024 || gy > 65535 ||
         (long long)gx * bx < W || (long long)gy * by < H;
}

template <int TT>
void launch_support(int axis, dim3 grid, dim3 block, cudaStream_t s,
                    const float* img, float* out, int T, int H_in, int W,
                    int y_first, int H_out, int row0, int last, float inv_c,
                    float inv_p) {
  if (axis == 0) {
    support_w_kernel<TT, 0><<<grid, block, 0, s>>>(
        img, out, T, H_in, W, y_first, H_out, row0, last, inv_c, inv_p);
  } else {
    support_w_kernel<TT, 1><<<grid, block, 0, s>>>(
        img, out, T, H_in, W, y_first, H_out, row0, last, inv_c, inv_p);
  }
}

template <int TT>
void launch_refine(int mode, dim3 grid, dim3 block, cudaStream_t s,
                   const float* w, long long w_tap, const float* a,
                   const float* b, const float* conf, float* value,
                   float* den, int T, int H, int W, float eps) {
  switch (mode) {
    case 0:
      refine_kernel<TT, 0><<<grid, block, 0, s>>>(w, w_tap, a, b, conf, value,
                                                  den, T, H, W, eps);
      break;
    case 1:
      refine_kernel<TT, 1><<<grid, block, 0, s>>>(w, w_tap, a, b, conf, value,
                                                  den, T, H, W, eps);
      break;
    default:
      refine_kernel<TT, 2><<<grid, block, 0, s>>>(w, w_tap, a, b, conf, value,
                                                  den, T, H, W, eps);
  }
}

}  // namespace

// K9: img (H_in, W, 3) -> out (T, H_out, W), output row j from image row
// y_first + j; axis 0 measures distances in frame rows row0 + y clamped to
// [0, h_glob - 1], axis 1 in columns clamped to [0, W - 1].  A block of
// bx x by threads, gx x gy blocks (kernels/asw_refine.py refine_tiles).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int support_w_f32(const float* img, float* out, int T, int H_in,
                             int W, int y_first, int H_out, int axis,
                             int row0, int h_glob, float inv_c, float inv_p,
                             int bx, int by, int gx, int gy, void* stream) {
  if (T < 1 || T % 2 == 0 || (axis != 0 && axis != 1) || y_first < 0 ||
      H_out < 0 || y_first + H_out > H_in || h_glob < 1 ||
      bad_block(bx, by, gx, gy, W, H_out)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)H_out * W == 0) return (int)cudaGetLastError();
  const int last = axis == 0 ? h_glob - 1 : W - 1;
  const dim3 grid(gx, gy), block(bx, by);
  cudaStream_t s = (cudaStream_t)stream;
  if (T == kBakedTaps) {
    launch_support<kBakedTaps>(axis, grid, block, s, img, out, T, H_in, W,
                               y_first, H_out, row0, last, inv_c, inv_p);
  } else {
    launch_support<0>(axis, grid, block, s, img, out, T, H_in, W, y_first,
                      H_out, row0, last, inv_c, inv_p);
  }
  return (int)cudaGetLastError();
}

// K10: mode 0 (v), 1 (win) or 2 (h) over an (H, W) output; w[t] starts
// w_tap floats after w[t - 1], its rows W floats apart.  Maps are (H, W),
// or (H + T - 1, W) for a and conf in mode 1.  Returns as support_w_f32.
extern "C" int refine_pass_f32(int mode, const float* w, long long w_tap,
                               const float* a, const float* b,
                               const float* conf, float* value, float* den,
                               int T, int H, int W, float eps, int bx, int by,
                               int gx, int gy, void* stream) {
  if (mode < 0 || mode > 2 || T < 1 || T % 2 == 0 ||
      w_tap < (long long)H * W || bad_block(bx, by, gx, gy, W, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)H * W == 0) return (int)cudaGetLastError();
  const dim3 grid(gx, gy), block(bx, by);
  cudaStream_t s = (cudaStream_t)stream;
  if (T == kBakedTaps) {
    launch_refine<kBakedTaps>(mode, grid, block, s, w, w_tap, a, b, conf,
                              value, den, T, H, W, eps);
  } else {
    launch_refine<0>(mode, grid, block, s, w, w_tap, a, b, conf, value, den,
                     T, H, W, eps);
  }
  return (int)cudaGetLastError();
}

// y = expf(x) over n floats, compiled with the kernels' flags: the exp of
// K9, for chip_smoke.py to hold against torch.exp.
extern "C" int expf_f32(const float* x, float* y, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  expf_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}
