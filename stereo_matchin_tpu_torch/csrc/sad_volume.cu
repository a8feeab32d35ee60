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
// ops/cost.py sad_cost_volume, which this kernel equals bit for bit.  The
// right image is scaled once while it is staged and the left pixel once
// per thread: the same roundings as the plain version's l*s and r*s.
//
// Bound: bytes.  The volume is written once (4 bytes an output) and the
// pair is read a few times from L2.  The plan is kernels/sad_volume.py
// sad_tiles (tests/test_torch_sad_tiles.py walks it in numpy): a block of
// kSadThreads threads owns kSadTx = 4 * kSadThreads columns of one row and
// a chunk of dc <= kSadDc planes.  It stages, once, the pre-scaled right
// segment the chunk reads -- columns max(x0 - d0 - d_lo - dc + 1 + s, 0),
// s in [0, kSadTx + dc - 1), as three channel planes with one pad word
// every 32 (lanes read 4 words apart: at most one 2-way bank conflict a
// load) -- and each thread owns 4 consecutive x.  It keeps their scaled
// left colours in registers and walks the chunk's planes in ascending d
// with a window of 4 right colours that slides one column a plane: one
// staged pixel (3 shared loads) and one 16-byte store (W % 4 == 0 and an
// aligned volume; else 4-byte stores) for 4 outputs.  Indices are 32-bit
// within a row; the output pointer advances by a plane (64-bit) per d.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The compiled-in shape (kernels/sad_volume.py holds the same numbers and
// the plan built on them).
constexpr int kSadThreads = 128;            // threads a block
constexpr int kSadTx = 4 * kSadThreads;     // columns a block: 4 a thread
constexpr int kSadDc = 32;                  // planes a chunk at most

// Staged word of segment position s: one pad word every 32.
__device__ __forceinline__ int pad(int s) { return s + (s >> 5); }

// Words of one staged channel plane of a segment of n positions.
__host__ __device__ constexpr int pitch(int n) { return n + (n >> 5) + 1; }

template <bool kVec>
__global__ void __launch_bounds__(kSadThreads)
sad_volume_kernel(const float* __restrict__ left,
                  const float* __restrict__ right, float* __restrict__ cost,
                  int D, int H, int W, int d0, float scale, int dc) {
  extern __shared__ float stage[];            // [3][pitch(kSadTx + dc - 1)]
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kSadTx;
  const int y = blockIdx.y;
  const int d_lo = blockIdx.z * dc;
  const int n = kSadTx + dc - 1;
  const int p = pitch(n);
  // Segment position s holds column c0 + s, clamped to column 0; columns
  // past W - 1 only feed outputs past the frame and are not staged.
  const int c0 = x0 - d0 - d_lo - (dc - 1);
  const float* rrow = right + (size_t)y * W * 3;
  for (int s = tid; s < n; s += kSadThreads) {
    const int c = max(c0 + s, 0);
    if (c < W) {
      stage[pad(s)] = rrow[3 * c] * scale;
      stage[p + pad(s)] = rrow[3 * c + 1] * scale;
      stage[2 * p + pad(s)] = rrow[3 * c + 2] * scale;
    }
  }
  const int x = x0 + 4 * tid;
  float l0[4], l1[4], l2[4];
  const float* lrow = left + (size_t)y * W * 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int xe = min(x + e, W - 1);
    l0[e] = lrow[3 * xe] * scale;
    l1[e] = lrow[3 * xe + 1] * scale;
    l2[e] = lrow[3 * xe + 2] * scale;
  }
  __syncthreads();
  if (x >= W) return;
  const int planes = min(dc, D - d_lo);
  // Plane k reads positions 4 tid + dc - 1 - k + e, e = 0..3: a window
  // that slides down one position a plane.  Each step shifts it up one
  // entry and loads entry 0; the first step finds entries 1..3 loaded here.
  const int s0 = 4 * tid + dc - 1;
  float r0[4], r1[4], r2[4];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    r0[e] = stage[pad(s0 + 1 + e)];
    r1[e] = stage[p + pad(s0 + 1 + e)];
    r2[e] = stage[2 * p + pad(s0 + 1 + e)];
  }
  const size_t plane = (size_t)H * W;
  float* out = cost + ((size_t)d_lo * H + y) * W + x;
  const int live = min(W - x, 4);
#pragma unroll 4
  for (int k = 0; k < planes; ++k) {
#pragma unroll
    for (int e = 3; e > 0; --e) {
      r0[e] = r0[e - 1];
      r1[e] = r1[e - 1];
      r2[e] = r2[e - 1];
    }
    const int s = pad(s0 - k);
    r0[0] = stage[s];
    r1[0] = stage[p + s];
    r2[0] = stage[2 * p + s];
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t0 = fabsf(l0[e] - r0[e]);
      const float t1 = fabsf(l1[e] - r1[e]);
      const float t2 = fabsf(l2[e] - r2[e]);
      v[e] = (t0 + t1) + t2;
    }
    if (kVec && live == 4) {
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < live) out[e] = v[e];
      }
    }
    out += plane;
  }
}

}  // namespace

// left, right: (H, W, 3); cost: (D, H, W).  The plan is
// kernels/sad_volume.py sad_tiles: dc planes a chunk in `chunks` chunks,
// `shared` bytes a block.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not cover the D planes or
// does not match the compiled layout.
extern "C" int sad_volume_f32(const float* left, const float* right,
                              float* cost, int D, int H, int W, int d0,
                              float scale, int dc, int chunks, int shared,
                              void* stream) {
  if ((long long)D * H * W == 0) return (int)cudaGetLastError();
  if (d0 < 0 || dc < 1 || dc > kSadDc || chunks < 1 || chunks > 65535 ||
      H > 65535 || (long long)H * W > 0x7fffffffLL ||
      (long long)dc * (chunks - 1) >= D || (long long)dc * chunks < D ||
      shared != 12 * pitch(kSadTx + dc - 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((W + kSadTx - 1) / kSadTx, H, chunks);
  cudaStream_t s = (cudaStream_t)stream;
  d0 = d0 < W ? d0 : W;    // from d0 = W on, every read clamps to column 0
  if (W % 4 == 0 && ((uintptr_t)cost & 15) == 0) {
    sad_volume_kernel<true><<<grid, kSadThreads, shared, s>>>(
        left, right, cost, D, H, W, d0, scale, dc);
  } else {
    sad_volume_kernel<false><<<grid, kSadThreads, shared, s>>>(
        left, right, cost, D, H, W, d0, scale, dc);
  }
  return (int)cudaGetLastError();
}
