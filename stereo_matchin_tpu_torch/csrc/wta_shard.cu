// The disparity-sharded winner-take-all on Hopper: K13 (one disp shard's
// segment of the epipolar target scan) and K14 (the merges of the shards'
// all-gathered summaries), one thread per pixel.
//
// Replaces no pallas_call: these are the fusions XLA makes of the JAX
// package's jitted shard program (stereo_matchin_tpu/parallel/wta_sharded.py):
//   K13 epipolar_segment_f32        <- epipolar_partial's fori_loop (:68-102)
//   K14 shard_merge_reference_f32   <- reference_scan_sharded's fold of
//                                      two_min_combine (:38-65)
//   K14 shard_merge_target_f32      <- target_scan_sharded's fold and the
//                                      WTA's maps (:105-135)
// The plain versions (parallel/wta_sharded.py): epipolar_partial +
// stack_two_min; merge_reference_gathered; merge_target_gathered +
// wta_result.
//
// K13, per pixel (y, x), d1 = d1[y, x], imax = min(d1, total_disp - 1):
// scan step i < imax visits the global plane b(i) = d1 - min(i, x) at
// column max(x - i, 0), and counts only where b(i) - d0 lies in
// [0, n_local).  A step outside the shard is a no-op in the plain loop
// (v = inf never takes c1, and min(c2, inf) = c2), so the thread walks only
// the steps that count, in the plain loop's order, ascending i:
//   1. the unclamped steps, i in [max(0, d1 - d0 - n_local + 1),
//      min(x, d1 - d0, imax - 1)]: cost[d1 - i - d0, y, x - i], kUnrollK13
//      steps' loads issued before any of them is compared, as K4's walk;
//   2. the clamped tail, i in [x + 1, imax - 1], where bt = d1 - x lies in
//      the shard: plane bt at column 0, loaded once, each step with its own
//      penalty sc * |ct - i|, walked step by step as the plain loop walks it
//      (no closed form).
// The tracker is the plain loop's: c1 = c2 = big and best = d1 at the
// start; v < c1 takes (c2 = c1, best = b), else c2 = minimum(c2, v).  No
// descending-b walk: K4's '<=' on ascending b would need the tail first.
// K13 writes the stacked (3, H, W) summary the all-gather sends, as
// stack_two_min lays it out: c1, c2 and best's int32 bits (__int_as_float,
// no conversion).
//
// K14 reads the gathered (n, 3, H, W) summaries, the third plane of each as
// int32 bits (no float operation touches it), and folds them with
// two_min_combine: the reference in ascending shard order, then d = 0
// where c1 is not below big; the target in descending shard order (=
// ascending i) from (big, big, d1), then the four WTAResult maps: d_ref
// and d_t as f32, (c2 - c1) / c2 of both (IEEE division: 0 / 0 is NaN, as
// the plain ops give).
//
// minimum and maximum propagate NaN as torch's CUDA ones do (a NaN first
// argument wins, then a NaN second, else fminf / fmaxf), so that the
// kernels equal the plain ops on the card for any input.  Numerics: built
// with --fmad=false and without -use_fast_math; cost + sc * |ct - i| is two
// roundings in the plain order.
//
// Bound: bytes.  K13 reads each counted step's cost (4 bytes; the
// diagonals' scattered columns move whole 32-byte sectors, as K4's do),
// d1, the penalty maps, and writes 12 bytes a pixel; a shard reads at most
// n_local planes of each diagonal, so its walk is K4's restricted to the
// shard.  K14 reads 12 bytes a pixel a shard (and the reference's 12 in the
// target mode) and writes 12 or 16.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Threads per block, one pixel each; K13's steps loaded at once (K4's 8).
constexpr int kThreadsK13 = 128;
constexpr int kUnrollK13 = 8;
constexpr int kThreadsK14 = 256;

__device__ __forceinline__ float torch_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float torch_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// cost + sc * |ct - i|, two roundings in the plain version's order.
__device__ __forceinline__ float penalized(float v, float s, float c, int i) {
  return __fadd_rn(v, __fmul_rn(s, fabsf(__fsub_rn(c, (float)i))));
}

// The sequential tracker: strict '<' on ascending i.
__device__ __forceinline__ void track(float v, int b, float& c1, float& c2,
                                      int& best) {
  if (v < c1) {
    c2 = c1;
    c1 = v;
    best = b;
  } else {
    c2 = torch_min(c2, v);
  }
}

// two_min_combine(a = (c1, c2, d), b): a is earlier in scan order, ties go
// to a.
__device__ __forceinline__ void combine(float& c1, float& c2, int& d,
                                        float b1, float b2, int bd) {
  const bool take = b1 < c1;
  const float m2 = torch_min(torch_min(c2, b2), torch_max(c1, b1));
  c1 = take ? b1 : c1;
  d = take ? bd : d;
  c2 = m2;
}

// K13, one thread per pixel p = y * W + x of the shard's (Dl, H, W) volume
// (plane k holding global disparity d0 + k).
template <bool PEN>
__global__ void epipolar_segment_kernel(const float* __restrict__ cost,
                                        const int* __restrict__ d1,
                                        const float* __restrict__ sc,
                                        const float* __restrict__ ct,
                                        float* __restrict__ out, int W,
                                        long long HW, int d0, int n_local,
                                        int total_disp, float big) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int x = (int)(p % W);
  const float* row = cost + (p - x);    // row y of plane 0
  const int dd = d1[p];
  const int imax = min(dd, total_disp - 1);
  float s = 0.0f, center = 0.0f;
  if (PEN) {
    s = sc[p];
    center = ct[p];
  }
  float c1 = big, c2 = big;
  int best = dd;
  // 1. The unclamped steps: plane dd - i - d0, column x - i.
  const int lo = max(0, dd - d0 - n_local + 1);
  const int hi = min(min(x, dd - d0), imax - 1);
  for (int i = lo; i <= hi; i += kUnrollK13) {
    float v[kUnrollK13];
#pragma unroll
    for (int u = 0; u < kUnrollK13; ++u) {
      const int j = i + u;
      v[u] = j <= hi ? __ldg(row + (long long)(dd - j - d0) * HW + (x - j))
                     : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnrollK13; ++u) {
      const int j = i + u;
      if (j > hi) break;
      track(PEN ? penalized(v[u], s, center, j) : v[u], dd - j, c1, c2, best);
    }
  }
  // 2. The clamped tail: steps x + 1 .. imax - 1 revisit plane bt at
  // column 0.
  const int bt = dd - x, btl = bt - d0;
  if (x + 1 < imax && btl >= 0 && btl < n_local) {
    const float base = __ldg(row + (long long)btl * HW);
    for (int i = x + 1; i < imax; ++i) {
      track(PEN ? penalized(base, s, center, i) : base, bt, c1, c2, best);
    }
  }
  out[p] = c1;
  out[HW + p] = c2;
  out[2 * HW + p] = __int_as_float(best);
}

// K14, reference mode: fold the shards in ascending order.
__global__ void merge_reference_kernel(const float* __restrict__ g, int n,
                                       long long HW, float big,
                                       float* __restrict__ c1_out,
                                       float* __restrict__ c2_out,
                                       int* __restrict__ d_out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int* gi = reinterpret_cast<const int*>(g);
  float c1 = g[p], c2 = g[HW + p];
  int d = gi[2 * HW + p];
  for (int s = 1; s < n; ++s) {
    const long long at = 3 * HW * s + p;
    combine(c1, c2, d, g[at], g[at + HW], gi[at + 2 * HW]);
  }
  c1_out[p] = c1;
  c2_out[p] = c2;
  d_out[p] = c1 < big ? d : 0;
}

// K14, target mode: fold the shards in descending order from (big, big,
// d_ref), then the WTA's maps with the reference's (c1, c2, d_ref).
__global__ void merge_target_kernel(const float* __restrict__ g, int n,
                                    long long HW, float big,
                                    const float* __restrict__ r1,
                                    const float* __restrict__ r2,
                                    const int* __restrict__ rd,
                                    float* __restrict__ d_ref,
                                    float* __restrict__ conf_ref,
                                    float* __restrict__ d_t,
                                    float* __restrict__ conf_t) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int* gi = reinterpret_cast<const int*>(g);
  const int dr = rd[p];
  float c1 = big, c2 = big;
  int d = dr;
  for (int s = n - 1; s >= 0; --s) {
    const long long at = 3 * HW * s + p;
    combine(c1, c2, d, g[at], g[at + HW], gi[at + 2 * HW]);
  }
  const float a1 = r1[p], a2 = r2[p];
  d_ref[p] = (float)dr;
  conf_ref[p] = __fdiv_rn(__fsub_rn(a2, a1), a2);
  d_t[p] = (float)d;
  conf_t[p] = __fdiv_rn(__fsub_rn(c2, c1), c2);
}

unsigned blocks_of(long long HW, int threads) {
  return (unsigned)((HW + threads - 1) / threads);
}

}  // namespace

// K13.  cost: (Dl, H, W) f32, plane k holding global disparity d0 + k;
// d1: (H, W) int32 global disparities; sc, ct: (H, W) f32 or both null (no
// penalty); out: (3, H, W) f32.  Needs 1 <= n_local <= Dl (the plain
// version clamps planes past Dl; the wrapper refuses them), d0 >= 0 and
// total_disp >= 1.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments the kernel cannot run.
extern "C" int epipolar_segment_f32(const float* cost, const int* d1,
                                    const float* sc, const float* ct,
                                    float* out, int Dl, int H, int W, int d0,
                                    int n_local, int total_disp, float big,
                                    void* stream) {
  const long long HW = (long long)H * W;
  if (Dl < 1 || n_local < 1 || n_local > Dl || d0 < 0 || total_disp < 1 ||
      HW < 0 || (sc == nullptr) != (ct == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (HW == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = blocks_of(HW, kThreadsK13);
  if (sc != nullptr) {
    epipolar_segment_kernel<true><<<blocks, kThreadsK13, 0, s>>>(
        cost, d1, sc, ct, out, W, HW, d0, n_local, total_disp, big);
  } else {
    epipolar_segment_kernel<false><<<blocks, kThreadsK13, 0, s>>>(
        cost, d1, sc, ct, out, W, HW, d0, n_local, total_disp, big);
  }
  return (int)cudaGetLastError();
}

// K14, reference mode.  g: (n, 3, H, W) f32, the third plane of each shard
// int32 bits; outputs (H, W): c1, c2 f32 and d int32.
extern "C" int shard_merge_reference_f32(const float* g, int n, int H, int W,
                                         float big, float* c1, float* c2,
                                         int* d, void* stream) {
  const long long HW = (long long)H * W;
  if (n < 1 || HW < 0) return (int)cudaErrorInvalidValue;
  if (HW == 0) return (int)cudaGetLastError();
  merge_reference_kernel<<<blocks_of(HW, kThreadsK14), kThreadsK14, 0,
                           (cudaStream_t)stream>>>(g, n, HW, big, c1, c2, d);
  return (int)cudaGetLastError();
}

// K14, target mode.  g: (n, 3, H, W) as above; r1, r2, rd: the reference
// merge's c1, c2 (f32) and d (int32), (H, W); outputs (H, W) f32: d_ref,
// conf_ref, d_t, conf_t.
extern "C" int shard_merge_target_f32(const float* g, int n, int H, int W,
                                      float big, const float* r1,
                                      const float* r2, const int* rd,
                                      float* d_ref, float* conf_ref,
                                      float* d_t, float* conf_t,
                                      void* stream) {
  const long long HW = (long long)H * W;
  if (n < 1 || HW < 0) return (int)cudaErrorInvalidValue;
  if (HW == 0) return (int)cudaGetLastError();
  merge_target_kernel<<<blocks_of(HW, kThreadsK14), kThreadsK14, 0,
                        (cudaStream_t)stream>>>(
      g, n, HW, big, r1, r2, rd, d_ref, conf_ref, d_t, conf_t);
  return (int)cudaGetLastError();
}
