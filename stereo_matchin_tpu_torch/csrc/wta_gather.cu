// Winner-take-all on Hopper: kernels K3 (reference-view two-min) and K4
// (target-view epipolar two-min), on the (D, H, W) f32 cost volume, and
// K11 (the WTA epilogue) on their (H, W) outputs.
//
// Replaces the TPU kernels of stereo_matchin_tpu/kernels/wta_gather.py:
//   K3 two_min_f32  <- two_min_pallas  (:314, _two_min_kernel)
//   K4 wta_diag_f32 <- wta_diag_pallas (:426, _diag_wta_kernel)
// The TPU version of K4 reads a diagonally sheared (H, D, W+D-1) copy of the
// volume through one-hot matmuls split three ways in bf16; here K4 reads
// the diagonals from the volume itself, so no shear, pad or split exists.
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
// Bound: bytes.  K3 reads the whole volume once, coalesced along x, one
// thread per pixel; on config 3's band tail it moves the volume at 89-91%
// of the H100's HBM rate (device time over a CUDA graph).  A version
// with 4 pixels per thread (16-byte loads), 2 planes per load batch and the
// planes split into slices merged in shared memory was no faster at config
// 3 and 23% slower at 288x384, so K3 stays this loop (PERF.md section 6).
// K4 must read the diagonal b in [max(1, d1-x), d1] of each pixel, the
// bound's bytes.  One thread per pixel walking its diagonal with one load in
// flight is latency-bound, and a warp runs as many steps as its longest
// diagonal: on a map with a few outlying d1 (the argmin of a raw or
// aggregated volume) nearly every warp carries one, and its other lanes
// idle for most of the walk.  Here a thread issues kUnrollK4 planes' loads
// before it compares any (lanes with equal d1 read neighbouring columns, so
// the loads coalesce where the map is smooth), and the walk has two passes.
// The first walks the first `head` planes of every diagonal.  Where at most
// kSparseK4 lanes of a warp have longer diagonals, each of them leaves its
// tracker in the outputs and its index in a queue (one atomic per warp),
// and the second pass walks the rest of the queued diagonals with every
// lane of a warp busy; a warp with more such lanes (a noisy map) walks them
// to the end at once, as its lanes are busy anyway.  Where head >= D - 1
// no diagonal is longer and the second pass is not launched.  Each pixel
// sees the sequence of compares of the plain version, so no merge is
// needed.  A design that staged each block's diagonal window in shared
// memory (cp.async, double-buffered) staged 1.8x the diagonals at 288x384
// and 10x on config 3's shifted pair, whose few outliers stretch every
// window to all planes, and lost to direct loads on every input measured.
// Scattered diagonals move whole 32-byte sectors, so K4's time follows the
// sectors its diagonals touch more than the 4 bytes per element the bound
// counts (PERF.md section 6).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreadsK3 = 256;
// K4: threads per block in both passes; planes loaded at once (8 beat 2, 4
// and 16 on the card); the most lanes of a warp that leave the rest of
// their diagonals to the second pass; the second pass's blocks (16 of
// 128 threads per SM of an H100, grid-stride over the queue).
constexpr int kThreadsK4 = 128;
constexpr int kUnrollK4 = 8;
constexpr int kSparseK4 = 8;
constexpr int kTailBlocksK4 = 16 * 132;
// K11: threads per block, one pixel each.
constexpr int kThreadsK11 = 256;

__global__ void two_min_kernel(const float* __restrict__ cost,
                               const float* __restrict__ sc,
                               const float* __restrict__ ct,
                               float* __restrict__ c1_out,
                               float* __restrict__ c2_out,
                               int* __restrict__ d1_out, int D, int HW,
                               int d0, float big) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const bool pen = sc != nullptr;
  const float s = pen ? sc[p] : 0.0f;
  const float center = pen ? ct[p] : 0.0f;
  float c1 = INFINITY, c2 = INFINITY;
  int best = 0;
  for (int d = 0; d < D; ++d) {
    float v = cost[(long long)d * HW + p];
    if (pen) v = v + s * fabsf(center - (float)(d0 + d));
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

// K4's tracker: values >= big are skipped; '<=' keeps the largest b.
__device__ __forceinline__ void take_last(float v, int b, float big,
                                          float& c1, float& c2, int& bw) {
  if (!(v < big)) return;
  if (v <= c1) {
    c2 = c1;
    c1 = v;
    bw = b;
  } else if (v < c2) {
    c2 = v;
  }
}

// Planes lo .. hi of one pixel's diagonal, ascending, kUnrollK4 planes'
// loads issued before any of them is compared.
template <bool PEN>
__device__ __forceinline__ void walk(const float* row, long long HW, int W,
                                     int x, int dd, int lo, int hi, float s,
                                     float center, float big, float& c1,
                                     float& c2, int& bw) {
  for (int b = lo; b <= hi; b += kUnrollK4) {
    float v[kUnrollK4];
#pragma unroll
    for (int u = 0; u < kUnrollK4; ++u) {
      const int bb = b + u;
      v[u] = bb <= hi ? __ldg(row + bb * HW + min(max(x - dd + bb, 0), W - 1))
                      : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnrollK4; ++u) {
      const int bb = b + u;
      if (bb > hi) break;
      float w = v[u];
      if (PEN) w = w + s * fabsf(center - (float)(dd - bb));
      take_last(w, bb, big, c1, c2, bw);
    }
  }
}

__device__ __forceinline__ void store_diag(float c1, float c2, int bw, int dd,
                                           float big, float* c1_out,
                                           float* c2_out, int* b_out,
                                           long long p) {
  const bool any = c1 < big;
  c1_out[p] = fminf(c1, big);
  c2_out[p] = any ? fminf(c2, big) : big;
  b_out[p] = any ? bw : dd;
}

// K4, first pass: one thread per pixel walks the first `head` planes of its
// diagonal.  Where at most kSparseK4 lanes of a warp have longer diagonals,
// each of them leaves its tracker (c1, c2, b, uncapped) in the outputs and
// its index in queue[1 + i]; queue[0] counts them (one atomic per warp).
// A warp with more walks its diagonals to the end here.  Also writes
// base.
template <bool PEN>
__global__ void wta_diag_head(const float* __restrict__ cost,
                              const int* __restrict__ d1,
                              const float* __restrict__ sc,
                              const float* __restrict__ ct,
                              float* __restrict__ c1_out,
                              float* __restrict__ c2_out,
                              int* __restrict__ b_out,
                              float* __restrict__ base_out,
                              int* __restrict__ queue, int D, int H, int W,
                              float big, int head) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = p < HW;
  const int x = inside ? (int)(p % W) : 0;
  const float* row = cost + (inside ? p - x : 0);
  const int dd = inside ? d1[p] : 0;
  // d1 lies in [0, D-1] on every caller's path; the clamps only keep a bad
  // d1 from reading outside the volume.
  const int lo = max(1, dd - x), hi = min(dd, D - 1);
  const int head_hi = hi - lo < head ? hi : lo + head - 1;
  float s = 0.0f, center = 0.0f;
  if (PEN && inside) {
    s = sc[p];
    center = ct[p];
  }
  float c1 = INFINITY, c2 = INFINITY;
  int bw = 0;
  if (inside) walk<PEN>(row, HW, W, x, dd, lo, head_hi, s, center, big, c1,
                        c2, bw);
  // Every lane of the warp reaches the ballot: blocks are whole warps and
  // lanes past the frame stay to this point.
  const bool longer = inside && head_hi < hi;
  const unsigned lanes = __ballot_sync(0xffffffffu, longer);
  const bool more = longer && __popc(lanes) <= kSparseK4;
  if (longer && !more) {
    walk<PEN>(row, HW, W, x, dd, head_hi + 1, hi, s, center, big, c1, c2, bw);
  }
  if (more) {
    // Exactly the lanes of `lanes` are here, so the shuffle names them.
    const int lane = threadIdx.x & 31, leader = __ffs(lanes) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(queue, __popc(lanes));
    at = __shfl_sync(lanes, at, leader);
    queue[1 + at + __popc(lanes & ((1u << lane) - 1))] = (int)p;
  }
  if (!inside) return;
  if (more) {
    c1_out[p] = c1;
    c2_out[p] = c2;
    b_out[p] = bw;
  } else {
    store_diag(c1, c2, bw, dd, big, c1_out, c2_out, b_out, p);
  }
  const int b0 = min(max(dd - x, 0), D - 1);
  base_out[p] = row[b0 * HW + min(max(x - dd + b0, 0), W - 1)];
}

// K4, second pass: the queued pixels, dense in every warp, walk the rest of
// their diagonals from the first pass's trackers (the same compares in the
// same order) and store the capped results.
template <bool PEN>
__global__ void wta_diag_tail(const float* __restrict__ cost,
                              const int* __restrict__ d1,
                              const float* __restrict__ sc,
                              const float* __restrict__ ct,
                              float* __restrict__ c1_out,
                              float* __restrict__ c2_out,
                              int* __restrict__ b_out,
                              const int* __restrict__ queue, int D, int H,
                              int W, float big, int head) {
  const long long HW = (long long)H * W;
  const int n = queue[0];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const long long p = queue[1 + i];
    const int x = (int)(p % W);
    const float* row = cost + (p - x);
    const int dd = d1[p];
    const int lo = max(1, dd - x), hi = min(dd, D - 1);
    float s = 0.0f, center = 0.0f;
    if (PEN) {
      s = sc[p];
      center = ct[p];
    }
    float c1 = c1_out[p], c2 = c2_out[p];
    int bw = b_out[p];
    walk<PEN>(row, HW, W, x, dd, lo + head, hi, s, center, big, c1, c2, bw);
    store_diag(c1, c2, bw, dd, big, c1_out, c2_out, b_out, p);
  }
}

template <bool PEN>
void launch_diag(const float* cost, const int* d1, const float* sc,
                 const float* ct, float* c1, float* c2, int* b, float* base,
                 int* queue, int D, int H, int W, float big, int head,
                 bool tail, cudaStream_t stream) {
  const long long HW = (long long)H * W;
  const unsigned blocks = (unsigned)((HW + kThreadsK4 - 1) / kThreadsK4);
  wta_diag_head<PEN><<<blocks, kThreadsK4, 0, stream>>>(
      cost, d1, sc, ct, c1, c2, b, base, queue, D, H, W, big, head);
  if (tail) {
    wta_diag_tail<PEN><<<kTailBlocksK4, kThreadsK4, 0, stream>>>(
        cost, d1, sc, ct, c1, c2, b, queue, D, H, W, big, head);
  }
}

// K11: base + sc * |ct - i|, two roundings in the plain version's order.
__device__ __forceinline__ float tail_value(float base, float s, float c,
                                            float i) {
  return __fadd_rn(base, __fmul_rn(s, fabsf(__fsub_rn(c, i))));
}

// K11, one thread per pixel p = y * W + x.
template <bool PEN>
__global__ void wta_merge_kernel(const float* __restrict__ c1,
                                 const float* __restrict__ c2,
                                 const int* __restrict__ d1,
                                 const float* __restrict__ mc1,
                                 const float* __restrict__ mc2,
                                 const int* __restrict__ md,
                                 const float* __restrict__ base,
                                 const float* __restrict__ sc,
                                 const float* __restrict__ ct,
                                 float* __restrict__ d_ref,
                                 float* __restrict__ conf_ref,
                                 float* __restrict__ d_t,
                                 float* __restrict__ conf_t, int D, int W,
                                 long long HW, float big) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int x = (int)(p % W);
  const int dd = d1[p];
  const float r1 = c1[p], r2 = c2[p];
  d_ref[p] = (float)dd;
  conf_ref[p] = __fdiv_rn(__fsub_rn(r2, r1), r2);
  // The tail's probes i in [lo, hi] = [max(1, x + 1), min(D - 2, d1 - 1)].
  const float lo = fmaxf(__fadd_rn((float)x, 1.0f), 1.0f);
  const float hi = fminf(__fsub_rn((float)dd, 1.0f), (float)(D - 2));
  const float n = __fadd_rn(__fsub_rn(hi, lo), 1.0f);
  const float b = base[p];
  float v1 = b, v2 = b;
  if (PEN) {
    const float s = sc[p], c = ct[p];
    const float q = fminf(fmaxf(rintf(c), lo), hi);
    v1 = tail_value(b, s, c, q);
    const float below = __fsub_rn(q, 1.0f), above = __fadd_rn(q, 1.0f);
    const float q_lo = below >= lo ? tail_value(b, s, c, below) : INFINITY;
    const float q_hi = above <= hi ? tail_value(b, s, c, above) : INFINITY;
    v2 = fminf(q_lo, q_hi);
  }
  const float tc1 = n >= 1.0f && v1 < big ? v1 : INFINITY;
  const float tc2 = n >= 2.0f && v2 < big ? v2 : INFINITY;
  const float tc1c = fminf(tc1, big);
  const float tc2c = tc1 < big ? fminf(tc2, big) : big;
  const float m1 = mc1[p], m2 = mc2[p];
  const bool take = tc1c < m1;
  const float e1 = take ? tc1c : m1;
  const float e2 = fminf(fminf(m2, tc2c), fmaxf(m1, tc1c));
  d_t[p] = (float)(take ? max(dd - x, 0) : md[p]);
  conf_t[p] = __fdiv_rn(__fsub_rn(e2, e1), e2);
}

}  // namespace

// cost: (D, H, W), plane d holding disparity d0 + d (the penalty's d);
// sc, ct: (H, W) or both null (no penalty); c1, c2: (H, W) f32; d1: (H, W)
// int32, the plane index.  Returns cudaGetLastError().
extern "C" int two_min_f32(const float* cost, const float* sc, const float* ct,
                           float* c1, float* c2, int* d1, int D, int H, int W,
                           int d0, float big, void* stream) {
  const long long n = (long long)H * W;
  if (n > 0) {
    two_min_kernel<<<(unsigned)((n + kThreadsK3 - 1) / kThreadsK3),
                     kThreadsK3, 0, (cudaStream_t)stream>>>(
        cost, sc, ct, c1, c2, d1, D, H * W, d0, big);
  }
  return (int)cudaGetLastError();
}

// cost: (D, H, W); d1: (H, W) int32 in [0, D-1]; sc, ct: (H, W) or null;
// outputs (H, W): c1, c2, base f32 and b int32.  head (>= 1): the planes
// of each diagonal that the first pass walks; queue: H*W + 1 int32 of
// scratch for the second pass, unused (may be null) where head >= D - 1.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernels cannot run.
extern "C" int wta_diag_f32(const float* cost, const int* d1, const float* sc,
                            const float* ct, float* c1, float* c2, int* b,
                            float* base, int* queue, int D, int H, int W,
                            float big, int head, void* stream) {
  const long long HW = (long long)H * W;
  // No diagonal is longer than D - 1 planes: with head >= D - 1 the first
  // pass walks them all and queues nothing.
  const bool tail = head < D - 1;
  if (D < 1 || head < 1 || HW >= 0x7fffffffLL || (tail && queue == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (HW == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (tail) {
    const cudaError_t err = cudaMemsetAsync(queue, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (sc != nullptr) {
    launch_diag<true>(cost, d1, sc, ct, c1, c2, b, base, queue, D, H, W, big,
                      head, tail, s);
  } else {
    launch_diag<false>(cost, d1, sc, ct, c1, c2, b, base, queue, D, H, W, big,
                       head, tail, s);
  }
  return (int)cudaGetLastError();
}

// K11.  c1, c2, d1: K3's outputs; mc1, mc2, md, base: K4's; sc, ct: the
// target view's penalty maps, or both null; all (H, W), d1 and md int32.
// Writes d_ref, conf_ref, d_t, conf_t, (H, W) f32.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// cannot run.
extern "C" int wta_merge_f32(const float* c1, const float* c2, const int* d1,
                             const float* mc1, const float* mc2,
                             const int* md, const float* base,
                             const float* sc, const float* ct, float* d_ref,
                             float* conf_ref, float* d_t, float* conf_t,
                             int D, int H, int W, float big, void* stream) {
  const long long HW = (long long)H * W;
  if (D < 1 || HW < 0 || (sc == nullptr) != (ct == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (HW == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((HW + kThreadsK11 - 1) / kThreadsK11);
  cudaStream_t s = (cudaStream_t)stream;
  if (sc != nullptr) {
    wta_merge_kernel<true><<<blocks, kThreadsK11, 0, s>>>(
        c1, c2, d1, mc1, mc2, md, base, sc, ct, d_ref, conf_ref, d_t, conf_t,
        D, W, HW, big);
  } else {
    wta_merge_kernel<false><<<blocks, kThreadsK11, 0, s>>>(
        c1, c2, d1, mc1, mc2, md, base, sc, ct, d_ref, conf_ref, d_t, conf_t,
        D, W, HW, big);
  }
  return (int)cudaGetLastError();
}
