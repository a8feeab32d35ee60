// The disparity-sharded winner-take-all on Hopper: K13 (one disp shard's
// segment of the epipolar target scan: row segments and staged planes, or
// one thread a pixel on a small grid) and K14 (the merges of the shards'
// all-gathered summaries, one thread per pixel).
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
// (v = inf never takes c1, and min(c2, inf) = c2), so only the steps that
// count are walked, in the plain loop's order, ascending i: first the
// unclamped steps, i in [max(0, d1 - d0 - n_local + 1), min(x, d1 - d0,
// imax - 1)], reading cost[kl, y, x - i] at local plane kl = d1 - d0 - i,
// that is column u + kl with u = x - d1 + d0; then the clamped tail, i in
// [x + 1, imax - 1], where bt = d1 - x lies in the shard: plane bt at
// column 0, loaded once, each step with its own penalty sc * |ct - i|,
// walked step by step as the plain loop walks it (no closed form).  The
// tracker is the plain loop's: c1 = c2 = big and best = d1 at the start;
// v < c1 takes (c2 = c1, best = b), else c2 = minimum(c2, v).  K13 writes
// the stacked (3, H, W) summary the all-gather sends, as stack_two_min lays
// it out: c1, c2 and best's int32 bits (__int_as_float, no conversion).
//
// What bounds K13, and the design.  On a d1 that varies from lane to lane,
// one thread a pixel walking its diagonal (K13's first design, the pixel
// walk below) makes each warp load touch 32 scattered planes, 11.4 MB apart,
// and a warp runs as long as its longest lane's interval: 2.51 ms on a
// config-3 (1,2,2) shard with a uniform d1, 14% of its 4-byte bound, 19%
// of the bound of the 32-byte sectors it touched (NVIDIA H100 80GB HBM3,
// 700 W).  Yet almost every float it needs lies in a few contiguous row
// segments of each plane, since walking kl descending is walking i
// ascending.  So K13 has two walks, and the entry point picks one from the
// launch's shape:
//  - The segment walk, where the grid holds at least kMinGridK13 segment
//    blocks.  A block owns a segment of at most kSegK13 columns of one row
//    (the row cut into equal segments), each thread kPixK13 pixels of it
//    with their trackers in registers, and it:
//    1. counts its pixels' intervals [klo, khi] of planes into a coverage
//       array and takes as its staged range [ka, kb] the first and last
//       planes that 1 / kShareK13 of its columns walk (staging a plane
//       moves a window about a segment wide, loading it directly moves a
//       32-byte sector a pixel, so planes walked by a few pixels are left
//       out: outliers do not stretch the staged range, as they stretched
//       every window of the staged K4 that lost to direct loads,
//       wta_gather.cu);
//    2. stages plane kb, kb - 1, .., ka, each its window of the row (the
//       columns u + kl of the pixels that walk a staged plane, at most the
//       segment and the total_disp - 2 columns before it), through a ring
//       of kRingK13 windows in dynamic shared memory, filled by cp.async
//       (16 bytes where the window's 16-byte phase allows it, 4 at the
//       ragged ends), kRingK13 - 1 planes in flight while the block
//       compares one;
//    3. walks the planes of its pixels outside [ka, kb] through a queue in
//       shared memory, one pixel a thread whatever its owner (as K4's
//       second pass walks its queue), kUnrollK13 loads in flight, every
//       walker on the same planes at once from the queue's top plane down
//       (neighbouring columns of one plane row); the planes above kb
//       before the staged ones, handing the trackers back to their owners,
//       the planes below ka after them, the walkers then finishing those
//       pixels' tails;
//    4. walks the staged planes in lockstep, every pixel's read of a plane
//       issued before its compare (track_if: selects, no branch), then the
//       other pixels' tails.
//    A sparse block (no plane staged, at most 32 active pixels, as on the
//    disp shard past a scene's disparities) would spend its time in the
//    queue's chain of n_local / kUnrollK13 loads, its SM idle: there warp
//    0 copies each active pixel's planes into the free ring at once and
//    walks them from shared memory (sparse_block).
//  - The pixel walk, K13's first design, where the segment grid would be
//    smaller: a block then walks its planes a barrier each on an SM of its
//    own, and the shard's planes mostly sit in L2, so scattered loads cost
//    little.
// Every pixel thus sees the plain loop's compare sequence.  At config 3
// (1988 x 2880, 280 planes, (1,2,2)) the segments are 1440 columns, two
// blocks an SM (the ring and queue take 78 KB).  Device ms with the
// penalty, in turns on one card with the first design (NVIDIA H100 80GB
// HBM3, 700 W; scripts/kernel_turns.py; parent -> this): a config-3
// (1,2,2) shard, uniform d1, shard 0 2.51 -> 0.93 (1.69 GB staged: 0.51
// ms of bytes), shard 1 1.77 -> 0.80; a smooth d1 in [0, 40) with 3 in 32
// outliers in [93, 279] 0.68 -> 0.58 and 0.43 -> 0.36; d1 = 37 with 3 in
// 100 pixels uniform (the shifted pair the sharded path runs) 0.444 ->
// 0.441 and 0.182 -> 0.177 (sparse blocks); on (1,4,2), 994 segment
// blocks, 1.24 -> 0.48 uniform, 0.232 -> 0.231 shifted (the pixel walk
// there: 1.24 and 0.233); at 288 x 384, 144 or 288 rows a shard, the
// pixel walk 0.007-0.013, as the first design, where the segment walk took
// 0.009-0.043.  What remains on a dense d1 is issue: the lockstep compares of
// 1440 pixels a plane (~17 instructions a pixel and a plane), a barrier a
// plane, and ~3.5-way bank conflicts.  Tried and dropped: whole rows of
// 2880 columns a block, 512 threads x 6 pixels (1.24 ms on the uniform
// shard 0 with branches around each pixel's compare, 0.97 with selects:
// one block an SM); fewer pixels a thread, 1-2, for more warps (1.35-1.82
// ms: a barrier a plane for one compare a thread); two planes a barrier
// (0.97 against 0.90); a ring of 4 or 12 windows (no faster; 12 leaves one
// block an SM); copies issued by 2 or 4 warps only (1.02-1.12 ms); 8 loads
// in flight in the queue (0.45 and 0.27 ms on the shifted d1) or 32
// (spills: 1.21 ms uniform); the walkers each from their own top plane
// (0.46 against 0.36 ms on the structured d1's shard 1); the share of a
// plane's walkers against the active pixels rather than the columns
// (staged 1.4 GB for the 7% of pixels that reach the structured d1's shard
// 1: 1.06 ms); each thread walking its own pixels' outlying planes instead
// of the queue (0.99 and 0.87 ms on the structured shards; 0.56 against
// 0.24 on the shifted d1's shard 1); a queue of whole pixels, walked from
// the start by one or two walker warps beside the owners' staged planes
// (0.39 ms on the shifted d1's shard 0, but 0.68 on the structured d1's
// shard 0 and 0.94-0.98 on the uniform shard 1, whose queued pixels load
// their staged planes again); a short queue walked by up to 16 lanes a
// pixel, the loads shared by shuffles (0.25 against 0.24 ms on the shifted
// shard 1: every lane tracked every plane, and spills); every sparse block
// buffering its queue, ~100 walkers a block on the structured shard 1
// (0.43 against 0.35: the copies only add work where the load pipe is
// already full); the sparse branch inlined (the staged cases 2-4% slower:
// registers).
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
// Bound: bytes.  K13 must read each counted step's cost (4 bytes), d1, the
// penalty maps, and write 12 bytes a pixel; it moves the staged windows
// and a 32-byte sector for each direct load.  K14 reads 12 bytes a pixel a
// shard (and the reference's 12 in the target mode) and writes 12 or 16.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// K13's plan (epipolar_segment_plan hands it to the wrapper): threads a
// block, pixels a thread (so at most kSegK13 columns of a row a block),
// windows in the ring, the share 1 / kShareK13 of a block's columns that a
// staged plane must reach, the blocks an SM should hold, and a direct
// walk's loads in flight a lane.
constexpr int kThreadsK13 = 384;
constexpr int kPixK13 = 4;
constexpr int kSegK13 = kThreadsK13 * kPixK13;
constexpr int kRingK13 = 8;
constexpr int kShareK13 = 8;
constexpr int kMinBlocksK13 = 2;
constexpr int kUnrollK13 = 16;
// The pixel walk (one thread a pixel, kUnrollPixK13 loads in flight) takes
// a launch whose segment grid would hold fewer than kMinGridK13 blocks.
constexpr int kThreadsPixK13 = 128;
constexpr int kUnrollPixK13 = 8;
constexpr int kMinGridK13 = 528;
static_assert(kRingK13 >= 2, "the ring holds at least two windows");
constexpr int kSmemMaxK13 = 232448;  // a block's shared memory on sm_90
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

// track() where `on`, else nothing: selects, no branch, so that a thread's
// pixels' steps interleave.
__device__ __forceinline__ void track_if(bool on, float v, int b, float& c1,
                                         float& c2, int& best) {
  const bool take = on && v < c1;
  const float m = torch_min(c2, v);
  c2 = take ? c1 : (on ? m : c2);
  best = take ? b : best;
  c1 = take ? v : c1;
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

// cp.async copies into shared memory: 4 bytes, or 16 (both addresses
// 16-byte aligned), completing in commit groups.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cov[k] += v for the lanes where `on`, with one atomic for the warp where
// those lanes agree on k (a smooth d1 makes most of a segment's intervals
// alike), else one a lane.  Every lane of the warp calls it.
__device__ __forceinline__ void add_counts(int* cov, bool on, int k, int v) {
  const unsigned lanes = __ballot_sync(~0u, on);
  if (lanes == 0) return;
  const int first = __ffs(lanes) - 1;
  const int k0 = __shfl_sync(~0u, k, first);
  if (__all_sync(~0u, !on || k == k0)) {
    if ((int)(threadIdx.x & 31) == first) {
      atomicAdd(&cov[k0], v * __popc(lanes));
    }
  } else if (on) {
    atomicAdd(&cov[k], v);
  }
}

// The staged window of plane kl of block (y, [x0, x1)): columns [ws, we]
// of the row (empty where we < ws).  Every read of a pixel whose interval
// holds kl falls in it: its column u + kl lies in [umin + kl, umax + kl],
// in [0, W) and in [x0 - (total_disp - 2), x1 - 1] (a step i <=
// total_disp - 2 reads column x - i).
struct Window {
  int ws, we;
};

__device__ __forceinline__ Window window_of(int kl, int umin, int umax,
                                            int lowc, int highc) {
  return {max(lowc, umin + kl), min(highc, umax + kl)};
}

// Shared-memory index offset of a window: column c of plane kl lies at
// slot + c - ws + a, where a = the row's first float's 16-byte phase, so
// that the window's 16-byte-aligned floats land on 16-byte-aligned slots.
__device__ __forceinline__ int phase_of(const float* p) {
  return (int)((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}

// Issue the copies of one window: the floats before the first 16-byte
// boundary and after the last one by 4 bytes, the rest by 16.
__device__ __forceinline__ void stage_window(float* slot, const float* g,
                                             int len, int a, int tid) {
  const int head = min(len, (4 - a) & 3);
  const int body = (len - head) >> 2;
  const int units = len - 3 * body;          // head + body + tail
  for (int q = tid; q < units; q += kThreadsK13) {
    if (q < head) {
      cp_async4(slot + a + q, g + q);
    } else if (q < head + body) {
      const int off = head + 4 * (q - head);
      cp_async16(slot + a + off, g + off);
    } else {
      const int off = head + 4 * body + (q - head - body);
      cp_async4(slot + a + off, g + off);
    }
  }
}

// Walk one pixel's planes hi down to lo (ascending steps) by direct loads,
// kUnrollK13 planes at a time from `top` >= hi down, so that the block's
// walkers read the same planes at once (neighbouring columns of one plane
// row), each plane loaded where it lies in [lo, hi] and all of a step's
// loads issued before any is compared (e: the pixel's d - d0; step i reads
// plane e - i at column u + kl, u = x - e).
template <bool PEN>
__device__ __forceinline__ void walk_direct(const float* row, long long HW,
                                            int u, int e, int d0, int top,
                                            int hi, int lo, float s,
                                            float cen, float& c1, float& c2,
                                            int& best) {
  for (int k = top; k >= lo; k -= kUnrollK13) {
    float v[kUnrollK13];
#pragma unroll
    for (int q = 0; q < kUnrollK13; ++q) {
      const int kl = k - q;
      v[q] = kl >= lo && kl <= hi
                 ? __ldg(row + (long long)kl * HW + (u + kl))
                 : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kUnrollK13; ++q) {
      const int kl = k - q;
      if (kl < lo) break;
      if (kl <= hi) {
        track(PEN ? penalized(v[q], s, cen, e - kl) : v[q], kl + d0, c1, c2,
              best);
      }
    }
  }
}

// walk_direct from a buffer in shared memory: every plane's float copied
// in at once (cp.async, 4 bytes each), then tracked in the plain order, so
// that the walk waits on one load's latency, not on one for each
// kUnrollK13 planes.
template <bool PEN>
__device__ __forceinline__ void walk_buffered(const float* row, long long HW,
                                              float* buf, int u, int e,
                                              int d0, int hi, int lo,
                                              float s, float cen, float& c1,
                                              float& c2, int& best) {
  for (int kl = hi; kl >= lo; --kl) {
    cp_async4(buf + (hi - kl), row + (long long)kl * HW + (u + kl));
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int kl = hi; kl >= lo; --kl) {
    const float v = buf[hi - kl];
    track(PEN ? penalized(v, s, cen, e - kl) : v, kl + d0, c1, c2, best);
  }
}

// The clamped tail of pixel x: steps x + 1 .. imax - 1 revisit plane bt =
// d - x at column 0, each with its own penalty.
template <bool PEN>
__device__ __forceinline__ void walk_tail(const float* row, long long HW,
                                          int x, int d, int d0, int n_local,
                                          int total_disp, float s, float cen,
                                          float& c1, float& c2, int& best) {
  const int imax = min(d, total_disp - 1);
  const int bt = d - x, btl = bt - d0;
  if (x + 1 < imax && btl >= 0 && btl < n_local) {
    const float base = __ldg(row + (long long)btl * HW);
    for (int i = x + 1; i < imax; ++i) {
      track(PEN ? penalized(base, s, cen, i) : base, bt, c1, c2, best);
    }
  }
}

// K13's sparse block (no plane staged, at most 32 active pixels): the
// pixels' walks are the block's whole time, each a chain of n_local /
// kUnrollK13 loads by direct walks, so warp 0 walks them from the block's
// ring, which is free, each pixel's planes copied in at once while they
// fit (`cap` floats), and the other threads finish the other pixels of
// [x0, x1) (their tails) after queueing the active ones in qx.  Apart from
// the kernel (noinline) so that the staged path's registers stay its own.
template <bool PEN>
__device__ __noinline__ void sparse_block(
    const float* __restrict__ row, const int* __restrict__ d1,
    const float* __restrict__ sc, const float* __restrict__ ct,
    float* __restrict__ out, int W, long long HW, int d0, int n_local,
    int total_disp, float big, int x0, int x1, int rowoff, float* ring,
    int cap, int* qx, int* misc) {
  const int tid = threadIdx.x;
  for (int x = x0 + tid; x < x1; x += kThreadsK13) {
    const int d = d1[rowoff + x], e = d - d0, imax = min(d, total_disp - 1);
    if (min(min(x, e), imax - 1) >= max(0, e - n_local + 1)) {
      qx[atomicAdd(&misc[4], 1)] = x;
      continue;
    }
    float c1 = big, c2 = big;
    int best = d;
    walk_tail<PEN>(row, HW, x, d, d0, n_local, total_disp,
                   PEN ? sc[rowoff + x] : 0.0f, PEN ? ct[rowoff + x] : 0.0f,
                   c1, c2, best);
    const int p = rowoff + x;
    out[p] = c1;
    out[HW + p] = c2;
    out[2 * HW + p] = __int_as_float(best);
  }
  __syncthreads();
  if (tid < misc[4]) {
    const int x = qx[tid], d = d1[rowoff + x];
    const float sq = PEN ? sc[rowoff + x] : 0.0f;
    const float cq = PEN ? ct[rowoff + x] : 0.0f;
    const int e = d - d0, imax = min(d, total_disp - 1);
    const int lo = max(0, e - n_local + 1), hi = min(min(x, e), imax - 1);
    const int len = hi - lo + 1, at = atomicAdd(&misc[9], len);
    float a1 = big, a2 = big;
    int ab = d;
    if (at <= cap - len) {
      walk_buffered<PEN>(row, HW, ring + at, x - e, e, d0, e - lo, e - hi, sq,
                         cq, a1, a2, ab);
    } else {
      walk_direct<PEN>(row, HW, x - e, e, d0, e - lo, e - lo, e - hi, sq,
                       cq, a1, a2, ab);
    }
    walk_tail<PEN>(row, HW, x, d, d0, n_local, total_disp, sq, cq, a1, a2,
                   ab);
    const int p = rowoff + x;
    out[p] = a1;
    out[HW + p] = a2;
    out[2 * HW + p] = __int_as_float(ab);
  }
}

// K13: block (blockIdx.x = row y, blockIdx.y = segment s) owns the
// columns [x0, x1) = [s * seg, min(W, (s + 1) * seg)) of row y of the
// shard's (Dl, H, W) volume (plane k holding global disparity d0 + k);
// thread t owns its pixels x = x0 + t + j * kThreadsK13, j < kPixK13,
// their trackers in registers.  Unclamped step i of pixel x (d = d1[y, x])
// reads local plane kl = d - d0 - i at column x - i = u + kl, u = x - d +
// d0, so walking kl descending walks i ascending, the plain order.  The
// pixel's planes are [klo, khi]; the block stages the planes [ka, kb] that
// at least 1 / kShareK13 of its columns walk, through a ring of kRingK13
// windows filled by cp.async, one plane a commit group and a barrier.
// Each pixel walks its planes above kb first, then kb .. ka from
// shared memory in lockstep with the block, then those below ka, then its
// clamped tail.  The planes outside [ka, kb] are few pixels' long walks, so
// they go through a queue in shared memory, one pixel a thread whatever
// its owner, as K4's second pass does: the owners queue the pixels with
// planes above kb, every thread walks queued pixels from (big, big, d) and
// leaves their trackers in the queue, and the owners take them back before
// the staged planes; after them the owners queue their trackers of the
// pixels with planes below ka, and every thread walks queued pixels to
// the end of their tails and writes them.
template <bool PEN>
__global__ void __launch_bounds__(kThreadsK13, kMinBlocksK13)
    epipolar_segment_kernel(const float* __restrict__ cost,
                            const int* __restrict__ d1,
                            const float* __restrict__ sc,
                            const float* __restrict__ ct,
                            float* __restrict__ out, int W, long long HW,
                            int d0, int n_local, int total_disp, float big,
                            int seg, int slot) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* q1 = smem + kRingK13 * slot;  // the queue: trackers and pixels
  float* q2 = q1 + seg;
  int* qbest = reinterpret_cast<int*>(q2 + seg);
  int* qx = qbest + seg;
  int* cov = qx + seg;            // n_local + 1 coverage differences
  // ka, kb, umin, umax, then the queue's pixels and top plane, above the
  // staged range and below it, then the active pixels and the floats a
  // sparse block has taken from its ring.
  int* misc = cov + n_local + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y = blockIdx.x;
  const int x0 = blockIdx.y * seg, x1 = min(W, x0 + seg);
  const int rowoff = y * W;
  const float* row = cost + rowoff;  // row y of plane 0
  for (int k = tid; k <= n_local; k += kThreadsK13) cov[k] = 0;
  if (tid == 0) {
    misc[0] = 0;
    misc[1] = -1;
    misc[2] = INT_MAX;
    misc[3] = INT_MIN;
    misc[4] = 0;
    misc[5] = -1;
    misc[6] = 0;
    misc[7] = -1;
    misc[8] = 0;
    misc[9] = 0;
  }
  __syncthreads();

  // Each pixel's interval of unclamped steps, as planes [klo, khi] (empty:
  // khi = -1), counted into the block's coverage by a difference array.
  float c1[kPixK13], c2[kPixK13], s[kPixK13], cen[kPixK13];
  int e[kPixK13], best[kPixK13], klo[kPixK13], khi[kPixK13];  // e = d - d0
#pragma unroll
  for (int j = 0; j < kPixK13; ++j) {
    const int x = x0 + tid + j * kThreadsK13;
    c1[j] = big;
    c2[j] = big;
    s[j] = 0.0f;
    cen[j] = 0.0f;
    e[j] = -d0;
    klo[j] = 0;
    khi[j] = -1;
    if (x < x1) {
      const int d = d1[rowoff + x];
      e[j] = d - d0;
      if (PEN) {
        s[j] = sc[rowoff + x];
        cen[j] = ct[rowoff + x];
      }
      const int imax = min(d, total_disp - 1);
      const int lo = max(0, d - d0 - n_local + 1);
      const int hi = min(min(x, d - d0), imax - 1);
      if (hi >= lo) {
        klo[j] = d - d0 - hi;
        khi[j] = d - d0 - lo;
      }
    }
    best[j] = e[j] + d0;
    add_counts(cov, khi[j] >= klo[j], klo[j], 1);
    add_counts(cov, khi[j] >= klo[j], khi[j] + 1, -1);
    add_counts(misc + 8, khi[j] >= klo[j], 0, 1);   // the active pixels
  }
  __syncthreads();

  // The staged range: the first and last planes that at least 1 /
  // kShareK13 of the segment's columns walk (warp 0 scans the difference
  // array).  Staging a plane moves its window, about a row; loading it
  // directly moves a 32-byte sector for each pixel that walks it.
  if (warp == 0) {
    const int chunk = (n_local + 31) >> 5;
    const int k0 = min(n_local, lane * chunk), k1 = min(n_local, k0 + chunk);
    int sum = 0;
    for (int k = k0; k < k1; ++k) sum += cov[k];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum, first = INT_MAX, last = -1;
    for (int k = k0; k < k1; ++k) {
      run += cov[k];
      if (run > 0 && run * kShareK13 >= x1 - x0) {
        first = min(first, k);
        last = k;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      first = min(first, __shfl_xor_sync(~0u, first, o));
      last = max(last, __shfl_xor_sync(~0u, last, o));
    }
    if (lane == 0 && last >= 0) {
      misc[0] = first;
      misc[1] = last;
    }
  }
  __syncthreads();
  const int ka = misc[0], kb = misc[1];

  // A sparse block: no plane staged, and its active pixels (the few whose
  // diagonal reaches this shard) fill at most a warp (sparse_block).
  if (kb < ka && misc[8] <= 32) {
    sparse_block<PEN>(row, d1, sc, ct, out, W, HW, d0, n_local, total_disp,
                      big, x0, x1, rowoff, ring, kRingK13 * slot, qx, misc);
    return;
  }

  // The column offsets u of the pixels that walk a staged plane, and the
  // queue of the pixels with planes above kb.
  int umin = INT_MAX, umax = INT_MIN;
  int slotq[kPixK13];
#pragma unroll
  for (int j = 0; j < kPixK13; ++j) {
    const int x = x0 + tid + j * kThreadsK13;
    if (khi[j] >= ka && klo[j] <= kb) {
      const int u = x - e[j];
      umin = min(umin, u);
      umax = max(umax, u);
    }
    slotq[j] = -1;
    if (khi[j] > kb) {
      slotq[j] = atomicAdd(&misc[4], 1);
      qx[slotq[j]] = x;
      atomicMax(&misc[5], khi[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    umin = min(umin, __shfl_xor_sync(~0u, umin, o));
    umax = max(umax, __shfl_xor_sync(~0u, umax, o));
  }
  if (lane == 0 && umin <= umax) {
    atomicMin(&misc[2], umin);
    atomicMax(&misc[3], umax);
  }
  __syncthreads();
  umin = misc[2];
  umax = misc[3];
  const int lowc = max(0, x0 - max(total_disp - 2, 0)), highc = x1 - 1;
  const int m = kb - ka + 1;  // staged planes, kb first

  auto stage = [&](int t) {  // window t (plane kb - t), one commit group
    const int kl = kb - t;
    if (t < m) {
      const Window w = window_of(kl, umin, umax, lowc, highc);
      if (w.we >= w.ws) {
        const float* g = row + (long long)kl * HW + w.ws;
        stage_window(ring + (t % kRingK13) * slot, g, w.we - w.ws + 1,
                     phase_of(g), tid);
      }
    }
    cp_async_commit();
  };

  // The ring's first windows.
#pragma unroll
  for (int t = 0; t < kRingK13 - 1; ++t) stage(t);

  // 1. The queued pixels' planes above the staged range, one pixel a
  // thread.
  const int n_above = misc[4], top_above = misc[5];
  for (int q = tid; q < n_above; q += kThreadsK13) {
    const int x = qx[q], d = d1[rowoff + x];
    const float sq = PEN ? sc[rowoff + x] : 0.0f;
    const float cq = PEN ? ct[rowoff + x] : 0.0f;
    const int e = d - d0, imax = min(d, total_disp - 1);
    const int lo = max(0, e - n_local + 1), hi = min(min(x, e), imax - 1);
    float a1 = big, a2 = big;
    int ab = d;
    walk_direct<PEN>(row, HW, x - e, e, d0, top_above, e - lo,
                     max(e - hi, kb + 1), sq, cq, a1, a2, ab);
    q1[q] = a1;
    q2[q] = a2;
    qbest[q] = ab;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPixK13; ++j) {
    if (slotq[j] >= 0) {
      c1[j] = q1[slotq[j]];
      c2[j] = q2[slotq[j]];
      best[j] = qbest[slotq[j]];
    }
  }

  // 2. The staged planes, kb down to ka, in lockstep: every pixel's read
  // issued, then the compares where a pixel's interval holds the plane.
  for (int t = 0; t < m; ++t) {
    cp_async_wait<kRingK13 - 2>();
    __syncthreads();  // window t is in; every thread is past window t - 1
    stage(t + kRingK13 - 1);
    const int kl = kb - t;
    const Window w = window_of(kl, umin, umax, lowc, highc);
    // Column c of plane kl lies at ring[at + c]; pixel x reads u + kl.
    const int at = (t % kRingK13) * slot +
                   phase_of(row + (long long)kl * HW + w.ws) - w.ws + kl;
    float v[kPixK13];
#pragma unroll
    for (int j = 0; j < kPixK13; ++j) {
      const int u = x0 + tid + j * kThreadsK13 - e[j];
      v[j] = ring[kl >= klo[j] && kl <= khi[j] ? at + u : 0];
    }
#pragma unroll
    for (int j = 0; j < kPixK13; ++j) {
      track_if(kl >= klo[j] && kl <= khi[j],
               PEN ? penalized(v[j], s[j], cen[j], e[j] - kl) : v[j],
               kl + d0, c1[j], c2[j], best[j]);
    }
  }
  __syncthreads();  // every tracker is out of the queue

  // 3. The owners queue the trackers of the pixels with planes below ka,
  // and finish the others: their clamped tails, their outputs.
#pragma unroll
  for (int j = 0; j < kPixK13; ++j) {
    const int x = x0 + tid + j * kThreadsK13;
    if (x >= x1) continue;
    if (khi[j] >= klo[j] && klo[j] < ka) {
      const int q = atomicAdd(&misc[6], 1);
      atomicMax(&misc[7], min(khi[j], ka - 1));
      qx[q] = x;
      q1[q] = c1[j];
      q2[q] = c2[j];
      qbest[q] = best[j];
      continue;
    }
    walk_tail<PEN>(row, HW, x, e[j] + d0, d0, n_local, total_disp, s[j],
                   cen[j], c1[j], c2[j], best[j]);
    const int p = rowoff + x;
    out[p] = c1[j];
    out[HW + p] = c2[j];
    out[2 * HW + p] = __int_as_float(best[j]);
  }
  __syncthreads();
  // 4. The queued pixels' planes below the staged range and their tails,
  // one pixel a thread.
  const int n_below = misc[6], top_below = misc[7];
  for (int q = tid; q < n_below; q += kThreadsK13) {
    const int x = qx[q], d = d1[rowoff + x];
    const float sq = PEN ? sc[rowoff + x] : 0.0f;
    const float cq = PEN ? ct[rowoff + x] : 0.0f;
    const int e = d - d0, imax = min(d, total_disp - 1);
    const int hi = min(min(x, e), imax - 1);
    float a1 = q1[q], a2 = q2[q];
    int ab = qbest[q];
    walk_direct<PEN>(row, HW, x - e, e, d0, top_below,
                     min(e - max(0, e - n_local + 1), ka - 1), e - hi, sq, cq,
                     a1, a2, ab);
    walk_tail<PEN>(row, HW, x, d, d0, n_local, total_disp, sq, cq, a1, a2,
                   ab);
    const int p = rowoff + x;
    out[p] = a1;
    out[HW + p] = a2;
    out[2 * HW + p] = __int_as_float(ab);
  }
}

// K13's pixel walk, its first design: one thread a pixel p = y * W + x,
// its unclamped steps (plane d - i - d0, column x - i) by direct loads,
// kUnrollPixK13 at a time, then its clamped tail.  A warp walks as long
// as its longest lane; a launch whose segment blocks would be too few to
// fill the card, each walking a barrier a plane, takes it.
template <bool PEN>
__global__ void epipolar_pixel_kernel(const float* __restrict__ cost,
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
  for (int i = lo; i <= hi; i += kUnrollPixK13) {
    float v[kUnrollPixK13];
#pragma unroll
    for (int u = 0; u < kUnrollPixK13; ++u) {
      const int j = i + u;
      v[u] = j <= hi ? __ldg(row + (long long)(dd - j - d0) * HW + (x - j))
                     : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnrollPixK13; ++u) {
      const int j = i + u;
      if (j > hi) break;
      track(PEN ? penalized(v[u], s, center, j) : v[u], dd - j, c1, c2, best);
    }
  }
  // 2. The clamped tail.
  walk_tail<PEN>(row, HW, x, dd, d0, n_local, total_disp, s, center, c1, c2,
                 best);
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

// K13's plan for a row of W columns: segments a row, columns a segment,
// floats a ring slot (the widest window plus its 16-byte phase, in 16-byte
// units) and the dynamic shared memory; smem = 0 where the ring and the
// coverage do not fit a block.
struct SegPlan {
  int n_seg, seg, slot;
  long long smem;
};

SegPlan segment_plan(int W, int n_local, int total_disp) {
  SegPlan p;
  p.n_seg = (W + kSegK13 - 1) / kSegK13;
  p.seg = (W + p.n_seg - 1) / p.n_seg;
  const long long span =
      std::min<long long>(W, (long long)p.seg + std::max(total_disp - 2, 0));
  p.slot = (int)((span + 3 + 3) / 4 * 4);
  p.smem = ((long long)kRingK13 * p.slot + 4LL * p.seg + n_local + 11) * 4;
  if (p.smem > kSmemMaxK13 || p.n_seg > 65535) p.smem = 0;
  return p;
}

}  // namespace

// K13's plan for a row of W columns, for the wrapper (kernels/wta_shard.py
// segment_plan): out[0 .. 8] = threads a block, pixels a thread, windows in
// the ring, the share's denominator, segments a row, columns a segment,
// floats a ring slot, bytes of dynamic shared memory (0 where the block's
// ring, queue and coverage do not fit), and the least segment blocks a
// launch takes the segment walk with (H * segments; fewer: the pixel
// walk).
extern "C" void epipolar_segment_plan(int W, int n_local, int total_disp,
                                      long long* out) {
  const SegPlan p = segment_plan(W, n_local, total_disp);
  const long long v[9] = {kThreadsK13, kPixK13, kRingK13, kShareK13,
                          p.n_seg,     p.seg,   p.slot,   p.smem,
                          kMinGridK13};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// K13.  cost: (Dl, H, W) f32, plane k holding global disparity d0 + k;
// d1: (H, W) int32 global disparities; sc, ct: (H, W) f32 or both null (no
// penalty); out: (3, H, W) f32; walk: 0 the segment walk where its grid
// holds at least kMinGridK13 blocks, else the pixel walk; 1 the pixel walk,
// 2 the segment walk.  Needs 1 <= n_local <= Dl (the plain version clamps
// planes past Dl; the wrapper refuses them), d0 >= 0, total_disp >= 1,
// H * W < 2^31, and a ring that fits a block's shared memory
// (segment_plan; the wrapper refuses the rest, whichever walk).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels
// cannot run.
extern "C" int epipolar_segment_walk_f32(const float* cost, const int* d1,
                                         const float* sc, const float* ct,
                                         float* out, int Dl, int H, int W,
                                         int d0, int n_local, int total_disp,
                                         float big, int walk, void* stream) {
  const long long HW = (long long)H * W;
  if (Dl < 1 || n_local < 1 || n_local > Dl || d0 < 0 || total_disp < 1 ||
      H < 0 || W < 0 || HW > INT_MAX || (sc == nullptr) != (ct == nullptr) ||
      walk < 0 || walk > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (HW == 0) return (int)cudaGetLastError();
  const SegPlan plan = segment_plan(W, n_local, total_disp);
  if (plan.smem == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (walk == 0) walk = (long long)H * plan.n_seg >= kMinGridK13 ? 2 : 1;
  if (walk == 1) {
    const unsigned grid =
        (unsigned)((HW + kThreadsPixK13 - 1) / kThreadsPixK13);
    if (sc != nullptr) {
      epipolar_pixel_kernel<true><<<grid, kThreadsPixK13, 0, s>>>(
          cost, d1, sc, ct, out, W, HW, d0, n_local, total_disp, big);
    } else {
      epipolar_pixel_kernel<false><<<grid, kThreadsPixK13, 0, s>>>(
          cost, d1, sc, ct, out, W, HW, d0, n_local, total_disp, big);
    }
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)H, (unsigned)plan.n_seg);
  const int smem = (int)plan.smem;
  // Above 48 KB only after this, once on each device.
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    cudaFuncSetAttribute(epipolar_segment_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemMaxK13);
    cudaFuncSetAttribute(epipolar_segment_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemMaxK13);
    opted_in[dev] = true;
  }
  if (sc != nullptr) {
    epipolar_segment_kernel<true><<<grid, kThreadsK13, smem, s>>>(
        cost, d1, sc, ct, out, W, HW, d0, n_local, total_disp, big, plan.seg,
        plan.slot);
  } else {
    epipolar_segment_kernel<false><<<grid, kThreadsK13, smem, s>>>(
        cost, d1, sc, ct, out, W, HW, d0, n_local, total_disp, big, plan.seg,
        plan.slot);
  }
  return (int)cudaGetLastError();
}

// K13 with the walk its shape takes (walk 0 above).
extern "C" int epipolar_segment_f32(const float* cost, const int* d1,
                                    const float* sc, const float* ct,
                                    float* out, int Dl, int H, int W, int d0,
                                    int n_local, int total_disp, float big,
                                    void* stream) {
  return epipolar_segment_walk_f32(cost, d1, sc, ct, out, Dl, H, W, d0,
                                   n_local, total_disp, big, 0, stream);
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
