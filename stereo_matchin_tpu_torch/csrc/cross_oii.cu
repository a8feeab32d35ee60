// The cross-based method on Hopper: kernels K5 (adaptive cross arms), K7
// (one OII windowed-mean pass) and K8 (histogram vote: per-row counts,
// then the vertical sum and mode).
//
// Replaces the TPU kernels of stereo_matchin_tpu/kernels/cross_oii.py:
//   K5 cross_arms_f32 <- cross_arms_pallas (_arms_kernel)
//   K7 oii_pass_f32   <- oii_hpass_pallas (_oii_h_kernel) and its
//                        transposed twin oii_hpass_pallas_t
//                        (_oii_h_kernel_t), axis 2;
//                        oii_vpass_pallas (_oii_v_kernel), axis 1
//   K8 vote_h_u8      <- histogram_vote_pallas, _vote_h_kernel
//      vote_v_i32     <- histogram_vote_pallas, _vote_v_kernel
// The TPU versions answer TPU costs -- a transposed twin chosen by a
// lane-padding gate, zero-baked column bounds, lane rolls for the d-shift,
// a one-hot bf16 matmul on the MXU for the vote counts and a packed
// count * D_pad + d float max for the mode.  Here the d-shift is an index,
// the bounds are loop limits and the counts are integers.
//
// Contracts (arms: (4, H, W) int32 [h-, h+, v-, v+], minus arms negative):
//   K5 per pixel and direction, dist = first .. first + L - 2: the arm
//      (starting at 1) grows while the neighbour at dist lies in the frame
//      and |nb - p| < tau on all three channels (f32); the first failure
//      freezes it.  Rows are anchored to the frame: the image holds frame
//      rows row0 .. row0 + H - 1, the in-frame test runs on the global row
//      clamp(row0 + y, 0, h_glob - 1) (a row past the frame border carries
//      the border row's walk bounds), and the colours are read at the local
//      row clamped to the image (edge replication).  row0 = 0, h_glob = H is
//      the whole frame.  Equals ops/cross.py cross_arms (int32, bit for bit).
//   K7 out[d,y,x] = sum_{j = -L..L, m <= j <= p, 1 <= i+j <= n-1}
//                   vol[.., i+j] / (p - m),   j ascending,
//      i = x (axis 2, h arms) or y (axis 1, v arms); m = max(minus_l[y,x],
//      minus_r[y, max(x-d0-d, 0)]), p = min of the plus arms the same way
//      -- for the v planes too.  Axis 1 is anchored like K5: the bound
//      1 <= i+j <= n-1 holds on the frame row row0 + y + j against h_glob,
//      and taps outside the volume's own rows add nothing.  Equals
//      ops/oii.py oii_pass_plain.
//   K8 rc[d,y,x]  = #{j in [hm, hp] ∩ [-L, L] : idx[y, clamp(x+j)] == d}
//      (h arms of (y, x); a border pixel is re-counted, CLAMP_TO_EDGE);
//      mode[y,x]  = argmax_d sum_{i in [vm, vp] ∩ [-L, L]} rc[d, clamp(y+i), x]
//      with the ANCHOR pixel's v arms, ties to the highest d.  Equal to
//      ops/vote.py vote_counts_plain / vote_mode_plain (exact integers).
//
// Numerics: built with --fmad=false and without -use_fast_math; K7 adds in
// j order and divides by IEEE division.  K7 skips masked taps where the
// plain version adds +0.0: every addend is >= +0.0 (costs are sums of
// absolute values, and the h pass's means of them), and x + (+0.0) == x for
// every such x, so the sums are bit-identical.
//
// K7 reads and writes the volume once (its byte bound); the plan is
// kernels/cross_oii.py oii_tiles, which the wrapper passes to oii_pass_f32
// (tests/test_torch_oii_tiles.py walks both axes in numpy).  A block owns a
// tile of pixels and a chunk of dc planes (at most 32, fewer where the grid
// needs more blocks).  It stages the chunk's right arms of its rows once,
// at the columns max(x - d0 - d, 0) of its x and d, as int2 (minus, plus);
// each thread keeps its pixels' left arms in registers.  Per plane it
// stages the volume its windows reach (cp.async, the next plane in flight),
// and each thread walks the union of its outputs' windows once, ascending,
// reading each staged value once into a register and adding it to every
// output whose window holds it (a predicated add; unconditionally over the
// positions that all hold).  Indices are 32-bit within a plane, 64-bit
// across planes; no % or / per output but the IEEE divide.
//   axis 1: 32 columns (lane = column) x TY = 8 * R rows (R = kOiiRows =
//      4 a thread); the plane's rows y0 - L .. y0 + TY + L - 1 of those
//      columns are staged (16-byte copies where W % 4 == 0), so the volume
//      crosses L2 1 + 2L / TY times, and lanes read their own column: no
//      bank conflict.
//   axis 2: 8 rows (warp = row) x 32 * C columns (C = kOiiCols = 2 a
//      thread); each row's segment x0 - LA .. x0 + 32C + LA - 1 (LA = L
//      rounded up to 4) is staged, and a thread reads C columns a load.
//      Where all C windows share a core, the positions before it lie below
//      every window's end and those after it above every start, so each
//      fringe tests one bound.
// R = 4 and C = 2 were faster on the H100 than R = 2, 8 and C = 4 (PERF.md,
// K7).  What limits K7 there is issue, not bytes: the walk's predicated adds,
// paid for the longest window of a warp's lanes (PERF.md, K7).  The
// anchoring (row0, h_glob) of K5 and K7 serves the band drivers: a band's
// window of rows gives every kept row the values of the whole frame.
//
// K5 is bound by its walk where arms are long (up to L - 1 colour tests a
// pixel and direction, paid for the longest arm of a warp's lanes) and by
// its staging where they are short.  Its plan is kernels/cross_oii.py
// arms_tiles (tests/test_torch_arms_tiles.py walks it in numpy).  One
// launch runs both axes, each over tiles whose halo is one dimensional: R =
// first + L - 2 (the longest distance walked) past each side.
//   v tiles (the grid's first blocks): 32 columns (lane = column) x TY
//      rows (TY = ty_v of the plan, at most 32; warp w owns rows w, w + 8,
//      ...); the rows y0 - R .. y0 + TY + R - 1, clamped to the image, are
//      copied as they lie in the image, 3 interleaved floats a pixel
//      (cp.async, 16-byte copies where W % 4 == 0 and the image is
//      aligned, else 4-byte ones).  A step reads 3 floats; the lanes' reads
//      lie 3 words apart, so no bank conflict.
//   h tiles: kArmsHx = 256 columns of one row, a pixel a thread; the row
//      segment x0 - R .. x0 + kArmsHx + R - 1 within the frame is staged as
//      float4 (r, g, b, 0): a step is one 16-byte shared load, 32
//      consecutive float4 a warp.
// Each thread walks its pixel's minus and plus arms of its axis; a walk's
// last distance is cut to the frame (columns 0 .. W - 1, frame rows 0 ..
// h_glob - 1 from clamp(row0 + y)) before it starts, so a step tests the
// colours only.  Indices are 32-bit (a plane holds < 2^31 pixels); one
// division a block splits its index into tile coordinates.  On the H100
// (PERF.md, K5): copies beat float4 staging for the v tiles and lost for
// the h tiles; 256-column h tiles beat 2 rows of 128; taller v tiles, a
// halo staged in two steps, fused minus/plus walks and unrolled walks
// were slower.  Where every arm is 1 and the image passes L2 (a noise
// frame at config 3), K5 is slower than the one-thread-a-pixel kernel it
// replaced: the two axes' tiles read the image twice from HBM.

// K8 is bound by its bytes: rc (D, H, W) uint8 is written once by the count
// and read once by the mode; the plans are kernels/cross_oii.py
// vote_h_tiles / vote_v_tiles, which the wrappers pass to the entry points
// below (tests/test_torch_vote_tiles.py walks both in numpy).
//   vote_h: a block owns kVoteHTx pixels of one row and a chunk of dc
//      planes.  It stages the row's bins over the segment plus L columns on
//      each side (clamped: CLAMP_TO_EDGE) and zeroes a [dc][kVoteHPitch]
//      uint8 histogram tile in shared memory; each thread walks its pixel's
//      <= 2L+1 taps once, adding each run of equal bins to its own column
//      (bins outside the chunk, and so outside [0, D), are not counted), and
//      the block writes the tile out in 16-byte stores.  Work per pixel is
//      2L+1 shared reads plus D/16 stores, instead of D * (2L+1) compares.
//   vote_v: a block owns 32 columns and G * TY output rows (TY = 16 where
//      L allows); its warps are G = 2 row warps (TY rows each) times P = 4
//      plane groups (a contiguous range of planes each).  Per step a group
//      stages two planes' rows clamp(y0 - L + r), r in [0, G * TY + 2L), of
//      its 32 columns (16-byte cp.async, the next two planes in flight
//      while these are summed); each warp forms the column prefix of its
//      own TY + 2L rows for both planes at once, one plane per 16-bit half
//      of a uint32 (each half at most 255 * (TY + 2L) <= 65535: the plan
//      keeps TY + 2L <= 257), and each lane's TY pixels read their window
//      sums of both planes as one difference of two prefix entries,
//      keeping best / best_d in registers with '>=' over ascending d.  The
//      plane groups' results meet in shared memory, ascending, with the
//      same '>='.  rc is read (1 + 2L / (G * TY)) times, not up to 2L+1.
//      (A plan sweep on the H100 chose G = 2, P = 4 and plane pairs over
//      G = 1..8 row warps and single planes, at 288x384 and at config 3.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// K5's compiled-in shapes (kernels/cross_oii.py holds the same numbers and
// the plan built on them).
constexpr int kArmsThreads = 256;       // threads a block, both axes
constexpr int kArmsWarps = kArmsThreads / 32;
constexpr int kArmsHx = kArmsThreads;   // h tiles: columns of one row
constexpr int kArmsVx = 32;             // v tiles: columns (a warp's lanes)
// Blocks an SM must hold: caps the kernel at 32 registers a thread.  Left
// to itself nvcc took 48, 5 blocks an SM, and K5 ran slower on the H100 on
// every input timed (PERF.md, K5).
constexpr int kArmsBlocksPerSm = 8;

// K8's compiled-in shapes (kernels/cross_oii.py holds the same numbers and
// the plans built on them).
constexpr int kSharedLimit = 232448;    // 227 KB: the most a block may have
constexpr int kVoteHTx = 128;           // vote_h: pixels (threads) per block
constexpr int kVoteHPitch = kVoteHTx + 32;  // tile row: rows 4 apart differ
                                        // in bank (40 words a row)
constexpr int kVoteVRowWarps = 2;       // vote_v: row warps (G) at most
constexpr int kVoteVGroups = 4;         // vote_v: plane groups (P) at most
constexpr int kVoteVRows = 257;         // vote_v: TY + 2L at most (uint16)
// K7's compiled-in shapes.
constexpr int kOiiThreads = 256;        // threads a block, both axes
constexpr int kOiiWarps = kOiiThreads / 32;
constexpr int kOiiRows = 4;             // axis 1: output rows a thread
constexpr int kOiiCols = 2;             // axis 2: output columns a thread
constexpr int kOiiFar = 1 << 30;        // past every row and column index

// Asynchronous 16-byte copy global -> shared (cp.async.cg, L2 only).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// Asynchronous 4-byte copy global -> shared (cp.async.ca).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until every committed group of this thread has landed.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
// Barrier `id` (1..15; 0 is __syncthreads') of the n threads that use it.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// K5: the arm of one direction from a pixel's staged colour c, its
// neighbours `step` floats apart a distance (interleaved colours): 1 plus
// the distances first .. lim passed before the first colour test fails.
__device__ __forceinline__ int arm_walk(const float* c, int step, float tau,
                                        int first, int lim) {
  const float p0 = c[0], p1 = c[1], p2 = c[2];
  int arm = 1;
  for (int dist = first; dist <= lim; ++dist) {
    const float* nb = c + dist * step;
    if (!(fabsf(nb[0] - p0) < tau && fabsf(nb[1] - p1) < tau &&
          fabsf(nb[2] - p2) < tau)) {
      break;
    }
    ++arm;
  }
  return arm;
}

// K5: the same with colours staged as float4, `step` float4 apart, p the
// pixel's own.
__device__ __forceinline__ int arm_walk(const float4* c, int step, float4 p,
                                        float tau, int first, int lim) {
  int arm = 1;
  for (int dist = first; dist <= lim; ++dist) {
    const float4 nb = c[dist * step];
    if (!(fabsf(nb.x - p.x) < tau && fabsf(nb.y - p.y) < tau &&
          fabsf(nb.z - p.z) < tau)) {
      break;
    }
    ++arm;
  }
  return arm;
}

// K5: blocks 0 .. blocks_v - 1 are v tiles (gx_v of them a band of ty_v
// rows), the rest h tiles (gx_h of them a row); see the note at the top.
// vec: the image is 16-byte aligned and W % 4 == 0, so every staged v row
// starts on a 16-byte boundary.
__global__ void __launch_bounds__(kArmsThreads, kArmsBlocksPerSm)
cross_arms_kernel(const float* __restrict__ img, int* __restrict__ arms,
                  int H, int W, int L, int first, float tau, int row0,
                  int h_glob, int R, int ty_v, int gx_v, int blocks_v,
                  int gx_h, int vec) {
  extern __shared__ float4 tile[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = first + L - 2;      // the last distance walked
  const int HW = H * W;
  const int b = blockIdx.x;
  if (b < blocks_v) {
    const int band = b / gx_v, x0 = (b - band * gx_v) * kArmsVx;
    const int y0 = band * ty_v, rows = ty_v + 2 * R;
    float* raw = reinterpret_cast<float*>(tile);   // [rows][3 * kArmsVx]
    const int nf = 3 * min(kArmsVx, W - x0);       // floats of a tile row
    for (int r = warp; r < rows; r += kArmsWarps) {
      const int yy = min(max(y0 - R + r, 0), H - 1);
      const float* src = img + 3 * (size_t)(yy * W + x0);
      float* dst = raw + r * 3 * kArmsVx;
      if (vec) {
        if (4 * lane < nf) copy16(dst + 4 * lane, src + 4 * lane);
      } else {
        for (int k = lane; k < nf; k += 32) copy4(dst + k, src + k);
      }
    }
    commit();
    wait_all();
    __syncthreads();
    const int x = x0 + lane;
    if (x >= W) return;
    for (int i = warp; i < ty_v && y0 + i < H; i += kArmsWarps) {
      const int y = y0 + i;
      const int gy = min(max(row0 + y, 0), h_glob - 1);
      const float* c = raw + (R + i) * 3 * kArmsVx + 3 * lane;
      const int q = y * W + x;
      arms[2 * (size_t)HW + q] =
          -arm_walk(c, -3 * kArmsVx, tau, first, min(last, gy));
      arms[3 * (size_t)HW + q] =
          arm_walk(c, 3 * kArmsVx, tau, first, min(last, h_glob - 1 - gy));
    }
    return;
  }
  const int y = (b - blocks_v) / gx_h;
  const int x0 = (b - blocks_v - y * gx_h) * kArmsHx;
  const int sw = kArmsHx + 2 * R;                  // [sw] float4
  for (int s = threadIdx.x; s < sw; s += kArmsThreads) {
    const int xx = x0 - R + s;
    if (xx >= 0 && xx < W) {
      const float* px = img + 3 * (size_t)(y * W + xx);
      tile[s] = make_float4(px[0], px[1], px[2], 0.f);
    }
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const float4* c = tile + R + threadIdx.x;
  const float4 p = *c;
  const int q = y * W + x;
  arms[q] = -arm_walk(c, -1, p, tau, first, min(last, x));
  arms[(size_t)HW + q] = arm_walk(c, 1, p, tau, first, min(last, W - 1 - x));
}

// K7's blocks (both axes): the chunk's right arms of the block's rows, read
// at max(x - d0 - d, 0) for every x of the block and d of the chunk: columns
// ca .. ca + aw - 1 (clipped to the frame), as (minus, plus) pairs
// [ty][aw].  Warp w stages rows w, w + kOiiWarps, ...
__device__ __forceinline__ void stage_right_arms(int2* arms_s,
                                                 const int* minus_r,
                                                 const int* plus_r, int H,
                                                 int W, int yb, int ty, int ca,
                                                 int aw) {
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < ty && yb + row < H;
       row += kOiiWarps) {
    const int q0 = (yb + row) * W;
    for (int c = lane; c < aw && ca + c < W; c += 32) {
      arms_s[row * aw + c] = make_int2(minus_r[q0 + ca + c], plus_r[q0 + ca + c]);
    }
  }
}

// One output's window on its axis: the positions i + j, j in [m, p] ∩ [-L,
// L], that lie in [first, last] (lo, n: the first position and the count),
// and its divisor p - m (int32 arithmetic, wrapping as the plain version's).
__device__ __forceinline__ void window(int i, int m, int p, int L, int first,
                                       int last, int& lo, int& n, float& div) {
  lo = max(i + min(max(m, -L), L + 1), first);
  const int hi = min(i + max(min(p, L), -L - 1), last);
  n = max(hi - lo + 1, 0);
  div = (float)(int)((unsigned)p - (unsigned)m);
}

// Adds v to each of the N accumulators whose window [lo, lo + n) holds
// position r.  A masked tap is skipped (a predicated add; the plain version
// adds +0.0 there, which changes no sum here: each starts at +0.0 and adds
// values >= +0.0).
template <int N>
__device__ __forceinline__ void add_masked(float (&acc)[N], const int (&lo)[N],
                                           const int (&n)[N], int r, float v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if ((unsigned)(r - lo[i]) < (unsigned)n[i]) acc[i] += v;
  }
}

// add_masked for a position r that lies at or below every window's end
// (before a shared core): only the start is tested.
template <int N>
__device__ __forceinline__ void add_from(float (&acc)[N], const int (&lo)[N],
                                         int r, float v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (r >= lo[i]) acc[i] += v;
  }
}

// add_masked for a position r that lies at or above every window's start
// (after a shared core): only the end is tested.
template <int N>
__device__ __forceinline__ void add_until(float (&acc)[N], const int (&lo)[N],
                                          const int (&n)[N], int r, float v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (r < lo[i] + n[i]) acc[i] += v;
  }
}

// The union [a, b] of the N windows, and their intersection [c0, c1] where
// every window holds it; an empty intersection (or an empty window) is
// returned as [b + 1, b], so that the walk a .. c0 - 1, c0 .. c1, c1 + 1 ..
// b covers [a, b] once.  No window: a > b.
template <int N>
__device__ __forceinline__ void union_and_core(const int (&lo)[N],
                                               const int (&n)[N], int& a,
                                               int& b, int& c0, int& c1) {
  a = kOiiFar;
  b = -kOiiFar;
  c0 = -kOiiFar;
  c1 = kOiiFar;
  bool all = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (n[i] > 0) {
      a = min(a, lo[i]);
      b = max(b, lo[i] + n[i] - 1);
      c0 = max(c0, lo[i]);
      c1 = min(c1, lo[i] + n[i] - 1);
    } else {
      all = false;
    }
  }
  if (!all || c0 > c1) {
    c0 = b + 1;
    c1 = b;
  }
}

// K7, axis 1.  Block (x0 = 32 * blockIdx.x, rows yb = TY * blockIdx.y ..
// yb + TY - 1 with TY = kOiiWarps * R and R = kOiiRows, planes d_lo = dc * blockIdx.z ..
// d_lo + nd - 1); lane = column x0 + lane, warp w = the rows yb + w * R + i,
// i < R.  Shared: two stages of one plane's volume rows rb + k, k in [0,
// TY + 2L) with rb = yb - L, of the block's 32 columns ([2][TY + 2L][32]
// f32; only rows whose frame row lies in 1 .. h_glob - 1 are copied, the
// others are never read), then the right arms [TY][32 + dc - 1] int2.
// vec: W % 4 == 0 and vol on a 16-byte boundary (rows staged in 16-byte
// cp.async; else 4-byte).  Per plane each thread walks the union of its R
// windows once, ascending, reading each staged row once and adding it to
// the outputs whose window holds it (unconditionally over the rows that all
// hold).  Lane = column: whatever rows the lanes read, no bank conflict.
__global__ void __launch_bounds__(kOiiThreads)
    oii_v_kernel(const float* __restrict__ vol, const int* __restrict__ arms_l,
                 const int* __restrict__ arms_r, float* __restrict__ out,
                 int D, int H, int W, int L, int d0, int row0, int h_glob,
                 int dc, int vec) {
  constexpr int R = kOiiRows, TY = kOiiWarps * R;
  extern __shared__ uint4 oii_smem[];
  const int Rs = TY + 2 * L;
  float* const stages = reinterpret_cast<float*>(oii_smem);
  int2* const arms_s = reinterpret_cast<int2*>(stages + 2 * 32 * Rs);
  const long long HW = (long long)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = 32 * blockIdx.x, yb = TY * blockIdx.y, x = x0 + lane;
  const int rb = yb - L;
  const int d_lo = dc * blockIdx.z, nd = min(dc, D - d_lo);
  const int aw = 32 + dc - 1, ca = max(x0 - d0 - d_lo - dc + 1, 0);
  // Volume rows whose frame row row0 + r lies in 1 .. h_glob - 1 (written
  // over r, with no negated row: nvcc 12.9 for sm_90a once dropped the
  // negation in max(-y, 1 - row0 - y)).
  const int r_first = max(0, 1 - row0), r_last = min(H - 1, h_glob - 1 - row0);

  auto fill = [&](int d, float* buf) {
    const float* src = vol + (long long)d * HW;
    if (vec) {
      for (int k = threadIdx.x; k < 8 * Rs; k += kOiiThreads) {
        const int r = rb + (k >> 3), cx = x0 + 4 * (k & 7);
        if (r >= r_first && r <= r_last && cx < W) {
          copy16(buf + 4 * k, src + r * W + cx);
        }
      }
    } else {
      for (int k = threadIdx.x; k < 32 * Rs; k += kOiiThreads) {
        const int r = rb + (k >> 5), cx = x0 + (k & 31);
        if (r >= r_first && r <= r_last && cx < W) {
          copy4(buf + k, src + r * W + cx);
        }
      }
    }
  };

  fill(d_lo, stages);
  commit();
  // The arms and the left arms load while plane d_lo is in flight.
  stage_right_arms(arms_s, arms_r + 2 * HW, arms_r + 3 * HW, H, W, yb, TY, ca,
                   aw);
  int ml[R], pl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int y = yb + warp * R + i;
    ml[i] = pl[i] = 0;
    if (x < W && y < H) {
      ml[i] = arms_l[2 * HW + y * W + x];
      pl[i] = arms_l[3 * HW + y * W + x];
    }
  }
  for (int k = 0; k < nd; ++k) {
    if (k + 1 < nd) fill(d_lo + k + 1, stages + 32 * Rs * ((k + 1) & 1));
    commit();
    wait_all_but_one();
    __syncthreads();  // plane k (and, at k = 0, the arms) in place
    const int d = d_lo + k;
    const float* col = stages + 32 * Rs * (k & 1) + lane;  // col[32 * (r - rb)]
    int lo[R], n[R];
    float div[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int y = yb + warp * R + i;
      lo[i] = n[i] = 0;
      div[i] = 1.0f;
      if (x < W && y < H) {
        const int2 ar = arms_s[(warp * R + i) * aw + max(x - d0 - d, 0) - ca];
        window(y, max(ml[i], ar.x), min(pl[i], ar.y), L, r_first, r_last,
               lo[i], n[i], div[i]);
      }
    }
    int a, b, c0, c1;
    union_and_core(lo, n, a, b, c0, c1);
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    for (int r = a; r < c0; ++r) add_masked(acc, lo, n, r, col[32 * (r - rb)]);
    for (int r = c0; r <= c1; ++r) {
      const float v = col[32 * (r - rb)];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += v;
    }
    for (int r = c1 + 1; r <= b; ++r) {
      add_masked(acc, lo, n, r, col[32 * (r - rb)]);
    }
    float* o = out + (long long)d * HW;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int y = yb + warp * R + i;
      if (x < W && y < H) o[y * W + x] = acc[i] / div[i];
    }
    __syncthreads();  // stage k & 1 is refilled at step k + 1
  }
}

// K7, axis 2.  Block (x0 = TX * blockIdx.x with TX = 32 * C and C =
// kOiiCols, rows yb = kOiiWarps * blockIdx.y .., planes as in axis 1); warp
// w = row yb + w, lane = the C columns x0 + C * lane + c.  Shared: two stages of one
// plane's row segments, columns sb + k, k in [0, TX + 2 LA) with LA = L
// rounded up to a multiple of 4 and sb = x0 - LA ([2][kOiiWarps][TX + 2 LA]
// f32; columns outside 0 .. W - 1 are not copied and never read), then the
// right arms [kOiiWarps][TX + dc - 1] int2.  vec: bit 0 = W % 4 == 0 and vol
// on a 16-byte boundary (16-byte cp.async, else 4-byte), bit 1 = W % C == 0
// and out on a 16-byte boundary (C-wide stores).  Per plane each thread
// walks the union of its C windows once, ascending, C columns a shared load
// (unconditionally over the groups of C columns that all its windows hold;
// before them it tests each window's start only, after them its end).
__global__ void __launch_bounds__(kOiiThreads)
    oii_h_kernel(const float* __restrict__ vol, const int* __restrict__ arms_l,
                 const int* __restrict__ arms_r, float* __restrict__ out,
                 int D, int H, int W, int L, int d0, int dc, int vec) {
  constexpr int C = kOiiCols, TX = 32 * C;
  static_assert(C == 2, "loads and stores below are float2");
  extern __shared__ uint4 oii_smem[];
  const int LA = (L + 3) & ~3, SW = TX + 2 * LA;
  float* const stages = reinterpret_cast<float*>(oii_smem);
  int2* const arms_s = reinterpret_cast<int2*>(stages + 2 * kOiiWarps * SW);
  const long long HW = (long long)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = TX * blockIdx.x, y = kOiiWarps * blockIdx.y + warp;
  const int xt = x0 + C * lane, sb = x0 - LA;
  const int d_lo = dc * blockIdx.z, nd = min(dc, D - d_lo);
  const int aw = TX + dc - 1, ca = max(x0 - d0 - d_lo - dc + 1, 0);

  // Warp w copies its own row's segment.
  auto fill = [&](int d, float* buf) {
    if (y >= H) return;
    const float* src = vol + (long long)d * HW + y * W;
    float* dst = buf + warp * SW;
    if (vec & 1) {
      for (int q = lane; 4 * q < SW; q += 32) {
        const int cx = sb + 4 * q;
        if (cx >= 0 && cx < W) copy16(dst + 4 * q, src + cx);
      }
    } else {
      for (int q = lane; q < SW; q += 32) {
        const int cx = sb + q;
        if (cx >= 0 && cx < W) copy4(dst + q, src + cx);
      }
    }
  };

  fill(d_lo, stages);
  commit();
  // The arms and the left arms load while plane d_lo is in flight.
  stage_right_arms(arms_s, arms_r, arms_r + HW, H, W, kOiiWarps * blockIdx.y,
                   kOiiWarps, ca, aw);
  int ml[C], pl[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ml[c] = pl[c] = 0;
    if (xt + c < W && y < H) {
      ml[c] = arms_l[y * W + xt + c];
      pl[c] = arms_l[HW + y * W + xt + c];
    }
  }
  for (int k = 0; k < nd; ++k) {
    if (k + 1 < nd) fill(d_lo + k + 1, stages + kOiiWarps * SW * ((k + 1) & 1));
    commit();
    wait_all_but_one();
    __syncthreads();  // plane k (and, at k = 0, the arms) in place
    const int d = d_lo + k;
    const float* row = stages + kOiiWarps * SW * (k & 1) + warp * SW;
    int lo[C], n[C];
    float div[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo[c] = n[c] = 0;
      div[c] = 1.0f;
      if (xt + c < W && y < H) {
        const int2 ar = arms_s[warp * aw + max(xt + c - d0 - d, 0) - ca];
        window(xt + c, max(ml[c], ar.x), min(pl[c], ar.y), L, 1, W - 1, lo[c],
               n[c], div[c]);
      }
    }
    int a, b, c0, c1;
    union_and_core(lo, n, a, b, c0, c1);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    if (a <= b) {
      // Groups of C columns g * C .. g * C + C - 1 (a >= 1: no negative g);
      // the core groups g0 .. g1 lie wholly inside every window.  Where
      // there are any, the groups before them lie at or below every
      // window's end (g0 * C - 1 <= c1 - C) and those after them at or
      // above every start ((g1 + 1) * C > c0).
      const int ga = a / C, gb = b / C;
      const int g0 = (c0 + C - 1) / C, g1 = (c1 + 1) / C - 1;
      auto at = [&](int g) {
        return *reinterpret_cast<const float2*>(row + (g * C - sb));
      };
      if (c0 <= c1 && g0 <= g1) {
        for (int g = ga; g < g0; ++g) {
          const float2 v = at(g);
          add_from(acc, lo, g * C, v.x);
          add_from(acc, lo, g * C + 1, v.y);
        }
        for (int g = g0; g <= g1; ++g) {
          const float2 v = at(g);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[c] += v.x;
            acc[c] += v.y;
          }
        }
        for (int g = g1 + 1; g <= gb; ++g) {
          const float2 v = at(g);
          add_until(acc, lo, n, g * C, v.x);
          add_until(acc, lo, n, g * C + 1, v.y);
        }
      } else {
        for (int g = ga; g <= gb; ++g) {
          const float2 v = at(g);
          add_masked(acc, lo, n, g * C, v.x);
          add_masked(acc, lo, n, g * C + 1, v.y);
        }
      }
    }
    if (y < H && xt < W) {
      float* o = out + (long long)d * HW + y * W + xt;
      float r[C];
#pragma unroll
      for (int c = 0; c < C; ++c) r[c] = acc[c] / div[c];
      if (vec & 2) {
        *reinterpret_cast<float2*>(o) = make_float2(r[0], r[1]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (xt + c < W) o[c] = r[c];
        }
      }
    }
    __syncthreads();  // stage k & 1 is refilled at step k + 1
  }
}

// Block (x0 = kVoteHTx * blockIdx.x, row blockIdx.y, planes d_lo .. d_lo +
// dc - 1 with d_lo = dc * blockIdx.z); shared: the tile [dc][kVoteHPitch],
// then the bins of columns clamp(x0 - L + k), k in [0, kVoteHTx + 2L).
// vec: W % 16 == 0 and rc on a 16-byte boundary (every tile row goes out in
// 16-byte stores).
__global__ void __launch_bounds__(kVoteHTx)
    vote_h_kernel(const int* __restrict__ idx, const int* __restrict__ arms_l,
                  uint8_t* __restrict__ rc, int D, int H, int W, int L, int dc,
                  int vec) {
  extern __shared__ uint4 vote_h_smem[];
  uint8_t* const tile = reinterpret_cast<uint8_t*>(vote_h_smem);
  int* const bins = reinterpret_cast<int*>(tile + dc * kVoteHPitch);
  const long long HW = (long long)H * W;
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * kVoteHTx, y = blockIdx.y;
  const int d_lo = blockIdx.z * dc;
  const int nd = min(dc, D - d_lo);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = t; i < nd * (kVoteHPitch / 16); i += kVoteHTx) {
    reinterpret_cast<uint4*>(tile)[i] = zero;
  }
  const int* row = idx + (long long)y * W;
  for (int k = t; k < kVoteHTx + 2 * L; k += kVoteHTx) {
    bins[k] = row[min(max(x0 - L + k, 0), W - 1)];
  }
  __syncthreads();
  const int x = x0 + t;
  if (x < W) {
    const long long p = (long long)y * W + x;
    const int lo = max(arms_l[p], -L);
    const int hi = min(arms_l[HW + p], L);
    const int* s = bins + t + L;
    // Runs of equal bins go to the tile as one add; a bin's plane in the
    // chunk is bin - d_lo, unsigned, so a bin outside it (negative, or at
    // D and above) is never counted and never indexes the tile.
    unsigned cur = 0u;
    int run = 0;
    for (int j = lo; j <= hi; ++j) {
      const unsigned k = (unsigned)s[j] - (unsigned)d_lo;
      if (k != cur) {
        if (run > 0 && cur < (unsigned)nd) {
          uint8_t* c = tile + cur * kVoteHPitch + t;
          *c = (uint8_t)(*c + run);
        }
        cur = k;
        run = 0;
      }
      ++run;
    }
    if (run > 0 && cur < (unsigned)nd) {
      uint8_t* c = tile + cur * kVoteHPitch + t;
      *c = (uint8_t)(*c + run);
    }
  }
  __syncthreads();
  const int w = min(kVoteHTx, W - x0);
  uint8_t* out = rc + (long long)d_lo * HW + (long long)y * W + x0;
  if (vec) {
    const int n16 = w / 16;
    for (int i = t; i < nd * n16; i += kVoteHTx) {
      const int r = i / n16, c = i - r * n16;
      *reinterpret_cast<uint4*>(out + r * HW + 16 * c) =
          reinterpret_cast<const uint4*>(tile + r * kVoteHPitch)[c];
    }
  } else {
    for (int i = t; i < nd * w; i += kVoteHTx) {
      const int r = i / w, c = i - r * w;
      out[r * HW + c] = tile[r * kVoteHPitch + c];
    }
  }
}

// Block (x0 = 32 * blockIdx.x, rows yb = G * TY * blockIdx.y ..), warps
// w = p * G + g: plane group p (planes [p * D / P, (p + 1) * D / P), two
// at a time), row warp g (output rows y0 = yb + g * TY ..); lane = column
// x0 + lane, with the TY pixels (y0 + i, x).  Shared: per plane group two
// stages of two planes [2][Rs][32] uint8, rows clamp(yb - L + r), r in
// [0, Rs), Rs = G * TY + 2L (`stage` bytes); per warp (`region` bytes) the
// prefix [Rw + 1][32] uint32 of its rows g * TY .. g * TY + Rw - 1, Rw =
// TY + 2L (row 0 zero), plane d in the low and plane d + 1 in the high
// half: each half is at most 255 * Rw <= 65535, so a 32-bit add never
// carries into the high half, and a difference of two prefix entries of
// one column never borrows from it; at the end the warp's best [TY][32]
// and best_d [TY][32] int32.  vec: W % 16 == 0 and rc on a 16-byte
// boundary (rows staged in 16-byte cp.async).
template <int TY>
__global__ void __launch_bounds__(32 * kVoteVRowWarps * kVoteVGroups, 2)
    vote_v_kernel(const uint8_t* __restrict__ rc,
                  const int* __restrict__ arms_l, int* __restrict__ mode,
                  int D, int H, int W, int L, int G, int stage, int region,
                  int vec) {
  extern __shared__ uint4 vote_v_smem[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(vote_v_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = (blockDim.x >> 5) / G;
  const int g = warp % G, pg = warp / G;
  const int Rw = TY + 2 * L, Rs = G * TY + 2 * L;
  uint8_t* const stages = base + pg * stage;
  const int mine = P * stage + warp * region;  // bytes from base
  uint32_t* const pre = reinterpret_cast<uint32_t*>(base + mine) + lane;
  const long long HW = (long long)H * W;
  const int x0 = 32 * blockIdx.x, yb = G * TY * blockIdx.y, x = x0 + lane;
  const int y0 = yb + g * TY;

  // Window of pixel i: rows y + [lo, hi] (clipped to [-L, L]; empty where
  // hi < lo, and outside the frame) = the warp's rows i + L + lo .. i + L +
  // hi, summed as pre[i + L + hi + 1] - pre[i + L + lo]; oa / ob are those
  // entries' byte offsets from base.
  int oa[TY], ob[TY], best[TY], best_d[TY];
#pragma unroll
  for (int i = 0; i < TY; ++i) {
    const int y = y0 + i;
    int lo = 0, hi = -1;
    if (x < W && y < H) {
      const long long p = (long long)y * W + x;
      lo = min(max(arms_l[2 * HW + p], -L), L + 1);
      hi = max(min(arms_l[3 * HW + p], L), lo - 1);
    }
    oa[i] = mine + 4 * lane + 128 * (i + L + hi + 1);
    ob[i] = mine + 4 * lane + 128 * (i + L + lo);
    best[i] = -1;
    best_d[i] = 0;
  }
  pre[0] = 0u;

  // The plane group's 32 * G threads copy plane d's rows clamp(yb - L + r,
  // 0, H - 1): CLAMP_TO_EDGE re-counts the border rows.
  const int t = 32 * g + lane, nt = 32 * G;
  auto fill = [&](int d, uint8_t* buf) {
    const uint8_t* src = rc + (long long)d * HW;
    if (vec) {
      for (int k = t; k < 2 * Rs; k += nt) {
        const int r = k >> 1, cx = x0 + 16 * (k & 1);
        if (cx < W) {
          const int gy = min(max(yb - L + r, 0), H - 1);
          copy16(buf + 32 * r + 16 * (k & 1), src + (long long)gy * W + cx);
        }
      }
    } else if (x < W) {
      for (int r = g; r < Rs; r += G) {
        const int gy = min(max(yb - L + r, 0), H - 1);
        buf[32 * r + lane] = src[(long long)gy * W + x];
      }
    }
  };

  // Step st: planes d = d_begin + 2 st and d + 1 (where d + 1 < d_end) into
  // stage st & 1.
  const int d_begin = (int)((long long)pg * D / P);
  const int d_end = (int)((long long)(pg + 1) * D / P);
  const int steps = (d_end - d_begin + 1) / 2;
  auto fill_step = [&](int st) {
    uint8_t* buf = stages + 64 * Rs * (st & 1);
    const int d = d_begin + 2 * st;
    fill(d, buf);
    if (d + 1 < d_end) fill(d + 1, buf + 32 * Rs);
  };
  if (steps > 0) fill_step(0);
  commit();
  for (int st = 0; st < steps; ++st) {
    group_sync(1 + pg, nt);  // the group has summed the stage refilled next
    if (st + 1 < steps) fill_step(st + 1);
    commit();
    wait_all_but_one();
    // Step st's planes, copied by the whole group, are in place.
    group_sync(1 + pg, nt);
    // Column prefix of the warp's Rw rows of both planes, 8 rows of loads
    // in flight at a time.  Without a second plane the high half sums
    // whatever the stage holds and is never read.
    const uint8_t* c0 = stages + 64 * Rs * (st & 1) + 32 * g * TY + lane;
    const uint8_t* c1 = c0 + 32 * Rs;
    uint32_t s = 0u;
    int r = 0;
    for (; r + 8 <= Rw; r += 8) {
      uint32_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = c0[32 * (r + q)] | (uint32_t)c1[32 * (r + q)] << 16;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s += v[q];
        pre[32 * (r + q + 1)] = s;
      }
    }
    for (; r < Rw; ++r) {
      s += c0[32 * r] | (uint32_t)c1[32 * r] << 16;
      pre[32 * (r + 1)] = s;
    }
    // A lane reads only its own column of pre: no barrier.
    const int d = d_begin + 2 * st;
    const bool second = d + 1 < d_end;
#pragma unroll
    for (int i = 0; i < TY; ++i) {
      const uint32_t diff = *reinterpret_cast<const uint32_t*>(base + oa[i]) -
                            *reinterpret_cast<const uint32_t*>(base + ob[i]);
      const int t0 = (int)(diff & 0xffffu), t1 = (int)(diff >> 16);
      if (t0 >= best[i]) {  // ascending d: '>=' keeps the highest d on ties
        best[i] = t0;
        best_d[i] = d;
      }
      if (second && t1 >= best[i]) {
        best[i] = t1;
        best_d[i] = d + 1;
      }
    }
  }

  __syncwarp();  // the warp's lanes are done with its prefix
  int* const res = reinterpret_cast<int*>(base + mine);
#pragma unroll
  for (int i = 0; i < TY; ++i) {
    res[32 * i + lane] = best[i];
    res[32 * (TY + i) + lane] = best_d[i];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 32 * G * TY; q += blockDim.x) {
    const int row = q >> 5, gq = row / TY, iq = row - gq * TY;
    const int xq = x0 + (q & 31), yq = yb + row;
    const int e = 32 * iq + (q & 31);
    int bv = -1, bd = 0;
    for (int pq = 0; pq < P; ++pq) {  // ascending plane groups, '>=' again
      const int* rw = reinterpret_cast<const int*>(
          base + P * stage + (pq * G + gq) * region);
      if (rw[e] >= bv) {
        bv = rw[e];
        bd = rw[32 * TY + e];
      }
    }
    if (xq < W && yq < H) mode[(long long)yq * W + xq] = bd;
  }
}

template <int TY>
int launch_vote_v(const uint8_t* rc, const int* arms_l, int* mode, int D,
                  int H, int W, int L, int G, int P, int stage, int region,
                  int shared, int vec, cudaStream_t s) {
  auto kernel = vote_v_kernel<TY>;
  const unsigned gy = (unsigned)((H + G * TY - 1) / (G * TY));
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((W + 31) / 32, gy), 32 * G * P, shared, s>>>(
      rc, arms_l, mode, D, H, W, L, G, stage, region, vec);
  return (int)cudaGetLastError();
}

// Launches one K7 kernel over a grid of blocks of kOiiThreads threads.
template <typename Kernel, typename... Args>
int launch_oii(Kernel kernel, dim3 grid, int shared, cudaStream_t s,
               Args... args) {
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kOiiThreads, shared, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// img: (H, W, 3) f32, frame rows row0 .. row0 + H - 1 of an h_glob-row
// frame; arms: (4, H, W) int32.  The plan is kernels/cross_oii.py
// arms_tiles: the halo R, rows ty_v of a v tile, blocks_v v tiles, blocks_h
// h tiles, `shared` bytes a block.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not match the frame or the
// compiled layout.
extern "C" int cross_arms_f32(const float* img, int* arms, int H, int W,
                              int arm_len, int first_dist, float tau,
                              int row0, int h_glob, int R, int ty_v,
                              int blocks_v, int blocks_h, int shared,
                              void* stream) {
  if ((long long)H * W == 0) return (int)cudaGetLastError();
  const int gx_v = (W + kArmsVx - 1) / kArmsVx;
  const int gx_h = (W + kArmsHx - 1) / kArmsHx;
  const long long v_bytes = 12LL * kArmsVx * (ty_v + 2LL * R);
  const long long h_bytes = 16LL * (kArmsHx + 2LL * R);
  if (arm_len < 1 || first_dist < 1 || h_glob < 1 ||
      (long long)H * W > 0x7fffffffLL ||
      R != first_dist + (long long)arm_len - 2 || ty_v < kArmsWarps ||
      ty_v % kArmsWarps != 0 ||
      (long long)blocks_v != gx_v * (((long long)H + ty_v - 1) / ty_v) ||
      (long long)blocks_h != (long long)gx_h * H ||
      (long long)blocks_v + blocks_h > 0x7fffffffLL ||
      shared != (v_bytes > h_bytes ? v_bytes : h_bytes) ||
      shared > kSharedLimit) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cross_arms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  cross_arms_kernel<<<blocks_v + blocks_h, kArmsThreads, shared,
                      (cudaStream_t)stream>>>(
      img, arms, H, W, arm_len, first_dist, tau, row0, h_glob, R, ty_v, gx_v,
      blocks_v, gx_h, W % 4 == 0 && ((uintptr_t)img & 15) == 0);
  return (int)cudaGetLastError();
}

// vol, out: (D, H, W) f32, plane k = disparity d0 + k; arms_l, arms_r:
// (4, H, W) int32; axis 2 = horizontal (h arms), 1 = vertical (v arms),
// whose rows are frame rows row0 .. row0 + H - 1 of an h_glob-row frame.
// The plan is kernels/cross_oii.py oii_tiles: dc planes per chunk in
// `chunks` chunks, a plane's `stage` bytes, the chunk's right arms' `arm`
// bytes, `shared` bytes a block.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another axis or a plan that does not cover the
// D planes or does not match the shared layout.
extern "C" int oii_pass_f32(const float* vol, const int* arms_l,
                            const int* arms_r, float* out, int D, int H,
                            int W, int L, int d0, int axis, int row0,
                            int h_glob, int dc, int chunks, int stage, int arm,
                            int shared, void* stream) {
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if ((long long)D * H * W == 0) return (int)cudaGetLastError();
  if (L < 0 || L > 65535 || dc < 1 || chunks < 1 || chunks > 65535 ||
      (long long)H * W > 0x7fffffffLL || (long long)dc * (chunks - 1) >= D ||
      (long long)dc * chunks < D) {
    return (int)cudaErrorInvalidValue;
  }
  const int tx = axis == 1 ? 32 : 32 * kOiiCols;
  const int ty = axis == 1 ? kOiiWarps * kOiiRows : kOiiWarps;
  const long long want_stage =
      axis == 1 ? 4LL * 32 * (ty + 2 * L)
                : 4LL * ty * (tx + 2 * ((L + 3) & ~3));
  const long long want_arm = 8LL * ty * (tx + dc - 1);
  if (stage != want_stage || arm != want_arm ||
      shared != 2LL * stage + arm || shared > kSharedLimit) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((W + tx - 1) / tx, (H + ty - 1) / ty, chunks);
  const int vec_in = W % 4 == 0 && ((uintptr_t)vol & 15) == 0;
  const int vec_out = W % kOiiCols == 0 && ((uintptr_t)out & 15) == 0;
  if (axis == 1) {
    return launch_oii(oii_v_kernel, grid, shared, s, vol, arms_l, arms_r, out,
                      D, H, W, L, d0, row0, h_glob, dc, vec_in);
  }
  return launch_oii(oii_h_kernel, grid, shared, s, vol, arms_l, arms_r, out,
                    D, H, W, L, d0, dc, vec_in | 2 * vec_out);
}

// idx: (H, W) int32 bins; arms_l: (4, H, W) int32; rc: (D, H, W) uint8.
// The plan is kernels/cross_oii.py vote_h_tiles: dc planes per chunk in
// `chunks` chunks, `shared` bytes a block.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not cover the D planes or does
// not match the shared layout.
extern "C" int vote_h_u8(const int* idx, const int* arms_l, uint8_t* rc,
                         int D, int H, int W, int L, int dc, int chunks,
                         int shared, void* stream) {
  if ((long long)D * H * W == 0) return (int)cudaGetLastError();
  if (L < 0 || dc < 1 || chunks < 1 || chunks > 65535 || H > 65535 ||
      (long long)dc * (chunks - 1) >= D || (long long)dc * chunks < D ||
      shared != dc * kVoteHPitch + 4 * (kVoteHTx + 2 * L) ||
      shared > kSharedLimit) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      vote_h_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  const int vec = W % 16 == 0 && ((uintptr_t)rc & 15) == 0;
  vote_h_kernel<<<dim3((W + kVoteHTx - 1) / kVoteHTx, H, chunks), kVoteHTx,
                  shared, (cudaStream_t)stream>>>(idx, arms_l, rc, D, H, W, L,
                                                  dc, vec);
  return (int)cudaGetLastError();
}

// rc: (D, H, W) uint8; arms_l: (4, H, W) int32; mode: (H, W) int32.  The
// plan is kernels/cross_oii.py vote_v_tiles: TY rows a warp, G row warps, P
// plane groups, a group's `stage` bytes, a warp's `region` bytes, `shared`
// bytes a block.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan that does not match the shared layout.
extern "C" int vote_v_i32(const uint8_t* rc, const int* arms_l, int* mode,
                          int D, int H, int W, int L, int ty, int G, int P,
                          int stage, int region, int shared, void* stream) {
  if ((long long)H * W == 0) return (int)cudaGetLastError();
  const int rw = ty + 2 * L;
  if (L < 0 || G < 1 || G > kVoteVRowWarps || P < 1 || P > kVoteVGroups ||
      rw > kVoteVRows || stage != 128 * (G * ty + 2 * L) || region % 16 ||
      region < 128 * (rw + 1) || region < 256 * ty ||
      shared != P * stage + G * P * region || shared > kSharedLimit) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = W % 16 == 0 && ((uintptr_t)rc & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define VOTE_V(T)                                                         \
  case T:                                                                 \
    return launch_vote_v<T>(rc, arms_l, mode, D, H, W, L, G, P, stage,    \
                            region, shared, vec, s)
  switch (ty) {
    VOTE_V(16);
    VOTE_V(8);
    VOTE_V(4);
    VOTE_V(2);
    VOTE_V(1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VOTE_V
}
