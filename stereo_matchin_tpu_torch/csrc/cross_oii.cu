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
// Bound: K7 and K8's count are memory-bound volume passes: one thread per
// output element, x fastest, so loads and stores are coalesced and the up
// to 2L+1 taps of neighbouring threads share cache lines (L1/L2).  K5 and
// K8's mode run one thread per pixel; K8's mode reads D * (vp - vm + 1)
// bytes per pixel through L1/L2.  Tiling through shared memory is later
// work.  The anchoring (row0, h_glob) serves the band drivers: a band's
// window of rows gives every kept row the values of the whole frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

__global__ void cross_arms_kernel(const float* __restrict__ img,
                                  int* __restrict__ arms, int H, int W,
                                  int arm_len, int first_dist, float tau,
                                  int row0, int h_glob) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int x = (int)(p % W);
  const int y = (int)(p / W);
  const int gy = min(max(row0 + y, 0), h_glob - 1);
  const float c0 = img[p * 3], c1 = img[p * 3 + 1], c2 = img[p * 3 + 2];
  const int dys[4] = {0, 0, -1, 1};
  const int dxs[4] = {-1, 1, 0, 0};
  for (int k = 0; k < 4; ++k) {
    int arm = 1;
    for (int dist = first_dist; dist < first_dist + arm_len - 1; ++dist) {
      const int gny = gy + dys[k] * dist, nx = x + dxs[k] * dist;
      if (gny < 0 || gny > h_glob - 1 || nx < 0 || nx > W - 1) break;
      const int ny = min(max(y + dys[k] * dist, 0), H - 1);
      const float* nb = img + ((long long)ny * W + nx) * 3;
      if (!(fabsf(nb[0] - c0) < tau && fabsf(nb[1] - c1) < tau &&
            fabsf(nb[2] - c2) < tau)) {
        break;
      }
      ++arm;
    }
    arms[k * HW + p] = (k % 2 == 0) ? -arm : arm;
  }
}

template <int AXIS>
__global__ void oii_pass_kernel(const float* __restrict__ vol,
                                const int* __restrict__ arms_l,
                                const int* __restrict__ arms_r,
                                float* __restrict__ out, int D, int H, int W,
                                int L, int d0, int row0, int h_glob) {
  const long long HW = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HW * D) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int d = (int)(i / HW);
  const long long pl = (long long)y * W + x;
  const long long pr = (long long)y * W + max(x - d0 - d, 0);
  const int pm = AXIS == 2 ? 0 : 2;  // minus plane; the plus plane follows
  const int m = max(arms_l[pm * HW + pl], arms_r[pm * HW + pr]);
  const int p = min(arms_l[(pm + 1) * HW + pl], arms_r[(pm + 1) * HW + pr]);
  float acc = 0.0f;
  if (AXIS == 2) {
    // Taps j with column x + j in 1 .. W-1.
    const int lo = max(max(m, -L), 1 - x);
    const int hi = min(min(p, L), W - 1 - x);
    const float* src = vol + i;
    for (int j = lo; j <= hi; ++j) {
      acc = acc + src[j];
    }
  } else {
    // Taps as volume rows r = y + j, ascending: rows of the volume whose
    // frame row row0 + r lies in 1 .. h_glob-1.  (Written over r, not as
    // max(-y, 1 - row0 - y) on j: nvcc 12.9 for sm_90a dropped that
    // negation.)
    const int r_lo = max(max(0, 1 - row0), y + max(m, -L));
    const int r_hi = min(min(H - 1, h_glob - 1 - row0), y + min(p, L));
    const float* col = vol + (i - (long long)y * W);
    for (int r = r_lo; r <= r_hi; ++r) {
      acc = acc + col[(long long)r * W];
    }
  }
  out[i] = acc / (float)(p - m);
}

__global__ void vote_h_kernel(const int* __restrict__ idx,
                              const int* __restrict__ arms_l,
                              uint8_t* __restrict__ rc, int D, int H, int W,
                              int L) {
  const long long HW = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HW * D) return;
  const int x = (int)(i % W);
  const long long p = i % HW;
  const int d = (int)(i / HW);
  const int hm = max(arms_l[p], -L);
  const int hp = min(arms_l[HW + p], L);
  const int* row = idx + (p - x);
  int count = 0;
  for (int j = hm; j <= hp; ++j) {
    count += row[min(max(x + j, 0), W - 1)] == d;
  }
  rc[i] = (uint8_t)count;
}

__global__ void vote_v_kernel(const uint8_t* __restrict__ rc,
                              const int* __restrict__ arms_l,
                              int* __restrict__ mode, int D, int H, int W,
                              int L) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int x = (int)(p % W);
  const int y = (int)(p / W);
  const int vm = max(arms_l[2 * HW + p], -L);
  const int vp = min(arms_l[3 * HW + p], L);
  int best = -1, best_d = 0;
  for (int d = 0; d < D; ++d) {
    const uint8_t* col = rc + d * HW + x;
    int tab = 0;
    for (int k = vm; k <= vp; ++k) {
      tab += col[(long long)min(max(y + k, 0), H - 1) * W];
    }
    if (tab >= best) {  // ascending d: '>=' keeps the highest d on ties
      best = tab;
      best_d = d;
    }
  }
  mode[p] = best_d;
}

}  // namespace

// img: (H, W, 3) f32, frame rows row0 .. row0 + H - 1 of an h_glob-row
// frame; arms: (4, H, W) int32.  Returns cudaGetLastError().
extern "C" int cross_arms_f32(const float* img, int* arms, int H, int W,
                              int arm_len, int first_dist, float tau,
                              int row0, int h_glob, void* stream) {
  const long long n = (long long)H * W;
  if (n > 0) {
    cross_arms_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        img, arms, H, W, arm_len, first_dist, tau, row0, h_glob);
  }
  return (int)cudaGetLastError();
}

// vol, out: (D, H, W) f32, plane k = disparity d0 + k; arms_l, arms_r:
// (4, H, W) int32; axis 2 = horizontal (h arms), 1 = vertical (v arms),
// whose rows are frame rows row0 .. row0 + H - 1 of an h_glob-row frame.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another axis.
extern "C" int oii_pass_f32(const float* vol, const int* arms_l,
                            const int* arms_r, float* out, int D, int H,
                            int W, int L, int d0, int axis, int row0,
                            int h_glob, void* stream) {
  const long long n = (long long)D * H * W;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (axis == 2) {
      oii_pass_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(
          vol, arms_l, arms_r, out, D, H, W, L, d0, row0, h_glob);
    } else {
      oii_pass_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(
          vol, arms_l, arms_r, out, D, H, W, L, d0, row0, h_glob);
    }
  }
  return (int)cudaGetLastError();
}

// idx: (H, W) int32 bins; arms_l: (4, H, W) int32; rc: (D, H, W) uint8.
// Returns cudaGetLastError().
extern "C" int vote_h_u8(const int* idx, const int* arms_l, uint8_t* rc,
                         int D, int H, int W, int L, void* stream) {
  const long long n = (long long)D * H * W;
  if (n > 0) {
    vote_h_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        idx, arms_l, rc, D, H, W, L);
  }
  return (int)cudaGetLastError();
}

// rc: (D, H, W) uint8; arms_l: (4, H, W) int32; mode: (H, W) int32.
// Returns cudaGetLastError().
extern "C" int vote_v_i32(const uint8_t* rc, const int* arms_l, int* mode,
                          int D, int H, int W, int L, void* stream) {
  const long long n = (long long)H * W;
  if (n > 0) {
    vote_v_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        rc, arms_l, mode, D, H, W, L);
  }
  return (int)cudaGetLastError();
}
