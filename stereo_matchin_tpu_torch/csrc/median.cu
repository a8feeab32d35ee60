// 3x3 median on Hopper: kernel K12, per channel, clamp-to-edge reads,
// shared-memory tiles.
//
// Replaces no pallas_call: it is the port's counterpart of the XLA fusion
// of stereo_matchin_tpu/ops/median.py median3x3 (:27), the 19-exchange
// selection network over the nine edge-clamped taps, which the JAX package
// runs inside its jitted frames (the ASW median and the cross method's
// three medians).  The plain version is ops/median.py median3x3_plain.
//
// The image is (H, W, C) f32 in the caller's layout, C = 1 for an (H, W)
// map: a row is W * C floats, and the horizontal neighbours of element e
// (channel c of pixel x) are e - C and e + C, so a tile is a range of a
// row's elements and needs no division by C.  Block (bx, by) owns elements
// [e0, e0 + kThreadsK12) of rows [y0, y0 + ty), one element a thread.  It
// stages the (ty + 2) x (kThreadsK12 + 2C) halo in shared memory with
// coalesced 4-byte cp.async copies (each row once, clamped to the frame as
// the plain version's edge pad: row -1 is row 0, element -C + c is c, and
// element W * C + c is (W - 1) * C + c), then each thread walks its column
// of rows top to bottom.  Tap k = 3 * dy + dx is (row y + dy - 1, element
// e + (dx - 1) * C).  The network's first nine exchanges sort each row's
// triple (taps 0-2, 3-5, 6-8) apart from the other two, so a thread sorts
// each staged row's triple once and slides the three sorted triples down
// in registers (3 new taps a row), then runs the other ten exchanges in
// the network's order: every slot sees the same fminf / fmaxf sequence as
// in _MED9_NET, so the same bits, signed zeros included.  fminf / fmaxf are
// what torch.minimum / torch.maximum compute on the card for inputs that
// are not NaN, and the inputs (images in [0, 1], disparity maps) are
// finite.
//
// Bound: bytes, the image read once and the result written once.  The
// staged halo adds 2 / ty of the rows and 2C / kThreadsK12 of the columns
// (L2 serves most of it); ty is the tallest of 32, 16, ..., 2 that still
// gives kBlocksK12 blocks, so small frames fill the card.  The 10 remaining
// exchanges and a third of the sort cost 26 min/max a pixel at most, under
// the bytes' time at config 3.
//
// The parent design, one thread an element reading its nine taps through
// L1 after four 64-bit divisions and modulos by W and C, ran at 27% of the
// bytes' time at config 3; this one, in turns with it on one card (NVIDIA
// H100 80GB HBM3, 700 W; scripts/kernel_turns.py): the 1988 x 2880 x 3
// image 0.152 -> 0.065 ms (bound 0.041), the map 0.053 -> 0.025 (bound
// 0.014), 288 x 384 0.0050 -> 0.0043 and 0.0033 -> 0.0032 (launch-sized).
// Tried and dropped: 256 elements a tile (0.070 ms on the config-3 image);
// 16-row tiles at most and 2112 blocks (0.064 / 0.024 ms, inside the
// calls' spread of the 32-row tiles).

#include <cuda_runtime.h>

namespace {

// K12's plan (median3x3_plan hands it to the wrapper).
constexpr int kThreadsK12 = 128;  // elements of a row a block
constexpr int kTyMaxK12 = 32;     // rows a block, at most
constexpr int kTyMinK12 = 2;
constexpr int kBlocksK12 = 1056;  // 8 blocks on each of 132 SMs
constexpr int kSmemMaxK12 = 48 * 1024;

__device__ __forceinline__ void exchange(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The network's first nine exchanges on one row's triple (slots 3r, 3r + 1,
// 3r + 2): (1, 2), (0, 1), (1, 2) in the row's slots.
__device__ __forceinline__ void sort3(float& a, float& b, float& c) {
  exchange(b, c);
  exchange(a, b);
  exchange(b, c);
}

// CT: C compiled in (1, 3), or 0 for any C (runtime `c_rt`).
template <int CT>
__global__ void __launch_bounds__(kThreadsK12)
    median3x3_kernel(const float* __restrict__ img, float* __restrict__ out,
                     int H, int WC, int c_rt, int ty) {
  extern __shared__ float tile[];
  const int C = CT > 0 ? CT : c_rt;
  const int sw = kThreadsK12 + 2 * C;   // a staged row, in floats
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kThreadsK12, y0 = blockIdx.y * ty;
  for (int r = 0; r < ty + 2; ++r) {
    const int gy = min(max(y0 - 1 + r, 0), H - 1);
    const float* src = img + gy * WC;
    for (int k = tid; k < sw; k += kThreadsK12) {
      int e = e0 - C + k;
      if (e < 0) {
        e += C;
      } else if (e >= WC) {
        e = e < WC + C ? e - C : WC - 1;   // past W: read by no output
      }
      cp_async4(tile + r * sw + k, src + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int e = e0 + tid;
  if (e >= WC) return;
  const float* col = tile + tid;   // taps at col[r * sw + {0, C, 2C}]
  float a0 = col[0], a1 = col[C], a2 = col[2 * C];
  float b0 = col[sw], b1 = col[sw + C], b2 = col[sw + 2 * C];
  sort3(a0, a1, a2);
  sort3(b0, b1, b2);
  const int rows = min(ty, H - y0);
  for (int r = 0; r < rows; ++r) {
    const float* nx = col + (r + 2) * sw;
    float c0 = nx[0], c1 = nx[C], c2 = nx[2 * C];
    sort3(c0, c1, c2);
    float t[9] = {a0, a1, a2, b0, b1, b2, c0, c1, c2};
    // The network of ops/median.py _MED9_NET after its first nine, in its
    // order.
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
    out[(y0 + r) * WC + e] = t[4];
    a0 = b0;
    a1 = b1;
    a2 = b2;
    b0 = c0;
    b1 = c1;
    b2 = c2;
  }
}

// K12's plan: rows a block, the grid and the staged tile's bytes; ty = 0
// where no tile fits.
void median_plan(int H, int W, int C, int* ty, int* gx, int* gy,
                 int* smem) {
  const long long WC = (long long)W * C;
  const long long row = (long long)(kThreadsK12 + 2 * C) * 4;
  *gx = (int)((WC + kThreadsK12 - 1) / kThreadsK12);
  int t = kTyMaxK12;
  while (t > kTyMinK12 && ((long long)*gx * ((H + t - 1) / t) < kBlocksK12 ||
                           (t + 2) * row > kSmemMaxK12)) {
    t /= 2;
  }
  *ty = (t + 2) * row > kSmemMaxK12 ? 0 : t;
  *gy = (H + t - 1) / t;
  *smem = (int)((t + 2) * row);
}

}  // namespace

// K12's plan for an (H, W, C) image, for the wrapper (kernels/median.py
// median_tiles): out[0 .. 4] = elements of a row a tile (threads a
// block), rows a tile (0 where no tile fits), tiles along a row and down
// the rows, bytes of dynamic shared memory.
extern "C" void median3x3_plan(int H, int W, int C, int* out) {
  out[0] = kThreadsK12;
  median_plan(H, W, C, out + 1, out + 2, out + 3, out + 4);
}

// img, out: (H, W, C) f32, contiguous, C >= 1, H * W * C < 2^31.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel
// cannot run.
extern "C" int median3x3_f32(const float* img, float* out, int H, int W,
                             int C, void* stream) {
  if (H < 0 || W < 0 || C < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)H * W * C;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  int ty, gx, gy, smem;
  median_plan(H, W, C, &ty, &gx, &gy, &smem);
  if (ty == 0 || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1) {
    median3x3_kernel<1><<<grid, kThreadsK12, smem, s>>>(img, out, H, W, C, ty);
  } else if (C == 3) {
    median3x3_kernel<3><<<grid, kThreadsK12, smem, s>>>(img, out, H, 3 * W, C,
                                                        ty);
  } else {
    median3x3_kernel<0><<<grid, kThreadsK12, smem, s>>>(img, out, H, W * C, C,
                                                        ty);
  }
  return (int)cudaGetLastError();
}
