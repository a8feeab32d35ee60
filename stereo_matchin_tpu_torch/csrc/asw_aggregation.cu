// ASW cost aggregation on Hopper: kernels K1 (denominator) and K2 (one
// vertical or horizontal pass, and the windowed vertical pass), in the
// port's (D, H, W) / (T, H, W) f32 layouts.
//
// Replaces the TPU kernels of stereo_matchin_tpu/kernels/asw_aggregation_dres.py:
//   K1 (mode 0) <- asw_den_dres   (_den_kernel)
//   K2 (mode 1) <- asw_vpass_dres (_v_kernel), vertical taps
//      (mode 2) <- asw_hpass_dres (_h_kernel), horizontal taps
//      (mode 3) <- asw_vpass_dres_win (_v_kernel over caller-supplied
//                  margin rows), the wavefront band driver's pass
// and, through d0 (a disparity chunk's offset), the (D, H, W) grid kernels
// of kernels/asw_aggregation.py (asw_den_pallas, asw_vpass_pallas,
// asw_hpass_pallas) on the d-chunked path of models/asw.py.
//
//   K1: den[d,y,x] = eps + sum_t wl[t,y,x] * wr[t,y,max(x-d0-d,0)]
//   K2: num = eps; num += (wl[t,y,x] * wr[t,y,max(x-d0-d,0)]) * cost[d, nb_t]
//       out = num / den          nb_t: y+t-R (mode 1) or x+t-R (mode 2),
//       clamped to the frame; mode 3: cost is (D, H+T-1, W) of real rows
//       and nb_t = row y+t, no clamp
//
// Numerics: built with --fmad=false and without -use_fast_math, so every
// product and sum is rounded once, in t order, and the divide is IEEE --
// the same operations as ops/aggregation.py asw_den_plain / asw_pass_plain /
// asw_pass_win_plain, which these kernels equal bit for bit.  Tiling moves
// where an output is computed and where its operands come from, never the
// order of its operations.  Offsets into a volume are 64-bit: a
// Middlebury-2014 volume holds 1.6e9 elements.
//
// Bound: bytes.  A launch must read the two weight strips (2 T H W floats),
// the cost and den volumes (D H W each) and write D H W: at BASELINE
// config 3 (1988x2880, a 70-plane chunk, T = 33) 6.3 GB for K2, 1.89 ms at
// 3.35 TB/s; its 3 D T H W float operations (mul, mul, add, unfused) take
// 0.6 ms at 67 TFLOP/s.  The first port (one thread per (d, y, x), d the
// slowest grid index) re-read all 2T weight rows of every pixel for each
// plane: the strips (1.5 GB) do not fit the 50 MB L2, so a launch moved
// ~106 GB.  Here a block owns a tile of by x bx pixels and walks every
// plane of the call:
//   - the tile's left weights are read once: into registers (T values per
//     thread) where the tap count is compiled in, else into shared memory;
//   - for each span of planes [s0, s0 + sn) the right-weight row segment
//     columns x0 - d0 - (s0 + sn - 1) .. x0 + bx - 1 - d0 - s0 is staged
//     once, clamped at column 0 while staging, so the taps read it with no
//     branch (column 0 repeats where x - d0 - d < 0, as shifted_columns);
//   - for each group of G planes the cost taps of the tile with their
//     R-row (mode 1), R-column (mode 2) or T-1-row (mode 3) halo are
//     staged, clamped at the frame edge (mode 3 reads real rows), the next
//     group's tile in flight (cp.async) while this one is summed;
//   - each thread keeps the G sums of its pixel in registers, reads den
//     once per output and writes each output once.
// So the weights come from DRAM about once per launch.  Weight rows are
// staged 16 bytes per lane where four columns lie inside the frame on an
// aligned address, 4 bytes with the clamp elsewhere; cost taps 4 bytes per
// lane, the G planes of a tap side by side for one vector load.  The tile
// sizes, span, group, grid and shared bytes are planned in Python
// (kernels/asw_aggregation.py aggregation_tiles) and checked here against
// the layout below.  Tensor
// cores do not apply: no operand matrix is shared and the f32 order is
// fixed.  Measured at config 3 on an H100 (PERF.md section 6): K1 2.1 ms,
// K2 h 4.6 ms, K2 v 8.1 ms; what bounds them now is the staging from L2,
// which does not overlap the taps, most in the vertical pass, whose
// 12-row tiles stage a 3.7x cost halo.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSharedLimit = 232448;  // 227 KB, a block's most on sm_90

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Shared layout, in floats: left weights [T][by][bx] (none when the tap
// count is compiled in) and 8 floats of padding (the discarded sums of a
// short group read up to G - 1 floats before a segment row), right-weight
// segments [T][by][sw], then two cost tiles [crows][crow][G] (the G planes
// of a tap side by side, read with one vector load); every part starts on
// a 16-byte boundary.
struct Layout {
  int sw, crow, crows;
  long long sl, sr, sc, total;
};

Layout layout(int mode, int T, int bx, int by, int span, int group,
              bool baked) {
  Layout L;
  L.sw = bx + round4(span + 5);  // the segment staged from an aligned column
  L.crow = mode == 2 ? round4(bx + T - 1) : bx;
  L.crows = mode == 2 ? by : by + T - 1;
  L.sl = (baked ? 0 : (long long)T * by * bx) + 8;
  L.sr = (long long)T * by * L.sw;
  L.sc = mode == 0 ? 0 : 2LL * group * L.crows * L.crow;
  L.total = L.sl + L.sr + L.sc;
  return L;
}

// Asynchronous copies global -> shared: 4 bytes (cp.async.ca) or 16 bytes
// (cp.async.cg, L2 only); a thread issues all its copies of a stage without
// waiting on any of them.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The threads of a block stage `rows` rows of n floats: row r is read from
// row_ptr(r) at frame columns col0 + c, c in [0, n), clamped to [0, W - 1],
// and lands at dst + r * stride.  n, stride and dst are multiples of 4
// floats.  A thread row (blockDim.x lanes) copies blockDim.x / (n / 4) rows
// at once, one 4-column chunk per lane: 16 bytes where the chunk lies
// inside the frame on an aligned address, four clamped 4-byte copies
// elsewhere.
template <typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int stride, int rows,
                                           int n, int col0, int W,
                                           RowPtr row_ptr) {
  const int nch = n / 4, bx = blockDim.x;
  const int per = nch < bx ? bx / nch : 1;     // rows per thread row
  const int sub = threadIdx.x / (nch < bx ? nch : bx);
  const int ch0 = nch < bx ? threadIdx.x % nch : threadIdx.x;
  if (sub >= per) return;
  for (int r = threadIdx.y * per + sub; r < rows; r += blockDim.y * per) {
    const float* src = row_ptr(r);
    float* d = dst + r * stride;
    for (int ch = ch0; ch < nch; ch += (nch < bx ? nch : bx)) {
      const int c = col0 + 4 * ch;
      if (c >= 0 && c + 3 < W && ((uintptr_t)(src + c) & 15) == 0) {
        copy16(d + 4 * ch, src + c);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          copy4(d + 4 * ch + i, src + min(max(c + i, 0), W - 1));
        }
      }
    }
  }
}

// G (2, 4 or 8) consecutive shared floats, G * 4-byte aligned, in one or
// two vector loads.
template <int G>
__device__ __forceinline__ void load_group(const float* p, float (&v)[G]) {
  if (G == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[G > 1 ? 1 : 0] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x;
      v[i + 1 < G ? i + 1 : 0] = a.y;
      v[i + 2 < G ? i + 2 : 0] = a.z;
      v[i + 3 < G ? i + 3 : 0] = a.w;
    }
  }
}

// One block: a tile of blockDim.y rows and blockDim.x columns, one thread
// per pixel.  TT > 0 compiles the tap count in (TT == T): the tap loop
// unrolls fully and the pixel's left weights stay in registers; TT == 0
// takes T at run time and stages the left weights in shared memory.
template <int MODE, int G, int TT>
__global__ void asw_tile_kernel(const float* __restrict__ cost,
                                const float* __restrict__ wl,
                                const float* __restrict__ wr,
                                const float* __restrict__ den,
                                float* __restrict__ out, int T_run, int H,
                                int W, int D, int d0, float eps, int span,
                                int sw, int crow, int sr_off, int sc_off) {
  extern __shared__ __align__(16) float smem[];
  const int T = TT > 0 ? TT : T_run;
  const int R = (T - 1) / 2;
  const int bx = blockDim.x, by = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * bx, y0 = blockIdx.y * by;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const long long plane = (long long)H * W;
  const int crows = MODE == 2 ? by : by + T - 1;
  const int ctile = G * crows * crow;
  const long long cplane = MODE == 3 ? (long long)(H + T - 1) * W : plane;
  float* sl = smem;             // [T][by][bx] unless TT
  float* sr = smem + sr_off;    // [T][by][sw]
  float* sc = smem + sc_off;    // [2][crows][crow][G]

  const long long wrow = (long long)min(y, H - 1) * W;
  float lreg[TT > 0 ? TT : 1];
  if (TT > 0) {
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : 1); ++t) {
      lreg[t] = wl[t * plane + wrow + min(x, W - 1)];
    }
  } else {
    // Strip row t * by + r is frame row y0 + r of tap t.
    stage_rows(sl, bx, T * by, bx, x0, W, [&](int i) {
      return wl + (i / by) * plane + (long long)min(y0 + i % by, H - 1) * W;
    });
  }
  commit();
  // Cost tile of planes g0 .. g0 + gn - 1 into buf, plane g of tile
  // column c at buf[(r * crow + c) * G + g] (4-byte copies).
  auto stage_cost = [&](float* buf, int g0, int gn) {
    for (int g = 0; g < gn; ++g) {
      const float* p = cost + (long long)(g0 + g) * cplane;
      for (int r = ty; r < crows; r += by) {
        const int yy = MODE == 1   ? min(max(y0 - R + r, 0), H - 1)
                       : MODE == 2 ? min(y0 + r, H - 1)
                                   : min(y0 + r, H + T - 2);
        const float* src = p + (long long)yy * W;
        for (int c = tx; c < crow; c += bx) {
          const int xx = MODE == 2 ? min(max(x0 - R + c, 0), W - 1)
                                   : min(x0 + c, W - 1);
          copy4(buf + (r * crow + c) * G + g, src + xx);
        }
      }
    }
  };
  // Groups run in order k = 0, 1, ...: within each span [s0, s0 + sn),
  // planes g0 = s0, s0 + G, ...  The cost tile of group k + 1 is in flight
  // while group k is summed.
  if (MODE != 0) stage_cost(sc, 0, min(G, min(span, D)));
  commit();
  int k = 0;
  for (int s0 = 0; s0 < D; s0 += span) {
    const int sn = min(span, D - s0);
    // Segment column j holds frame column xa + j, xa = xbase rounded down to
    // a multiple of 4 (xbase: the column of the span's last plane at x0),
    // clamped to [0, W - 1]; plane d reads column jo + tx + (s0+sn-1-d).
    const int xbase = x0 - d0 - (s0 + sn - 1);
    const int xa = xbase >= 0 ? xbase / 4 * 4 : -((-xbase + 3) / 4 * 4);
    const int jo = xbase - xa;
    // The last group's trailing barrier: every thread is done with sr.
    stage_rows(sr, sw, T * by, round4(jo + bx + sn - 1), xa, W, [&](int i) {
      return wr + (i / by) * plane + (long long)min(y0 + i % by, H - 1) * W;
    });
    commit();
    for (int g0 = s0; g0 < s0 + sn; g0 += G, ++k) {
      const int gn = min(G, s0 + sn - g0);
      // Start the next group's cost tile (the next span's first group
      // after this span's last).
      int n0 = g0 + G, nn = min(G, s0 + sn - n0);
      if (n0 >= s0 + sn) {
        n0 = s0 + sn;
        nn = min(G, min(span, D - n0));
      }
      if (MODE != 0 && n0 < D) stage_cost(sc + ((k + 1) & 1) * ctile, n0, nn);
      commit();
      const long long o = (long long)g0 * plane + (long long)y * W + x;
      // den is read before the taps, so its latency hides behind them.
      float dv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dv[g] = MODE != 0 && inside && g < gn ? den[o + g * plane] : 1.0f;
      }
      wait_all_but_one();  // sl, sr and group k's cost tile have landed
      __syncthreads();
      float acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = eps;
      // All G sums run, with no branch; those of planes past the group's
      // gn read stale shared words and are never written.
      const float* rcol = sr + ty * sw + jo + tx + (s0 + sn - 1 - g0);
      const float* lcol = sl + ty * bx + tx;
      const float* ccol = sc + (k & 1) * ctile + (ty * crow + tx) * G;
      const int cstep = (MODE == 2 ? 1 : crow) * G;  // cost step per tap
#pragma unroll(TT > 0 ? TT : 3)
      for (int t = 0; t < T; ++t) {
        const float l = TT > 0 ? lreg[TT > 0 ? t : 0] : lcol[t * by * bx];
        const float* rrow = rcol + t * by * sw;
        float c[G];
        if (MODE != 0) load_group<G>(ccol + t * cstep, c);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float ww = l * rrow[-g];
          if (MODE == 0) {
            acc[g] = acc[g] + ww;
          } else {
            acc[g] = acc[g] + ww * c[g];
          }
        }
      }
      if (inside) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < gn) out[o + g * plane] = MODE == 0 ? acc[g] : acc[g] / dv[g];
        }
      }
      __syncthreads();  // cost buffer k & 1 and sr are free again
    }
  }
}

template <int MODE, int G, int TT>
int launch(const float* cost, const float* wl, const float* wr,
           const float* den, float* out, int T, int H, int W, int D, int d0,
           float eps, int bx, int by, int span, int gx, int gy,
           const Layout& L, cudaStream_t stream) {
  auto kernel = asw_tile_kernel<MODE, G, TT>;
  const int shared = (int)(4 * L.total);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(gx, gy), dim3(bx, by), shared, stream>>>(
      cost, wl, wr, den, out, T, H, W, D, d0, eps, span, L.sw, L.crow,
      (int)L.sl, (int)(L.sl + L.sr));
  return (int)cudaGetLastError();
}

// The instantiations: group sizes 2, 4 and 8, with the tap count taken at
// run time or compiled in for the reference window (T = 33).
template <int MODE, int G>
int launch_taps(bool baked, const float* cost, const float* wl,
                const float* wr, const float* den, float* out, int T, int H,
                int W, int D, int d0, float eps, int bx, int by, int span,
                int gx, int gy, const Layout& L, cudaStream_t s) {
  if (baked) {
    if (T != 33) return (int)cudaErrorInvalidValue;
    return launch<MODE, G, 33>(cost, wl, wr, den, out, T, H, W, D, d0, eps,
                               bx, by, span, gx, gy, L, s);
  }
  return launch<MODE, G, 0>(cost, wl, wr, den, out, T, H, W, D, d0, eps, bx,
                            by, span, gx, gy, L, s);
}

template <int MODE>
int launch_group(int group, bool baked, const float* cost, const float* wl,
                 const float* wr, const float* den, float* out, int T, int H,
                 int W, int D, int d0, float eps, int bx, int by, int span,
                 int gx, int gy, const Layout& L, cudaStream_t s) {
  switch (group) {
    case 2:
      return launch_taps<MODE, 2>(baked, cost, wl, wr, den, out, T, H, W, D,
                                  d0, eps, bx, by, span, gx, gy, L, s);
    case 4:
      return launch_taps<MODE, 4>(baked, cost, wl, wr, den, out, T, H, W, D,
                                  d0, eps, bx, by, span, gx, gy, L, s);
    case 8:
      return launch_taps<MODE, 8>(baked, cost, wl, wr, den, out, T, H, W, D,
                                  d0, eps, bx, by, span, gx, gy, L, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One launch of K1 (mode 0), K2 (modes 1, 2) or the windowed K2 (mode 3)
// with a tile plan from kernels/asw_aggregation.py aggregation_tiles:
// block (bx, by) over a tile of by rows and bx columns (bx a multiple of
// 4), grid (gx, gy), `span` planes per staged right-weight segment,
// `group` planes summed at once (2, 4 or 8), `baked` = the tap count
// compiled in (T must be 33), `shared` dynamic shared bytes.
//   mode 0: wl, wr (T, H, W) -> out (D, H, W); cost and den unused.
//   modes 1, 2: cost, den, out (D, H, W); wl, wr (T, H, W).
//   mode 3: cost (D, H + T - 1, W) real rows; wl, wr (T, H, W); den, out
//           (D, H, W); out row y reads cost rows y .. y + T - 1.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan that
// does not cover the frame or does not match the shared layout.
extern "C" int asw_tiles_f32(int mode, const float* cost, const float* wl,
                             const float* wr, const float* den, float* out,
                             int T, int H, int W, int D, int d0, float eps,
                             int bx, int by, int span, int group, int baked,
                             int gx, int gy, int shared, void* stream) {
  if (mode < 0 || mode > 3 || T < 1 || T % 2 == 0 || bx < 4 || bx % 4 ||
      by < 1 || bx * by > 1024 || span < 1 || d0 < 0 ||
      (long long)gx * bx < W || (long long)gy * by < H || gy > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout(mode, T, bx, by, span, group, baked != 0);
  if (4 * L.total > kSharedLimit || 4 * L.total != shared) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)D * H * W == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool b = baked != 0;
  switch (mode) {
    case 0:
      return launch_group<0>(group, b, cost, wl, wr, den, out, T, H, W, D, d0,
                             eps, bx, by, span, gx, gy, L, s);
    case 1:
      return launch_group<1>(group, b, cost, wl, wr, den, out, T, H, W, D, d0,
                             eps, bx, by, span, gx, gy, L, s);
    case 2:
      return launch_group<2>(group, b, cost, wl, wr, den, out, T, H, W, D, d0,
                             eps, bx, by, span, gx, gy, L, s);
    default:
      return launch_group<3>(group, b, cost, wl, wr, den, out, T, H, W, D, d0,
                             eps, bx, by, span, gx, gy, L, s);
  }
}
