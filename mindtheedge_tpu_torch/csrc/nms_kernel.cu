// Fused Sobel-5 + direction-quantised non-maximum suppression, for Hopper (sm_90a).
//
// Replaces the TPU kernel mindtheedge_tpu/ops/pallas/nms_kernel.py:_nms_kernel
// (its pallas_call at nms_kernel.py:111, launched by non_max_suppression_pallas).
// Plain version and oracle: mindtheedge_tpu_torch/ops/edge_ops.py:non_max_suppression.
// Wrapper: mindtheedge_tpu_torch/ops/cuda/nms_kernel.py.  Times: PERF.md.
//
// What it computes, for each [H,W] image of a [B,H,W] float32 batch:
//   sx, sy = separable Sobel-5 (smooth [1,4,6,4,1] x deriv [-1,-2,0,2,1]) on a
//            reflect-101 border, rows (along H) first, then columns;
//   bucket = 0/45/90/135 deg from slope tests against tan(22.5) and tan(67.5);
//   out    = c if c >= both neighbours of its bucket (ties keep), else 0;
//            the 1-pixel image border is 0.
//
// Bound on the H100: each pixel is read once and written once, 8 bytes, and
// costs about 40 flops, so the least time is set by bytes: 15.7 MB at
// [4,384,1280] is 4.70 us at 3.35 TB/s, where the flops take 1.17 us at
// 67 TFLOP/s.  Tensor cores do not apply: a single-channel fp32 stencil has
// no matrix product to give them, and TF32 would round the inputs and break
// the bit-equality with the plain version.
//
// Design.  One warp owns a strip of 128 input columns (4 a lane, one float4)
// and a band of BAND output rows of one image; the grid is flat, one warp per
// (image, band, strip), so the batch has no grid-dimension limit.
//  * Loads.  A lane loads its BAND + 4 input rows into registers, each load
//    independent of the arithmetic, so the compiler issues it as early as the
//    registers allow; no shared memory and no barrier: every byte is used by
//    the lane that loaded it or, by a shuffle, by its two neighbours.  BAND = 4 makes [4,384,1280] 4,224 warps: with at most 64
//    registers a thread that is 32 warps on each of 132 SMs, one full wave.
//    Small batches (at one row per warp, at most 16 warps an SM, as at the
//    DEE annotation scales) take BAND = 1, the shortest chain per warp: there
//    the launch and one warp's latency are the time.  BAND = 1 reads each
//    input row five times, so a busier card loses by it.
//  * Vertical sums once.  Each lane computes the smoothed and differentiated
//    column sums (vs, vd) of its own 4 columns once per row; the +-2 columns
//    of the horizontal pass and the +-1 neighbours of the compare come from
//    the adjacent lanes by shuffles.  Lanes 0 and 31 only feed their
//    neighbours, so a warp writes 120 columns and strips overlap by 8
//    columns, read twice from L2.
//  * Borders.  Reflect-101 rows and columns are read from their mirror in the
//    image (x = -1 reads x = 1, x = W reads x = W-2); no padded copy exists.
//  * Any width.  With W % 4 == 0 and 16-byte aligned tensors a lane moves one
//    float4 a row (the kernel's VEC form); otherwise 4-byte accesses.
//  * Issue, not bytes, sets the pace once the loads are in flight: 24
//    rounded Sobel operations a pixel, and compares and selects that run at
//    half the rate of fp32 arithmetic.  So the compare has no branches, takes
//    one max of each neighbour pair (max.NaN keeps c >= q && c >= r exact)
//    and selects among the four maxima.
// Not TMA or cp.async: a ring in shared memory filled by cp.async with every
// row in flight at once ran slower on the card than loads into registers
// (PERF.md), and staging adds a store and a reload a row; TMA would also need
// W % 4 == 0 and fills out-of-bounds boxes with zeros, not reflect-101.
//
// Arithmetic.  Each tap is one rounded product and one rounded add
// (__fmul_rn/__fadd_rn, never contracted into an FMA), in the order of the
// plain version (edge_ops._sobel_sep); a +-1 tap's product is exact and is
// left out.  So sx and sy are bit-equal to the plain version's, and a
// vertical sum shared between neighbouring outputs is the same sum.
//
// Bucket rule: the slope tests of nms_kernel.py:66-70 with two changes.
// (a) A flat pixel (sx = sy = 0) takes the horizontal pair, as the plain
//     version's atan2(0, 0) = 0 and the reference tools.py:9-46 do; the TPU
//     kernel's diagonal test admitted it and picked the 135 deg pair.  So the
//     90 deg and diagonal tests also require |sy| > 0.
// (b) The 45-vs-135 sign test is (sx > 0) == (sy > 0), not sx * sy > 0,
//     which underflows to 0 for tiny gradients.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int COLS = 4;                      // columns per lane: one float4
constexpr int STRIP = (LANES - 2) * COLS;    // output columns per warp
constexpr int WARPS = 4;                     // warps per block
constexpr int SHORT_BAND_WARPS_PER_SM = 16;  // see "Loads" above
constexpr unsigned FULL = 0xffffffffu;
constexpr float TAN_22_5 = 0.41421356237f;
constexpr float TAN_67_5 = 2.41421356237f;

// reflect-101 index for -2 <= i < n + 2 (n >= 3), clamped into [0, n) so
// that rows and columns past a ragged band or strip still read in bounds.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// one tap: acc + k * v, the product and the sum each rounded on its own
__device__ __forceinline__ float tap(float acc, float k, float v) {
  return __fadd_rn(acc, __fmul_rn(k, v));
}

// the larger of a and b, NaN if either is NaN, so that c >= max_nan(q, r)
// is c >= q && c >= r for every input
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// c if `in` and c is >= both neighbours of its gradient's bucket, else 0;
// u*, c* and d* are rows y-1, y, y+1 at columns x-1 (l), x (c), x+1 (r)
__device__ __forceinline__ float suppress(bool in, float sx, float sy,
                                          float ul, float uc, float ur,
                                          float cl, float c, float cr,
                                          float dl, float dc, float dr) {
  const float ax = fabsf(sx), ay = fabsf(sy);
  const bool nz = ay > 0.0f;
  const bool is90 = nz && ay >= TAN_67_5 * ax;
  const bool steep = nz && ay >= TAN_22_5 * ax;             // 45, 90 or 135
  const bool same_sign = (sx > 0.0f) == (sy > 0.0f);
  float m = same_sign ? max_nan(ul, dr) : max_nan(dl, ur);  // 45 / 135 deg
  m = steep ? m : max_nan(cl, cr);                          // 0 deg
  m = is90 ? max_nan(uc, dc) : m;                           // 90 deg
  return (in && c >= m) ? c : 0.0f;
}

// VEC: W % 4 == 0 and 16-byte aligned pointers, one float4 a lane and row;
// otherwise 4-byte accesses with reflect-101 columns.
template <bool VEC, int BAND>
__global__ void __launch_bounds__(LANES * WARPS)
nms_sobel5_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int h, int w, int strips, int bands, int warps) {
  constexpr int ROWS = BAND + 4;             // input rows of a band
  const int lane = threadIdx.x % LANES;
  const int task = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (task >= warps) return;                 // whole warps leave together
  const int image_band = task / strips;
  const int y0 = (image_band % bands) * BAND;
  const size_t image = static_cast<size_t>(image_band / bands) * h * w;
  // lane 0 holds the 4 columns left of the strip's outputs
  const int x = (task % strips) * STRIP + (lane - 1) * COLS;
  // VEC: a float4 at a column clamped into the image; the two lanes that
  // stand for reflect-101 columns (x = -4: -2, -1; x = W: W, W+1) mirror it
  const int xv = min(max(x, 0), w - COLS);
  const bool left_mirror = x == -COLS, right_mirror = x == w;
  int cx[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) cx[i] = reflect101(x + i, w);

  // every load of the band first: rows y0-2 .. y0+BAND+1
  float v[ROWS][COLS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float* row = img + image + static_cast<size_t>(reflect101(y0 - 2 + j, h)) * w;
    if (VEC) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + xv));
      v[j][0] = right_mirror ? t.z : t.x;    // column W reads W-2
      v[j][1] = t.y;                         // W+1 reads W-3
      v[j][2] = t.z;                         // -2 reads 2
      v[j][3] = left_mirror ? t.y : t.w;     // -1 reads 1
    } else {
#pragma unroll
      for (int i = 0; i < COLS; ++i) v[j][i] = __ldg(row + cx[i]);
    }
  }

  bool col_in[COLS];                         // off the image's side borders
#pragma unroll
  for (int i = 0; i < COLS; ++i) col_in[i] = x + i > 0 && x + i < w - 1;
  const bool writes = lane > 0 && lane < LANES - 1 && x < w;
  float* o = out + image + static_cast<size_t>(y0) * w + x;
  // rows past a ragged band are computed from clamped rows and not stored
#pragma unroll
  for (int r = 0; r < BAND; ++r, o += w) {
    const int y = y0 + r;
    // rows first: vs, vd at columns x-2 .. x+5 (own columns at 2..5)
    float vs[COLS + 4], vd[COLS + 4];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const float a = v[r][i], b = v[r + 1][i], m = v[r + 2][i],
                  d = v[r + 3][i], e = v[r + 4][i];
      vs[i + 2] = __fadd_rn(tap(tap(tap(a, 4.0f, b), 6.0f, m), 4.0f, d), e);
      vd[i + 2] = __fadd_rn(tap(tap(-a, -2.0f, b), 2.0f, d), e);
    }
    vs[0] = __shfl_up_sync(FULL, vs[4], 1);
    vs[1] = __shfl_up_sync(FULL, vs[5], 1);
    vs[6] = __shfl_down_sync(FULL, vs[2], 1);
    vs[7] = __shfl_down_sync(FULL, vs[3], 1);
    vd[0] = __shfl_up_sync(FULL, vd[4], 1);
    vd[1] = __shfl_up_sync(FULL, vd[5], 1);
    vd[6] = __shfl_down_sync(FULL, vd[2], 1);
    vd[7] = __shfl_down_sync(FULL, vd[3], 1);
    // rows y-1, y, y+1 at columns x-1 .. x+4
    float up[COLS + 2], mid[COLS + 2], dn[COLS + 2];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      up[i + 1] = v[r + 1][i];
      mid[i + 1] = v[r + 2][i];
      dn[i + 1] = v[r + 3][i];
    }
    up[0] = __shfl_up_sync(FULL, up[COLS], 1);
    mid[0] = __shfl_up_sync(FULL, mid[COLS], 1);
    dn[0] = __shfl_up_sync(FULL, dn[COLS], 1);
    up[COLS + 1] = __shfl_down_sync(FULL, up[1], 1);
    mid[COLS + 1] = __shfl_down_sync(FULL, mid[1], 1);
    dn[COLS + 1] = __shfl_down_sync(FULL, dn[1], 1);

    // then columns, and the compare
    const bool row_in = y > 0 && y < h - 1;
    float res[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const float sx = __fadd_rn(tap(tap(-vs[i], -2.0f, vs[i + 1]), 2.0f,
                                     vs[i + 3]), vs[i + 4]);
      const float sy = __fadd_rn(
          tap(tap(tap(vd[i], 4.0f, vd[i + 1]), 6.0f, vd[i + 2]), 4.0f,
              vd[i + 3]), vd[i + 4]);
      res[i] = suppress(row_in, sx, sy, up[i], up[i + 1], up[i + 2], mid[i],
                        mid[i + 1], mid[i + 2], dn[i], dn[i + 1], dn[i + 2]);
    }
    // the side borders; in the VEC form only a lane's first and last columns
    // can be the image's first or last
#pragma unroll
    for (int i = 0; i < COLS; ++i)
      if (!VEC || i == 0 || i == COLS - 1) res[i] = col_in[i] ? res[i] : 0.0f;
    if (writes && y < h) {
      if (VEC) {
        *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int i = 0; i < COLS; ++i)
          if (x + i < w) o[i] = res[i];
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t) for a contiguous [batch, h, w] float32
// image; batch >= 1, 3 <= h, w < 2^30.  Returns a cudaError_t: the launch's,
// from cudaGetLastError().
extern "C" int mte_nms_sobel5(const float* img, float* out, int batch, int h,
                              int w, void* stream) {
  if (batch < 1 || h < 3 || w < 3 || h >= (1 << 30) || w >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (w + STRIP - 1) / STRIP;
  // one row a warp while that grid leaves the card half idle, else four
  const bool short_band = static_cast<long long>(batch) * h * strips <=
                          static_cast<long long>(SHORT_BAND_WARPS_PER_SM) * sms;
  const int band = short_band ? 1 : 4;
  const int bands = (h + band - 1) / band;
  const long long warps = static_cast<long long>(batch) * bands * strips;
  if (warps > INT_MAX - WARPS) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = static_cast<int>((warps + WARPS - 1) / WARPS);
  const bool vec = w % COLS == 0 &&
      (reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const auto kernel = short_band ? (vec ? nms_sobel5_kernel<true, 1> : nms_sobel5_kernel<false, 1>)
                                 : (vec ? nms_sobel5_kernel<true, 4> : nms_sobel5_kernel<false, 4>);
  kernel<<<blocks, LANES * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, strips, bands, static_cast<int>(warps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mte_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
