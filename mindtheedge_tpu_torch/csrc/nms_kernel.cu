// Fused Sobel-5 + direction-quantised non-maximum suppression, for Hopper (sm_90a).
//
// Replaces the TPU kernel mindtheedge_tpu/ops/pallas/nms_kernel.py:_nms_kernel
// (its pallas_call at nms_kernel.py:111, launched by non_max_suppression_pallas).
// Plain version and oracle: mindtheedge_tpu_torch/ops/edge_ops.py:non_max_suppression.
// Wrapper: mindtheedge_tpu_torch/ops/cuda/nms_kernel.py.
//
// What it computes, for each [H,W] image of a [B,H,W] float32 batch:
//   sx, sy = separable Sobel-5 (smooth [1,4,6,4,1] x deriv [-1,-2,0,2,1]) on a
//            reflect-101 border, rows first, then columns;
//   bucket = 0/45/90/135 deg from slope tests against tan(22.5) and tan(67.5);
//   out    = c if c >= both neighbours of its bucket (ties keep), else 0;
//            the 1-pixel image border is 0.
//
// Bound on this card: each pixel is read once and written once, 8 bytes, and
// costs about 40 flops, so the kernel is memory-bound.  At B x 384 x 1280 that
// is 3.93 MB per image, about 1.2 us per image at 3.35 TB/s.
//
// Design.  One block per (image, 32x8 output tile), 256 threads.  The block
// loads its tile plus a 2-pixel halo into shared memory once, with the
// reflect-101 indices computed here: radius 2 covers the Sobel, and the +-1
// neighbours of the original image lie inside the same buffer.  Neighbouring
// threads load and store neighbouring addresses.  Nothing but the output is
// written to device memory: no padded copy and no overlapping bands, which
// the TPU wrapper materialised (nms_kernel.py:104-109).
//
// Arithmetic.  Each tap is one rounded product and one rounded add
// (__fmul_rn/__fadd_rn, never contracted into an FMA), in the order of the
// plain version, so sx and sy are bit-equal to it.
//
// Bucket rule: the slope tests of nms_kernel.py:66-70 with two changes.
// (a) A flat pixel (sx = sy = 0) takes the horizontal pair, as the plain
//     version's atan2(0, 0) = 0 and the reference tools.py:9-46 do; the TPU
//     kernel's diagonal test admitted it and picked the 135 deg pair.  So the
//     diagonal test also requires |sy| > 0.
// (b) The 45-vs-135 sign test is (sx > 0) == (sy > 0), not sx * sy > 0,
//     which underflows to 0 for tiny gradients.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int HALO = 2;
constexpr int SMEM_W = TILE_W + 2 * HALO;
constexpr int SMEM_H = TILE_H + 2 * HALO;
constexpr float TAN_22_5 = 0.41421356237f;
constexpr float TAN_67_5 = 2.41421356237f;

// reflect-101 index for -HALO <= i < n + HALO (n >= 3), clamped into [0, n)
// so that rows and columns past a ragged tile's edge still read in bounds.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// one tap: acc + k * v, the product and the sum each rounded on its own
__device__ __forceinline__ float tap(float acc, float k, float v) {
  return __fadd_rn(acc, __fmul_rn(k, v));
}

__global__ void __launch_bounds__(TILE_W * TILE_H)
nms_sobel5_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int h, int w) {
  __shared__ float tile[SMEM_H][SMEM_W];
  const size_t plane = static_cast<size_t>(h) * w;
  const float* src = img + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int y0 = blockIdx.y * TILE_H - HALO;
  const int x0 = blockIdx.x * TILE_W - HALO;

  for (int k = threadIdx.y * TILE_W + threadIdx.x; k < SMEM_H * SMEM_W;
       k += TILE_W * TILE_H) {
    const int r = k / SMEM_W, c = k % SMEM_W;
    const int gy = reflect101(y0 + r, h), gx = reflect101(x0 + c, w);
    tile[r][c] = src[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  const int y = blockIdx.y * TILE_H + threadIdx.y;
  const int x = blockIdx.x * TILE_W + threadIdx.x;
  if (y >= h || x >= w) return;
  const int ty = threadIdx.y + HALO, tx = threadIdx.x + HALO;
  const float c = tile[ty][tx];
  float result = 0.0f;

  if (y > 0 && y < h - 1 && x > 0 && x < w - 1) {
    // rows first: smoothed (vs) and differentiated (vd) column sums at the
    // 5 columns tx-2 .. tx+2
    float vs[5], vd[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int col = tx - 2 + j;
      const float a = tile[ty - 2][col], b = tile[ty - 1][col],
                  m = tile[ty][col], d = tile[ty + 1][col],
                  e = tile[ty + 2][col];
      vs[j] = __fmul_rn(1.0f, a);
      vs[j] = tap(vs[j], 4.0f, b);
      vs[j] = tap(vs[j], 6.0f, m);
      vs[j] = tap(vs[j], 4.0f, d);
      vs[j] = tap(vs[j], 1.0f, e);
      vd[j] = __fmul_rn(-1.0f, a);
      vd[j] = tap(vd[j], -2.0f, b);
      vd[j] = tap(vd[j], 2.0f, d);
      vd[j] = tap(vd[j], 1.0f, e);
    }
    // then columns
    float sx, sy;
    sx = __fmul_rn(-1.0f, vs[0]);
    sx = tap(sx, -2.0f, vs[1]);
    sx = tap(sx, 2.0f, vs[3]);
    sx = tap(sx, 1.0f, vs[4]);
    sy = __fmul_rn(1.0f, vd[0]);
    sy = tap(sy, 4.0f, vd[1]);
    sy = tap(sy, 6.0f, vd[2]);
    sy = tap(sy, 4.0f, vd[3]);
    sy = tap(sy, 1.0f, vd[4]);

    const float ax = fabsf(sx), ay = fabsf(sy);
    const bool is90 = (ay >= TAN_67_5 * ax) && (ay > 0.0f);
    const bool diag = !is90 && (ay >= TAN_22_5 * ax) && (ay > 0.0f);
    const bool same_sign = (sx > 0.0f) == (sy > 0.0f);
    // neighbour pair (q at +offset, r at -offset) per bucket, as edge_ops
    int dy = 0, dx = 1;                             // 0 deg: (0, +1) / (0, -1)
    if (diag && same_sign) { dy = -1; dx = -1; }    // 45 deg
    else if (is90) { dy = 1; dx = 0; }              // 90 deg
    else if (diag) { dy = 1; dx = -1; }             // 135 deg
    const float q = tile[ty + dy][tx + dx];
    const float r = tile[ty - dy][tx - dx];
    if (c >= q && c >= r) result = c;
  }
  dst[static_cast<size_t>(y) * w + x] = result;
}

}  // namespace

// Launch on `stream` (a cudaStream_t) for a contiguous [batch, h, w] float32
// image; batch <= 65535, h >= 3, w >= 3.  Returns cudaGetLastError().
extern "C" int mte_nms_sobel5(const float* img, float* out, int batch, int h,
                              int w, void* stream) {
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, batch);
  nms_sobel5_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mte_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
