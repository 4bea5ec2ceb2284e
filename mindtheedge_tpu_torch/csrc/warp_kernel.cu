// The pinhole warp's geometry for the photometric loss, for Hopper (sm_90a):
// depth -> 3-D points -> the reference camera -> its sampling grid, and the
// backward of that chain with the pose's gradient reduced across the card.
//
// Replaces no TPU kernel: the JAX package leaves the warp's geometry to XLA
// (mindtheedge_tpu/geometry/camera.py, reconstruct and project).  The port's
// plain version is the chain of PyTorch ops in geometry/camera.py
// (reconstruct + project, which view_synthesis runs on the CPU): an image
// grid, a closed-form K^-1, three batched 3x3 products, a clamp and two divides,
// each a launch over [B,H,W,3] float32 maps that autograd keeps.  Its
// backward computes the pose's gradient as a [3,N] x [N,3] product
// (geometry/pose.transform_points), N the frame's pixels, which cuBLAS runs
// in one 32x32 tile a frame: the whole sum on one SM.
// Wrapper: mindtheedge_tpu_torch/ops/cuda/warp_kernel.py.  Times: PERF.md.
//
// What it computes, per frame b and pixel (u, v) of an H x W grid, with
// Kinv the closed-form inverse of K (K with 1/fx, 1/fy, -cx/fx, -cy/fy in
// place of fx, fy, cx, cy; its other entries as they are), R and t the top
// three rows of pose [b] (original -> reference camera):
//   ray = Kinv [u, v, 1];  X = d * ray;  Y = R X + t;  P = ref_K Y;
//   Z = max(P_z, 1e-5) (NaN stays NaN);
//   x = 2 (P_x / Z) / (W - 1) - 1,  y = 2 (P_y / Z) / (H - 1) - 1.
// Forward: depth [B,H,W] -> coords [B,H,W,2].  Backward, from the coords'
// gradient g: the depth's gradient per pixel, and per frame the 12 sums
//   dR[i][j] = sum over pixels of gY_i X_j,  dt[i] = sum of gY_i,
// gY = ref_K^T gP, where gP_z is 0 where P_z < 1e-5 (torch.clamp's
// gradient passes where P_z >= min).  Nothing is saved between the passes:
// the backward recomputes ray, X, Y and P from the depth.  Everything is
// float32; the division by W - 1 and H - 1 is a product with the
// reciprocal, as PyTorch divides a CUDA tensor by a Python number.
//
// Bound on the H100: memory.  The forward reads 4 B a pixel and writes 8,
// the backward reads 12 and writes 4: at [3,384,1280] 17.7 and 23.6 MB, 5.3
// and 7.0 us at 3.35 TB/s.  The arithmetic (about 40 FLOP a pixel forward,
// 90 backward) is far below the card's fp32 rate.
//
// Design.
//  * One launch a warp forward, and two backward: a block walks a strided
//    share of one frame's pixels (coalesced, one pixel a thread a step),
//    the frame's matrices built once a block in shared memory from the
//    [B,3,3] and [B,4,4] inputs, so no grid, inverse or product is staged
//    through device memory.
//  * The pose's 12 sums spread over the card: each thread sums its pixels'
//    terms in registers, a warp reduces them by shuffles, the block's warps
//    through shared memory in a fixed order, and the block writes its 12
//    partials to a [B, blocks, 12] scratch that the wrapper allocates.  A
//    second kernel, one block a frame, sums a frame's partials in a fixed
//    order and writes the [B,4,4] gradient (bottom row 0).  No atomics: the
//    same inputs on one card give the same bits.
//  * The grid: about WAVES waves of the blocks the card holds at once, split
//    between the frames, and no more blocks than a frame has 256-pixel
//    strips.  Offsets are 64-bit, a pixel's index in its frame 32-bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUMS = 12;             // dR (3x3, row-major), then dt
constexpr int WAVES = 2;
constexpr int MAX_FRAMES = 65535;    // gridDim.y
constexpr int MAX_DEVICES = 64;
constexpr float MIN_Z = 1e-5f;

// One frame's matrices, row-major.
struct Frame {
  float kinv[9];
  float r[9];
  float t[3];
  float kref[9];
};

// Threads 0..8 fill the block's Frame for frame b; the caller syncs.
__device__ __forceinline__ void load_frame(Frame& f, const float* __restrict__ K,
                                           const float* __restrict__ ref_K,
                                           const float* __restrict__ pose, long long b) {
  const int i = threadIdx.x;
  if (i < 9) {
    const float* k = K + 9 * b;
    float v = k[i];
    if (i == 0 || i == 4) v = 1.0f / v;
    if (i == 2) v = -k[2] / k[0];
    if (i == 5) v = -k[5] / k[4];
    f.kinv[i] = v;
    f.kref[i] = ref_K[9 * b + i];
    f.r[i] = pose[16 * b + 4 * (i / 3) + i % 3];
    if (i < 3) f.t[i] = pose[16 * b + 4 * i + 3];
  }
}

// M row i times (a, b, c), as one fma chain
__device__ __forceinline__ float row3(const float* m, int i, float a, float b, float c) {
  return fmaf(m[3 * i + 2], c, fmaf(m[3 * i + 1], b, __fmul_rn(m[3 * i], a)));
}

// The pixel's ray, point X and projected P.
struct Pixel {
  float ray[3], x[3], p[3];
};

__device__ __forceinline__ Pixel project_pixel(const Frame& f, float u, float v, float d) {
  Pixel q;
  for (int i = 0; i < 3; ++i) q.ray[i] = row3(f.kinv, i, u, v, 1.0f);
  for (int i = 0; i < 3; ++i) q.x[i] = __fmul_rn(q.ray[i], d);
  float y[3];
  for (int i = 0; i < 3; ++i) y[i] = __fadd_rn(row3(f.r, i, q.x[0], q.x[1], q.x[2]), f.t[i]);
  for (int i = 0; i < 3; ++i) q.p[i] = row3(f.kref, i, y[0], y[1], y[2]);
  return q;
}

__device__ __forceinline__ float clamp_z(float z) { return z < MIN_Z ? MIN_Z : z; }

__global__ void __launch_bounds__(THREADS)
warp_coords_kernel(const float* __restrict__ depth, const float* __restrict__ K,
                   const float* __restrict__ ref_K, const float* __restrict__ pose,
                   float2* __restrict__ coords, int h, int w) {
  __shared__ Frame f;
  const long long b = blockIdx.y;
  load_frame(f, K, ref_K, pose, b);
  __syncthreads();
  const long long hw = static_cast<long long>(h) * w;
  const float inv_w = 1.0f / static_cast<float>(w - 1);
  const float inv_h = 1.0f / static_cast<float>(h - 1);
  const float* d = depth + b * hw;
  float2* out = coords + b * hw;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; p < hw;
       p += step) {
    const int pixel = static_cast<int>(p), row = pixel / w;
    const Pixel q = project_pixel(f, static_cast<float>(pixel - row * w), static_cast<float>(row),
                                  __ldg(d + p));
    const float z = clamp_z(q.p[2]);
    out[p] = make_float2(__fadd_rn(__fmul_rn(__fmul_rn(2.0f, __fdiv_rn(q.p[0], z)), inv_w), -1.0f),
                         __fadd_rn(__fmul_rn(__fmul_rn(2.0f, __fdiv_rn(q.p[1], z)), inv_h), -1.0f));
  }
}

// Sum acc[] over the block in a fixed order; thread 0 gets the totals.
__device__ __forceinline__ void block_sum(float (&acc)[SUMS], float (&red)[WARPS][SUMS]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < SUMS; ++k)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < SUMS; ++k) red[warp][k] = acc[k];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < SUMS; ++k) {
      float s = red[0][k];
      for (int i = 1; i < WARPS; ++i) s += red[i][k];
      acc[k] = s;
    }
}

__global__ void __launch_bounds__(THREADS)
warp_coords_backward_kernel(const float2* __restrict__ grad, const float* __restrict__ depth,
                            const float* __restrict__ K, const float* __restrict__ ref_K,
                            const float* __restrict__ pose, float* __restrict__ grad_depth,
                            float* __restrict__ partial, int h, int w) {
  __shared__ Frame f;
  __shared__ float red[WARPS][SUMS];
  const long long b = blockIdx.y;
  load_frame(f, K, ref_K, pose, b);
  __syncthreads();
  const long long hw = static_cast<long long>(h) * w;
  const float inv_w = 1.0f / static_cast<float>(w - 1);
  const float inv_h = 1.0f / static_cast<float>(h - 1);
  const float* d = depth + b * hw;
  const float2* g = grad + b * hw;
  float* gd = grad_depth + b * hw;
  float acc[SUMS];
#pragma unroll
  for (int k = 0; k < SUMS; ++k) acc[k] = 0.0f;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; p < hw;
       p += step) {
    const int pixel = static_cast<int>(p), row = pixel / w;
    const float2 gp = g[p];
    const Pixel q = project_pixel(f, static_cast<float>(pixel - row * w), static_cast<float>(row),
                                  __ldg(d + p));
    const float z = clamp_z(q.p[2]);
    // x = (2 (P_x / Z)) * inv_w - 1: back through the product, the 2, the divide
    const float ax = __fmul_rn(2.0f, __fmul_rn(gp.x, inv_w));
    const float ay = __fmul_rn(2.0f, __fmul_rn(gp.y, inv_h));
    const float qx = __fdiv_rn(q.p[0], z), qy = __fdiv_rn(q.p[1], z);
    float gP[3];
    gP[0] = __fdiv_rn(ax, z);
    gP[1] = __fdiv_rn(ay, z);
    const float gz = __fadd_rn(-__fmul_rn(ax, __fdiv_rn(qx, z)), -__fmul_rn(ay, __fdiv_rn(qy, z)));
    gP[2] = q.p[2] >= MIN_Z ? gz : 0.0f;
    float gY[3];      // ref_K^T gP
    for (int j = 0; j < 3; ++j)
      gY[j] = fmaf(f.kref[6 + j], gP[2], fmaf(f.kref[3 + j], gP[1], __fmul_rn(f.kref[j], gP[0])));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[3 * i + j] = fmaf(gY[i], q.x[j], acc[3 * i + j]);
      acc[9 + i] += gY[i];
    }
    float gd_p = 0.0f;   // (R^T gY) . ray
    for (int j = 0; j < 3; ++j) {
      const float gx = fmaf(f.r[6 + j], gY[2], fmaf(f.r[3 + j], gY[1], __fmul_rn(f.r[j], gY[0])));
      gd_p = fmaf(gx, q.ray[j], gd_p);
    }
    gd[p] = gd_p;
  }
  block_sum(acc, red);
  if (threadIdx.x == 0) {
    float* out = partial + (b * gridDim.x + blockIdx.x) * SUMS;
#pragma unroll
    for (int k = 0; k < SUMS; ++k) out[k] = acc[k];
  }
}

// One block a frame: its `blocks` partials summed in a fixed order -> the
// frame's [4,4] gradient.
__global__ void __launch_bounds__(THREADS)
warp_pose_sum_kernel(const float* __restrict__ partial, float* __restrict__ grad_pose,
                     int blocks) {
  __shared__ float red[WARPS][SUMS];
  const long long b = blockIdx.x;
  float acc[SUMS];
#pragma unroll
  for (int k = 0; k < SUMS; ++k) acc[k] = 0.0f;
  for (int i = threadIdx.x; i < blocks; i += THREADS) {
    const float* src = partial + (b * blocks + i) * SUMS;
#pragma unroll
    for (int k = 0; k < SUMS; ++k) acc[k] += src[k];
  }
  block_sum(acc, red);
  if (threadIdx.x == 0) {
    float* out = grad_pose + 16 * b;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) out[4 * i + j] = acc[3 * i + j];
      out[4 * i + 3] = acc[9 + i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) out[12 + j] = 0.0f;
  }
}

// The blocks the card holds at once of `kernel` on the current device, times
// WAVES: queried once a device and kernel, then read from `cached`.
template <typename Kernel>
cudaError_t card_blocks(Kernel kernel, long long* card) {
  static std::atomic<long long> cached[MAX_DEVICES];
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *card = cached[device].load(std::memory_order_relaxed);
  if (*card > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  *card = static_cast<long long>(WAVES) * std::max(per_sm, 1) * sms;
  cached[device].store(*card, std::memory_order_relaxed);
  return cudaSuccess;
}

// Blocks a frame: about WAVES waves of what the card holds at once, split
// between the frames, at most one a 256-pixel strip of the frame.
template <typename Kernel>
cudaError_t frame_blocks(Kernel kernel, int batch, long long hw, int* blocks) {
  long long card = 0;
  const cudaError_t err = card_blocks(kernel, &card);
  if (err != cudaSuccess) return err;
  const long long strips = (hw + THREADS - 1) / THREADS;
  *blocks = static_cast<int>(std::max(1LL, std::min({(card + batch - 1) / batch, strips,
                                                      static_cast<long long>(INT_MAX)})));
  return cudaSuccess;
}

bool valid(int batch, int h, int w) {
  return batch >= 1 && batch <= MAX_FRAMES && h >= 1 && w >= 1 &&
         static_cast<long long>(h) * w <= INT_MAX;
}

}  // namespace

// The blocks a frame that the backward's first pass launches, into *blocks:
// the wrapper allocates its [batch, *blocks, 12] float32 scratch.  Returns a
// cudaError_t.
extern "C" int mte_warp_backward_blocks(int batch, int h, int w, int* blocks) {
  if (!valid(batch, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(frame_blocks(warp_coords_backward_kernel, batch,
                                       static_cast<long long>(h) * w, blocks));
}

// Forward on `stream` (a cudaStream_t): contiguous float32 depth [batch,h,w],
// K and ref_K [batch,3,3], pose [batch,4,4] -> coords [batch,h,w,2].
// 1 <= batch <= 65535, h, w >= 1, h * w < 2^31.  Returns a cudaError_t: the
// launch's, from cudaGetLastError().
extern "C" int mte_warp_coords(const void* depth, const void* K, const void* ref_K,
                               const void* pose, void* coords, int batch, int h, int w,
                               void* stream) {
  if (!valid(batch, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t err = frame_blocks(warp_coords_kernel, batch, static_cast<long long>(h) * w, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_coords_kernel<<<dim3(blocks, batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const float*>(K),
      static_cast<const float*>(ref_K), static_cast<const float*>(pose),
      static_cast<float2*>(coords), h, w);
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`: grad [batch,h,w,2] (the coords' gradient) and the
// forward's inputs -> grad_depth [batch,h,w] and grad_pose [batch,4,4],
// through `partial`, a float32 scratch of [batch, blocks, 12] with `blocks`
// from mte_warp_backward_blocks.  Two launches.  Returns a cudaError_t.
extern "C" int mte_warp_coords_backward(const void* grad, const void* depth, const void* K,
                                        const void* ref_K, const void* pose, void* grad_depth,
                                        void* grad_pose, void* partial, int blocks, int batch,
                                        int h, int w, void* stream) {
  if (!valid(batch, h, w) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  warp_coords_backward_kernel<<<dim3(blocks, batch), THREADS, 0, s>>>(
      static_cast<const float2*>(grad), static_cast<const float*>(depth),
      static_cast<const float*>(K), static_cast<const float*>(ref_K),
      static_cast<const float*>(pose), static_cast<float*>(grad_depth),
      static_cast<float*>(partial), h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_pose_sum_kernel<<<batch, THREADS, 0, s>>>(static_cast<const float*>(partial),
                                                 static_cast<float*>(grad_pose), blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mte_warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
