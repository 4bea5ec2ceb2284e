// The pack layers' 1-channel 3x3x3 conv over (channel-as-depth, H, W), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this conv with XLA's
// convolution (mindtheedge_tpu/ops/blocks.py, the pack layers' conv3d), and
// the port's plain version is F.conv3d, which cuDNN runs in its generic
// implicit_convolveNd_sgemm kernel: no GEMM-shaped algorithm fits one input
// channel and d = 4 outputs, so cuDNN stages an im2col through memory.
// Plain version and oracle: F.conv3d (ops/cuda/conv3d_kernel.py:plain and
// ops/blocks.py:Conv3dOverChannels on the CPU).  Wrapper:
// mindtheedge_tpu_torch/ops/cuda/conv3d_kernel.py.  Times: PERF.md.
//
// What it computes: x [B,D,H,W], weight [d,1,3,3,3], bias [d] -> out
// [B,d*D,H,W], channel f*D + z holding feature f at depth z:
//   out[b,f,z,y,x] = bias[f] + sum over (kz,ky,kx) of
//                    weight[f,0,kz,ky,kx] * x[b, z+kz-1, y+ky-1, x+kx-1],
// zero padding of 1 on all three axes, stride 1, d = 4 or 8, float32 or
// bfloat16 storage, in one of two layouts:
//  * NCHW (layout 0): x contiguous [B,D,H,W], out contiguous [B,d,D,H,W];
//  * NHWC (layout 1, the bf16 networks' channels-last activations): x
//    contiguous [B,H,W,D], out contiguous [B,H,W,d,D], i.e. channels-last
//    [B,D,H,W] and [B,d*D,H,W].  The conv is symmetric in its three axes, so
//    the kernel below runs the same stencil with the axes in memory order:
//    its "depth" is the image's rows, its "rows" the image's columns and its
//    "columns" the channels, the taps permuted to match, and each output
//    feature written D elements apart inside a pixel.
// The 27 taps are summed in fp32 by fmaf in the order of the kernel's axes,
// (kz, ky, kx) in NCHW and (y, x, z) in NHWC, the bias is added in fp32 and
// the sum is rounded once to the storage type (__floats2bfloat162_rn: round
// to nearest even).
//
// Bound on the H100: each input element is read once and each of the d
// outputs written once, and each output costs 27 FMAs.  A batch-4 request's
// ten convs read 152 M and write 609 M elements: 0.455 ms of bytes in bf16
// and 0.91 ms in fp32 at 3.35 TB/s, and 32.9 GFLOP, 0.49 ms at 67 TFLOP/s of
// fp32 FMA.  So bf16 is bound by the FMAs and fp32 by the bytes, both near
// 0.5-0.9 ms.  Tensor cores do not apply: the sums stay in fp32 FMA so that
// fp32 keeps its precision, and a 27 x d product per output has no depth
// for a wgmma tile.
//
// Design.  A block owns one (H, W) tile of one image and walks a chunk of
// depths in order: a stencil that reads its input once, where cuDNN's
// generic kernel expands it into an im2col first.
//  * Rolling planes.  The tile's input planes, each with a 1-pixel halo
//    (4 columns on each side, so that copies stay 16-byte chunks), pass
//    through a ring of RING = 4 buffers in shared memory in the storage
//    type: cp.async copies each plane two steps before it is used, so the
//    loads fly while two steps of arithmetic run, with one barrier a step.
//    Each thread copies its 3 x 6 window of the newest plane into
//    registers, widened to fp32, where the windows of planes z-1, z and z+1
//    stay: the thread's three planes roll through registers (the loop is
//    unrolled by three so that every index is a constant), and each plane
//    is read from shared memory once.  (A ring of 2 filled through
//    registers, one step ahead, spilled registers and waited on its loads:
//    1.56 ms fp32, 1.72 bf16 a request; deeper rings gain nothing: PERF.md.)
//  * Register blocking.  A thread computes all d features at P = 4
//    consecutive W positions: each window value serves up to 27 * d FMAs,
//    and a tap's d weights are one 16-byte broadcast load from shared
//    memory per 4 * d FMAs.  The weights and biases are read from their
//    device pointers into shared memory once a block: no constant-memory
//    copy and no host sync.
//  * Stores.  Each feature's 4 outputs are one 16-byte (fp32) or 8-byte
//    (bf16) store along W; a warp's stores cover whole rows.  The output is
//    written once; the input is read once, plus the tile halos and two planes
//    again at each chunk edge.
//  * Filling the card.  The tile's width is W split into pieces of at most
//    128 columns, its height what 256 threads cover (at most 64 rows), the
//    block's threads that tile rounded up to a warp.  The depth chunk is
//    sized from the shape so that the grid holds about four waves of the
//    blocks that fit on the card at once, chunks of at least 4 depths: from
//    pack1 (D 128 at 192x640, 120 tiles an image) to pack5 (D 2048 at 12x40,
//    one tile an image) every shape launches hundreds of blocks or more.  In
//    NHWC a tile is up to 128 channels of a run of pixels along a row, and
//    a block walks a chunk of the image's rows: a warp's stores then cover
//    128 contiguous channels of one pixel.
//  * Edges.  Any B, D, H, W >= 1: zero planes, rows and columns outside the
//    volume.  With W % 4 == 0 and aligned pointers, cp.async chunks (the VEC
//    form, zero-filled outside); otherwise plain element loads into the
//    ring, which wait for their data.  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int P = 4;                 // W positions a thread, one 4-wide access
constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE_W = 128;
constexpr int MAX_TILE_H = 64;
constexpr int PLANE = 1600;          // a staged tile: (tile_h + 2) * (tile_w + 8) elements
constexpr int RING = 4;              // staged planes: RING - 2 in flight ahead of use
constexpr int WAVES = 4;             // the grid, in blocks resident on the card
constexpr int MIN_CHUNK = 4;         // depths a block walks, at least

// a 4-element chunk from global to shared memory, asynchronously; zeros
// where !valid (src-size 0)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Raw: the storage type's bits, which shared memory holds; widening to
// fp32 on the way into registers, rounding on the way out
template <typename T> struct Io;

template <> struct Io<float> {
  using Raw = float;
  // the 6 values p[-1] .. p[4] of a shared row, p on 16 bytes
  static __device__ __forceinline__ void row6(const float* p, float (&w)[P + 2]) {
    const float4 m = *reinterpret_cast<const float4*>(p);
    w[0] = p[-1];
    w[1] = m.x;
    w[2] = m.y;
    w[3] = m.z;
    w[4] = m.w;
    w[5] = p[P];
  }
  static __device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <> struct Io<__nv_bfloat16> {
  using Raw = unsigned short;
  // a bf16 is the top half of the fp32 of the same value
  static __device__ __forceinline__ float widen(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
  }
  // p on 8 bytes
  static __device__ __forceinline__ void row6(const unsigned short* p, float (&w)[P + 2]) {
    const uint2 m = *reinterpret_cast<const uint2*>(p);
    w[0] = widen(p[-1]);
    w[1] = widen(m.x & 0xffffu);
    w[2] = __uint_as_float(m.x & 0xffff0000u);
    w[3] = widen(m.y & 0xffffu);
    w[4] = __uint_as_float(m.y & 0xffff0000u);
    w[5] = widen(p[P]);
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // .x = a, the low half
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                                float c, float d) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(a, b), pack(c, d));
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

struct Geometry {
  int batch, depth, h, w;      // the input [B,D,H,W] in the kernel's axes (NHWC: [B,H,W,D])
  int tile_h, tile_w;          // output rows and columns of a block's tile
  int tiles_h, tiles_w;        // tiles across H and W
  int chunk;                   // depths a block walks
  bool nhwc;                   // the taps' axes: (y, x, z) of the image where set
  size_t out_batch, out_feature, out_plane, out_row;   // the output's strides
};

template <typename T, int F, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv3d_over_channels_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                            const T* __restrict__ bias, T* __restrict__ out, Geometry g) {
  using Raw = typename Io<T>::Raw;
  __shared__ __align__(16) Raw ring[RING][PLANE];
  __shared__ __align__(16) float taps[27][F];      // [kz*9 + ky*3 + kx][feature]
  __shared__ float biases[F];

  const int tid = threadIdx.x, threads = blockDim.x;
  for (int i = tid; i < 27 * F; i += threads) {     // weight [F,1,3,3,3]: (f, kz, ky, kx)
    const int t = i % 27;
    taps[g.nhwc ? (t / 3 % 3) * 9 + (t % 3) * 3 + t / 9 : t][i / 27] = Io<T>::load1(weight + i);
  }
  if (tid < F) biases[tid] = Io<T>::load1(bias + tid);

  int blk = blockIdx.x;
  const int x0 = (blk % g.tiles_w) * g.tile_w;
  blk /= g.tiles_w;
  const int y0 = (blk % g.tiles_h) * g.tile_h;
  blk /= g.tiles_h;
  const int b = blk % g.batch;
  const int z0 = (blk / g.batch) * g.chunk;
  const int steps = min(g.chunk, g.depth - z0);      // outputs z0 .. z0+steps-1

  // a staged plane: rows y0-1 .. y0+tile_h, columns x0-4 .. x0+tile_w+3 as
  // chunks of 4, so that each thread's 4 columns start on a chunk
  const int stride = g.tile_w + 8, rows = g.tile_h + 2, quads = g.tile_w / P;
  const int chunks = rows * (quads + 2);
  const int tx = tid % quads, ty = tid / quads;
  const int ry = min(ty, g.tile_h - 1);              // spare threads read a real row
  const int y = y0 + ty, xo = x0 + P * tx;
  const bool stores = ty < g.tile_h && y < g.h && xo < g.w;
  const size_t hw = static_cast<size_t>(g.h) * g.w;
  const Raw* xb = reinterpret_cast<const Raw*>(x) + static_cast<size_t>(b) * g.depth * hw;

  // plane z of the tile into buf, zeros outside the volume; one cp.async
  // group a call, empty where the chunk does not need the plane
  auto stage = [&](int z, Raw* buf, bool needed) {
    const bool in = z >= 0 && z < g.depth;
    const Raw* plane = xb + static_cast<size_t>(in ? z : 0) * hw;
    for (int i = tid; needed && i < chunks; i += threads) {
      const int r = i / (quads + 2), c = i % (quads + 2);
      const int gy = y0 - 1 + r, gx = x0 - P + P * c;
      const bool row_in = in && gy >= 0 && gy < g.h;
      const Raw* src = plane + static_cast<size_t>(row_in ? gy : 0) * g.w;
      Raw* dst = buf + r * stride + P * c;
      if (VEC) {
        const bool valid = row_in && gx >= 0 && gx < g.w;
        cp_async<P * sizeof(Raw)>(dst, src + (valid ? gx : 0), valid);
      } else {
#pragma unroll
        for (int e = 0; e < P; ++e)
          dst[e] = row_in && gx + e >= 0 && gx + e < g.w ? __ldg(src + gx + e) : Raw(0);
      }
    }
    cp_async_commit();
  };

  // win[s][r][c]: a plane's rows y-1 .. y+1 at columns xo-1 .. xo+4
  float win[3][3][P + 2];
  auto read = [&](const Raw* buf, float (&w)[3][P + 2]) {
#pragma unroll
    for (int r = 0; r < 3; ++r) Io<T>::row6(buf + (ry + r) * stride + P * (tx + 1), w[r]);
  };

  T* ob = out + static_cast<size_t>(b) * g.out_batch + static_cast<size_t>(z0) * g.out_plane +
          static_cast<size_t>(y) * g.out_row + xo;

  // plane j = z - (z0 - 1) lives in ring[j % RING]: planes 0 .. RING-1 in
  // flight, 0 and 1 into the window slots 0 and 1 (the first barrier also
  // publishes the weights)
#pragma unroll
  for (int j = 0; j < RING; ++j) stage(z0 - 1 + j, ring[j], j <= steps + 1);
  cp_async_wait<RING - 1>();
  __syncthreads();
  read(ring[0], win[0]);
  cp_async_wait<RING - 2>();
  __syncthreads();
  read(ring[1], win[1]);

  // output z0 + k from the windows of planes k, k+1, k+2 in slots K, K+1,
  // K+2 (mod 3), K = k mod 3; plane k+2 comes into the window in this step
  // and plane k+RING goes in flight into the buffer plane k left
  auto step = [&](auto slot, int k) {
    constexpr int K = decltype(slot)::value;
    cp_async_wait<RING - 3>();
    __syncthreads();
    read(ring[(k + 2) % RING], win[(K + 2) % 3]);
    stage(z0 - 1 + k + RING, ring[k % RING], k + RING <= steps + 1);
    float acc[F][P];
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[f][p] = 0.0f;
#pragma unroll
    for (int kz = 0; kz < 3; ++kz)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wt = taps[kz * 9 + ky * 3 + kx];
#pragma unroll
          for (int f0 = 0; f0 < F; f0 += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wt + f0);
            const float wf[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int f = 0; f < 4; ++f)
#pragma unroll
              for (int p = 0; p < P; ++p)
                acc[f0 + f][p] = fmaf(wf[f], win[(K + kz) % 3][ky][p + kx], acc[f0 + f][p]);
          }
        }
    if (stores) {
      T* o = ob + static_cast<size_t>(k) * g.out_plane;
#pragma unroll
      for (int f = 0; f < F; ++f, o += g.out_feature) {
        const float bf = biases[f];
        if (VEC) {
          Io<T>::store4(o, acc[f][0] + bf, acc[f][1] + bf, acc[f][2] + bf, acc[f][3] + bf);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p)
            if (xo + p < g.w) Io<T>::store1(o + p, acc[f][p] + bf);
        }
      }
    }
  };

  for (int k = 0; k < steps; k += 3) {    // k and the barriers: the same in every thread
    step(std::integral_constant<int, 0>{}, k);
    if (k + 1 < steps) step(std::integral_constant<int, 1>{}, k + 1);
    if (k + 2 < steps) step(std::integral_constant<int, 2>{}, k + 2);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int F, bool VEC>
cudaError_t launch(const void* x, const void* weight, const void* bias, void* out,
                   Geometry g, int threads, cudaStream_t stream) {
  const auto kernel = conv3d_over_channels_kernel<T, F, VEC>;
  static int resident[MAX_THREADS / 32 + 1];   // blocks an SM holds, by warps a block
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int& per_sm = resident[threads / 32];
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(g.batch) * g.tiles_h * g.tiles_w;
  const long long want = static_cast<long long>(WAVES) * std::max(per_sm, 1) * sms;
  const int chunks = static_cast<int>(std::min<long long>(
      ceil_div(g.depth, MIN_CHUNK), std::max(1LL, (want + tiles - 1) / tiles)));
  g.chunk = ceil_div(g.depth, chunks);
  const long long blocks = tiles * ceil_div(g.depth, g.chunk);
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<int>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), static_cast<const T*>(bias),
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* weight, const void* bias, void* out,
                         int features, bool vec, Geometry g, int threads, cudaStream_t s) {
  if (features == 4)
    return vec ? launch<T, 4, true>(x, weight, bias, out, g, threads, s)
               : launch<T, 4, false>(x, weight, bias, out, g, threads, s);
  return vec ? launch<T, 8, true>(x, weight, bias, out, g, threads, s)
             : launch<T, 8, false>(x, weight, bias, out, g, threads, s);
}

}  // namespace

// Launch on `stream` (a cudaStream_t) for x [batch, depth, h, w], weight
// [features, 1, 3, 3, 3], bias [features] and out [batch, features * depth, h,
// w], all of one dtype: 0 float32, 1 bfloat16; features 4 or 8; layout 0
// (NCHW: x and out contiguous) or 1 (NHWC: x contiguous as [batch, h, w,
// depth], out as [batch, h, w, features * depth]); every size >= 1 and h, w,
// depth < 2^30.  Returns a cudaError_t: the launch's, from cudaGetLastError().
extern "C" int mte_conv3d_over_channels(const void* x, const void* weight, const void* bias,
                                        void* out, int dtype, int features, int layout,
                                        int batch, int depth, int h, int w, void* stream) {
  if ((dtype != 0 && dtype != 1) || (features != 4 && features != 8) ||
      (layout != 0 && layout != 1) || batch < 1 || depth < 1 || h < 1 || w < 1 ||
      h >= (1 << 30) || w >= (1 << 30) || depth >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{};
  g.batch = batch;
  g.nhwc = layout == 1;
  // the kernel's axes: (depth, rows, columns) = (D, H, W) or (H, W, D)
  g.depth = g.nhwc ? h : depth;
  g.h = g.nhwc ? w : h;
  g.w = g.nhwc ? depth : w;
  const size_t plane = static_cast<size_t>(g.h) * g.w;
  if (g.nhwc) {               // out [B, H, W, F, D]
    g.out_row = static_cast<size_t>(features) * g.w;
    g.out_plane = g.out_row * g.h;
    g.out_batch = g.out_plane * g.depth;
    g.out_feature = g.w;
  } else {                    // out [B, F, D, H, W]
    g.out_row = g.w;
    g.out_plane = plane;
    g.out_feature = plane * g.depth;
    g.out_batch = g.out_feature * features;
  }
  g.tiles_w = ceil_div(g.w, MAX_TILE_W);
  g.tile_w = ceil_div(ceil_div(g.w, g.tiles_w), P) * P;
  const int quads = g.tile_w / P;
  g.tiles_h = ceil_div(g.h, std::min(MAX_TILE_H, MAX_THREADS / quads));
  g.tile_h = ceil_div(g.h, g.tiles_h);
  const int threads = ceil_div(g.tile_h * quads, 32) * 32;
  if ((g.tile_h + 2) * (g.tile_w + 8) > PLANE || threads > MAX_THREADS)   // the ring's planes
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t align = dtype == 0 ? 16 : 8;
  const bool vec = g.w % P == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % align == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(x, weight, bias, out, features, vec, g, threads, s)
                 : launch_typed<__nv_bfloat16>(x, weight, bias, out, features, vec, g, threads, s);
  return static_cast<int>(err);
}

extern "C" const char* mte_conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
