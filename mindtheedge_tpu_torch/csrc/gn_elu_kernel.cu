// GroupNorm(16) + ELU over NHWC bfloat16 activations, forward and backward,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and ELU to XLA
// (mindtheedge_tpu/ops/blocks.py).  The port's plain version is
// F.elu(F.group_norm(x.contiguous())) (ops/cuda/gn_elu_kernel.py:plain),
// and ATen's CUDA GroupNorm takes NCHW-contiguous input only, so on the
// bf16 path, whose convs run NHWC (ops/blocks.py:nhwc), it would copy every
// activation back to NCHW for the next conv to transpose again.  This pair
// reads and writes NHWC.  Wrapper: mindtheedge_tpu_torch/ops/cuda/
// gn_elu_kernel.py.  Times: PERF.md.
//
// What it computes, for x [B, P, C] (a channels-last [B,C,H,W], P = H*W,
// C = 16 groups of Cg contiguous channels), gamma, beta [C], all bf16:
//   forward   mean, rstd [B,16] (fp32, biased variance, rstd = rsqrt(var + eps))
//             y = elu(gamma * (x - mean) * rstd + beta), computed in fp32
//             (a = rstd * gamma, b = beta - a * mean, z = fmaf(x, a, b)) and
//             rounded once to bf16 (round to nearest even);
//   backward  dz = dy where y > 0, dy * (y + 1) elsewhere (ELU's derivative
//             from its output, as autograd of F.elu takes it);
//             ds[b,c] = sum_p dz * x, db[b,c] = sum_p dz;
//             ATen's GroupNorm backward from them: per (b,g) with
//             sum1 = sum_c ds * gamma, sum2 = sum_c db * gamma, n = Cg * P,
//             c2 = (sum2 * mean - sum1) * rstd^3 / n,
//             c3 = -c2 * mean - sum2 * rstd / n;
//             dx = rstd * gamma * dz + c2 * x + c3 (bf16, rounded once);
//             dgamma[c] = sum_b (ds - db * mean) * rstd, dbeta[c] = sum_b db.
// Every sum is fp32, in an order fixed by the shape, so two runs give equal
// bits: no float atomics.
//
// Bound on the H100: bytes.  The forward reads x twice (statistics, then
// the normalise) and writes y: 6 bytes an element; the backward reads dy,
// y and x twice (sums, then the data gradient) and writes dx: 14 bytes an
// element.  At 3.35 TB/s that is 1.79 ns a million elements forward and
// 4.18 backward; FLOPs are ~10 an element, far under the card's rate.
// ATen's path (moments, normalise, ELU; ELU backward, GroupNorm's sums and
// data gradient) moves 10 and 16 bytes an element, in NCHW.
//
// Design.
//  * Coalesced channel vectors.  A pixel's C channels are contiguous: a
//    thread reads 16 bytes (8 channels) of one pixel, the block's threads
//    cover C/8 vectors of 256*8/C consecutive pixels, so a warp reads
//    512 contiguous bytes.  A thread keeps one channel vector for the whole
//    pass: its channels' affine factors stay in registers.
//  * Split statistics.  Each image's pixels are cut into tiles, which the
//    wrapper sizes so that the grid holds about two waves of resident
//    blocks over all SMs; each block writes its tile's partials, and a
//    second, small kernel combines them in tile order: Welford triplets
//    (count, mean, M2, combined by Chan's formula) in the forward, as ATen's
//    RowwiseMoments does, plain fp32 sums in the backward.
//  * Launches: forward statistics, their combination, normalise + ELU;
//    backward sums, their combination into per-group coefficients (and per
//    image affine partials), the data gradient, and the affine gradients
//    summed over the batch.  The forward saves nothing but mean and rstd;
//    the backward reads the input and the output the autograd Function
//    saved, as autograd of F.elu(F.group_norm(x)) saves them.
//  * Shapes: C a multiple of 16, at most 2048, with Cg in {1, 2, 4} or a
//    multiple of 8 (a 16-byte vector then holds whole groups or lies in
//    one); any B up to 65535 and any P; 16-byte aligned pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUPS = 16;
constexpr int VEC = 8;              // bf16 channels in a 16-byte access
constexpr int THREADS = 256;        // the streaming passes' blocks, at most
constexpr int COMBINE_THREADS = 1024;
constexpr int MAX_CHANNELS = 2048;
constexpr int SPLIT = 16;           // threads a group in the block's reduction

struct Stat {
  float n, mean, m2;
};

// Chan's parallel Welford combination
__device__ __forceinline__ Stat combine(Stat a, Stat b) {
  if (b.n == 0.0f) return a;
  if (a.n == 0.0f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float delta = b.mean - a.mean;
  return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[VEC]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);              // the low half first
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // .x = a, the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[VEC]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

struct Shape {
  int batch, channels, tiles;   // tiles an image
  int vecs;                     // channels / VEC
  int lanes;                    // pixels a block covers at once: blockDim = lanes * vecs
  int group_channels;           // channels / GROUPS
  long long pixels;             // H * W
  long long tile_pixels;        // pixels a tile (the last may hold fewer)
};

// ---------------------------------------------------------------------------
// forward

// GPV: groups a 16-byte vector holds (8 / Cg), or 1 where a group spans vectors
template <int GPV>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const uint4* __restrict__ x, Stat* __restrict__ partial, Shape s) {
  __shared__ Stat red[THREADS * GPV];
  __shared__ Stat group_red[GROUPS * SPLIT];
  constexpr int E = VEC / GPV;                 // a group's channels in a vector
  const int v = threadIdx.x % s.vecs, lane = threadIdx.x / s.vecs, b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * s.tile_pixels;
  const long long p1 = min(p0 + s.tile_pixels, s.pixels);
  const uint4* xb = x + static_cast<size_t>(b) * s.pixels * s.vecs + v;

  Stat acc[GPV];
#pragma unroll
  for (int j = 0; j < GPV; ++j) acc[j] = Stat{0.0f, 0.0f, 0.0f};
  for (long long p = p0 + lane; p < p1; p += s.lanes) {
    float f[VEC];
    unpack8(__ldg(xb + static_cast<size_t>(p) * s.vecs), f);
#pragma unroll
    for (int j = 0; j < GPV; ++j) {
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) sum += f[j * E + e];
      const float m = sum * (1.0f / E);
      float m2 = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = f[j * E + e] - m;
        m2 = fmaf(d, d, m2);
      }
      acc[j] = combine(acc[j], Stat{static_cast<float>(E), m, m2});
    }
  }
#pragma unroll
  for (int j = 0; j < GPV; ++j) red[threadIdx.x * GPV + j] = acc[j];
  __syncthreads();

  // group g's entries: GPV > 1, slot g % GPV of vector g / GPV in every
  // lane; GPV == 1, the group's vpg vectors in every lane.  SPLIT threads a
  // group take every SPLIT-th entry, then one thread combines their SPLIT.
  const int vpg = GPV > 1 ? 1 : s.group_channels / VEC;
  const int count = s.lanes * vpg;
  for (int i = threadIdx.x; i < GROUPS * SPLIT; i += blockDim.x) {
    const int g = i / SPLIT;
    Stat st{0.0f, 0.0f, 0.0f};
    for (int e = i % SPLIT; e < count; e += SPLIT) {
      const int t = GPV > 1 ? e * s.vecs + g / GPV
                            : (e / vpg) * s.vecs + g * vpg + e % vpg;
      st = combine(st, red[t * GPV + (GPV > 1 ? g % GPV : 0)]);
    }
    group_red[i] = st;
  }
  __syncthreads();
  if (threadIdx.x < GROUPS) {
    Stat st = group_red[threadIdx.x * SPLIT];
    for (int k = 1; k < SPLIT; ++k) st = combine(st, group_red[threadIdx.x * SPLIT + k]);
    partial[(static_cast<size_t>(b) * s.tiles + blockIdx.x) * GROUPS + threadIdx.x] = st;
  }
}

// one block an image, one warp a group: the tiles' partials in tile order
// per lane, then a fixed shuffle tree
__global__ void __launch_bounds__(GROUPS * 32)
stats_combine_kernel(const Stat* __restrict__ partial, float* __restrict__ mean,
                     float* __restrict__ rstd, float eps, Shape s) {
  const int g = threadIdx.x / 32, l = threadIdx.x % 32, b = blockIdx.x;
  Stat st{0.0f, 0.0f, 0.0f};
  for (int t = l; t < s.tiles; t += 32)
    st = combine(st, partial[(static_cast<size_t>(b) * s.tiles + t) * GROUPS + g]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stat o{__shfl_down_sync(0xffffffffu, st.n, off),
                 __shfl_down_sync(0xffffffffu, st.mean, off),
                 __shfl_down_sync(0xffffffffu, st.m2, off)};
    st = combine(st, o);
  }
  if (l == 0) {
    mean[b * GROUPS + g] = st.mean;
    rstd[b * GROUPS + g] = rsqrtf(fmaxf(st.m2 / st.n, 0.0f) + eps);
  }
}

__global__ void __launch_bounds__(THREADS)
apply_kernel(const uint4* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
             const __nv_bfloat16* __restrict__ beta, const float* __restrict__ mean,
             const float* __restrict__ rstd, uint4* __restrict__ y, Shape s) {
  const int v = threadIdx.x % s.vecs, lane = threadIdx.x / s.vecs, b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * s.tile_pixels;
  const long long p1 = min(p0 + s.tile_pixels, s.pixels);
  float a[VEC], c[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = v * VEC + e, g = b * GROUPS + ch / s.group_channels;
    a[e] = rstd[g] * bf(gamma, ch);
    c[e] = fmaf(-a[e], mean[g], bf(beta, ch));
  }
  const size_t base = static_cast<size_t>(b) * s.pixels * s.vecs + v;
  for (long long p = p0 + lane; p < p1; p += s.lanes) {
    const size_t i = base + static_cast<size_t>(p) * s.vecs;
    float f[VEC];
    unpack8(__ldg(x + i), f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float z = fmaf(f[e], a[e], c[e]);
      f[e] = z > 0.0f ? z : expm1f(z);
    }
    y[i] = pack8(f);
  }
}

// ---------------------------------------------------------------------------
// backward

// ELU's derivative from its bf16 output, times the incoming gradient
__device__ __forceinline__ float elu_grad(float dy, float y) {
  return y > 0.0f ? dy : dy * (y + 1.0f);
}

__global__ void __launch_bounds__(THREADS)
grad_sums_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ y,
                 const uint4* __restrict__ x, float2* __restrict__ partial, Shape s) {
  __shared__ float2 red[THREADS * VEC];
  const int v = threadIdx.x % s.vecs, lane = threadIdx.x / s.vecs, b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * s.tile_pixels;
  const long long p1 = min(p0 + s.tile_pixels, s.pixels);
  float ds[VEC], db[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) ds[e] = db[e] = 0.0f;
  const size_t base = static_cast<size_t>(b) * s.pixels * s.vecs + v;
  for (long long p = p0 + lane; p < p1; p += s.lanes) {
    const size_t i = base + static_cast<size_t>(p) * s.vecs;
    float g[VEC], o[VEC], in[VEC];
    unpack8(__ldg(dy + i), g);
    unpack8(__ldg(y + i), o);
    unpack8(__ldg(x + i), in);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float dz = elu_grad(g[e], o[e]);
      ds[e] = fmaf(dz, in[e], ds[e]);
      db[e] += dz;
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[threadIdx.x * VEC + e] = make_float2(ds[e], db[e]);
  __syncthreads();
  // channel ch = v * VEC + e: its lanes in order
  for (int ch = threadIdx.x; ch < s.channels; ch += blockDim.x) {
    float2 sum = make_float2(0.0f, 0.0f);
    for (int l = 0; l < s.lanes; ++l) {
      const float2 r = red[(l * s.vecs + ch / VEC) * VEC + ch % VEC];
      sum.x += r.x;
      sum.y += r.y;
    }
    partial[(static_cast<size_t>(b) * s.tiles + blockIdx.x) * s.channels + ch] = sum;
  }
}

// One block an image: the tiles' (ds, db) in a fixed order, then the
// image's per-group coefficients (c2, c3) and per-channel affine partials.
__global__ void __launch_bounds__(COMBINE_THREADS)
grad_combine_kernel(const float2* __restrict__ partial, const __nv_bfloat16* __restrict__ gamma,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    float2* __restrict__ coef, float2* __restrict__ affine, Shape s) {
  __shared__ float2 red[COMBINE_THREADS];
  __shared__ float2 sums[MAX_CHANNELS];
  const int b = blockIdx.x, C = s.channels;
  const int cc = min(C, static_cast<int>(blockDim.x)), splits = blockDim.x / cc;
  const int cl = threadIdx.x % cc, k = threadIdx.x / cc;
  const float2* pb = partial + static_cast<size_t>(b) * s.tiles * C;
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int ch = c0 + cl;
    float2 acc = make_float2(0.0f, 0.0f);
    if (k < splits && ch < C)
      for (int t = k; t < s.tiles; t += splits) {
        const float2 p = pb[static_cast<size_t>(t) * C + ch];
        acc.x += p.x;
        acc.y += p.y;
      }
    if (k < splits) red[k * cc + cl] = acc;
    __syncthreads();
    if (k == 0 && ch < C) {
      float2 tot = red[cl];
      for (int j = 1; j < splits; ++j) {
        tot.x += red[j * cc + cl].x;
        tot.y += red[j * cc + cl].y;
      }
      sums[ch] = tot;
    }
    __syncthreads();
  }
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    const int g = b * GROUPS + ch / s.group_channels;
    affine[static_cast<size_t>(b) * C + ch] =
        make_float2((sums[ch].x - sums[ch].y * mean[g]) * rstd[g], sums[ch].y);
  }
  if (threadIdx.x < GROUPS) {
    const int g = threadIdx.x, cg = s.group_channels;
    float sum1 = 0.0f, sum2 = 0.0f;
    for (int ch = g * cg; ch < (g + 1) * cg; ++ch) {
      const float ga = bf(gamma, ch);
      sum1 = fmaf(sums[ch].x, ga, sum1);
      sum2 = fmaf(sums[ch].y, ga, sum2);
    }
    const float m = mean[b * GROUPS + g], r = rstd[b * GROUPS + g];
    const float inv_n = 1.0f / (static_cast<float>(cg) * static_cast<float>(s.pixels));
    const float c2 = (sum2 * m - sum1) * r * r * r * inv_n;
    coef[b * GROUPS + g] = make_float2(c2, -c2 * m - sum2 * r * inv_n);
  }
}

__global__ void __launch_bounds__(THREADS)
grad_input_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ y,
                  const uint4* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
                  const float* __restrict__ rstd, const float2* __restrict__ coef,
                  uint4* __restrict__ dx, Shape s) {
  const int v = threadIdx.x % s.vecs, lane = threadIdx.x / s.vecs, b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * s.tile_pixels;
  const long long p1 = min(p0 + s.tile_pixels, s.pixels);
  float c1[VEC], c2[VEC], c3[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = v * VEC + e, g = b * GROUPS + ch / s.group_channels;
    c1[e] = rstd[g] * bf(gamma, ch);
    c2[e] = coef[g].x;
    c3[e] = coef[g].y;
  }
  const size_t base = static_cast<size_t>(b) * s.pixels * s.vecs + v;
  for (long long p = p0 + lane; p < p1; p += s.lanes) {
    const size_t i = base + static_cast<size_t>(p) * s.vecs;
    float g[VEC], o[VEC], in[VEC];
    unpack8(__ldg(dy + i), g);
    unpack8(__ldg(y + i), o);
    unpack8(__ldg(x + i), in);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      g[e] = fmaf(c1[e], elu_grad(g[e], o[e]), fmaf(c2[e], in[e], c3[e]));
    dx[i] = pack8(g);
  }
}

__global__ void __launch_bounds__(THREADS)
grad_affine_kernel(const float2* __restrict__ affine, __nv_bfloat16* __restrict__ dgamma,
                   __nv_bfloat16* __restrict__ dbeta, Shape s) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= s.channels) return;
  float dg = 0.0f, dbt = 0.0f;
  for (int b = 0; b < s.batch; ++b) {
    const float2 a = affine[static_cast<size_t>(b) * s.channels + ch];
    dg += a.x;
    dbt += a.y;
  }
  dgamma[ch] = __float2bfloat16_rn(dg);
  dbeta[ch] = __float2bfloat16_rn(dbt);
}

// ---------------------------------------------------------------------------

bool make_shape(int batch, long long pixels, int channels, int tiles, Shape& s) {
  if (batch < 1 || batch > 65535 || pixels < 1 || tiles < 1 || channels < GROUPS ||
      channels > MAX_CHANNELS || channels % GROUPS)
    return false;
  const int cg = channels / GROUPS;
  if (!(cg == 1 || cg == 2 || cg == 4 || cg % VEC == 0)) return false;
  s.batch = batch;
  s.channels = channels;
  s.tiles = tiles;
  s.vecs = channels / VEC;
  s.lanes = THREADS / s.vecs;
  s.group_channels = cg;
  s.pixels = pixels;
  s.tile_pixels = (pixels + tiles - 1) / tiles;
  return true;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The forward on `stream` (a cudaStream_t): x and y [batch, pixels, channels]
// bf16 (a channels-last [B,C,H,W]), gamma and beta [channels] bf16, mean and
// rstd [batch, 16] fp32 (written), partial a scratch of batch * tiles * 16 * 3
// floats.  Returns a cudaError_t: cudaErrorInvalidValue for a shape or a
// pointer it does not take, else the first launch's error.
extern "C" int mte_gn_elu_forward(const void* x, const void* gamma, const void* beta, void* y,
                                  void* mean, void* rstd, void* partial, int batch,
                                  long long pixels, int channels, int tiles, float eps,
                                  void* stream) {
  Shape s;
  if (!make_shape(batch, pixels, channels, tiles, s) || !aligned(x) || !aligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, batch);
  const int threads = s.lanes * s.vecs;
  const uint4* xv = static_cast<const uint4*>(x);
  Stat* part = static_cast<Stat*>(partial);
  switch (s.group_channels >= VEC ? 1 : VEC / s.group_channels) {
    case 1: stats_kernel<1><<<grid, threads, 0, st>>>(xv, part, s); break;
    case 2: stats_kernel<2><<<grid, threads, 0, st>>>(xv, part, s); break;
    case 4: stats_kernel<4><<<grid, threads, 0, st>>>(xv, part, s); break;
    default: stats_kernel<8><<<grid, threads, 0, st>>>(xv, part, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_combine_kernel<<<batch, GROUPS * 32, 0, st>>>(part, static_cast<float*>(mean),
                                                      static_cast<float*>(rstd), eps, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_kernel<<<grid, threads, 0, st>>>(
      xv, static_cast<const __nv_bfloat16*>(gamma), static_cast<const __nv_bfloat16*>(beta),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<uint4*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

// The backward on `stream`: dy, y, x and dx [batch, pixels, channels] bf16,
// gamma [channels] bf16, mean and rstd [batch, 16] fp32 from the forward;
// dgamma and dbeta [channels] bf16 (written); scratch: partial batch * tiles *
// channels float2, coef batch * 16 float2, affine batch * channels float2.
extern "C" int mte_gn_elu_backward(const void* dy, const void* y, const void* x,
                                   const void* gamma, const void* mean, const void* rstd,
                                   void* dx, void* dgamma, void* dbeta, void* partial,
                                   void* coef, void* affine, int batch, long long pixels,
                                   int channels, int tiles, void* stream) {
  Shape s;
  if (!make_shape(batch, pixels, channels, tiles, s) || !aligned(dy) || !aligned(y) ||
      !aligned(x) || !aligned(dx))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, batch);
  const int threads = s.lanes * s.vecs;
  const uint4 *dyv = static_cast<const uint4*>(dy), *yv = static_cast<const uint4*>(y),
              *xv = static_cast<const uint4*>(x);
  const __nv_bfloat16* ga = static_cast<const __nv_bfloat16*>(gamma);
  const float *mn = static_cast<const float*>(mean), *rs = static_cast<const float*>(rstd);
  float2 *part = static_cast<float2*>(partial), *cf = static_cast<float2*>(coef),
         *af = static_cast<float2*>(affine);
  grad_sums_kernel<<<grid, threads, 0, st>>>(dyv, yv, xv, part, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_combine_kernel<<<batch, COMBINE_THREADS, 0, st>>>(part, ga, mn, rs, cf, af, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_input_kernel<<<grid, threads, 0, st>>>(dyv, yv, xv, ga, rs, cf, static_cast<uint4*>(dx), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_affine_kernel<<<(channels + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      af, static_cast<__nv_bfloat16*>(dgamma), static_cast<__nv_bfloat16*>(dbeta), s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mte_gn_elu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
