// K2 and K3: bilinear grid sample with border padding, NHWC, 4 channels,
// and the sample's gradient with respect to the grid.
//
// K2 replaces tha4_tpu/ops/pallas_warp.py:grid_sample_fast (primal kernel
// _forward_impl / _fwd_kernel).  K3, the differentiable warp, replaces its
// custom VJP: the forward _forward_corners_impl / _fwd_corners_kernel and
// the backward _grid_sample_fast_bwd.  Semantics are torch
// grid_sample(mode='bilinear', padding_mode='border', align_corners=False),
// in the operation order of
// tha4_tpu/ops/warp.py:grid_sample_bilinear_border:
//   ix = clamp(((gx + 1) * W - 1) * 0.5, 0, W - 1), floor, corners clamped
//   to W - 1 / H - 1, lerp along x then y in f32, store in the image dtype.
// K3's forward is K2's kernel (its out is the TPU corners kernel's out).
// Its backward, grid_sample_grid_backward_kernel, gathers the four corners
// again and forms _fwd_corners_kernel's f32 fields in its order: top_dx =
// v01 - v00, bot_dx = v11 - v10, top = v00 + top_dx * tx, bot = v10 +
// bot_dx * tx, dx = top_dx + (bot_dx - top_dx) * ty, dy = bot - top; then
// dgrid = (sum_c g_c * dx_c, sum_c g_c * dy_c), c = 0..3 in order, zero
// where the unclamped coordinate is not strictly inside (0, size - 1),
// times size / 2 (pallas_warp.py:336-350).  The image gets no gradient.
// The _rn intrinsics keep nvcc from fusing those steps into FMAs, so the
// kernels round exactly where the plain PyTorch versions round.
//
// These warps are EXACT.  The TPU kernels are not: they gather through
// one-hot matmuls over a VMEM window, so displacements beyond about 60 rows
// / 63 columns (52 for K3's taller-window variant) clamp to the window edge,
// and K2's lerp weights are truncated to bf16 by the single-pass MXU dot.  A
// GPU reads any texel directly, so neither limit exists here.
//
// What bounds them on an NVIDIA H100 80GB HBM3 (50 MB L2, 3.35 TB/s; the
// figures below are for that card at a 700 W power limit): memory.  A 512^2
// frame reads the 2 MB (bf16) or 4 MB (f32) image, which stays in L2 across
// the four corner gathers, plus 2 MB of grid, and writes one image.  The
// TPU saves a second gather at cotangent time by writing dx and dy, two f32
// images, in the forward; on this card that trade runs the other way: at
// the body student's head warp, (8, 512^2, 4), the fields are 67 MB written
// and read back, while one batch of images (16.8 MB bf16, 33.5 MB f32) fits
// in L2 and the backward's regather costs little beyond its compulsory
// bytes.  K3 moves forward 50.3 + backward 67.1 MB in bf16 (image, grid,
// out; g, image, grid, dgrid), 83.9 + 100.7 MB in f32.  Design: one thread
// per output pixel; each corner texel is one 16-byte (f32) or 8-byte (bf16)
// load, each output one store of the same width, each grid point and its
// gradient one 8-byte access; no atomics, so two calls are bit-identical.
// chip_smoke.py measured on that card: K2 3.1 us a call at 512^2 and B = 1
// (the card's own time, a CUDA graph; 1024 blocks, too few to reach the
// card's bandwidth), 0.021 ms at B = 8, bf16, against about 1 ms for the
// plain PyTorch version; K3's forward + grid backward at the head warp
// 0.046 / 0.065 ms bf16 / f32, 0.77 / 0.85 of the bytes' bound.

#include "common.cuh"

namespace {

struct Texel {
  float c[4];
};

template <typename T> __device__ __forceinline__ Texel load_texel(const T* p);
template <> __device__ __forceinline__ Texel load_texel<float>(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return Texel{{v.x, v.y, v.z, v.w}};
}
template <> __device__ __forceinline__ Texel load_texel<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return Texel{{a.x, a.y, b.x, b.y}};
}

template <typename T> __device__ __forceinline__ void store_texel(T* p, const Texel& t);
template <> __device__ __forceinline__ void store_texel<float>(float* p, const Texel& t) {
  *reinterpret_cast<float4*>(p) = make_float4(t.c[0], t.c[1], t.c[2], t.c[3]);
}
template <> __device__ __forceinline__ void store_texel<__nv_bfloat16>(__nv_bfloat16* p,
                                                                       const Texel& t) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(t.c[0], t.c[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(t.c[2], t.c[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), t));
}

// Unnormalise (align_corners=False): the source coordinate before the clamp.
__device__ __forceinline__ float unnormalise(float g, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(size)), 1.0f), 0.5f);
}

// The border clamp of the unnormalised coordinate.
__device__ __forceinline__ float source_coord(float g, int size) {
  return fminf(fmaxf(unnormalise(g, size), 0.0f), static_cast<float>(size - 1));
}

// One output pixel's sample point: the offset of its batch element's image,
// the four corners' texel offsets inside that image and the lerp weights.
struct Sample {
  size_t image;
  size_t c00, c01, c10, c11;
  float tx, ty;
};

__device__ __forceinline__ Sample sample_at(float2 g, long long i, int h, int w, long long per_image) {
  const int b = static_cast<int>(i / per_image);
  const float ix = source_coord(g.x, w);
  const float iy = source_coord(g.y, h);
  const float fx0 = floorf(ix);
  const float fy0 = floorf(iy);
  const int x0 = static_cast<int>(fx0);
  const int y0 = static_cast<int>(fy0);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  return Sample{static_cast<size_t>(b) * h * w * 4,
                (static_cast<size_t>(y0) * w + x0) * 4, (static_cast<size_t>(y0) * w + x1) * 4,
                (static_cast<size_t>(y1) * w + x0) * 4, (static_cast<size_t>(y1) * w + x1) * 4,
                __fsub_rn(ix, fx0), __fsub_rn(iy, fy0)};
}

template <typename T>
__global__ void __launch_bounds__(256)
grid_sample_kernel(const T* __restrict__ image, const float2* __restrict__ grid,
                   T* __restrict__ out, int n, int h, int w, int ho, int wo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_image = static_cast<long long>(ho) * wo;
  if (i >= per_image * n) return;
  const Sample s = sample_at(__ldg(grid + i), i, h, w, per_image);
  const T* img = image + s.image;
  const Texel v00 = load_texel<T>(img + s.c00);
  const Texel v01 = load_texel<T>(img + s.c01);
  const Texel v10 = load_texel<T>(img + s.c10);
  const Texel v11 = load_texel<T>(img + s.c11);
  Texel o;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top = lerp_rn(v00.c[c], v01.c[c], s.tx);
    const float bottom = lerp_rn(v10.c[c], v11.c[c], s.tx);
    o.c[c] = lerp_rn(top, bottom, s.ty);
  }
  store_texel<T>(out + i * 4, o);
}

// K3's backward: dgrid from the output's cotangent g, the image and the
// grid, the four corners gathered again (from L2: the forward just read them).
template <typename T>
__global__ void __launch_bounds__(256)
grid_sample_grid_backward_kernel(const T* __restrict__ gout, const T* __restrict__ image,
                                 const float2* __restrict__ grid, float2* __restrict__ dgrid,
                                 int n, int h, int w, int ho, int wo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_image = static_cast<long long>(ho) * wo;
  if (i >= per_image * n) return;
  const float2 p = __ldg(grid + i);
  const Sample s = sample_at(p, i, h, w, per_image);
  const T* img = image + s.image;
  const Texel v00 = load_texel<T>(img + s.c00);
  const Texel v01 = load_texel<T>(img + s.c01);
  const Texel v10 = load_texel<T>(img + s.c10);
  const Texel v11 = load_texel<T>(img + s.c11);
  const Texel go = load_texel<T>(gout + i * 4);
  float sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top_dx = __fsub_rn(v01.c[c], v00.c[c]);
    const float bot_dx = __fsub_rn(v11.c[c], v10.c[c]);
    const float top = __fadd_rn(v00.c[c], __fmul_rn(top_dx, s.tx));
    const float bot = __fadd_rn(v10.c[c], __fmul_rn(bot_dx, s.tx));
    const float ddx = __fadd_rn(top_dx, __fmul_rn(__fsub_rn(bot_dx, top_dx), s.ty));
    const float ddy = __fsub_rn(bot, top);
    sx = __fadd_rn(sx, __fmul_rn(go.c[c], ddx));
    sy = __fadd_rn(sy, __fmul_rn(go.c[c], ddy));
  }
  // The border clamp passes no gradient: strict masks on the unclamped
  // coordinate, so a sample exactly on the first or last texel centre gets 0.
  const float ix = unnormalise(p.x, w);
  const float iy = unnormalise(p.y, h);
  const float mx = (ix > 0.0f && ix < static_cast<float>(w - 1)) ? 1.0f : 0.0f;
  const float my = (iy > 0.0f && iy < static_cast<float>(h - 1)) ? 1.0f : 0.0f;
  dgrid[i] = make_float2(__fmul_rn(__fmul_rn(sx, mx), 0.5f * static_cast<float>(w)),
                         __fmul_rn(__fmul_rn(sy, my), 0.5f * static_cast<float>(h)));
}

}  // namespace

// image (N, H, W, 4) and out (N, Ho, Wo, 4) in f32 or bf16; grid
// (N, Ho, Wo, 2) f32 with x first.  Returns a cudaError_t (0 on success).
extern "C" int tha4_grid_sample_forward(const void* image, const void* grid, void* out, int n,
                                        int h, int w, int ho, int wo, int is_bf16,
                                        void* stream) {
  if (n < 1 || h < 1 || w < 1 || ho < 1 || wo < 1) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(n) * ho * wo;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    grid_sample_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(image), static_cast<const float2*>(grid),
        static_cast<__nv_bfloat16*>(out), n, h, w, ho, wo);
  } else {
    grid_sample_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(image), static_cast<const float2*>(grid),
        static_cast<float*>(out), n, h, w, ho, wo);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3's backward: g (N, Ho, Wo, 4) in the image's dtype, image (N, H, W, 4),
// grid (N, Ho, Wo, 2) f32 -> dgrid (N, Ho, Wo, 2) f32.  Returns a
// cudaError_t (0 on success).
extern "C" int tha4_grid_sample_grid_backward(const void* g, const void* image, const void* grid,
                                              void* dgrid, int n, int h, int w, int ho, int wo,
                                              int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w < 1 || ho < 1 || wo < 1) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(n) * ho * wo;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    grid_sample_grid_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(image),
        static_cast<const float2*>(grid), static_cast<float2*>(dgrid), n, h, w, ho, wo);
  } else {
    grid_sample_grid_backward_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(image),
        static_cast<const float2*>(grid), static_cast<float2*>(dgrid), n, h, w, ho, wo);
  }
  return static_cast<int>(cudaGetLastError());
}
