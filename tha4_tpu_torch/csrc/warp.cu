// K2: bilinear grid sample with border padding, NHWC, 4 channels.
//
// Replaces tha4_tpu/ops/pallas_warp.py:grid_sample_fast (primal kernel
// _forward_impl / _fwd_kernel).  Semantics are torch grid_sample(mode=
// 'bilinear', padding_mode='border', align_corners=False), in the operation
// order of tha4_tpu/ops/warp.py:grid_sample_bilinear_border:
//   ix = clamp(((gx + 1) * W - 1) * 0.5, 0, W - 1), floor, corners clamped
//   to W - 1 / H - 1, lerp along x then y in f32, store in the image dtype.
// The _rn intrinsics keep nvcc from fusing those steps into FMAs, so the
// kernel rounds exactly where the plain PyTorch version rounds.
//
// This warp is EXACT.  The TPU kernel is not: it gathers through one-hot
// matmuls over a VMEM window, so displacements beyond about 60 rows / 63
// columns clamp to the window edge, and its lerp weights are truncated to
// bf16 by the single-pass MXU dot.  A GPU reads any texel directly, so
// neither limit exists here.
//
// What bounds it on an H100: memory.  A 512^2 frame reads the 2 MB (bf16) or
// 4 MB (f32) image, which stays in the 50 MB L2 across the four corner
// gathers, plus 2 MB of grid, and writes one image.  Design: one thread per
// output pixel; each corner texel is one 16-byte (f32) or 8-byte (bf16)
// load, and the output one store of the same width.  At 512^2 that is 1024
// blocks, too few to reach the card's bandwidth: measured 0.024 ms a call on
// an H100 SXM 80 GB at a 700 W power limit, mostly launch and gather
// latency, against 0.87-0.96 ms for the plain PyTorch version.

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

// Unnormalise (align_corners=False), then clamp the coordinate (border).
__device__ __forceinline__ float source_coord(float g, int size) {
  const float x = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(size)), 1.0f), 0.5f);
  return fminf(fmaxf(x, 0.0f), static_cast<float>(size - 1));
}

template <typename T>
__global__ void __launch_bounds__(256)
grid_sample_kernel(const T* __restrict__ image, const float2* __restrict__ grid,
                   T* __restrict__ out, int n, int h, int w, int ho, int wo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_image = static_cast<long long>(ho) * wo;
  if (i >= per_image * n) return;
  const int b = static_cast<int>(i / per_image);

  const float2 g = __ldg(grid + i);
  const float ix = source_coord(g.x, w);
  const float iy = source_coord(g.y, h);
  const float fx0 = floorf(ix);
  const float fy0 = floorf(iy);
  const float tx = __fsub_rn(ix, fx0);
  const float ty = __fsub_rn(iy, fy0);
  const int x0 = static_cast<int>(fx0);
  const int y0 = static_cast<int>(fy0);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);

  const T* img = image + static_cast<size_t>(b) * h * w * 4;
  const Texel v00 = load_texel<T>(img + (static_cast<size_t>(y0) * w + x0) * 4);
  const Texel v01 = load_texel<T>(img + (static_cast<size_t>(y0) * w + x1) * 4);
  const Texel v10 = load_texel<T>(img + (static_cast<size_t>(y1) * w + x0) * 4);
  const Texel v11 = load_texel<T>(img + (static_cast<size_t>(y1) * w + x1) * 4);
  Texel o;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top = lerp_rn(v00.c[c], v01.c[c], tx);
    const float bottom = lerp_rn(v10.c[c], v11.c[c], tx);
    o.c[c] = lerp_rn(top, bottom, ty);
  }
  store_texel<T>(out + i * 4, o);
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
