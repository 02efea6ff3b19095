// K5: the polynomial sine of the SIREN training path and its gradient, one
// elementwise pass each.
//
// Replaces tha4_tpu/ops/pallas_siren.py:poly_sin, a jax.custom_vjp (not a
// pallas_call) over _fast_sin / _fast_cos that the body student's NHWC
// training forward runs after every sine layer's pre-activation a:
//   forward   out = T_out(fast_sin(a))                 (one rounding)
//   backward  da  = T_in(g * fast_cos(a))              (g widened to f32)
// The backward's residual is a alone, in its incoming dtype.  T_out may be
// narrower than T_in (f32 a, bf16 out): that is poly_sin(a).astype(bf16) of
// the JAX package's selective-f32 ("mixed") path fused into one pass; its
// gradient is the same expression, since widening a bf16 cotangent to f32 is
// exact.
//
// What bounds it on an H100: memory.  At the body student's widest layer
// (8 x 512^2 x 90) a pass reads 377 MB of f32 a and writes 189 MB of bf16;
// the polynomial is ~20 f32 operations per element, far under the card's
// rate.  Design: a grid-stride loop, four elements per thread per step with
// one 16-byte (f32) or 8-byte (bf16) load per operand, and a scalar tail.

#include "common.cuh"

namespace {

template <typename T> __device__ __forceinline__ void load4(const T* p, float v[4]);
template <> __device__ __forceinline__ void load4<float>(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
template <> __device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T> __device__ __forceinline__ void store4(T* p, const float v[4]);
template <> __device__ __forceinline__ void store4<float>(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float v[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(256)
poly_sin_forward_kernel(const TIn* __restrict__ a, TOut* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long quads = n / 4;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; q < quads; q += stride) {
    float v[4];
    load4<TIn>(a + q * 4, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = tha4::fast_sin(v[k]);
    store4<TOut>(out + q * 4, v);
  }
  for (long long i = quads * 4 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = tha4::from_f32<TOut>(tha4::fast_sin(tha4::ldg_f32<TIn>(a + i)));
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(256)
poly_sin_backward_kernel(const TIn* __restrict__ a, const TOut* __restrict__ g,
                         TIn* __restrict__ da, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long quads = n / 4;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; q < quads; q += stride) {
    float va[4], vg[4];
    load4<TIn>(a + q * 4, va);
    load4<TOut>(g + q * 4, vg);
#pragma unroll
    for (int k = 0; k < 4; ++k) va[k] = __fmul_rn(vg[k], tha4::fast_cos(va[k]));
    store4<TIn>(da + q * 4, va);
  }
  for (long long i = quads * 4 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    da[i] = tha4::from_f32<TIn>(__fmul_rn(tha4::ldg_f32<TOut>(g + i), tha4::fast_cos(tha4::ldg_f32<TIn>(a + i))));
  }
}

unsigned grid_for(long long n) {
  // Enough blocks to fill the card several times over; the loop strides the rest.
  const long long quads = (n + 3) / 4;
  const long long blocks = (quads + 255) / 256;
  return static_cast<unsigned>(blocks < 132 * 16 ? (blocks < 1 ? 1 : blocks) : 132 * 16);
}

}  // namespace

// dtype codes: 0 = f32 a and out, 1 = bf16 a and out, 2 = f32 a, bf16 out.
// Every pointer 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int tha4_poly_sin_forward(const void* a, void* out, long long n, int dtypes, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = grid_for(n);
  if (dtypes == 0) {
    poly_sin_forward_kernel<float, float><<<blocks, 256, 0, s>>>(static_cast<const float*>(a), static_cast<float*>(out), n);
  } else if (dtypes == 1) {
    poly_sin_forward_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(out), n);
  } else if (dtypes == 2) {
    poly_sin_forward_kernel<float, __nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<__nv_bfloat16*>(out), n);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// g has the forward output's dtype, da the input's (the dtype codes above).
extern "C" int tha4_poly_sin_backward(const void* a, const void* g, void* da, long long n, int dtypes,
                                      void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = grid_for(n);
  if (dtypes == 0) {
    poly_sin_backward_kernel<float, float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(g), static_cast<float*>(da), n);
  } else if (dtypes == 1) {
    poly_sin_backward_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(da), n);
  } else if (dtypes == 2) {
    poly_sin_backward_kernel<float, __nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(g), static_cast<float*>(da), n);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
