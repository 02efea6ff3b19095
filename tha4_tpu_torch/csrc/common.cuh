// Shared device helpers for the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tha4 {

// float <-> compute dtype.  bf16 conversion rounds to nearest even, as
// torch's .to(torch.bfloat16) and JAX's astype(bfloat16) do.
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Read-only (non-coherent cache) load of one element, widened to float.
template <typename T> __device__ __forceinline__ float ldg_f32(const T* p);
template <> __device__ __forceinline__ float ldg_f32<float>(const float* p) { return __ldg(p); }
template <> __device__ __forceinline__ float ldg_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Polynomial sine, the same function as tha4_tpu/ops/pallas_siren.py
// _fast_sin and tha4_tpu_torch/ops/cuda_siren.py fast_sin: Cody-Waite
// reduction by 2*pi (split into an exact high part and a low part), then an
// odd degree-11 polynomial on [-pi, pi].  Max error 6.5e-7 for |x| <= 200.
// rintf rounds half to even like jnp.round / torch.round.  The _rn
// intrinsics stop nvcc from contracting a multiply and an add into one FMA,
// so every rounding step is the one the plain PyTorch version takes.
// Never replaced by __sinf (inaccurate outside [-pi, pi]) or sinf.
__device__ __forceinline__ float fast_sin(float x) {
  const float k = rintf(__fmul_rn(x, 0.15915494309189535f));
  float r = __fsub_rn(x, __fmul_rn(k, 6.28125f));
  r = __fsub_rn(r, __fmul_rn(k, 1.9353071795864769e-03f));
  const float r2 = __fmul_rn(r, r);
  float p = __fadd_rn(2.6997142332e-06f, __fmul_rn(r2, -2.0362228527e-08f));
  p = __fadd_rn(-1.9808632984e-04f, __fmul_rn(r2, p));
  p = __fadd_rn(8.3324029750e-03f, __fmul_rn(r2, p));
  p = __fadd_rn(-1.6666552633e-01f, __fmul_rn(r2, p));
  p = __fadd_rn(9.9999959991e-01f, __fmul_rn(r2, p));
  return __fmul_rn(r, p);
}

// cos(x) = fast_sin(x + pi/2): the backward's stand-in for the polynomial's
// own derivative (tha4_tpu/ops/pallas_siren.py _fast_cos); they differ by
// ~1e-6, the polynomial's fit error.
__device__ __forceinline__ float fast_cos(float x) {
  return fast_sin(__fadd_rn(x, 1.57079632679489661923f));
}

}  // namespace tha4
