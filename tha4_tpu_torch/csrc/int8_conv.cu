// Q1: the int8 teacher's stride-1 convolution (3x3 pad 1, or 1x1 pad 0) as
// an implicit GEMM on the int8 tensor cores, with the activation quantized
// as it is loaded and a per-output-channel dequantize epilogue.
//
// Replaces tha4_tpu/ops/quant.py:conv2d_int8, which the JAX package leaves to
// XLA (lax.conv_general_dilated on int8 operands into int32; no pallas_call):
//   xq  = clip(rint(x.f32 * inv), -127, 127)             inv = f32(1 / x_scale)
//   acc = sum over taps and Cin of xq * w8                (int32, exact)
//   out = T(acc.f32 * (xs * w_scale[co])) [+ T(bias[co])]  xs = f32(x_scale)
// T is x's dtype (f32 or bf16); the bias is added in T after the rounding,
// as the JAX conv adds it (ops/nn.py:172-176).  The sum is exact, so the
// kernel equals its plain version (ops/cuda_int8_conv.py int8_conv_plain)
// bit for bit, whatever the order.
//
// What bounds it on an H100: the int8 tensor cores (1979 TOP/s dense) at the
// teachers' wide levels, the bytes of x (read once per 64 output channels
// from L2) at the narrow ones.  This first version is simple: mma.sync
// m16n8k32 (s8 x s8 -> s32), a 128-pixel x 64-channel output tile per block
// of 8 warps (each 32 x 32), one 32-channel K step of one tap at a time
// staged through shared memory (x quantized on the way in), no software
// pipelining.  s8 wgmma fed by TMA is the later work.
//
// Layouts: x NHWC (N, H, W, Cin), contiguous; w8 (taps, Cout, Cin32) with
// each tap's input channels zero-padded to a multiple of 32; w_scale f32
// (Cout); bias T (Cout) or null; out NHWC (N, H, W, Cout).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 128;         // output pixels per block
constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // input channels per K step (one mma k)
constexpr int ROW = BK + 16;    // shared-memory row stride in bytes: no bank conflicts on fragment loads
constexpr int THREADS = 256;    // 8 warps: 4 along M x 2 along N, 32 x 32 each

__device__ __forceinline__ int quantize(float v, float inv) {
  // round half to even (rintf), then clip: jnp.round then jnp.clip.
  const float r = rintf(__fmul_rn(v, inv));
  return static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// 16 consecutive channels of x at one pixel, as floats.  vec: the 16 lie in
// x, start 16-byte aligned (Cin % 16 == 0, the pointer aligned).
template <typename T> __device__ __forceinline__ void load16(const T* p, int valid, bool vec, float v[16]);

template <> __device__ __forceinline__ void load16<float>(const float* p, int valid, bool vec, float v[16]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = i < valid ? __ldg(p + i) : 0.0f;
  }
}

template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, int valid, bool vec,
                                                                  float v[16]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + q);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[k]));
        v[8 * q + 2 * k] = f.x;
        v[8 * q + 2 * k + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = i < valid ? tha4::ldg_f32<__nv_bfloat16>(p + i) : 0.0f;
  }
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w8, const float* __restrict__ w_scale,
                 const T* __restrict__ bias, T* __restrict__ out, int n, int h, int w, int cin, int cout, int k,
                 float inv, float xs, bool vec) {
  __shared__ __align__(16) int8_t a_tile[BM * ROW];
  __shared__ __align__(16) int8_t b_tile[BN * ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int group = lane >> 2, tig = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const long long pixels = static_cast<long long>(n) * h * w;
  const long long block_m = static_cast<long long>(blockIdx.x) * BM;
  const int block_n = blockIdx.y * BN;
  const int cpad = (cin + BK - 1) / BK * BK;
  const int pad = k / 2;

  // This thread's A load: pixel block_m + tid / 2, channels half * 16 .. + 16.
  const int a_row = tid >> 1, a_half = tid & 1;
  const long long a_pixel = block_m + a_row;
  int py = 0, px = 0, pn = 0;
  if (a_pixel < pixels) {
    px = static_cast<int>(a_pixel % w);
    py = static_cast<int>((a_pixel / w) % h);
    pn = static_cast<int>(a_pixel / (static_cast<long long>(w) * h));
  }
  // Its B load (threads 0..127): output channel block_n + tid / 2, 16 bytes.
  const int b_row = tid >> 1, b_half = tid & 1;
  const int b_co = block_n + b_row;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int tap = 0; tap < k * k; ++tap) {
    const int iy = py + tap / k - pad, ix = px + tap % k - pad;
    const bool inside = a_pixel < pixels && iy >= 0 && iy < h && ix >= 0 && ix < w;
    const T* a_src = x + ((static_cast<long long>(pn) * h + iy) * w + ix) * cin;
    for (int c0 = 0; c0 < cpad; c0 += BK) {
      {
        const int ci = c0 + a_half * 16;
        const int valid = inside ? min(16, cin - ci) : 0;
        float v[16];
        if (valid > 0) {
          load16<T>(a_src + ci, valid, vec && valid == 16, v);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = 0.0f;
        }
        uint4 q;
        q.x = pack4(quantize(v[0], inv), quantize(v[1], inv), quantize(v[2], inv), quantize(v[3], inv));
        q.y = pack4(quantize(v[4], inv), quantize(v[5], inv), quantize(v[6], inv), quantize(v[7], inv));
        q.z = pack4(quantize(v[8], inv), quantize(v[9], inv), quantize(v[10], inv), quantize(v[11], inv));
        q.w = pack4(quantize(v[12], inv), quantize(v[13], inv), quantize(v[14], inv), quantize(v[15], inv));
        *reinterpret_cast<uint4*>(a_tile + a_row * ROW + a_half * 16) = q;
      }
      if (tid < 2 * BN) {
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (b_co < cout) {
          q = __ldg(reinterpret_cast<const uint4*>(w8 + (static_cast<long long>(tap) * cout + b_co) * cpad + c0 +
                                                   b_half * 16));
        }
        *reinterpret_cast<uint4*>(b_tile + b_row * ROW + b_half * 16) = q;
      }
      __syncthreads();

      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = a_tile + (warp_m * 32 + i * 16 + group) * ROW + tig * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * ROW);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * ROW + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = b_tile + (warp_n * 32 + j * 8 + group) * ROW + tig * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(base);
        b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
      __syncthreads();
    }
  }

  // Epilogue: c0, c1 at row group, columns tig * 2 + 0, 1; c2, c3 at row group + 8.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = block_m + warp_m * 32 + i * 16 + group + half * 8;
      if (m >= pixels) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = block_n + warp_n * 32 + j * 8 + tig * 2 + e;
          if (co >= cout) continue;
          const float scale = __fmul_rn(xs, __ldg(w_scale + co));
          T y = tha4::from_f32<T>(__fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), scale));
          if (bias != nullptr) y = tha4::from_f32<T>(__fadd_rn(tha4::to_f32<T>(y), tha4::ldg_f32<T>(bias + co)));
          out[m * cout + co] = y;
        }
      }
    }
  }
}

}  // namespace

// x NHWC (n, h, w, cin) f32 (is_bf16 = 0) or bf16 (1), 16-byte aligned;
// w8 (k * k, cout, cin rounded up to 32) int8, 16-byte aligned; w_scale f32
// (cout); bias in x's dtype (cout) or null; out NHWC (n, h, w, cout).  k is
// 3 (padding 1) or 1 (padding 0).  Returns a cudaError_t (0 on success).
extern "C" int tha4_int8_conv_forward(const void* x, const void* w8, const void* w_scale, const void* bias, void* out,
                                      int n, int h, int w, int cin, int cout, int k, float inv, float xs, int is_bf16,
                                      void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || (k != 1 && k != 3)) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((pixels + BM - 1) / BM), static_cast<unsigned>((cout + BN - 1) / BN));
  const bool vec = cin % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    int8_conv_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8), static_cast<const float*>(w_scale),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), n, h, w, cin, cout, k, inv, xs, vec);
  } else {
    int8_conv_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w8), static_cast<const float*>(w_scale),
        static_cast<const float*>(bias), static_cast<float*>(out), n, h, w, cin, cout, k, inv, xs, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
