// K6's fold: a GroupNorm with its affine, then a chain of FiLMs, as one
// per-(n, c) scale and shift, such that x * scale + shift is the chain.
//
// The counterpart of tha4_tpu/ops/pallas_conv.py:fold_groupnorm_film, the
// statistics and epilogue that K6 (pallas_conv.py:fused_affine_conv3_nchw)
// reads; the plain version is tha4_tpu_torch/ops/cuda_conv.py:
// fold_groupnorm_film_plain.  Two launches a fold:
//   1. group_norm_stats_kernel reads NHWC x once, in its own dtype (bf16 or
//      f32; no f32 copy), each block a run of pixels of one image: every
//      thread keeps a Welford count, mean and M2 for the channels of its
//      16-byte vector, merged per channel across the block in a fixed tree,
//      then per group in channel order (Chan's formula), to one (count,
//      mean, M2) per (n, group) and block.  Centred statistics throughout,
//      never E[x^2] - mean^2, which cancels in f32 at large means.
//   2. group_norm_fold_kernel merges the blocks' partials in block order
//      (deterministic), takes var = M2 / count and r = 1 / sqrt(var + eps),
//      and applies the affine and the FiLMs in the plain version's order:
//      a = gamma, b = beta; per FiLM m = condition_bias + f_scale, a = a * m,
//      b = b * m + f_shift; scale = a * r, shift = b - mean * scale.  The _rn
//      intrinsics keep nvcc from contracting those steps into FMAs.
// What bounds it on an H100: memory, one read of x (268 MB at (8, 512^2,
// 64) in bf16, 0.08 ms), where the PyTorch fold made an f32 copy of x and
// then read it (1.34 GB) over 10-25 launches.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Stat {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2) summaries.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  if (b.n == 0.0f) return a;
  if (a.n == 0.0f) return b;
  const float n = __fadd_rn(a.n, b.n);
  const float delta = __fsub_rn(b.mean, a.mean);
  const float mean = __fadd_rn(a.mean, __fmul_rn(delta, __fdiv_rn(b.n, n)));
  const float m2 = __fadd_rn(__fadd_rn(a.m2, b.m2), __fmul_rn(__fmul_rn(delta, delta), __fdiv_rn(__fmul_rn(a.n, b.n), n)));
  return Stat{n, mean, m2};
}

template <typename T, int LANE>
__device__ __forceinline__ void load_lane(const T* p, float v[LANE]);

template <>
__device__ __forceinline__ void load_lane<__nv_bfloat16, 8>(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_lane<float, 4>(const float* p, float v[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

// Block (j, n): pixels [j * per_block, (j + 1) * per_block) of image n.
// Thread t reads channel vector t % vpp (LANE channels) of pixels t / vpp,
// + ppi, ...  Writes partial[(n * blocks + j) * groups + g].
template <typename T, int LANE>
__global__ void __launch_bounds__(THREADS)
group_norm_stats_kernel(const T* __restrict__ x, Stat* __restrict__ partial, int hw, int c, int groups, int per_block) {
  __shared__ float s_n[THREADS];
  __shared__ float s_mean[THREADS][LANE];
  __shared__ float s_m2[THREADS][LANE];
  __shared__ Stat s_chan[2048];
  const int vpp = c / LANE;      // vectors per pixel
  const int ppi = THREADS / vpp;  // pixels per iteration
  const int cv = threadIdx.x % vpp;
  const int pr = threadIdx.x / vpp;
  const int n = blockIdx.y;
  const int p_begin = blockIdx.x * per_block;
  const int p_end = min(hw, p_begin + per_block);

  float count = 0.0f;
  float mean[LANE], m2[LANE];
#pragma unroll
  for (int k = 0; k < LANE; ++k) mean[k] = m2[k] = 0.0f;
  if (pr < ppi) {
    const T* base = x + static_cast<long long>(n) * hw * c + cv * LANE;
    for (int p = p_begin + pr; p < p_end; p += ppi) {
      float v[LANE];
      load_lane<T, LANE>(base + static_cast<long long>(p) * c, v);
      count = __fadd_rn(count, 1.0f);
      const float inv = __fdiv_rn(1.0f, count);
#pragma unroll
      for (int k = 0; k < LANE; ++k) {
        const float delta = __fsub_rn(v[k], mean[k]);
        mean[k] = __fadd_rn(mean[k], __fmul_rn(delta, inv));
        m2[k] = __fadd_rn(m2[k], __fmul_rn(delta, __fsub_rn(v[k], mean[k])));
      }
    }
  }
  s_n[threadIdx.x] = count;
#pragma unroll
  for (int k = 0; k < LANE; ++k) {
    s_mean[threadIdx.x][k] = mean[k];
    s_m2[threadIdx.x][k] = m2[k];
  }
  __syncthreads();
  // Across the ppi threads of each channel vector: a tree with a fixed
  // pairing (entry pr + s into pr), so the sums' order never changes.
  for (int s = 1; s < ppi; s *= 2) {
    if (pr < ppi && pr % (2 * s) == 0 && pr + s < ppi) {
      const int other = threadIdx.x + s * vpp;
#pragma unroll
      for (int k = 0; k < LANE; ++k) {
        const Stat m = merge(Stat{s_n[threadIdx.x], s_mean[threadIdx.x][k], s_m2[threadIdx.x][k]},
                             Stat{s_n[other], s_mean[other][k], s_m2[other][k]});
        s_mean[threadIdx.x][k] = m.mean;
        s_m2[threadIdx.x][k] = m.m2;
      }
    }
    __syncthreads();
    if (pr < ppi && pr % (2 * s) == 0 && pr + s < ppi) s_n[threadIdx.x] = __fadd_rn(s_n[threadIdx.x], s_n[threadIdx.x + s * vpp]);
    __syncthreads();
  }
  // Per channel (threads 0 .. vpp - 1 hold them), then per group in
  // channel order.
  if (threadIdx.x < vpp) {
#pragma unroll
    for (int k = 0; k < LANE; ++k) s_chan[threadIdx.x * LANE + k] = Stat{s_n[threadIdx.x], s_mean[threadIdx.x][k], s_m2[threadIdx.x][k]};
  }
  __syncthreads();
  const int cg = c / groups;
  for (int g = threadIdx.x; g < groups; g += THREADS) {
    Stat acc = s_chan[g * cg];
    for (int k = 1; k < cg; ++k) acc = merge(acc, s_chan[g * cg + k]);
    partial[(static_cast<long long>(n) * gridDim.x + blockIdx.x) * groups + g] = acc;
  }
}

__device__ __forceinline__ float film_value(const void* p, long long i, int is_bf16) {
  return is_bf16 ? tha4::ldg_f32<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(p) + i)
                 : __ldg(static_cast<const float*>(p) + i);
}

struct Film {
  const void* scale[2];
  const void* shift[2];
  long long scale_stride[2], shift_stride[2];  // row strides, elements
  int count, is_bf16;
};

// One block per image, one thread per channel (looping past 1024).
__global__ void __launch_bounds__(1024)
group_norm_fold_kernel(const Stat* __restrict__ partial, int blocks, int c, int groups, const float* __restrict__ gamma,
                       const float* __restrict__ beta, Film film, float condition_bias, float eps,
                       float* __restrict__ scale, float* __restrict__ shift) {
  const int n = blockIdx.x;
  const int cg = c / groups;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    Stat s = partial[static_cast<long long>(n) * blocks * groups + g];
    for (int j = 1; j < blocks; ++j) s = merge(s, partial[(static_cast<long long>(n) * blocks + j) * groups + g]);
    const float var = __fdiv_rn(s.m2, s.n);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    float a = __ldg(gamma + ch);
    float b = __ldg(beta + ch);
    for (int f = 0; f < film.count; ++f) {
      const float m = __fadd_rn(condition_bias, film_value(film.scale[f], n * film.scale_stride[f] + ch, film.is_bf16));
      a = __fmul_rn(a, m);
      b = __fadd_rn(__fmul_rn(b, m), film_value(film.shift[f], n * film.shift_stride[f] + ch, film.is_bf16));
    }
    const float sc = __fmul_rn(a, r);
    scale[n * c + ch] = sc;
    shift[n * c + ch] = __fsub_rn(b, __fmul_rn(s.mean, sc));
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || count < 1)
      count = 132;
  }
  return count;
}

// Channels a thread loads at once: one 16-byte vector.
int lane_of(int is_bf16) { return is_bf16 ? 8 : 4; }

}  // namespace

// Blocks per image of a fold's statistics pass (0 for sizes it refuses, C
// not a multiple of the lane among them): a few per SM over the batch, no
// more than the pixels allow.  The wrapper gives the pass a workspace of N x
// blocks x groups x 3 floats.
extern "C" int tha4_group_norm_fold_blocks(int n, int hw, int c, int groups, int is_bf16) {
  const int lane = lane_of(is_bf16);
  if (n < 1 || hw < 1 || c < 1 || groups < 1 || c % groups != 0 || c % lane != 0 || c > 2048) return 0;
  const int vpp = c / lane;
  if (vpp > THREADS) return 0;
  const int ppi = THREADS / vpp;
  const long long by_pixels = (static_cast<long long>(hw) + 4 * ppi - 1) / (4 * ppi);  // >= 4 pixels a thread
  const long long by_card = (4LL * sm_count() + n - 1) / n;
  const long long blocks = by_pixels < by_card ? by_pixels : by_card;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// x (N, H, W, C) NHWC f32 or bf16; gamma, beta (C,) f32; film_scale[i],
// film_shift[i] (N, C) rows of the given element strides, f32 or bf16
// (film_bf16), for i < film_count <= 2; workspace as
// tha4_group_norm_fold_blocks asks; scale, shift (N, C) f32 out.  Two
// launches.  Returns a cudaError_t.
extern "C" int tha4_group_norm_fold(const void* x, int n, int hw, int c, int groups, int is_bf16, const void* gamma,
                                    const void* beta, const void* film_scale0, long long scale_stride0,
                                    const void* film_shift0, long long shift_stride0, const void* film_scale1,
                                    long long scale_stride1, const void* film_shift1, long long shift_stride1,
                                    int film_count, int film_bf16, float condition_bias, float eps, void* workspace,
                                    void* scale, void* shift, void* stream) {
  const int blocks = tha4_group_norm_fold_blocks(n, hw, c, groups, is_bf16);
  if (blocks < 1 || film_count < 0 || film_count > 2 || workspace == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = (hw + blocks - 1) / blocks;
  Stat* partial = static_cast<Stat*>(workspace);
  const dim3 grid(blocks, n);
  if (is_bf16) {
    group_norm_stats_kernel<__nv_bfloat16, 8><<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x), partial, hw, c,
                                                                      groups, per_block);
  } else {
    group_norm_stats_kernel<float, 4><<<grid, THREADS, 0, s>>>(static_cast<const float*>(x), partial, hw, c, groups,
                                                             per_block);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Film film{{film_scale0, film_scale1}, {film_shift0, film_shift1}, {scale_stride0, scale_stride1},
                  {shift_stride0, shift_stride1}, film_count, film_bf16};
  const int threads = c < 1024 ? ((c + 31) / 32) * 32 : 1024;
  group_norm_fold_kernel<<<n, threads, 0, s>>>(partial, blocks, c, groups, static_cast<const float*>(gamma),
                                               static_cast<const float*>(beta), film, condition_bias, eps,
                                               static_cast<float*>(scale), static_cast<float*>(shift));
  return static_cast<int>(cudaGetLastError());
}
