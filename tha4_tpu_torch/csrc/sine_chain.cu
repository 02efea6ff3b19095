// K1: one whole SIREN level per launch, channels-first.
//
// Replaces tha4_tpu/ops/pallas_siren.py:fused_sine_chain_t (kernel body
// _make_kernel).  For every pixel and batch element it builds the level input
// h = [prev | pos_x, pos_y | pose] and runs h <- fast_sin(omega * (W h + b))
// through every sine layer, then an optional head linear without a sine,
// writing (N, Cout, HW).  Semantics kept from the TPU kernel:
//   * pos and pose are cast to the compute dtype before the first product;
//   * products take compute-dtype operands and accumulate in f32 (bf16 x bf16
//     products are exact in f32, so bf16 means "bf16 operands, f32 sums");
//   * the f32 bias is added to the f32 accumulator before the omega multiply;
//   * activations are stored in the compute dtype between layers;
//   * the head has no sine and is cast to the output (= compute) dtype.
//
// What bounds it on an H100: the four calls of one frame do 18.9 G
// multiply-adds, while the weights (1.8 MB f32 for all levels) and the level
// inputs/outputs are small, so the work is arithmetic: the card's f32 FMA
// floor is about 0.56 ms a frame.  The layer-by-layer alternative writes
// every (C, HW) intermediate to device memory (about 1 GB of traffic per
// frame at 512^2 x 90); here a pixel tile's activations stay in shared
// memory for the whole chain.  This first design issues one weight load per
// FMA, and that load, not the FMA, is what it waits on: measured 4.6 ms a
// frame in bf16 and 5.4 ms in f32 on an H100 SXM 80 GB at a 700 W power
// limit, against 11.2 / 10.5 ms for the plain PyTorch version.
//
// Design (simple and right first):
//   * one CTA per (32-pixel tile, batch element); lane = pixel, so shared
//     memory reads of an activation row are conflict-free;
//   * two (Cmax x 32) activation buffers in shared memory, ping-ponged
//     between layers (46 KB each at C = 360 in f32; set above 48 KB through
//     cudaFuncAttributeMaxDynamicSharedMemorySize);
//   * each thread owns 8 output channels of its pixel in f32 registers; the
//     8 warps sweep the output channels;
//   * weights are read from global memory through the read-only cache with a
//     warp-uniform address (one broadcast per load); every level's weights
//     stay resident in the 50 MB L2.
// CUDA-core FMAs, not tensor cores: streaming weight K-blocks through shared
// memory into mma/wgmma is the later optimisation (the bf16 face and L0
// weight sets, 241 KB and 423 KB, do not fit one block's 227 KB).

#include "common.cuh"

namespace {

constexpr int kMaxLayers = 16;
constexpr int kTile = 32;   // pixels per CTA, one per lane
constexpr int kWarps = 8;
constexpr int kRows = 8;    // output channels per thread per pass

struct ChainSpec {
  int num_layers;
  int num_sine;
  int cmax;
  int ci[kMaxLayers];
  int co[kMaxLayers];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
sine_chain_kernel(const T* __restrict__ prev, int cp, const T* __restrict__ pos,
                  const float* __restrict__ pose, int pose_dim, const T* __restrict__ w,
                  const float* __restrict__ b, const ChainSpec spec, float omega,
                  T* __restrict__ out, int hw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h = reinterpret_cast<T*>(smem_raw);
  T* nxt = h + spec.cmax * kTile;

  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int px = blockIdx.x * kTile + lane;
  const bool valid = px < hw;
  const T zero = tha4::from_f32<T>(0.0f);

  // Level input [prev | pos | pose] in the compute dtype.
  const int cin = cp + 2 + pose_dim;
  for (int c = warp; c < cin; c += kWarps) {
    T v;
    if (c < cp) {
      v = valid ? prev[(static_cast<size_t>(n) * cp + c) * hw + px] : zero;
    } else if (c < cp + 2) {
      v = valid ? pos[static_cast<size_t>(c - cp) * hw + px] : zero;
    } else {
      v = tha4::from_f32<T>(pose[static_cast<size_t>(n) * pose_dim + (c - cp - 2)]);
    }
    h[c * kTile + lane] = v;
  }
  __syncthreads();

  for (int l = 0; l < spec.num_layers; ++l) {
    const int ci = spec.ci[l];
    const int co = spec.co[l];
    const T* wl = w + spec.w_off[l];
    const float* bl = b + spec.b_off[l];
    const bool sine = l < spec.num_sine;
    const bool last = l == spec.num_layers - 1;

    for (int r0 = warp * kRows; r0 < co; r0 += kWarps * kRows) {
      const T* wrow[kRows];
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // Rows past co read the last row again; their sums are never stored.
        wrow[r] = wl + static_cast<size_t>(min(r0 + r, co - 1)) * ci;
        acc[r] = 0.0f;
      }
      for (int k = 0; k < ci; ++k) {
        const float hv = tha4::to_f32<T>(h[k * kTile + lane]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = fmaf(tha4::ldg_f32<T>(wrow[r] + k), hv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int o = r0 + r;
        if (o >= co) break;
        float a = __fadd_rn(acc[r], __ldg(bl + o));
        if (sine) a = tha4::fast_sin(__fmul_rn(omega, a));
        const T v = tha4::from_f32<T>(a);
        if (last) {
          if (valid) out[(static_cast<size_t>(n) * co + o) * hw + px] = v;
        } else {
          nxt[o * kTile + lane] = v;
        }
      }
    }
    __syncthreads();
    T* t = h;
    h = nxt;
    nxt = t;
  }
}

template <typename T>
cudaError_t launch(const void* prev, int cp, const void* pos, const void* pose, int pose_dim,
                   const void* w, const void* b, const ChainSpec& spec, float omega, void* out,
                   int n, int hw, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(spec.cmax) * kTile * sizeof(T);
  if (smem > 48 * 1024) {
    // Set on every launch: the attribute is per device, and the call is cheap.
    cudaError_t e = cudaFuncSetAttribute(sine_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((hw + kTile - 1) / kTile, n);
  sine_chain_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(prev), cp, static_cast<const T*>(pos),
      static_cast<const float*>(pose), pose_dim, static_cast<const T*>(w),
      static_cast<const float*>(b), spec, omega, static_cast<T*>(out), hw);
  return cudaGetLastError();
}

}  // namespace

// specs: host int32 array of num_layers rows (ci, co, w_off, b_off); w_off
// and b_off are element offsets into the packed weight and bias buffers.
// Returns a cudaError_t (0 on success).
extern "C" int tha4_sine_chain_forward(const void* prev, int has_prev, int cp, const void* pos,
                                       const void* pose, int pose_dim, const void* w,
                                       const void* b, const void* specs, int num_layers,
                                       int num_sine, float omega, void* out, int n, int hw,
                                       int is_bf16, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || num_sine > num_layers || n < 1 || hw < 1)
    return cudaErrorInvalidValue;
  if (!has_prev) cp = 0;
  ChainSpec spec;
  spec.num_layers = num_layers;
  spec.num_sine = num_sine;
  spec.cmax = cp + 2 + pose_dim;
  const int* rows = static_cast<const int*>(specs);
  for (int l = 0; l < num_layers; ++l) {
    spec.ci[l] = rows[4 * l + 0];
    spec.co[l] = rows[4 * l + 1];
    spec.w_off[l] = rows[4 * l + 2];
    spec.b_off[l] = rows[4 * l + 3];
    if (spec.co[l] < 1 || (l > 0 && spec.ci[l] != spec.co[l - 1])) return cudaErrorInvalidValue;
    if (spec.co[l] > spec.cmax) spec.cmax = spec.co[l];
  }
  if (spec.ci[0] != cp + 2 + pose_dim) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(prev, cp, pos, pose, pose_dim, w, b, spec,
                                                  omega, out, n, hw, s)
                          : launch<float>(prev, cp, pos, pose, pose_dim, w, b, spec, omega,
                                          out, n, hw, s);
  return static_cast<int>(e);
}

extern "C" const char* tha4_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
