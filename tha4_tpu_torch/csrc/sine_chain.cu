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
// Only the order of the f32 sums differs between the designs below and the
// TPU kernel.
//
// What bounds it on an H100: the four calls of one frame do 18.9 G
// multiply-adds, 0.038 ms of bf16 tensor-core time at 989 TFLOP/s, and 132 M
// fast_sin of about 20 CUDA-core operations each with their bias and omega,
// 0.079 ms at the CUDA cores' 33.5 T operations a second; the weights (1.8
// MB f32) and the level inputs and outputs are small.  In bf16 the sine
// epilogue, not the products, is the bound.  The layer-by-layer alternative
// writes every (C, HW) intermediate to device memory (about 1 GB a frame at
// 512^2 x 90); here a pixel tile's activations stay on chip for the whole
// chain.
//
// bf16, on wgmma (sine_chain_tc_kernel; csrc/sine_chain_tc.cuh): two
// warpgroups a block, one tile of 64 pixels; every layer a GEMM from the
// tile's activation buffer in shared memory (A) and weight tiles streamed
// through a four-stage ring of bulk copies (B), N in chunks of up to 128,
// each warpgroup half of a chunk.  The epilogue of a half (layer 0's folded
// pose and position terms or the bias, omega, fast_sin, bf16) writes the
// next layer's A; the last layer's output is staged in shared memory and
// stored one 64-pixel channel row at a time.  Layer 0's folded vector comes
// from fold_kernel, one launch before, once per call.  A block does not
// overlap its epilogues with its products; it sits on the epilogue, whose
// loads are all unconditional (a clamped index, then a select) so that none
// waits behind a branch, with the two or three blocks an SM holds (one at
// level 0's 368-channel buffers) hiding each other's latency and the weight
// stream's round trips to the L2 cache (each 64-pixel tile reads the
// level's weights once).
//
// f32, on the CUDA cores (sine_chain_kernel; no TF32 on an f32 path): one
// CTA per (32-pixel tile, batch element), lane = pixel; two (Cmax x 32)
// activation buffers in shared memory, ping-ponged between layers; each
// thread owns 8 output channels of its pixel in f32 registers; weights read
// through the read-only cache with a warp-uniform address, every level's
// weights resident in the 50 MB L2.  That load, not the FMA, is what it waits
// on: 5.4 ms a frame on an H100 SXM 80 GB at a 700 W power limit.

#include "sine_chain_tc.cuh"

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

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace tha4 {
namespace tc {

// Layer 0's folded vector (launch_fold, csrc/sine_chain_tc.cuh): a warp
// per output channel of a block's eight, batch element blockIdx.y.
__global__ void __launch_bounds__(256)
fold_kernel(const __nv_bfloat16* __restrict__ w, const float* __restrict__ b, const float* __restrict__ pose,
            const __grid_constant__ Chain ch, float* __restrict__ pre0) {
  const int o = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.y;
  if (o >= ch.co[0]) return;
  const __nv_bfloat16* row = w + ch.w_off[0] + static_cast<size_t>(o) * ch.ci[0] + ch.cp + 2;
  float s = 0.0f;
  for (int q = lane; q < ch.pose_dim; q += 32) {
    const float pq = __bfloat162float(__float2bfloat16_rn(__ldg(pose + static_cast<size_t>(n) * ch.pose_dim + q)));
    s = __fmaf_rn(ldg_f32(row + q), pq, s);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
  if (lane == 0) pre0[static_cast<size_t>(n) * ch.co[0] + o] = __fadd_rn(s, __ldg(b + ch.b_off[0] + o));
}

cudaError_t launch_fold(const Chain& c, const __nv_bfloat16* w, const float* b, const float* pose, int n, float* pre0,
                        cudaStream_t stream) {
  fold_kernel<<<dim3(cdiv(c.co[0], 8), n), 256, 0, stream>>>(w, b, pose, c, pre0);
  return cudaGetLastError();
}

// The epilogue of this warpgroup's half of an N chunk of layer l, channels
// from c0: bias (or layer 0's folded terms), omega, fast_sin for a sine
// layer, bf16, into the next buffer.
template <int H>
__device__ __forceinline__ void k1_epilogue(const Epi epi, const float (&acc)[H / 2], unsigned char* dst, int c0) {
#pragma unroll
  for (int k = 0; k < H / 2; k += 2) {
    const int o = c0 + frag_col(k);
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = epi.pre(acc[k + e], o + e, k);
      const float y = epi.sine ? fast_sin(__fmul_rn(epi.omega, a)) : a;
      v[e] = o + e < epi.co ? y : 0.0f;
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + act_off(o, frag_row(k))) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// One block: the tile of 64 pixels at blockIdx.x of batch element blockIdx.y.
__global__ void __launch_bounds__(kThreads, 2)
sine_chain_tc_kernel(const __nv_bfloat16* __restrict__ prev, const __nv_bfloat16* __restrict__ pos,
                     const __nv_bfloat16* __restrict__ w, const float* __restrict__ b,
                     const float* __restrict__ pre0, const __nv_bfloat16* __restrict__ layout,
                     const __grid_constant__ Chain ch, float omega, __nv_bfloat16* __restrict__ out, int hw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem, ch);
  const int n = blockIdx.y;
  const int px0 = blockIdx.x * kTile;
  Ring ring = start_ring(sm, ch, layout, false);

  load_prev(sm.buf[0], prev, ch.cp, n, px0, hw);
  load_fold(sm, ch, w, pre0, n);
  fence_proxy_async();
  __syncthreads();

  int tile = 0;
  int in = 0;
  for (int l = 0; l < ch.num_layers; ++l) {
    const Segment seg = fwd_segment(ch, l);
    const Epi epi = make_epi(sm, ch, b, pos, px0, hw, l, omega);
    for (int n0 = 0; n0 < seg.n_layout; n0 += kNChunk) {
      dispatch_half(min(kNChunk, seg.n_layout - n0), [&](auto width) {
        constexpr int H = decltype(width)::value;
        float acc[H / 2];
        gemm_chunk<H>(acc, sm.buf[in], seg.k_used, ring, tile);
        k1_epilogue<H>(epi, acc, sm.buf[in ^ 1], n0 + wg_index() * H);
      });
    }
    fence_proxy_async();
    __syncthreads();
    in ^= 1;
  }
  store_channels_first(sm.buf[in], out, ch.co[ch.num_layers - 1], n, px0, hw);
}

}  // namespace tc
}  // namespace tha4

// The bf16 kernels' plan for a chain (rows as for tha4_sine_chain_forward):
// plan[0] K1's shared memory a block, plan[1] K4's, plan[2] the elements of
// K1's weight layout, plan[3] of K4's, plan[4] the bytes of K4's workspace at
// n x hw with ``sms`` multiprocessors.  Returns a cudaError_t.
extern "C" int tha4_sine_chain_tc_plan(const void* specs, int num_layers, int num_sine, int cp, int pose_dim,
                                       int n, int hw, int sms, long long* plan) {
  tha4::tc::Chain fwd, bwd;
  int e = tha4::tc::make_chain(static_cast<const int*>(specs), num_layers, num_sine, cp, pose_dim, false, fwd);
  if (e == 0) e = tha4::tc::make_chain(static_cast<const int*>(specs), num_layers, num_sine, cp, pose_dim, true, bwd);
  if (e != 0) return e;
  if (n < 1 || hw < 1 || sms < 1) return cudaErrorInvalidValue;
  plan[0] = static_cast<long long>(tha4::tc::smem_bytes(fwd, 0));
  plan[1] = static_cast<long long>(tha4::tc::bwd_smem_bytes(bwd));
  plan[2] = fwd.fwd_elems;
  plan[3] = fwd.layout_elems;
  plan[4] = static_cast<long long>(tha4::tc::bwd_work(bwd, n, hw, sms).total);
  return 0;
}

// K1, bf16: ``layout`` is the weight layout of tile_index (K1's forward
// tiles at least); ``fold`` n x co_0 floats of scratch for layer 0's folded
// vector; the rest as for tha4_sine_chain_forward.  Two launches.
extern "C" int tha4_sine_chain_tc_forward(const void* prev, int cp, const void* pos, const void* pose, int pose_dim,
                                          const void* w, const void* b, const void* layout, const void* specs,
                                          int num_layers, int num_sine, float omega, void* out, void* fold, int n,
                                          int hw, void* stream) {
  tha4::tc::Chain ch;
  int e = tha4::tc::make_chain(static_cast<const int*>(specs), num_layers, num_sine, cp, pose_dim, false, ch);
  if (e != 0) return e;
  if (n < 1 || n > 65535 || hw < 1 || (cp > 0 && prev == nullptr) || fold == nullptr) return cudaErrorInvalidValue;
  const size_t smem = tha4::tc::smem_bytes(ch, 0);
  if (smem > tha4::tc::kSmemLimit) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pre0 = static_cast<float*>(fold);
  e = tha4::tc::launch_fold(ch, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
                            static_cast<const float*>(pose), n, pre0, s);
  if (e != cudaSuccess) return e;
  // Set on every launch: the attribute is per device, and the call is cheap.
  e = cudaFuncSetAttribute(tha4::tc::sine_chain_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(tha4::tc::cdiv(hw, tha4::tc::kTile), n);
  tha4::tc::sine_chain_tc_kernel<<<grid, tha4::tc::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(prev), static_cast<const __nv_bfloat16*>(pos), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), pre0, static_cast<const __nv_bfloat16*>(layout), ch, omega,
      static_cast<__nv_bfloat16*>(out), hw);
  return static_cast<int>(cudaGetLastError());
}

// K1, f32.  specs: host int32 array of num_layers rows (ci, co, w_off,
// b_off); w_off and b_off are element offsets into the packed weight and bias
// buffers.  Returns a cudaError_t (0 on success).
extern "C" int tha4_sine_chain_forward(const void* prev, int has_prev, int cp, const void* pos,
                                       const void* pose, int pose_dim, const void* w,
                                       const void* b, const void* specs, int num_layers,
                                       int num_sine, float omega, void* out, int n, int hw,
                                       void* stream) {
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
  return static_cast<int>(launch<float>(prev, cp, pos, pose, pose_dim, w, b, spec, omega, out, n, hw, s));
}

extern "C" const char* tha4_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
