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
// f32, on the CUDA cores (sine_chain_kernel; no TF32 on an f32 path), where
// the products are the bound: 0.566 ms a frame at 67 TFLOP/s, plus 0.079 ms
// of epilogue.  A register-tiled GEMM chain: one block of 256 threads per
// (tile of 64 pixels, or 32 for a chain wider than 388 channels, batch
// element; ops/cuda_siren.py f32_plan); two activation buffers (widest
// layer x tile) in shared memory, ping-ponged between layers; each layer
// walked in passes of the output channels the threads cover (128 at 64
// pixels) and, within a pass, stages of 32 input channels.  A stage is an
// image of W^T[k0:k0+32][pass] from the chain's layout (tile_layout, made
// once per chain), copied by 16-byte cp.async into one of two stages while
// the other is read.  Each thread holds 4 pixels x 8 channels in registers
// and reads one float4 of activations and two of weights a k: 32 FMAs for
// three shared-memory loads (90 registers, two blocks an SM where the
// buffers allow; 8 x 8 a thread, 172 registers and one block, was slower on
// the card).  Each output is still one FMA chain over k in order, so the
// outputs are the earlier one-pixel-a-lane kernel's bit for bit.  The level
// input is copied asynchronously, and the epilogue (bias, omega, fast_sin)
// runs over a thread's 32 outputs without a branch.  On an H100 SXM 80 GB
// at 700 W: 1.59 ms a frame back to back (face 0.13, levels 0.25, 0.49,
// 0.73), 40 % of the bound, where the earlier kernel waited 5.4 ms on one
// read-only load a FMA.  What a block waits on now, at level 2: the
// products take 22 of its 46 us; barrier waits (a 90-channel layer keeps
// six of eight warps busy, the 7-channel head one), the epilogue and the
// level input's read the rest.

#include "sine_chain_tc.cuh"

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 256;
constexpr int kTM = 4;     // pixels a thread: 4 pg .. 4 pg + 3
constexpr int kTN = 8;     // output channels a thread, contiguous
constexpr int kKc = 32;    // input channels a weight stage holds
constexpr int kKStep = 8;  // the depth a partial stage is read in; activation rows are padded to it

// Output channels of one pass at a tile of p pixels, the row stride of a
// weight stage (4 floats of padding, so that its rows start on other banks)
// and its floats; a block's shared memory: two activation buffers of
// ``rows`` x p floats and two stages.  ops/cuda_siren.py computes the same
// (f32_smem_bytes, the layout's stage images).
__host__ __device__ constexpr int pass_channels(int p) { return kThreads / (p / kTM) * kTN; }
__host__ __device__ constexpr int stage_stride(int p) { return pass_channels(p) + 4; }
__host__ __device__ constexpr int stage_floats(int p) { return kKc * stage_stride(p); }
__host__ __device__ constexpr size_t smem_bytes(int p, int rows) {
  return 4 * (2 * static_cast<size_t>(rows) * p + 2 * static_cast<size_t>(stage_floats(p)));
}

struct ChainSpec {
  int num_layers;
  int num_sine;
  int rows;  // the widest of the level input and every layer, rounded up to kKStep
  int ci[kMaxLayers];
  int co[kMaxLayers];
  int b_off[kMaxLayers];
};

// The weight layout's floats at tile p: one stage image for every layer,
// pass and kKc input channels, in the order the kernel reads them.
long long layout_floats(const ChainSpec& s, int p) {
  long long total = 0;
  for (int l = 0; l < s.num_layers; ++l)
    total += static_cast<long long>(tha4::tc::cdiv(s.co[l], pass_channels(p))) * tha4::tc::cdiv(s.ci[l], kKc) *
             stage_floats(p);
  return total;
}

// The stage a block works on: layer l, the pass's first channel group cg0,
// input channels k0 .. k0 + kKc.
struct Chunk {
  int l, cg0, k0;
};

// The chunk after c (layers, then passes, then K); false after the last.
template <int P>
__device__ __forceinline__ bool next_chunk(Chunk& c, const ChainSpec& s) {
  c.k0 += kKc;
  if (c.k0 < s.ci[c.l]) return true;
  c.k0 = 0;
  c.cg0 += pass_channels(P) / kTN;
  if (c.cg0 * kTN < s.co[c.l]) return true;
  c.cg0 = 0;
  return ++c.l < s.num_layers;
}

// One stage image of the layout into shared memory, 16 bytes a copy.
template <int P>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src) {
  for (int i = threadIdx.x; i < stage_floats(P) / 4; i += kThreads) tha4::cp_async16(dst + 4 * i, src + 4 * i);
  tha4::cp_async_commit();
}

// acc[i][j] += W^T[k][j] h[k][i] for K rows of the activations (row stride
// P) and of the stage, k in order, one FMA a product.
template <int P, int K>
__device__ __forceinline__ void fma_rows(float (&acc)[kTM][kTN], const float* h, const float* ws) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(h + k * P);
    const float4 w0 = *reinterpret_cast<const float4*>(ws + k * stage_stride(P));
    const float4 w1 = *reinterpret_cast<const float4*>(ws + k * stage_stride(P) + 4);
    const float av[kTM] = {a.x, a.y, a.z, a.w};
    const float wv[kTN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(wv[j], av[i], acc[i][j]);
  }
}

// One block: the tile of P pixels at blockIdx.x of batch element blockIdx.y.
// Thread t owns pixels 4 pg .. 4 pg + 3 (pg = t % (P / kTM)) and the kTN
// channels of channel group t / (P / kTM) of every pass.  ``vec``: prev
// and pos are read 16 bytes at a time (hw % 4 == 0, both 16-byte aligned).
template <int P>
__global__ void __launch_bounds__(kThreads)
sine_chain_kernel(const float* __restrict__ prev, int cp, const float* __restrict__ pos,
                  const float* __restrict__ pose, int pose_dim, const float* __restrict__ layout,
                  const float* __restrict__ b, const __grid_constant__ ChainSpec spec, float omega,
                  float* __restrict__ out, int hw, bool vec) {
  constexpr int kGroups = P / kTM;
  constexpr int kStage = stage_floats(P);
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + spec.rows * P;
  float* const stages = smem + 2 * spec.rows * P;

  const int n = blockIdx.y;
  const int px0 = blockIdx.x * P;
  const int pg = threadIdx.x % kGroups;
  const int cgl = threadIdx.x / kGroups;

  // Level input [prev | pos | pose] into buf0, 4 pixels at a time: prev and
  // pos copied asynchronously (zeros past hw), pose broadcast; buf0's rows
  // past cin and all of buf1 zero, so that every padded K reads finite
  // values beside the layout's zero weights.
  const int cin = cp + 2 + pose_dim;
  for (int i = threadIdx.x; i < spec.rows * (P / 4); i += kThreads) {
    const int c = i / (P / 4);
    const int px = px0 + 4 * (i % (P / 4));
    float4* dst = reinterpret_cast<float4*>(buf0) + i;
    reinterpret_cast<float4*>(buf1)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float* src = c < cp       ? prev + (static_cast<size_t>(n) * cp + c) * hw + px
                       : c < cp + 2 ? pos + static_cast<size_t>(c - cp) * hw + px
                                    : nullptr;
    if (src != nullptr && vec) {
      tha4::cp_async16_zfill(dst, px < hw ? src : pos, px < hw);
    } else if (src != nullptr) {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) e[u] = px + u < hw ? src[u] : 0.0f;
      *dst = make_float4(e[0], e[1], e[2], e[3]);
    } else {
      const float v = c < cin ? pose[static_cast<size_t>(n) * pose_dim + (c - cp - 2)] : 0.0f;
      *dst = make_float4(v, v, v, v);
    }
  }
  stage<P>(stages, layout);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  Chunk cur{0, 0, 0};
  int in = 0;
  for (int step = 0;; ++step) {
    // This chunk's stage has landed, every thread is done with the other
    // stage, and the last layer's outputs are in place.
    tha4::cp_async_wait<0>();
    __syncthreads();
    Chunk nxt = cur;
    const bool more = next_chunk<P>(nxt, spec);
    if (more) stage<P>(stages + ((step + 1) & 1) * kStage, layout + static_cast<size_t>(step + 1) * kStage);

    const int l = cur.l;
    const int ci = spec.ci[l];
    const int co = spec.co[l];
    const int o0 = (cur.cg0 + cgl) * kTN;
    const bool last_chunk = cur.k0 + kKc >= ci;
    float bias[kTN];
    if (last_chunk) {
      // Loaded before the products, which hide its latency.
#pragma unroll
      for (int j = 0; j < kTN; ++j) bias[j] = __ldg(b + spec.b_off[l] + min(o0 + j, co - 1));
    }
    if (o0 < co) {
      const float* h = (in ? buf1 : buf0) + cur.k0 * P + kTM * pg;
      const float* ws = stages + (step & 1) * kStage + kTN * cgl;
      const int depth = min(kKc, ci - cur.k0);
      if (depth == kKc) {
        fma_rows<P, kKc>(acc, h, ws);
      } else {
        for (int k = 0; k < depth; k += kKStep) fma_rows<P, kKStep>(acc, h + k * P, ws + k * stage_stride(P));
      }
    }

    if (last_chunk) {
      // The pass's epilogue, element by element: the f32 bias, then omega
      // and fast_sin for a sine layer; into the other buffer, or out.
      if (o0 < co) {
        if (l < spec.num_sine) {
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = tha4::fast_sin(__fmul_rn(omega, __fadd_rn(acc[i][j], bias[j])));
        } else {
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = __fadd_rn(acc[i][j], bias[j]);
        }
        const bool last = l == spec.num_layers - 1;
        const int px = px0 + kTM * pg;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int o = o0 + j;
          if (o >= co) continue;
          const float4 q = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          if (!last) {
            *reinterpret_cast<float4*>((in ? buf0 : buf1) + o * P + kTM * pg) = q;
          } else {
            float* dst = out + (static_cast<size_t>(n) * co + o) * hw + px;
            if (vec && px < hw) {
              *reinterpret_cast<float4*>(dst) = q;
            } else if (!vec) {
              const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (px + u < hw) dst[u] = e[u];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    }
    if (!more) break;
    if (nxt.l != l) in ^= 1;
    cur = nxt;
  }
}

template <int P>
cudaError_t launch(const float* prev, int cp, const float* pos, const float* pose, int pose_dim, const float* layout,
                   const float* b, const ChainSpec& spec, float omega, float* out, int n, int hw, bool vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(P, spec.rows);
  if (smem > tha4::tc::kSmemLimit) return cudaErrorInvalidValue;
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t e = cudaFuncSetAttribute(sine_chain_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(tha4::tc::cdiv(hw, P), n);
  sine_chain_kernel<P><<<grid, kThreads, smem, stream>>>(prev, cp, pos, pose, pose_dim, layout, b, spec, omega, out, hw,
                                                         vec);
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
// b_off); b_off are element offsets into the packed bias buffer.  layout:
// the chain's weights as the kernel's stage images at this tile
// (ops/cuda_siren.py tile_layout), layout_elems its floats; tile: the
// pixels of a block, 64 or 32 (ops/cuda_siren.py f32_plan).  Returns a
// cudaError_t (0 on success).
extern "C" int tha4_sine_chain_forward(const void* prev, int has_prev, int cp, const void* pos,
                                       const void* pose, int pose_dim, const void* layout,
                                       long long layout_elems, const void* b, const void* specs,
                                       int num_layers, int num_sine, float omega, void* out, int n,
                                       int hw, int tile, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || num_sine > num_layers || n < 1 || n > 65535 || hw < 1)
    return cudaErrorInvalidValue;
  if (!has_prev) cp = 0;
  if (cp > 0 && prev == nullptr) return cudaErrorInvalidValue;
  ChainSpec spec;
  spec.num_layers = num_layers;
  spec.num_sine = num_sine;
  int widest = cp + 2 + pose_dim;
  const int* rows = static_cast<const int*>(specs);
  for (int l = 0; l < num_layers; ++l) {
    spec.ci[l] = rows[4 * l + 0];
    spec.co[l] = rows[4 * l + 1];
    spec.b_off[l] = rows[4 * l + 3];
    if (spec.co[l] < 1 || (l > 0 && spec.ci[l] != spec.co[l - 1])) return cudaErrorInvalidValue;
    if (spec.co[l] > widest) widest = spec.co[l];
  }
  if (spec.ci[0] != cp + 2 + pose_dim) return cudaErrorInvalidValue;
  spec.rows = tha4::tc::cdiv(widest, kKStep) * kKStep;
  if ((tile != 64 && tile != 32) || layout_elems != layout_floats(spec, tile)) return cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (!aligned(layout) || !aligned(out)) return cudaErrorInvalidValue;
  const bool vec = hw % 4 == 0 && aligned(pos) && (cp == 0 || aligned(prev));
  const float* f_prev = static_cast<const float*>(prev);
  const float* f_pos = static_cast<const float*>(pos);
  const float* f_pose = static_cast<const float*>(pose);
  const float* f_layout = static_cast<const float*>(layout);
  const float* f_b = static_cast<const float*>(b);
  float* f_out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      tile == 64 ? launch<64>(f_prev, cp, f_pos, f_pose, pose_dim, f_layout, f_b, spec, omega, f_out, n, hw, vec, s)
                 : launch<32>(f_prev, cp, f_pos, f_pose, pose_dim, f_layout, f_b, spec, omega, f_out, n, hw, vec, s);
  return static_cast<int>(e);
}

extern "C" const char* tha4_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
