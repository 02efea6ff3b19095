// K4: the backward of one SIREN level, channels-first.
//
// Replaces tha4_tpu/ops/pallas_siren.py:fused_sine_chain_t_bwd (kernel body
// _make_bwd_kernel).  For every pixel and batch element it recomputes the
// level's forward (K1's arithmetic), keeping each sine layer's f32
// pre-activation a, then walks back through the layers:
//   g_a = g * (omega * fast_cos(omega * a))  for a sine layer, g_a = g for the head;
//   db += sum over pixels of g_a                 (f32, before any rounding);
//   dW += T(g_a) h_in^T, g <- W^T T(g_a)         (compute-dtype operands, f32 sums);
// and ends with dprev = T(g[:cp]) and dpose = sum over pixels of g[cp+2:]; the
// position rows' gradient is dropped (the grid is a constant).  Semantics kept
// from the TPU kernel, not from JAX's CPU autodiff: fast_cos(x) is
// fast_sin(x + pi/2), a deliberate ~1e-6 approximation of the polynomial's own
// derivative; g_a is rounded to the compute dtype before both products.
//
// What bounds it on an H100: at the face student's training shape (N = 8,
// 128^2, 41->128 x8->4) one call is three chain products of 15.8 G
// multiply-adds each (forward recompute, W^T g_a, g_a h^T): 47 G, 0.096 ms of
// bf16 tensor-core time (1.4 ms of f32 FMAs), and a fast_sin and a fast_cos
// per sine output, 0.16 ms of CUDA-core operations: in bf16 the sine
// epilogues are the bound, as in K1.  The TPU kernel carries dW
// across a sequential grid in VMEM; on Hopper blocks run in no order, and
// one block's dW (482 KB for the face) fits neither registers nor shared
// memory.
//
// bf16, on wgmma (csrc/sine_chain_tc.cuh), in three steps after K1's
// fold_kernel, deterministic (no float atomics; every sum in a fixed order):
//   1. sine_chain_bwd_tc_kernel, two warpgroups per 64-pixel tile (each half
//      of every N chunk, as in K1): K1's
//      forward, which also writes each sine layer's f32 pre-activation to a
//      stash in device memory (64 pixels x 1024 rows do not fit shared memory
//      at the face shape) and each layer's bf16 input h to scratch; then the
//      reverse chain, g <- W^T T(g_a) on wgmma from the weights' transposed
//      tiles, g_a formed in the accumulators from the stash, its tile sums
//      (db, and layer 0's rounded sums for dpose) reduced in a fixed tree,
//      T(g_a) written both to the next product's A buffer and to scratch.
//      h and T(g_a) go to scratch as [8 pixel groups][channels][8 pixels],
//      the K-major image of the dW product's operands.  About 1.1 GB of
//      scratch traffic at the face shape, ~0.3 ms at the card's memory rate.
//   2. sine_chain_dw_kernel: dW = T(g_a) h^T on wgmma, M = output channels
//      (64-row blocks), N = input channels (chunks of up to 128, a half per
//      warpgroup), K = pixels,
//      the tiles split into fixed runs, each block's run streamed through a
//      four-stage ring of bulk copies; one f32 partial per run.  Kept over
//      per-block slabs of the whole dW (the f32 kernel's): a slab per block is 482 KB at
//      the face shape, read and written per tile, where the stash costs one
//      write and one read.
//   3. column sums in a fixed order: the runs' partials (dW), the tiles'
//      sums (db, and per batch element layer 0's), then dpose =
//      W_pose^T (sum over pixels of T(g_a)) of layer 0, the TPU kernel's
//      sum in another order by linearity.
//
// f32, on the CUDA cores (sine_chain_bwd_kernel; no TF32 on an f32 path):
//   * a persistent grid of one block per SM; work item = (32-pixel tile,
//     batch element), block b takes items b, b + grid, b + 2 grid, ... in order;
//   * per item, shared memory holds every sine layer's f32 pre-activations
//     (the stash, 1024 rows at the face shape) and three C_max-row buffers
//     (layer input, cotangent, next cotangent), all with a 33-word row stride
//     so that lane = pixel and lane = channel reads are conflict-free: 182 KB
//     at the face shape, set through cudaFuncAttributeMaxDynamicSharedMemorySize;
//   * each block sums its items' dW, db and dpose into its own slab of the
//     scratch buffer (a read-modify-write that only this block, and always the
//     same thread, touches); a second kernel sums the slabs in block order;
//   * the chain products as K1's f32 kernel (lane = pixel, 8 rows per thread,
//     warp-uniform weight loads through the read-only cache); dW is a 4 x 4
//     micro-tile per lane contracted over the tile's 32 pixels.
// Two calls on one card give bit-identical gradients: every sum has a fixed
// order, given the grid size (the wrapper passes the SM count).

#include "sine_chain_tc.cuh"

namespace {

constexpr int kMaxLayers = 16;
constexpr int kTile = 32;           // pixels per work item, one per lane
constexpr int kStride = kTile + 1;  // shared-memory row stride, in floats
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;      // rows per thread in the chain products
constexpr int kGradRows = 4;  // dW micro-tile: 4 consecutive output channels
constexpr int kGradCols = 4;  // by 4 input channels, 32 apart
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use

struct BwdSpec {
  int num_layers;
  int num_sine;
  int cp;
  int pose_dim;
  int cmax;        // widest layer input or output
  int stash_rows;  // sum of the sine layers' output channels
  int w_total;     // elements of the packed weights
  int b_total;     // elements of the packed biases
  int ci[kMaxLayers];
  int co[kMaxLayers];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int s_off[kMaxLayers];  // first stash row of each sine layer
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return tha4::to_f32<T>(tha4::from_f32<T>(x));
}

// Sum over the 32 lanes; every lane ends with the same value (one IEEE add
// is commutative), in an order fixed by the butterfly.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The level input [prev | pos_x, pos_y | pose] of one tile, rounded to the
// compute dtype and stored as f32.  Pixels past hw read zeros.
template <typename T>
__device__ __forceinline__ void load_input(float* h, const T* __restrict__ prev, const T* __restrict__ pos,
                                           const float* __restrict__ pose, const BwdSpec& spec, int bn,
                                           int px, bool valid, int hw, int lane, int warp) {
  const int cp = spec.cp;
  const int cin = cp + 2 + spec.pose_dim;
  for (int c = warp; c < cin; c += kWarps) {
    float v;
    if (c < cp) {
      v = valid ? tha4::to_f32<T>(prev[(static_cast<size_t>(bn) * cp + c) * hw + px]) : 0.0f;
    } else if (c < cp + 2) {
      v = valid ? tha4::to_f32<T>(pos[static_cast<size_t>(c - cp) * hw + px]) : 0.0f;
    } else {
      v = round_to<T>(pose[static_cast<size_t>(bn) * spec.pose_dim + (c - cp - 2)]);
    }
    h[c * kStride + lane] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sine_chain_bwd_kernel(const T* __restrict__ prev, const T* __restrict__ pos,
                      const float* __restrict__ pose, const T* __restrict__ w,
                      const float* __restrict__ b, const T* __restrict__ gout, const BwdSpec spec,
                      float omega, T* __restrict__ dprev, float* __restrict__ scratch, int n,
                      int hw) {
  extern __shared__ __align__(16) float smem[];
  float* stash = smem;
  float* hb = stash + spec.stash_rows * kStride;
  float* gc = hb + spec.cmax * kStride;
  float* gn = gc + spec.cmax * kStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slab_size = spec.w_total + spec.b_total + n * spec.pose_dim;
  float* dw = scratch + static_cast<size_t>(blockIdx.x) * slab_size;
  float* db = dw + spec.w_total;
  float* dpose = db + spec.b_total;
  for (int i = tid; i < slab_size; i += kThreads) dw[i] = 0.0f;
  __syncthreads();

  const int last = spec.num_layers - 1;
  const int items = ((hw + kTile - 1) / kTile) * n;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bn = item % n;
    const int px = (item / n) * kTile + lane;
    const bool valid = px < hw;

    // Forward recompute: each sine layer's pre-activation into the stash, its
    // output (rounded to T) into the other buffer.  The last sine layer's
    // output is not kept: the backward recomputes every layer input.
    load_input<T>(hb, prev, pos, pose, spec, bn, px, valid, hw, lane, warp);
    __syncthreads();
    float* cur = hb;
    float* nxt = gc;
    for (int l = 0; l < spec.num_sine; ++l) {
      const int ci = spec.ci[l];
      const int co = spec.co[l];
      const T* wl = w + spec.w_off[l];
      const float* bl = b + spec.b_off[l];
      float* al = stash + spec.s_off[l] * kStride;
      const bool keep = l + 1 < spec.num_sine;
      for (int r0 = warp * kRows; r0 < co; r0 += kWarps * kRows) {
        const T* wrow[kRows];
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          wrow[r] = wl + static_cast<size_t>(min(r0 + r, co - 1)) * ci;
          acc[r] = 0.0f;
        }
        for (int k = 0; k < ci; ++k) {
          const float hv = cur[k * kStride + lane];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(tha4::ldg_f32<T>(wrow[r] + k), hv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int o = r0 + r;
          if (o >= co) break;
          const float a = __fadd_rn(acc[r], __ldg(bl + o));
          al[o * kStride + lane] = a;
          if (keep) nxt[o * kStride + lane] = round_to<T>(tha4::fast_sin(__fmul_rn(omega, a)));
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }

    // Backward.  gc holds the cotangent of the current layer's output (f32
    // values of compute-dtype numbers at the top); pixels past hw carry 0, so
    // they add nothing to any sum.
    const int co_last = spec.co[last];
    for (int o = warp; o < co_last; o += kWarps) {
      gc[o * kStride + lane] =
          valid ? tha4::to_f32<T>(gout[(static_cast<size_t>(bn) * co_last + o) * hw + px]) : 0.0f;
    }
    for (int l = last; l >= 0; --l) {
      const int ci = spec.ci[l];
      const int co = spec.co[l];
      const bool sine = l < spec.num_sine;
      const T* wl = w + spec.w_off[l];

      // The layer's input: the level input, or the previous (sine) layer's output.
      if (l == 0) {
        load_input<T>(hb, prev, pos, pose, spec, bn, px, valid, hw, lane, warp);
      } else {
        const float* ap = stash + spec.s_off[l - 1] * kStride;
        for (int r = warp; r < ci; r += kWarps) {
          hb[r * kStride + lane] = round_to<T>(tha4::fast_sin(__fmul_rn(omega, ap[r * kStride + lane])));
        }
      }
      // g_a in f32; its pixel sum is db; rounded to T, it replaces the
      // pre-activation in the stash (the head's stays in gc).
      float* ga = sine ? stash + spec.s_off[l] * kStride : gc;
      for (int o = warp; o < co; o += kWarps) {
        float v = gc[o * kStride + lane];
        if (sine) v = __fmul_rn(v, __fmul_rn(omega, tha4::fast_cos(__fmul_rn(omega, ga[o * kStride + lane]))));
        const float s = warp_sum(v);
        if (lane == 0) db[spec.b_off[l] + o] += s;
        ga[o * kStride + lane] = round_to<T>(v);
      }
      __syncthreads();

      // dW[o, c] += sum over the tile's pixels of g_a[o] h[c]: one 4 x 4
      // micro-tile per lane, rows shared by the warp, columns 32 apart.
      float* dwl = dw + spec.w_off[l];
      const int col_groups = (ci + 32 * kGradCols - 1) / (32 * kGradCols);
      const int units = ((co + kGradRows - 1) / kGradRows) * col_groups;
      for (int u = warp; u < units; u += kWarps) {
        const int r0 = (u / col_groups) * kGradRows;
        const int c0 = (u % col_groups) * (32 * kGradCols) + lane;
        const float* grow[kGradRows];
        const float* hrow[kGradCols];
        float acc[kGradRows][kGradCols];
#pragma unroll
        for (int i = 0; i < kGradRows; ++i) grow[i] = ga + min(r0 + i, co - 1) * kStride;
#pragma unroll
        for (int j = 0; j < kGradCols; ++j) hrow[j] = hb + min(c0 + 32 * j, ci - 1) * kStride;
#pragma unroll
        for (int i = 0; i < kGradRows; ++i) {
#pragma unroll
          for (int j = 0; j < kGradCols; ++j) acc[i][j] = 0.0f;
        }
        for (int p = 0; p < kTile; ++p) {
          float gv[kGradRows];
          float hv[kGradCols];
#pragma unroll
          for (int i = 0; i < kGradRows; ++i) gv[i] = grow[i][p];
#pragma unroll
          for (int j = 0; j < kGradCols; ++j) hv[j] = hrow[j][p];
#pragma unroll
          for (int i = 0; i < kGradRows; ++i) {
#pragma unroll
            for (int j = 0; j < kGradCols; ++j) acc[i][j] = fmaf(gv[i], hv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kGradRows; ++i) {
          const int o = r0 + i;
          if (o >= co) break;
#pragma unroll
          for (int j = 0; j < kGradCols; ++j) {
            const int c = c0 + 32 * j;
            if (c < ci) dwl[static_cast<size_t>(o) * ci + c] += acc[i][j];
          }
        }
      }

      // The input cotangent g_in[c] = sum_o W[o, c] g_a[o], into gn.
      for (int r0 = warp * kRows; r0 < ci; r0 += kWarps * kRows) {
        int col[kRows];
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          col[r] = min(r0 + r, ci - 1);
          acc[r] = 0.0f;
        }
        for (int k = 0; k < co; ++k) {
          const float gv = ga[k * kStride + lane];
          const T* wk = wl + static_cast<size_t>(k) * ci;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(tha4::ldg_f32<T>(wk + col[r]), gv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int c = r0 + r;
          if (c >= ci) break;
          gn[c * kStride + lane] = acc[r];
        }
      }
      __syncthreads();
      float* t = gc;
      gc = gn;
      gn = t;
    }

    // gc now holds the level input's cotangent: prev rows, two position rows
    // (dropped), pose rows.
    if (dprev != nullptr && valid) {
      for (int c = warp; c < spec.cp; c += kWarps) {
        dprev[(static_cast<size_t>(bn) * spec.cp + c) * hw + px] = tha4::from_f32<T>(gc[c * kStride + lane]);
      }
    }
    for (int q = warp; q < spec.pose_dim; q += kWarps) {
      const float s = warp_sum(gc[(spec.cp + 2 + q) * kStride + lane]);
      if (lane == 0) dpose[bn * spec.pose_dim + q] += s;
    }
    __syncthreads();
  }
}

// out[e] = sum over blocks, in block order, of the blocks' slabs.
__global__ void sum_slabs_kernel(const float* __restrict__ scratch, int blocks, int slab_size,
                                 float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= slab_size) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s = __fadd_rn(s, scratch[static_cast<size_t>(k) * slab_size + e]);
  out[e] = s;
}

template <typename T>
cudaError_t launch(const void* prev, const void* pos, const void* pose, const void* w, const void* b,
                   const void* gout, const BwdSpec& spec, float omega, void* dprev, void* scratch,
                   int blocks, void* grads, int n, int hw, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    // Set on every launch: the attribute is per device, and the call is cheap.
    cudaError_t e = cudaFuncSetAttribute(sine_chain_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sine_chain_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(prev), static_cast<const T*>(pos), static_cast<const float*>(pose),
      static_cast<const T*>(w), static_cast<const float*>(b), static_cast<const T*>(gout), spec,
      omega, static_cast<T*>(dprev), static_cast<float*>(scratch), n, hw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int slab_size = spec.w_total + spec.b_total + n * spec.pose_dim;
  sum_slabs_kernel<<<(slab_size + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(scratch), blocks, slab_size, static_cast<float*>(grads));
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace tha4 {
namespace tc {

// Sums over the tile's 64 pixels of this warpgroup's values (fragment
// order), for channels c0 .. c0 + H - 1 below co, into dst[channel]: each
// thread's two rows, then the warp's eight row groups by a butterfly, then
// the warpgroup's four warps in order.  Every block barrier here is reached
// by all threads.
template <int H>
__device__ __forceinline__ void tile_sum(const float (&v)[H / 2], float* red, float* __restrict__ dst, int c0,
                                         int co) {
  constexpr int kRow = kNChunk / 2;  // a warp's row of the table
  float* r = red + wg_index() * 4 * kRow;
  const int lane = threadIdx.x & 31;
  const int warp = wg_thread() >> 5;
#pragma unroll
  for (int k = 0; k < H / 2; k += 4) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = __fadd_rn(v[k + e], v[k + 2 + e]);
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 8));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 16));
      if (lane < 4) r[warp * kRow + frag_col(k + e)] = s;
    }
  }
  __syncthreads();
  const int t = wg_thread();
  if (t < H && c0 + t < co)
    dst[c0 + t] = __fadd_rn(__fadd_rn(__fadd_rn(r[t], r[kRow + t]), r[2 * kRow + t]), r[3 * kRow + t]);
  __syncthreads();
}

// An activation buffer's first ``channels`` channels (the rest, up to
// ``rows``, zeros) to scratch as [8 pixel groups][rows][8 pixels]: the
// K-major image of the dW product's operand.
__device__ inline void store_dw_operand(const unsigned char* buf, int channels, int rows,
                                        __nv_bfloat16* __restrict__ dst) {
  for (int i = threadIdx.x; i < 8 * rows; i += kThreads) {
    const int g = i / rows;
    const int c = i % rows;
    unsigned short v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (c < channels) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = *reinterpret_cast<const unsigned short*>(buf + act_off(c, 8 * g + j));
    }
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(i) * 8) =
        make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16), v[6] | (v[7] << 16));
  }
}

// Layer 0's input [prev | pos | pose] of the tile, rounded to bf16, to
// scratch in the dW operand's layout; prev comes from the activation buffer
// that holds it.  Pixels past hw: prev and pos 0.
__device__ inline void store_level_input(const unsigned char* prev_buf, const __nv_bfloat16* __restrict__ pos,
                                         const float* __restrict__ pose, const Chain& c, int n, int px0, int hw,
                                         __nv_bfloat16* __restrict__ dst) {
  const int rows = pad16(c.ci[0]);
  const unsigned short* pos16 = reinterpret_cast<const unsigned short*>(pos);
  for (int i = threadIdx.x; i < 8 * rows; i += kThreads) {
    const int g = i / rows;
    const int ch = i % rows;
    unsigned short v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int px = px0 + 8 * g + j;
      if (ch < c.cp) {
        v[j] = *reinterpret_cast<const unsigned short*>(prev_buf + act_off(ch, 8 * g + j));
      } else if (ch < c.cp + 2) {
        const unsigned short x = __ldg(pos16 + static_cast<size_t>(ch - c.cp) * hw + min(px, hw - 1));
        v[j] = px < hw ? x : 0;
      } else if (ch < c.ci[0]) {
        v[j] = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(pose + static_cast<size_t>(n) * c.pose_dim + ch - c.cp - 2)));
      } else {
        v[j] = 0;
      }
    }
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(i) * 8) =
        make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16), v[6] | (v[7] << 16));
  }
}

// The stash's index of accumulator k of this thread, in the half at c0 (a
// chunk's channels, the warpgroup's offset included): H x 64 floats a half,
// value k of warpgroup thread t at k x 128 + t.
__device__ __forceinline__ int stash_at(int c0, int k) { return c0 * kTile + k * 128 + wg_thread(); }

// Turns this warpgroup's half (channels from c0) of layer l's output
// cotangent g (fragment order, f32) into g_a: times omega fast_cos(omega a)
// for a sine layer (a from the stash); sums it over the tile's pixels into
// db; rounds it to bf16 (layer 0: sums the rounded values into s0) and
// writes it to ``dst``, the next product's A buffer, zeros past co.
template <int H>
__device__ __forceinline__ void finish_ga(float (&g)[H / 2], const Chain& c, int l, int c0, const float* stash,
                                          float omega, float* red, float* db, float* s0, unsigned char* dst) {
  const int co = c.co[l];
  if (l < c.num_sine) {
#pragma unroll
    for (int k = 0; k < H / 2; ++k) {
      const float a = stash[stash_at(c0, k)];
      g[k] = __fmul_rn(g[k], __fmul_rn(omega, fast_cos(__fmul_rn(omega, a))));
    }
  }
  tile_sum<H>(g, red, db + c.b_off[l], c0, co);
#pragma unroll
  for (int k = 0; k < H / 2; ++k) g[k] = __bfloat162float(__float2bfloat16_rn(g[k]));
  if (l == 0) tile_sum<H>(g, red, s0, c0, co);
#pragma unroll
  for (int k = 0; k < H / 2; k += 2) {
    const int o = c0 + frag_col(k);
    *reinterpret_cast<__nv_bfloat162*>(dst + act_off(o, frag_row(k))) =
        __floats2bfloat162_rn(o < co ? g[k] : 0.0f, o + 1 < co ? g[k + 1] : 0.0f);
  }
}

// This warpgroup's half of an N chunk of sine layer l's forward (channels
// from c0): K1's, which also keeps the f32 pre-activations in the stash.
template <int H>
__device__ __forceinline__ void fwd_chunk(const Epi epi, const unsigned char* a_buf, unsigned char* dst, float* st,
                                          int c0, int k_used, Ring& ring, int& tile) {
  float acc[H / 2];
  gemm_chunk<H>(acc, a_buf, k_used, ring, tile);
#pragma unroll
  for (int k = 0; k < H / 2; k += 2) {
    const int o = c0 + frag_col(k);
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = o + e < epi.co;
      const float a = epi.pre(acc[k + e], o + e, k);
      const float y = fast_sin(__fmul_rn(epi.omega, a));
      v[e] = live ? y : 0.0f;
      st[stash_at(c0, k + e)] = live ? a : 0.0f;
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + act_off(o, frag_row(k))) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// Step 1: one block per 64-pixel tile (blockIdx.x) of batch element blockIdx.y.
__global__ void __launch_bounds__(kThreads, 2)
sine_chain_bwd_tc_kernel(const __nv_bfloat16* __restrict__ prev, const __nv_bfloat16* __restrict__ pos,
                         const float* __restrict__ pose, const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ b, const __nv_bfloat16* __restrict__ layout,
                         const __grid_constant__ Chain ch, const __grid_constant__ BwdWork wk, float omega,
                         const __nv_bfloat16* __restrict__ gout, __nv_bfloat16* __restrict__ dprev,
                         unsigned char* __restrict__ ws, int hw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem, ch);
  float* red = reinterpret_cast<float*>(sm.extra);
  const int n = blockIdx.y;
  const int px0 = blockIdx.x * kTile;
  const long long tile_id = static_cast<long long>(n) * wk.tiles_hw + blockIdx.x;
  __nv_bfloat16* h_ws = reinterpret_cast<__nv_bfloat16*>(ws + wk.h);
  __nv_bfloat16* ga_ws = reinterpret_cast<__nv_bfloat16*>(ws + wk.ga);
  float* stash = reinterpret_cast<float*>(ws + wk.stash) + tile_id * wk.stash_rows * kTile;
  float* db = reinterpret_cast<float*>(ws + wk.db) + tile_id * ch.b_total;
  float* s0 = reinterpret_cast<float*>(ws + wk.s0) + tile_id * ch.co[0];
  Ring ring = start_ring(sm, ch, layout, true);
  const int L = ch.num_layers;

  load_prev(sm.buf[0], prev, ch.cp, n, px0, hw);
  load_fold(sm, ch, w, reinterpret_cast<const float*>(ws + wk.pre0), n);
  fence_proxy_async();
  __syncthreads();
  store_level_input(sm.buf[0], pos, pose, ch, n, px0, hw, h_ws + wk.h_off[0] + tile_id * pad16(ch.ci[0]) * kTile);

  // The forward of the sine layers: pre-activations to the stash, each
  // layer's output to the other buffer and, as the next layer's input, to
  // scratch.
  int tile = 0;
  int in = 0;
  for (int l = 0; l < ch.num_sine; ++l) {
    const Segment seg = fwd_segment(ch, l);
    const Epi epi = make_epi(sm, ch, b, pos, px0, hw, l, omega);
    unsigned char* dst = sm.buf[in ^ 1];
    float* st = stash + wk.s_row[l] * kTile;
    for (int n0 = 0; n0 < seg.n_layout; n0 += kNChunk) {
      dispatch_half(min(kNChunk, seg.n_layout - n0), [&](auto width) {
        constexpr int H = decltype(width)::value;
        fwd_chunk<H>(epi, sm.buf[in], dst, st, n0 + wg_index() * H, seg.k_used, ring, tile);
      });
    }
    fence_proxy_async();
    __syncthreads();
    if (l + 1 < L) store_dw_operand(dst, seg.n_layout, pad16(ch.ci[l + 1]), h_ws + wk.h_off[l + 1] + tile_id * pad16(ch.ci[l + 1]) * kTile);
    in ^= 1;
  }
  __syncthreads();

  // The last layer's g_a from the output cotangent.
  int cur = 0;
  {
    const int l = L - 1;
    const int co = ch.co[l];
    const int npad = pad16(co);
    for (int n0 = 0; n0 < npad; n0 += kNChunk) {
      dispatch_half(min(kNChunk, npad - n0), [&](auto width) {
        constexpr int H = decltype(width)::value;
        const int c0 = n0 + wg_index() * H;
        float g[H / 2];
#pragma unroll
        for (int k = 0; k < H / 2; ++k) {  // clamped loads, then a select: no load waits behind a branch
          const int o = c0 + frag_col(k);
          const int px = px0 + frag_row(k);
          const float v = ldg_f32(gout + (static_cast<size_t>(n) * co + min(o, co - 1)) * hw + min(px, hw - 1));
          g[k] = (o < co && px < hw) ? v : 0.0f;
        }
        finish_ga<H>(g, ch, l, c0, stash + wk.s_row[l] * kTile, omega, red, db, s0, sm.buf[cur]);
      });
    }
    fence_proxy_async();
    __syncthreads();
    store_dw_operand(sm.buf[cur], npad, pad64(co), ga_ws + wk.ga_off[l] + tile_id * pad64(co) * kTile);
  }

  // Down the chain: g of layer l - 1's output = W_l^T T(g_a of layer l).
  for (int l = L - 1; l >= 1; --l) {
    const Segment seg = bwd_segment(ch, l);
    unsigned char* dst = sm.buf[cur ^ 1];
    for (int n0 = 0; n0 < seg.n_used; n0 += kNChunk) {
      dispatch_half(min(kNChunk, seg.n_layout - n0), [&](auto width) {
        constexpr int H = decltype(width)::value;
        float g[H / 2];
        gemm_chunk<H>(g, sm.buf[cur], seg.k_used, ring, tile);
        finish_ga<H>(g, ch, l - 1, n0 + wg_index() * H, stash + wk.s_row[l - 1] * kTile, omega, red, db, s0, dst);
      });
    }
    fence_proxy_async();
    __syncthreads();
    const int co = ch.co[l - 1];
    store_dw_operand(dst, pad16(co), pad64(co), ga_ws + wk.ga_off[l - 1] + tile_id * pad64(co) * kTile);
    cur ^= 1;
  }

  // dprev = T(W_0^T T(g_a of layer 0)) over the prev columns.
  if (ch.cp > 0) {
    const Segment seg = bwd_segment(ch, 0);
    unsigned char* dst = sm.buf[cur ^ 1];
    for (int n0 = 0; n0 < seg.n_used; n0 += kNChunk) {
      dispatch_half(min(kNChunk, seg.n_layout - n0), [&](auto width) {
        constexpr int H = decltype(width)::value;
        float g[H / 2];
        gemm_chunk<H>(g, sm.buf[cur], seg.k_used, ring, tile);
#pragma unroll
        for (int k = 0; k < H / 2; k += 2) {
          const int o = n0 + wg_index() * H + frag_col(k);
          if (o < ch.cp)
            *reinterpret_cast<__nv_bfloat162*>(dst + act_off(o, frag_row(k))) = __floats2bfloat162_rn(g[k], g[k + 1]);
        }
      });
    }
    __syncthreads();
    store_channels_first(dst, dprev, ch.cp, n, px0, hw);
  }
}

// Step 2: dW of one (layer, 64 output rows, up to 128 input columns) work
// item (blockIdx.x) over one run of tiles (blockIdx.y), to that run's
// partial sums; each warpgroup takes half of the columns.
constexpr int kDwStages = 4;
constexpr int kDwA = 8 * 64 * 16;                // A: 8 pixel groups x 64 rows x 8 pixels
constexpr int kDwStage = kDwA + 8 * kNChunk * 16;  // then B: 8 x up to 128 columns x 8
constexpr int kDwSmem = kBarBytes + kDwStages * kDwStage;

__global__ void __launch_bounds__(kThreads, 2)
sine_chain_dw_kernel(const __grid_constant__ Chain ch, const __grid_constant__ BwdWork wk,
                     const unsigned char* __restrict__ ws, float* __restrict__ slabs) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + kBarBytes;
  int item = blockIdx.x;
  int l = 0;
  for (;; ++l) {
    const int items = (pad64(ch.co[l]) / 64) * cdiv(pad16(ch.ci[l]), kNChunk);
    if (item < items) break;
    item -= items;
  }
  const int ncs = cdiv(pad16(ch.ci[l]), kNChunk);
  const int m0 = (item / ncs) * 64;
  const int n0 = (item % ncs) * kNChunk;
  const int ga_rows = pad64(ch.co[l]);
  const int h_rows = pad16(ch.ci[l]);
  const int nb = min(kNChunk, h_rows - n0);
  const int t0 = blockIdx.y * wk.per_split;
  const int count = max(0, min(wk.tiles, t0 + wk.per_split) - t0);
  const __nv_bfloat16* ga = reinterpret_cast<const __nv_bfloat16*>(ws + wk.ga) + wk.ga_off[l];
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(ws + wk.h) + wk.h_off[l];

  auto issue = [&](int i) {  // thread 0: run tile i into stage i % kDwStages
    const long long t = t0 + i;
    unsigned char* st = stages + (i % kDwStages) * kDwStage;
    uint64_t* bar = bars + i % kDwStages;
    mbar_expect_tx(bar, 8 * (1024 + nb * 16));
    for (int g = 0; g < 8; ++g) {
      bulk_copy(st + g * 1024, ga + (t * ga_rows * kTile + (static_cast<long long>(g) * ga_rows + m0) * 8), 1024, bar);
      bulk_copy(st + kDwA + g * nb * 16, h + (t * h_rows * kTile + (static_cast<long long>(g) * h_rows + n0) * 8),
                nb * 16, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDwStages; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kDwStages && i < count; ++i) issue(i);
  }
  __syncthreads();

  dispatch_half(nb, [&](auto width) {
    constexpr int H = decltype(width)::value;
    float acc[H / 2];
#pragma unroll
    for (int k = 0; k < H / 2; ++k) acc[k] = 0.0f;
    for (int i = 0; i < count; ++i) {
      mbar_wait(bars + i % kDwStages, (i / kDwStages) & 1);
      const unsigned char* st = stages + (i % kDwStages) * kDwStage;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma<H>(acc, smem_desc(st + 2 * s * 1024, 1024, 128),
                 smem_desc(st + kDwA + (2 * s * 2 * H + wg_index() * H) * 16, 2 * H * 16, 128));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncthreads();
      if (threadIdx.x == 0 && i + kDwStages < count) issue(i + kDwStages);
    }
    float* out = slabs + static_cast<size_t>(blockIdx.y) * ch.w_total + ch.w_off[l];
#pragma unroll
    for (int k = 0; k < H / 2; ++k) {
      const int o = m0 + frag_row(k);
      const int c = n0 + wg_index() * H + frag_col(k);
      if (o < ch.co[l] && c < ch.ci[l]) out[static_cast<size_t>(o) * ch.ci[l] + c] = acc[k];
    }
  });
}

// Step 3: out[b][j] = sum over rows r, in order within each of eight runs
// of rows and then over the runs in order, of in[b][r][j].
__global__ void __launch_bounds__(256)
column_sum_kernel(const float* __restrict__ in, int rows, int cols, long long batch_in, float* __restrict__ out,
                  long long batch_out) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int per = cdiv(rows, 8);
  const float* src = in + blockIdx.y * batch_in;
  float s = 0.0f;
  if (j < cols) {
    for (int r = warp * per; r < min(rows, (warp + 1) * per); ++r) s = __fadd_rn(s, src[static_cast<size_t>(r) * cols + j]);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < cols) {
    float t = red[0][lane];
    for (int q = 1; q < 8; ++q) t = __fadd_rn(t, red[q][lane]);
    out[blockIdx.y * batch_out + j] = t;
  }
}

// dpose[n][q] = sum over layer 0's outputs o, in order, of W[o][cp + 2 + q]
// x (sum over the pixels of batch element n of T(g_a)[o]).
__global__ void dpose_kernel(const __grid_constant__ Chain ch, const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ sn, int n, float* __restrict__ dpose) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * ch.pose_dim) return;
  const int bn = i / ch.pose_dim;
  const int q = i % ch.pose_dim;
  float s = 0.0f;
  for (int o = 0; o < ch.co[0]; ++o)
    s = __fmaf_rn(ldg_f32(w + ch.w_off[0] + static_cast<size_t>(o) * ch.ci[0] + ch.cp + 2 + q),
                  sn[static_cast<size_t>(bn) * ch.co[0] + o], s);
  dpose[i] = s;
}

}  // namespace tc
}  // namespace tha4

// K4, bf16: prev (N, Cp, HW) or null, pos (2, HW), gout (N, Cout, HW) and
// dprev (N, Cp, HW) bf16; pose (N, P) and b f32; w the packed bf16 weights
// and ``layout`` all of tile_index's tiles; ``ws`` a workspace of the plan's
// bytes (tha4_sine_chain_tc_plan); grads receives [dW | db | dpose], f32.
// Seven launches.  Returns a cudaError_t (0 on success).
extern "C" int tha4_sine_chain_tc_backward(const void* prev, int cp, const void* pos, const void* pose, int pose_dim,
                                           const void* w, const void* b, const void* layout, const void* specs,
                                           int num_layers, int num_sine, float omega, const void* gout, void* dprev,
                                           void* ws, long long ws_bytes, void* grads, int n, int hw, int sms,
                                           void* stream) {
  namespace tc = tha4::tc;
  tc::Chain ch;
  int e = tc::make_chain(static_cast<const int*>(specs), num_layers, num_sine, cp, pose_dim, true, ch);
  if (e != 0) return e;
  if (n < 1 || n > 65535 || hw < 1 || sms < 1 || (cp > 0 && (prev == nullptr || dprev == nullptr)))
    return cudaErrorInvalidValue;
  const tc::BwdWork wk = tc::bwd_work(ch, n, hw, sms);
  const size_t smem = tc::bwd_smem_bytes(ch);
  if (smem > tc::kSmemLimit || static_cast<size_t>(ws_bytes) < wk.total) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* out = static_cast<float*>(grads);

  e = tc::launch_fold(ch, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
                      static_cast<const float*>(pose), n, reinterpret_cast<float*>(base + wk.pre0), s);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tc::sine_chain_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  tc::sine_chain_bwd_tc_kernel<<<dim3(wk.tiles_hw, n), tc::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(prev), static_cast<const __nv_bfloat16*>(pos), static_cast<const float*>(pose),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(layout), ch,
      wk, omega, static_cast<const __nv_bfloat16*>(gout), static_cast<__nv_bfloat16*>(dprev), base, hw);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  e = cudaFuncSetAttribute(tc::sine_chain_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kDwSmem);
  if (e != cudaSuccess) return e;
  float* slabs = reinterpret_cast<float*>(base + wk.slabs);
  tc::sine_chain_dw_kernel<<<dim3(wk.items, wk.splits), tc::kThreads, tc::kDwSmem, s>>>(ch, wk, base, slabs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  tc::column_sum_kernel<<<dim3(tc::cdiv(ch.w_total, 32), 1), 256, 0, s>>>(slabs, wk.splits, ch.w_total, 0, out, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tc::column_sum_kernel<<<dim3(tc::cdiv(ch.b_total, 32), 1), 256, 0, s>>>(reinterpret_cast<const float*>(base + wk.db), wk.tiles,
                                                                   ch.b_total, 0, out + ch.w_total, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (pose_dim == 0) return 0;
  float* sn = reinterpret_cast<float*>(base + wk.sn);
  tc::column_sum_kernel<<<dim3(tc::cdiv(ch.co[0], 32), n), 256, 0, s>>>(reinterpret_cast<const float*>(base + wk.s0), wk.tiles_hw,
                                                                 ch.co[0], static_cast<long long>(wk.tiles_hw) * ch.co[0],
                                                                 sn, ch.co[0]);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tc::dpose_kernel<<<tc::cdiv(n * pose_dim, 128), 128, 0, s>>>(ch, static_cast<const __nv_bfloat16*>(w), sn, n,
                                                       out + ch.w_total + ch.b_total);
  return static_cast<int>(cudaGetLastError());
}

// K4, f32.  specs: host int32 array of num_layers rows (ci, co, w_off,
// b_off), as for tha4_sine_chain_forward.  gout (N, Cout, HW) and dprev (N,
// Cp, HW) f32; scratch holds `blocks` slabs of (w_total + b_total + n *
// pose_dim) floats; grads receives [dW | db | dpose (N, pose_dim)], f32.
// Returns a cudaError_t (0 on success).
extern "C" int tha4_sine_chain_backward(const void* prev, int has_prev, int cp, const void* pos,
                                        const void* pose, int pose_dim, const void* w,
                                        const void* b, const void* specs, int num_layers,
                                        int num_sine, float omega, const void* gout, void* dprev,
                                        void* scratch, int blocks, void* grads, int n, int hw,
                                        void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || num_sine < num_layers - 1 ||
      num_sine > num_layers || n < 1 || hw < 1 || blocks < 1)
    return cudaErrorInvalidValue;
  if (!has_prev) cp = 0;
  BwdSpec spec;
  spec.num_layers = num_layers;
  spec.num_sine = num_sine;
  spec.cp = cp;
  spec.pose_dim = pose_dim;
  spec.cmax = cp + 2 + pose_dim;
  spec.stash_rows = 0;
  const int* rows = static_cast<const int*>(specs);
  for (int l = 0; l < num_layers; ++l) {
    spec.ci[l] = rows[4 * l + 0];
    spec.co[l] = rows[4 * l + 1];
    spec.w_off[l] = rows[4 * l + 2];
    spec.b_off[l] = rows[4 * l + 3];
    if (spec.co[l] < 1 || (l > 0 && spec.ci[l] != spec.co[l - 1])) return cudaErrorInvalidValue;
    if (spec.co[l] > spec.cmax) spec.cmax = spec.co[l];
    spec.s_off[l] = spec.stash_rows;
    if (l < num_sine) spec.stash_rows += spec.co[l];
  }
  if (spec.ci[0] != cp + 2 + pose_dim) return cudaErrorInvalidValue;
  const int last = num_layers - 1;
  spec.w_total = spec.w_off[last] + spec.co[last] * spec.ci[last];
  spec.b_total = spec.b_off[last] + spec.co[last];
  const size_t smem = static_cast<size_t>(spec.stash_rows + 3 * spec.cmax) * kStride * sizeof(float);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!has_prev) dprev = nullptr;
  return static_cast<int>(launch<float>(prev, pos, pose, w, b, gout, spec, omega, dprev, scratch, blocks, grads, n,
                                        hw, smem, s));
}
