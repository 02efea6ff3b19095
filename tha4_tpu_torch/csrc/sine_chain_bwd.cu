// K4: the backward of one SIREN level, channels-first.
//
// Replaces tha4_tpu/ops/pallas_siren.py:fused_sine_chain_t_bwd (kernel body
// _make_bwd_kernel).  For every pixel and batch element it recomputes the
// level's forward (K1's arithmetic, bit for bit), keeping each sine layer's
// f32 pre-activation a, then walks back through the layers:
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
// multiply-adds each (forward recompute, W^T g_a, g_a h^T): 47 G, whose f32 FMA
// floor is 1.4 ms.  The TPU kernel carries dW across a sequential grid in VMEM;
// on Hopper blocks run in no order, and one block's dW (482 KB for the face)
// fits neither registers nor shared memory.
//
// Design (simple and right first; deterministic, no float atomics):
//   * a persistent grid of one block per SM; work item = (32-pixel tile, batch
//     element), block b takes items b, b + grid, b + 2 grid, ... in order;
//   * per item, shared memory holds every sine layer's f32 pre-activations
//     (the stash, 1024 rows at the face shape) and three C_max-row buffers
//     (layer input, cotangent, next cotangent), all with a 33-word row stride
//     so that lane = pixel and lane = channel reads are conflict-free: 182 KB
//     at the face shape, set through cudaFuncAttributeMaxDynamicSharedMemorySize;
//   * each block sums its items' dW, db and dpose into its own slab of the
//     scratch buffer (a read-modify-write that only this block, and always the
//     same thread, touches); a second kernel sums the slabs in block order;
//   * the chain products run as in K1 (lane = pixel, 8 rows per thread,
//     warp-uniform weight loads through the read-only cache); dW is a 4 x 4
//     micro-tile per lane contracted over the tile's 32 pixels.
// Two calls on one card give bit-identical gradients: every sum has a fixed
// order, given the grid size (the wrapper passes the SM count).  CUDA-core
// FMAs, not tensor cores: mma/wgmma is later work, as for K1.

#include "common.cuh"

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

// specs: host int32 array of num_layers rows (ci, co, w_off, b_off), as for
// tha4_sine_chain_forward.  gout (N, Cout, HW) and dprev (N, Cp, HW) are in
// the compute dtype; scratch holds `blocks` slabs of (w_total + b_total +
// n * pose_dim) floats; grads receives [dW | db | dpose (N, pose_dim)], f32.
// Returns a cudaError_t (0 on success).
extern "C" int tha4_sine_chain_backward(const void* prev, int has_prev, int cp, const void* pos,
                                        const void* pose, int pose_dim, const void* w,
                                        const void* b, const void* specs, int num_layers,
                                        int num_sine, float omega, const void* gout, void* dprev,
                                        void* scratch, int blocks, void* grads, int n, int hw,
                                        int is_bf16, void* stream) {
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
  cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(prev, pos, pose, w, b, gout, spec, omega, dprev,
                                                  scratch, blocks, grads, n, hw, smem, s)
                          : launch<float>(prev, pos, pose, w, b, gout, spec, omega, dprev, scratch,
                                          blocks, grads, n, hw, smem, s);
  return static_cast<int>(e);
}
