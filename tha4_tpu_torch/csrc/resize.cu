// R1: the torch-rule bilinear resize (interpolate(mode='bilinear',
// align_corners=False), no antialias) and its adjoint, NCHW or NHWC.
//
// Replaces no TPU kernel: tha4_tpu/ops/resize.py resizes by two dense
// interpolation-matrix products (einsums on the MXU), which the port ran as
// two f32 torch.matmul calls a resize.  On an H100 those GEMMs multiply
// mostly by zero: the frame's two level upsamples, (1, 180, 128^2) -> 256^2
// and (1, 90, 256^2) -> 512^2 in f32, are 22.65 GFLOP of CUDA-core products
// for 176.9 MB of compulsory traffic.  The op is a two-tap stencil per axis,
// bound by memory: 0.053 ms at 3.35 TB/s for the frame's pair.
//
// Arithmetic, the plain version's (ops/cuda_resize.py resize_plain) step for
// step, so that the two agree bit for bit:
//   per axis, output index o takes source taps i0, i1 and weights w0, w1
//   (the f64 rule src = clamp((o + 0.5) * in / out - 0.5, 0, in - 1),
//   i0 = floor(src), i1 = min(i0 + 1, in - 1), w0 = f32(1 - t),
//   w1 = f32(t), t = src - i0; made once on the host, one int4 a index);
//   the H pass first, then the W pass, each fl(fl(w0 * a) + fl(w1 * b)) in
//   f32 on taps read in the input dtype (an axis whose size does not change
//   is passed through); one rounding to the input dtype at the end.  The _rn
//   intrinsics keep nvcc from contracting a product and a sum into an FMA.
//
// The adjoint gathers: each input element sums, in f32 and in a fixed
// order, the output elements whose taps hit it, from an inverse table per
// axis (the entries (o, w) sorted by source index, stable in (o, tap); then
// the in + 1 offsets).  The W adjoint is applied first, then the H adjoint
// (the transpose of H-then-W): dy(o_h, j) = sum over j's W entries of
// fl(w * g(o_h, o_w)), dx(i, j) = sum over i's H entries of fl(w * dy).
// One rounding to the dtype, no atomics: two calls give the same bits.
//
// Design.  What bounds it on an H100 is memory: the frame's pair moves
// 176.9 MB (0.053 ms at 3.35 TB/s), the body student's bf16 levels at B = 8
// 236 MB and 472 MB each way.  Before that, the load path and the
// instruction rate: a direct kernel reads four taps an output, each input element about
// sixteen times, and a flat index costs integer divisions and 64-bit
// offsets an element.  So the grid is the output's shape (blockIdx.y and
// threadIdx.y rows, blockIdx.z planes, x along a row) with 32-bit offsets
// (the wrapper checks that they fit), and:
//   NCHW forward (the frame): a block makes a chunk of 256 columns of four
//   output rows of one plane; it computes the chunk's H pass once per
//   source column into shared memory (two coalesced loads each) and the W
//   pass from there, a warp's columns consecutive (bilinear_resize_rows_
//   kernel).  Of the variants timed on the card (direct with 1, 2 or 4
//   columns a thread, this with 64-256 threads a row and 1-4 columns a
//   thread) it was fastest at the frame's shapes.  A W downsample steeper
//   than about 400x, whose chunk does not fit 48 KB, goes the NHWC way
//   through a permuted view (the wrapper asks tha4_bilinear_resize_rows_fit).
//   NHWC forward and adjoint (the body student's levels, the teacher): a
//   block makes part of one row of one image; a thread makes P items a
//   blockDim.x apart (4 forward, 2 adjoint), an item V channels of one
//   pixel (4, 2 or 1, whichever divides C), which share all four taps, each
//   read as one V-wide load where the channel stride is 1 and the other
//   strides and the address allow (VEC).  More items a thread keep more
//   loads in flight: at the student's first level one item a thread read
//   0.145 ms, four 0.124 ms, against 0.089 ms for a plain stream of the same
//   bytes.  The adjoint keeps an item's W entries (at most MAXW) in
//   registers across its row's H entries, which every thread of the block
//   shares.  An NCHW cotangent (no shipped path has one) is read as its
//   NHWC view, and its gradient returned as one.
// The input is read in place through its strides, so a permuted or sliced
// view costs no copy; the output is contiguous in the layout it is made in.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int P_FORWARD = 4;  // NHWC items a thread
constexpr int P_ADJOINT = 2;
constexpr int MAXW = 4;  // an adjoint item's W entries kept in registers (a 2x upsample has 4)

// V consecutive elements from p, widened to f32: one vector load.
template <typename T, int V> struct Vec;
template <typename T> struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = tha4::ldg_f32<T>(p); }
  static __device__ __forceinline__ void store(T* p, const float* v) { *p = tha4::from_f32<T>(v[0]); }
};
template <> struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    v[0] = a.x; v[1] = a.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// V channels at element offset o (channel stride sc): one vector load
// where VEC says the layout allows it.
template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_channels(const T* x, int o, int sc, float* v) {
  if (VEC) {
    Vec<T, V>::load(x + o, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = tha4::ldg_f32<T>(x + o + k * sc);
  }
}

// fl(fl(w0 * a) + fl(w1 * b)), no contraction.
__device__ __forceinline__ float two_tap(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// NCHW: a block makes a chunk of blockDim.x * V columns of blockDim.y output
// rows of one plane.  It first makes the chunk's H pass, y(j) = fl(fl(wh0 *
// x(i0, j)) + fl(wh1 * x(i1, j))) for the columns j that the chunk's taps
// read, each once, into shared memory (span floats a row), then the W pass
// from there; a thread's V columns are blockDim.x apart, so that a warp's
// loads, shared reads and stores are consecutive.  planes = N * C.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bilinear_resize_rows_kernel(const T* __restrict__ x, T* __restrict__ out, const int4* __restrict__ taps_h,
                            const int4* __restrict__ taps_w, int planes, int c, int h, int w, int ho, int wo, int sn,
                            int sc, int sh, int sw, int span) {
  extern __shared__ float ys[];
  float* y = ys + threadIdx.y * span;
  const bool hpass = h != ho, wpass = w != wo;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool live = row < ho;  // a row past the end makes the last row again and stores nothing
  const int ro = live ? row : ho - 1;
  const int4 th = __ldg(taps_h + ro);
  const float wh0 = __int_as_float(th.z), wh1 = __int_as_float(th.w);
  const int cbeg = blockIdx.x * blockDim.x * V;
  const int cend = min(cbeg + static_cast<int>(blockDim.x) * V, wo);
  const int jlo = __ldg(taps_w + cbeg).x, jhi = __ldg(taps_w + cend - 1).y;
  for (int plane = blockIdx.z; plane < planes; plane += gridDim.z) {
    const int n = plane / c, ci = plane - n * c;
    const int r0 = n * sn + ci * sc + th.x * sh, r1 = n * sn + ci * sc + th.y * sh;
    for (int j = jlo + threadIdx.x; j <= jhi; j += blockDim.x) {
      const float a = tha4::ldg_f32<T>(x + r0 + j * sw);
      y[j - jlo] = hpass ? two_tap(wh0, a, wh1, tha4::ldg_f32<T>(x + r1 + j * sw)) : a;
    }
    __syncthreads();
    if (live) {
      T* o = out + (static_cast<size_t>(plane) * ho + ro) * wo;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int co = cbeg + threadIdx.x + k * blockDim.x;
        if (co < cend) {
          const int4 tw = __ldg(taps_w + co);
          const float v = wpass ? two_tap(__int_as_float(tw.z), y[tw.x - jlo], __int_as_float(tw.w), y[tw.y - jlo])
                                : y[co - jlo];
          o[co] = tha4::from_f32<T>(v);
        }
      }
    }
    __syncthreads();
  }
}

// NHWC: a block makes part of one output row (blockIdx.y) of one image
// (blockIdx.z); a thread makes P items blockDim.x apart, an item V channels
// of one pixel, which share its four taps, each read as one V-wide load
// where VEC allows.  An item's offset in the row is its index x V.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(THREADS)
bilinear_resize_kernel(const T* __restrict__ x, T* __restrict__ out, const int4* __restrict__ taps_h,
                       const int4* __restrict__ taps_w, int c, int h, int w, int ho, int wo, int sn, int sc, int sh,
                       int sw) {
  const int ro = blockIdx.y, n = blockIdx.z;
  const bool hpass = h != ho, wpass = w != wo;
  const int groups = c / V, items = wo * groups;
  const int4 th = __ldg(taps_h + ro);
  const float wh0 = __int_as_float(th.z), wh1 = __int_as_float(th.w);
  const int r0 = n * sn + th.x * sh, r1 = n * sn + th.y * sh;
  T* row = out + static_cast<size_t>(n * ho + ro) * wo * c;
#pragma unroll
  for (int p = 0; p < P_FORWARD; ++p) {
    const int t = (blockIdx.x * P_FORWARD + p) * blockDim.x + threadIdx.x;
    if (t < items) {
      const int co = t / groups;
      const int cs = (t - co * groups) * V * sc;
      const int4 tw = __ldg(taps_w + co);
      float y0[V], y1[V], b[V], v[V];
      load_channels<T, V, VEC>(x, r0 + cs + tw.x * sw, sc, y0);
      if (wpass) load_channels<T, V, VEC>(x, r0 + cs + tw.y * sw, sc, y1);
      if (hpass) {
        load_channels<T, V, VEC>(x, r1 + cs + tw.x * sw, sc, b);
#pragma unroll
        for (int k = 0; k < V; ++k) y0[k] = two_tap(wh0, y0[k], wh1, b[k]);
        if (wpass) {
          load_channels<T, V, VEC>(x, r1 + cs + tw.y * sw, sc, b);
#pragma unroll
          for (int k = 0; k < V; ++k) y1[k] = two_tap(wh0, y1[k], wh1, b[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = wpass ? two_tap(__int_as_float(tw.z), y0[k], __int_as_float(tw.w), y1[k]) : y0[k];
      Vec<T, V>::store(row + t * V, v);
    }
  }
}

// The adjoint.  adj_h / adj_w: 2 * out entries {o, bits(w)} sorted by source
// index, then in + 1 offsets.  g is read through its strides (32-bit
// offsets); dx is contiguous in the layout.  dx(i, j) = sum over i's H
// entries (o_h, w_h) of fl(w_h * dy(o_h, j)), dy(o_h, j) = sum over j's W
// entries (o_w, w_w) of fl(w_w * g(o_h, o_w)), each sum from 0 in entry
// order; an axis whose size does not change passes its value through.

// The H entries of dx row i: [begin, end) into adj_h's entries, or one
// pass-through entry.
struct Entries {
  int begin, end;
};

__device__ __forceinline__ Entries h_entries(const int* adj_h, int i, int ho, bool hpass) {
  return hpass ? Entries{__ldg(adj_h + 4 * ho + i), __ldg(adj_h + 4 * ho + i + 1)} : Entries{0, 1};
}

// NHWC: a block makes part of dx row i (blockIdx.y) of one image
// (blockIdx.z); a thread makes P items blockDim.x apart, an item V channels
// of one pixel.  An item keeps its first MAXW W entries in registers across
// the row's H entries, which every thread of the block shares.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(THREADS)
bilinear_resize_backward_kernel(const T* __restrict__ g, T* __restrict__ dx, const int* __restrict__ adj_h,
                                const int* __restrict__ adj_w, int c, int h, int w, int ho, int wo, int sn, int sc,
                                int sh, int sw) {
  const int i = blockIdx.y, n = blockIdx.z;
  const bool hpass = h != ho, wpass = w != wo;
  const int groups = c / V, items = w * groups;
  const int2* entries_h = reinterpret_cast<const int2*>(adj_h);
  const int2* entries_w = reinterpret_cast<const int2*>(adj_w);
  const int* offsets_w = adj_w + 4 * wo;
  const Entries eh = h_entries(adj_h, i, ho, hpass);
  T* row = dx + static_cast<size_t>(n * h + i) * w * c;
#pragma unroll
  for (int p = 0; p < P_ADJOINT; ++p) {
    const int t = (blockIdx.x * P_ADJOINT + p) * blockDim.x + threadIdx.x;
    if (t < items) {
      const int j = t / groups;
      const int base = n * sn + (t - j * groups) * V * sc;
      const int wb = wpass ? __ldg(offsets_w + j) : 0;
      const int nw = wpass ? __ldg(offsets_w + j + 1) - wb : 1;
      int col[MAXW];
      float ww[MAXW];
#pragma unroll
      for (int m = 0; m < MAXW; ++m) {
        const int2 e = (wpass && m < nw) ? __ldg(entries_w + wb + m) : make_int2(j, __float_as_int(1.0f));
        col[m] = e.x * sw;
        ww[m] = __int_as_float(e.y);
      }
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.0f;
      for (int mh = eh.begin; mh < eh.end; ++mh) {
        const int2 e = hpass ? __ldg(entries_h + mh) : make_int2(i, 0);
        const int r = base + e.x * sh;
        float dy[V], gv[V];
        if (wpass) {
#pragma unroll
          for (int k = 0; k < V; ++k) dy[k] = 0.0f;
#pragma unroll
          for (int m = 0; m < MAXW; ++m) {
            if (m < nw) {
              load_channels<T, V, VEC>(g, r + col[m], sc, gv);
#pragma unroll
              for (int k = 0; k < V; ++k) dy[k] = __fadd_rn(dy[k], __fmul_rn(ww[m], gv[k]));
            }
          }
          for (int m = MAXW; m < nw; ++m) {
            const int2 ew = __ldg(entries_w + wb + m);
            load_channels<T, V, VEC>(g, r + ew.x * sw, sc, gv);
#pragma unroll
            for (int k = 0; k < V; ++k) dy[k] = __fadd_rn(dy[k], __fmul_rn(__int_as_float(ew.y), gv[k]));
          }
        } else {
          load_channels<T, V, VEC>(g, r + col[0], sc, dy);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = hpass ? __fadd_rn(acc[k], __fmul_rn(__int_as_float(e.y), dy[k])) : dy[k];
      }
      Vec<T, V>::store(row + t * V, acc);
    }
  }
}

// A launch's operands: src and dst (x and out, or g and dx), the two axes'
// tables, the sizes and src's strides.
struct Args {
  const void* src;
  void* dst;
  const void* th;
  const void* tw;
  int n, c, h, w, ho, wo, sn, sc, sh, sw;
  cudaStream_t s;
};

// The rows kernel's block and shared memory for (h, w) -> (ho, wo): 64 x 4
// threads, 4 columns a thread; a chunk's H pass reads at most
// (chunk - 1) * w / wo + 3 columns.  Where a steep downsample would need
// more than 48 KB, fewer columns a thread, then fewer rows and threads a
// block.  False where even one warp's row does not fit.
struct RowsPlan {
  int tx, ty, v, span;
};

bool rows_plan(int w, int wo, RowsPlan* plan) {
  for (int tx = 64; tx >= 32; tx /= 2) {
    for (int ty = 4; ty >= 1; ty /= 2) {
      for (int v = 4; v >= 1; v /= 2) {
        const long long span = static_cast<long long>(tx * v - 1) * w / wo + 3;
        if (span * ty * static_cast<long long>(sizeof(float)) <= 48 * 1024) {
          *plan = RowsPlan{tx, ty, v, static_cast<int>(span)};
          return true;
        }
      }
    }
  }
  return false;
}

unsigned planes_z(int planes) { return planes < 65535 ? planes : 65535; }

template <typename T>
int launch_rows(const Args& a) {
  RowsPlan p;
  if (!rows_plan(a.w, a.wo, &p)) return cudaErrorInvalidValue;
  const int planes = a.n * a.c;
  const dim3 blocks((a.wo + p.tx * p.v - 1) / (p.tx * p.v), (a.ho + p.ty - 1) / p.ty, planes_z(planes));
  const dim3 threads(p.tx, p.ty, 1);
  const size_t smem = static_cast<size_t>(p.span) * p.ty * sizeof(float);
  const T* x = static_cast<const T*>(a.src);
  T* out = static_cast<T*>(a.dst);
  const int4* h4 = static_cast<const int4*>(a.th);
  const int4* w4 = static_cast<const int4*>(a.tw);
#define THA4_R1_ROWS(V)                                                                                          \
  bilinear_resize_rows_kernel<T, V><<<blocks, threads, smem, a.s>>>(x, out, h4, w4, planes, a.c, a.h, a.w, a.ho,  \
                                                                     a.wo, a.sn, a.sc, a.sh, a.sw, p.span)
  if (p.v == 4) THA4_R1_ROWS(4);
  else if (p.v == 2) THA4_R1_ROWS(2);
  else THA4_R1_ROWS(1);
#undef THA4_R1_ROWS
  return static_cast<int>(cudaGetLastError());
}

// The NHWC forward (ADJOINT false) or adjoint: blocks of THREADS along a
// row's items, P items a thread; one row and one image a block.
template <bool ADJOINT, typename T, int V, bool VEC>
int launch_nhwc(const Args& a) {
  const int rows = ADJOINT ? a.h : a.ho, items = (ADJOINT ? a.w : a.wo) * (a.c / V);
  const int per_block = THREADS * (ADJOINT ? P_ADJOINT : P_FORWARD);
  if (rows > 65535 || a.n > 65535) return cudaErrorInvalidValue;
  const dim3 blocks((items + per_block - 1) / per_block, rows, a.n);
  if (ADJOINT) {
    bilinear_resize_backward_kernel<T, V, VEC><<<blocks, THREADS, 0, a.s>>>(
        static_cast<const T*>(a.src), static_cast<T*>(a.dst), static_cast<const int*>(a.th),
        static_cast<const int*>(a.tw), a.c, a.h, a.w, a.ho, a.wo, a.sn, a.sc, a.sh, a.sw);
  } else {
    bilinear_resize_kernel<T, V, VEC><<<blocks, THREADS, 0, a.s>>>(
        static_cast<const T*>(a.src), static_cast<T*>(a.dst), static_cast<const int4*>(a.th),
        static_cast<const int4*>(a.tw), a.c, a.h, a.w, a.ho, a.wo, a.sn, a.sc, a.sh, a.sw);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool ADJOINT, typename T>
int nhwc_by_vec(const Args& a, int vec, bool vec_load) {
  if (vec == 4) return vec_load ? launch_nhwc<ADJOINT, T, 4, true>(a) : launch_nhwc<ADJOINT, T, 4, false>(a);
  if (vec == 2) return vec_load ? launch_nhwc<ADJOINT, T, 2, true>(a) : launch_nhwc<ADJOINT, T, 2, false>(a);
  return launch_nhwc<ADJOINT, T, 1, false>(a);
}

// V divides C (NHWC; 1 for the NCHW rows kernel); the sizes are positive.
bool args_ok(const Args& a, int channels_last, int vec) {
  return a.n >= 1 && a.c >= 1 && a.h >= 1 && a.w >= 1 && a.ho >= 1 && a.wo >= 1 &&
         (vec == 1 || vec == 2 || vec == 4) && (channels_last ? a.c : 1) % vec == 0;
}

}  // namespace

// Whether the NCHW rows kernel takes a W resize w -> wo (1 or 0): a W
// downsample steeper than about 400x does not fit its shared memory, and
// the wrapper resizes such an image as NHWC through a permuted view.
extern "C" int tha4_bilinear_resize_rows_fit(int w, int wo) {
  RowsPlan p;
  return w >= 1 && wo >= 1 && rows_plan(w, wo, &p);
}

// x (N, C, H, W) or, channels_last, (N, H, W, C) in f32 or bf16, read
// through its strides sn, sc, sh, sw (elements; every offset fits 31
// bits); out contiguous (N, C, Ho, Wo) or (N, Ho, Wo, C) in x's dtype;
// taps_h (Ho, 4) and taps_w (Wo, 4) int32.  NHWC: vec (1, 2 or 4) divides
// C, and vec_load says C's stride is 1 and V-wide loads are aligned; NCHW
// (the rows kernel, where tha4_bilinear_resize_rows_fit) takes neither and
// vec is 1.  Returns a cudaError_t.
extern "C" int tha4_bilinear_resize_forward(const void* x, void* out, const void* taps_h, const void* taps_w,
                                            int n, int c, int h, int w, int ho, int wo, int channels_last,
                                            int sn, int sc, int sh, int sw, int is_bf16, int vec, int vec_load,
                                            void* stream) {
  const Args a{x, out, taps_h, taps_w, n, c, h, w, ho, wo, sn, sc, sh, sw, static_cast<cudaStream_t>(stream)};
  if (!args_ok(a, channels_last, vec)) return cudaErrorInvalidValue;
  if (!channels_last) return is_bf16 ? launch_rows<__nv_bfloat16>(a) : launch_rows<float>(a);
  return is_bf16 ? nhwc_by_vec<false, __nv_bfloat16>(a, vec, vec_load != 0)
                 : nhwc_by_vec<false, float>(a, vec, vec_load != 0);
}

// The adjoint: g (N, Ho, Wo, C) through its strides sn, sc, sh, sw (an NCHW
// cotangent is passed as its NHWC view), dx contiguous (N, H, W, C), both in
// one dtype; adj_h and adj_w the inverse tables (4 * Ho + H + 1 and 4 * Wo +
// W + 1 int32).  vec and vec_load as the forward's NHWC.  Returns a
// cudaError_t.
extern "C" int tha4_bilinear_resize_backward(const void* g, void* dx, const void* adj_h, const void* adj_w,
                                             int n, int c, int h, int w, int ho, int wo, int sn, int sc, int sh,
                                             int sw, int is_bf16, int vec, int vec_load, void* stream) {
  const Args a{g, dx, adj_h, adj_w, n, c, h, w, ho, wo, sn, sc, sh, sw, static_cast<cudaStream_t>(stream)};
  if (!args_ok(a, 1, vec)) return cudaErrorInvalidValue;
  return is_bf16 ? nhwc_by_vec<true, __nv_bfloat16>(a, vec, vec_load != 0)
                 : nhwc_by_vec<true, float>(a, vec, vec_load != 0);
}
