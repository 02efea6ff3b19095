// The tensor-core machinery of the bf16 SIREN kernels, K1
// (csrc/sine_chain.cu) and K4 (csrc/sine_chain_bwd.cu): two warpgroups, one
// tile of 64 pixels, each layer a GEMM on wgmma.
//
// A layer is a GEMM with M = the tile's 64 pixels, N = its output channels
// and K = its input channels, both padded to 16.  The tile's activations
// stay in shared memory for the whole chain, as the A operand: an
// activation buffer is [channel group of 8][64 pixels][8 channels] bf16, so
// every k16 step of A is two no-swizzle core matrices (LBO 1 KB, SBO 128 B).
// N is taken in chunks of at most 128, each split in two halves, one per
// warpgroup (at most 32 f32 accumulators a thread); a half's epilogue (bias,
// omega, fast_sin, the bf16 rounding) writes its channels straight into the
// other buffer, the next layer's A.  The epilogue is what bounds the kernel
// (about twenty CUDA-core operations per pixel and channel, against a
// fraction of a tensor-core cycle), so the second warpgroup is there for its
// CUDA cores and its latency hiding.
//
// The weights are the B operand.  They stream from a device layout made by
// tha4_tpu_torch/ops/cuda_siren.py (tile_index): per layer, per N chunk, per
// K block of 64, one contiguous tile [K group of 8][nb rows][8] bf16, the
// shared-memory image of the operand (LBO nb x 16 B, SBO 128 B).  The
// forward tiles hold W (rows: output channels), the backward tiles W^T
// (rows: input channels), forward layers in order, then backward layers in
// reverse order.  One thread keeps kStages tiles in flight through bulk
// copies on mbarriers; each tile, once multiplied, frees its stage for the
// tile kStages ahead, across layer boundaries.
//
// Layer 0 folds what is constant over a tile: its pose columns and the bias
// become one f32 vector per batch element, W_pose pose + b (exact bf16
// products summed in f32), and its two position columns two FMAs in the
// epilogue.  Its GEMM takes only the prev channels (none for the face and
// level 0).  Only the order of the f32 sums differs from the TPU kernel.

#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace tha4 {
namespace tc {

constexpr int kMaxLayers = 16;
constexpr int kTile = 64;       // pixels per tile: one wgmma m64
constexpr int kWarpgroups = 2;  // each takes half of every N chunk
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kKBlock = 64;     // K of one weight tile
constexpr int kNChunk = 128;    // the widest N chunk
constexpr int kStages = 4;      // weight tiles in flight
constexpr int kGroup = kTile * 16;  // bytes of one 8-channel group of an activation buffer
constexpr int kBarBytes = 128;  // the ring's mbarriers, before the stages
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int pad64(int x) { return (x + 63) & ~63; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Chain {
  int num_layers, num_sine, cp, pose_dim;
  int ci[kMaxLayers], co[kMaxLayers];
  int w_off[kMaxLayers], b_off[kMaxLayers];  // the plain packed layout (w, b)
  long long fwd_off[kMaxLayers];  // element offset of each layer's forward tiles
  long long bwd_off[kMaxLayers];  // and of its backward (transposed) tiles
  long long fwd_elems;            // elements of the forward tiles (K1's layout)
  long long layout_elems;         // and of all tiles (K4's)
  int cbuf;         // channels of an activation buffer
  int stage_bytes;  // bytes of one ring stage: the largest tile of the stream
  int w_total, b_total;
};

// One run of tiles: layer l's forward (W) or backward (W^T) product.
struct Segment {
  long long base;
  int n_layout;  // rows of the padded matrix
  int n_used;    // rows computed (layer 0's W^T: the prev columns only)
  int k_layout;  // columns of the padded matrix
  int k_used;    // columns multiplied (layer 0's W: the prev columns only)
};

__host__ __device__ inline Segment fwd_segment(const Chain& c, int l) {
  const int kl = pad16(c.ci[l]);
  return Segment{c.fwd_off[l], pad16(c.co[l]), pad16(c.co[l]), kl, l == 0 ? pad16(c.cp) : kl};
}

__host__ __device__ inline Segment bwd_segment(const Chain& c, int l) {
  const int nl = pad16(c.ci[l]);
  return Segment{c.bwd_off[l], nl, l == 0 ? pad16(c.cp) : nl, pad16(c.co[l]), pad16(c.co[l])};
}

__host__ __device__ inline int segment_tiles(const Segment& s) {
  return cdiv(s.n_used, kNChunk) * cdiv(s.k_used, kKBlock);
}

// The stream's segments: K1 runs the forward of every layer; K4 the forward
// of the sine layers, then the backward of every layer from the last.
__host__ __device__ inline int num_segments(const Chain& c, bool bwd) {
  return bwd ? c.num_sine + c.num_layers : c.num_layers;
}

__host__ __device__ inline Segment segment(const Chain& c, bool bwd, int s) {
  if (!bwd || s < c.num_sine) return fwd_segment(c, s);
  return bwd_segment(c, c.num_layers - 1 - (s - c.num_sine));
}

__host__ __device__ inline int stream_tiles(const Chain& c, bool bwd) {
  int t = 0;
  for (int s = 0; s < num_segments(c, bwd); ++s) t += segment_tiles(segment(c, bwd, s));
  return t;
}

// Host: the chain from the wrapper's (ci, co, w_off, b_off) rows, for K1's
// stream (bwd false) or K4's.  Returns a cudaError_t.
inline int make_chain(const int* rows, int num_layers, int num_sine, int cp, int pose_dim, bool bwd, Chain& c) {
  if (num_layers < 1 || num_layers > kMaxLayers || num_sine < 1 || num_sine > num_layers ||
      num_sine < num_layers - 1 || cp < 0 || pose_dim < 0)
    return cudaErrorInvalidValue;
  c.num_layers = num_layers;
  c.num_sine = num_sine;
  c.cp = cp;
  c.pose_dim = pose_dim;
  long long off = 0;
  c.cbuf = pad16(cp);
  for (int l = 0; l < num_layers; ++l) {
    c.ci[l] = rows[4 * l + 0];
    c.co[l] = rows[4 * l + 1];
    c.w_off[l] = rows[4 * l + 2];
    c.b_off[l] = rows[4 * l + 3];
    if (c.co[l] < 1 || c.ci[l] < 1 || (l > 0 && c.ci[l] != c.co[l - 1])) return cudaErrorInvalidValue;
    c.fwd_off[l] = off;
    off += static_cast<long long>(pad16(c.co[l])) * pad16(c.ci[l]);
    if (pad16(c.co[l]) > c.cbuf) c.cbuf = pad16(c.co[l]);
  }
  if (c.ci[0] != cp + 2 + pose_dim) return cudaErrorInvalidValue;
  c.fwd_elems = off;
  for (int l = num_layers - 1; l >= 0; --l) {
    c.bwd_off[l] = off;
    off += static_cast<long long>(pad16(c.ci[l])) * pad16(c.co[l]);
  }
  c.layout_elems = off;
  c.stage_bytes = 512;
  for (int s = 0; s < num_segments(c, bwd); ++s) {
    const Segment seg = segment(c, bwd, s);
    const int b = (seg.k_layout < kKBlock ? seg.k_layout : kKBlock) * (seg.n_layout < kNChunk ? seg.n_layout : kNChunk) * 2;
    if (b > c.stage_bytes) c.stage_bytes = b;
  }
  const int last = num_layers - 1;
  c.w_total = c.w_off[last] + c.co[last] * c.ci[last];
  c.b_total = c.b_off[last] + c.co[last];
  return 0;
}

// Shared memory of a block: the ring, two activation buffers, layer 0's
// folded vectors (3 x cbuf floats) and ``extra`` bytes.
inline size_t smem_bytes(const Chain& c, size_t extra) {
  return kBarBytes + static_cast<size_t>(kStages) * c.stage_bytes + 2 * static_cast<size_t>(c.cbuf / 8) * kGroup +
         3 * static_cast<size_t>(c.cbuf) * 4 + extra;
}

// K4's workspace, carved from one buffer (offsets in bytes, 256-aligned).
// Per tile T (= batch element x tiles of HW + tile) and layer l:
//   h:     layer l's input, bf16, [8 pixel groups][pad16(ci_l)][8 pixels];
//   ga:    layer l's g_a rounded to bf16, [8 pixel groups][pad64(co_l)][8];
//   stash: the sine layers' f32 pre-activations in accumulator-fragment
//          order (chunk by chunk: value k of thread t at k x 128 + t);
//   db:    the tile's f32 sums of g_a over its pixels, per bias entry;
//   s0:    the tile's sums of layer 0's rounded g_a, per output channel;
// then the dW GEMM's per-split partial sums (splits x w_total), the
// per-batch-element sums of s0 (n x co_0) and layer 0's folded vectors
// (n x co_0, launch_fold).
struct BwdWork {
  int tiles_hw, tiles;
  int items;               // dW work items: (layer, 64-row block, 128-column chunk)
  int splits, per_split;   // dW's split of the tiles, summed in split order
  int stash_rows;          // f32 rows of a tile's stash
  int s_row[kMaxLayers];   // first stash row of each sine layer
  long long h_off[kMaxLayers], ga_off[kMaxLayers];  // bf16 elements, layer l's tile 0
  size_t h, ga, stash, db, s0, slabs, sn, pre0, total;  // byte offsets, total bytes
};

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

inline int dw_items(const Chain& c) {
  int items = 0;
  for (int l = 0; l < c.num_layers; ++l) items += (pad64(c.co[l]) / 64) * cdiv(pad16(c.ci[l]), kNChunk);
  return items;
}

inline BwdWork bwd_work(const Chain& c, int n, int hw, int sms) {
  BwdWork w;
  w.tiles_hw = cdiv(hw, kTile);
  w.tiles = n * w.tiles_hw;
  w.items = dw_items(c);
  const int want = cdiv(2 * sms, w.items);
  w.splits = want < 1 ? 1 : (want > w.tiles ? w.tiles : want);
  w.per_split = cdiv(w.tiles, w.splits);
  w.splits = cdiv(w.tiles, w.per_split);
  long long h = 0, ga = 0;
  w.stash_rows = 0;
  for (int l = 0; l < c.num_layers; ++l) {
    w.h_off[l] = h;
    h += static_cast<long long>(w.tiles) * pad16(c.ci[l]) * kTile;
    w.ga_off[l] = ga;
    ga += static_cast<long long>(w.tiles) * pad64(c.co[l]) * kTile;
    w.s_row[l] = w.stash_rows;
    if (l < c.num_sine) w.stash_rows += pad16(c.co[l]);
  }
  size_t off = 0;
  w.h = off;
  off = align256(off + h * 2);
  w.ga = off;
  off = align256(off + ga * 2);
  w.stash = off;
  off = align256(off + static_cast<size_t>(w.tiles) * w.stash_rows * kTile * 4);
  w.db = off;
  off = align256(off + static_cast<size_t>(w.tiles) * c.b_total * 4);
  w.s0 = off;
  off = align256(off + static_cast<size_t>(w.tiles) * c.co[0] * 4);
  w.slabs = off;
  off = align256(off + static_cast<size_t>(w.splits) * c.w_total * 4);
  w.sn = off;
  off = align256(off + static_cast<size_t>(n) * c.co[0] * 4);
  w.pre0 = off;
  off = align256(off + static_cast<size_t>(n) * c.co[0] * 4);
  w.total = off;
  return w;
}

// Bytes of K4's tile kernel's shared memory: K1's and a table of f32 for
// the sums over a tile's pixels (per warpgroup, 4 warps x 64 channels).
inline size_t bwd_smem_bytes(const Chain& c) { return smem_bytes(c, kWarpgroups * 4 * (kNChunk / 2) * 4); }

// The weight ring.  All threads wait on a tile; after its products, a block
// barrier, then thread 0 refills the stage with the tile kStages ahead.
// Thread 0 walks the stream with a cursor (segment, row chunk, column
// block), one step a tile.
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  const __nv_bfloat16* layout;
  const Chain* chain;
  bool bwd;
  int total;
  int stage_bytes;
  // thread 0's cursor: the next tile to load
  int issued, seg, n0, k0;
  Segment cur;

  __device__ void next_segment() {
    for (++seg; seg < num_segments(*chain, bwd); ++seg) {
      cur = segment(*chain, bwd, seg);
      if (segment_tiles(cur) > 0) return;
    }
  }
  __device__ void issue() {
    const int nb = min(kNChunk, cur.n_layout - n0);
    const int bytes = min(kKBlock, cur.k_layout - k0) * nb * 2;
    const long long off = cur.base + static_cast<long long>(n0) * cur.k_layout + static_cast<long long>(k0) * nb;
    bulk_load(stages + (issued % kStages) * stage_bytes, layout + off, bytes, full + issued % kStages);
    ++issued;
    k0 += kKBlock;
    if (k0 < cur.k_used) return;
    k0 = 0;
    n0 += kNChunk;
    if (n0 < cur.n_used) return;
    n0 = 0;
    next_segment();
  }
  __device__ const unsigned char* wait(int i) const {
    mbar_wait(full + i % kStages, (i / kStages) & 1);
    return stages + (i % kStages) * stage_bytes;
  }
  __device__ void release(int i) {  // after a block barrier
    if (threadIdx.x == 0 && i + kStages < total) issue();
  }
};

// The block's shared memory, carved.
struct Smem {
  uint64_t* bars;
  unsigned char* stages;
  unsigned char* buf[2];
  float* pre0;  // layer 0: W_pose pose + b
  float* wx;    // layer 0: the two position columns
  float* wy;
  unsigned char* extra;
};

__device__ inline Smem carve(unsigned char* smem, const Chain& c) {
  Smem s;
  s.bars = reinterpret_cast<uint64_t*>(smem);
  s.stages = smem + kBarBytes;
  s.buf[0] = s.stages + kStages * c.stage_bytes;
  s.buf[1] = s.buf[0] + (c.cbuf / 8) * kGroup;
  s.pre0 = reinterpret_cast<float*>(s.buf[1] + (c.cbuf / 8) * kGroup);
  s.wx = s.pre0 + c.cbuf;
  s.wy = s.wx + c.cbuf;
  s.extra = reinterpret_cast<unsigned char*>(s.wy + c.cbuf);
  return s;
}

__device__ inline Ring start_ring(const Smem& s, const Chain& c, const __nv_bfloat16* layout, bool bwd) {
  Ring r{s.stages, s.bars, layout, &c, bwd, stream_tiles(c, bwd), c.stage_bytes, 0, -1, 0, 0, Segment{}};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(s.bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    r.next_segment();
    for (int i = 0; i < kStages && i < r.total; ++i) r.issue();
  }
  return r;
}

// The byte offset of (channel o, pixel m) in an activation buffer.
__device__ __forceinline__ int act_off(int o, int m) { return (o >> 3) * kGroup + m * 16 + (o & 7) * 2; }

// This thread's warpgroup, and its index within it.
__device__ __forceinline__ int wg_index() { return threadIdx.x >> 7; }
__device__ __forceinline__ int wg_thread() { return threadIdx.x & 127; }

// The accumulator fragment: value k of this thread is pixel row(k), channel
// col(k) of its warpgroup's columns (sm90.cuh, wgmma).
__device__ __forceinline__ int frag_row(int k) {
  return 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((k >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int k) { return 8 * (k >> 2) + 2 * (threadIdx.x & 3) + (k & 1); }

// acc = A (the buffer, k_used channels) x B (the stream's next tiles): this
// warpgroup's half, H = nb / 2 rows from row wg_index() x H, of one N chunk
// of nb rows, one tile per K block.  Both warpgroups wait on every tile and
// meet at a block barrier after it, before thread 0 refills its stage.
template <int H>
__device__ __forceinline__ void gemm_chunk(float (&acc)[H / 2], const unsigned char* a_buf, int k_used, Ring& ring,
                                           int& tile) {
  constexpr int nb = 2 * H;
#pragma unroll
  for (int k = 0; k < H / 2; ++k) acc[k] = 0.0f;
  for (int k0 = 0; k0 < k_used; k0 += kKBlock) {
    const unsigned char* stage = ring.wait(tile);
    // k16 step s reads A 2 x kGroup bytes and B 2 x nb x 16 bytes further
    // on: descriptors advance in their address field (bytes / 16).  The
    // steps are unrolled, as wgmma wants its accumulators untouched between.
    const uint64_t da = smem_desc(a_buf + (k0 >> 3) * kGroup, kGroup, 128);
    const uint64_t db = smem_desc(stage + wg_index() * H * 16, nb * 16, 128);
    constexpr uint64_t kA = 2 * kGroup / 16, kB = 2 * nb;
    fence_regs(acc);
    wgmma_fence();
    switch (min(kKBlock, k_used - k0) / 16) {
      case 4:
        wgmma<H>(acc, da, db);
        wgmma<H>(acc, da + kA, db + kB);
        wgmma<H>(acc, da + 2 * kA, db + 2 * kB);
        wgmma<H>(acc, da + 3 * kA, db + 3 * kB);
        break;
      case 3:
        wgmma<H>(acc, da, db);
        wgmma<H>(acc, da + kA, db + kB);
        wgmma<H>(acc, da + 2 * kA, db + 2 * kB);
        break;
      case 2:
        wgmma<H>(acc, da, db);
        wgmma<H>(acc, da + kA, db + kB);
        break;
      default:
        wgmma<H>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();
    ring.release(tile);
    ++tile;
  }
}

template <int N>
struct Width {
  static constexpr int value = N;
};

// Calls f(Width<nb / 2>()) for a chunk of nb rows (a multiple of 16 up to
// 128): each warpgroup's half, compiled once per width.
template <typename F>
__device__ __forceinline__ void dispatch_half(int nb, F&& f) {
  switch (nb) {
    case 16: f(Width<8>()); break;
    case 32: f(Width<16>()); break;
    case 48: f(Width<24>()); break;
    case 64: f(Width<32>()); break;
    case 80: f(Width<40>()); break;
    case 96: f(Width<48>()); break;
    case 112: f(Width<56>()); break;
    default: f(Width<64>()); break;
  }
}

// The prev channels of tile (n, px0), rounded already (bf16), into an
// activation buffer: channels [0, pad16(cp)), zeros past cp and past hw.
__device__ inline void load_prev(unsigned char* buf, const __nv_bfloat16* __restrict__ prev, int cp, int n, int px0,
                                 int hw) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(prev);
#pragma unroll 4
  for (int i = threadIdx.x; i < (pad16(cp) / 8) * kTile; i += kThreads) {
    const int g = i / kTile;
    const int p = i % kTile;
    const int px = px0 + p;
    unsigned short v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * g + j;
      const unsigned short x = __ldg(src + (static_cast<size_t>(n) * cp + min(c, cp - 1)) * hw + min(px, hw - 1));
      v[j] = (c < cp && px < hw) ? x : 0;  // clamped loads, then a select: no load waits behind a branch
    }
    *reinterpret_cast<uint4*>(buf + g * kGroup + p * 16) =
        make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16), v[6] | (v[7] << 16));
  }
}

// Layer 0's folded vector pre0 = W_pose bf16(pose) + b, one per batch
// element ([n][co_0] f32), made once per call by fold_kernel
// (csrc/sine_chain.cu): a warp per output channel, the pose terms' exact
// products summed over the lanes in a fixed tree, then the bias.
cudaError_t launch_fold(const Chain& c, const __nv_bfloat16* w, const float* b, const float* pose, int n, float* pre0,
                        cudaStream_t stream);

// The tile's copy of batch element n's folded vector and of layer 0's two
// position columns.
__device__ inline void load_fold(const Smem& s, const Chain& c, const __nv_bfloat16* __restrict__ w,
                                 const float* __restrict__ pre0, int n) {
  for (int o = threadIdx.x; o < c.co[0]; o += kThreads) {
    const __nv_bfloat16* row = w + c.w_off[0] + static_cast<size_t>(o) * c.ci[0];
    s.pre0[o] = __ldg(pre0 + static_cast<size_t>(n) * c.co[0] + o);
    s.wx[o] = ldg_f32(row + c.cp);
    s.wy[o] = ldg_f32(row + c.cp + 1);
  }
}

// One layer's epilogue parameters, passed by value into a chunk's code so
// that they live in registers: layer 0 adds its position terms and folded
// vector, any other layer its bias.
struct Epi {
  const float* bias;  // the layer's bias (layers past 0)
  const float* pre0;  // shared memory (layer 0)
  const float* wx;
  const float* wy;
  float pos_x[2], pos_y[2];  // this thread's two pixel rows
  float omega;
  int co;
  bool first;
  bool sine;

  // The pre-activation of accumulator k, channel o.  Branch-free (o is
  // clamped; a channel past co is dropped by the caller), so that the
  // compiler can issue every load of a chunk's epilogue ahead of its sines:
  // behind a per-element branch each load waited its full latency.
  __device__ __forceinline__ float pre(float acc, int o, int k) const {
    o = min(o, co - 1);
    if (first) {
      const int h = (k >> 1) & 1;
      acc = __fmaf_rn(pos_x[h], wx[o], acc);
      acc = __fmaf_rn(pos_y[h], wy[o], acc);
      return __fadd_rn(acc, pre0[o]);
    }
    return __fadd_rn(acc, __ldg(bias + o));
  }
};

// Layer l's Epi for this thread's pixel rows of the tile at px0.
__device__ inline Epi make_epi(const Smem& s, const Chain& c, const float* __restrict__ b,
                               const __nv_bfloat16* __restrict__ pos, int px0, int hw, int l, float omega) {
  Epi e{b + c.b_off[l], s.pre0, s.wx, s.wy, {0.0f, 0.0f}, {0.0f, 0.0f}, omega, c.co[l], l == 0, l < c.num_sine};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int px = px0 + frag_row(2 * h);
    e.pos_x[h] = px < hw ? ldg_f32(pos + px) : 0.0f;
    e.pos_y[h] = px < hw ? ldg_f32(pos + hw + px) : 0.0f;
  }
  return e;
}

// Channels [0, channels) of an activation buffer to (N, C, HW) memory at
// batch element n, pixels px0 ...: one channel row of 64 pixels at a time.
__device__ inline void store_channels_first(const unsigned char* buf, __nv_bfloat16* __restrict__ dst, int channels,
                                            int n, int px0, int hw) {
  for (int i = threadIdx.x; i < channels * kTile; i += kThreads) {
    const int o = i / kTile;
    const int p = i % kTile;
    if (px0 + p < hw)
      dst[(static_cast<size_t>(n) * channels + o) * hw + px0 + p] =
          *reinterpret_cast<const __nv_bfloat16*>(buf + act_off(o, p));
  }
}

}  // namespace tc
}  // namespace tha4
