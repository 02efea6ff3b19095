// K6: out = conv3x3(SiLU(x * scale + shift)) + bias [+ skip | + skip_w @ skip],
// NHWC in memory, as an implicit GEMM.
//
// Replaces tha4_tpu/ops/pallas_conv.py:fused_affine_conv3_nchw (kernel body
// _kernel), and with it K7, tha4_tpu/ops/pallas_packed_conv.py:
// fused_packed_conv3, the same function on the TPU's lane-packed layout (a
// reshape of contiguous NHWC; it has no meaning on a GPU).  The wrapper is
// tha4_tpu_torch/ops/cuda_conv.py; it runs the second half of every ResBlock
// of the teacher's two U-Nets (GroupNorm -> FiLM(t) -> FiLM(pose) -> SiLU ->
// conv1, plus the skip), the first half of every "same" ResBlock and the
// U-Net's last conv.  scale and shift (N, C) f32 hold the GroupNorm and the
// FiLMs folded together (csrc/group_norm_fold.cu).  The weights come in a
// device layout made once per weight by the wrapper: per block of BN output
// channels, the 3x3 conv's input channels in chunks of CK = 16, each chunk's
// nine taps, then the 1x1 skip's chunks (tha4_affine_conv3_plan says BN).
//
// Arithmetic, the plain version's (fused_affine_conv3_plain): v = x * scale
// + shift (two roundings, no FMA) and the SiLU v / (1 + e^-v) in f32,
// rounded once to x's dtype; zero padding after the activation (SiLU(shift)
// != 0); products of those operands with f32 sums; bias, then the identity
// skip, added in f32; one rounding to x's dtype.  A 1x1 skip is more of the
// same GEMM: its Cs channels are extra K columns over the tile's own pixels,
// summed into the same accumulators.  Sums run in a fixed order, so two
// calls are bit-identical.
//
// What bounds it on an H100.  In bf16 the teacher's ResBlocks sit near the
// card's ridge: at (8, 512^2, 64 -> 64) with an identity skip a call moves
// 805 MB and does 77 G multiply-adds, 0.24 ms of bytes against 0.16 ms of
// tensor-core time; the wide deep levels (Cin up to 512, 32^2 and 16^2) are
// bound by operations.  Two costs beside those: at Cout = 64 each wgmma
// reads 4 KB of operands from shared memory for 64 x 64 x 16 multiply-adds,
// which keeps shared memory as busy as the tensor cores; and the activation
// (an exponential and a division per loaded halo element) takes CUDA-core
// time of the same order.  The design overlaps the activation with the
// products and keeps the halo small.
//
// bf16, on wgmma (affine_silu_conv3_wgmma_kernel):
//   * A block owns ROWS image rows x 64 columns and the whole Cout (BN = 32,
//     64, 128 or 256; wider layers take several Cout blocks), so each halo
//     element is activated once for every output channel.  Its warpgroups
//     (two; four at BN = 64) own ROWS / NWG rows each (8 rows a block up to
//     BN = 64, then 2); one row is one m64 of wgmma.m64nBNk16, with f32
//     accumulators in registers.
//   * Shared memory holds the halo as [row][k group][66 pixels][8 channels]:
//     every tap's A operand (64 pixels shifted by dx, rows shifted by dy) is
//     then a run of whole no-swizzle core matrices (8 pixels x 16 bytes), so
//     wgmma reads it through a descriptor at any shift.  The weights of a
//     chunk are one contiguous block of the device layout, [tap][k group]
//     [BN][8], and arrive by one bulk copy (the TMA engine) on an mbarrier.
//   * A three-stage pipeline over the Cin chunks: while the tensor cores run
//     chunk q's 9 x ROWS / 2 products asynchronously, the threads activate
//     chunk q + 1 in place (cp.async brought it raw) and chunk q + 2's halo
//     and weights are in flight.
// f32, on the CUDA cores (no TF32; affine_silu_conv3_fma_kernel): 16 x 16
//   pixels x BN (32 or 64) channels a block, 8 pixels x BN / 8 channels a
//   thread; double-buffered cp.async of the raw halo and the weights; the
//   halo activated and transposed to channel-major once per chunk, so a
//   thread reads 10 pixels of a row once for the three dx taps.
// Small grids (the U-Nets' 16^2-64^2 levels, and B = 1) split the chunks
// among several blocks, which write f32 partial sums to a workspace; a
// second kernel adds them in split order (deterministic, no atomics), then
// the bias and skip, and rounds.

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace tha4;

constexpr int SKIP_NONE = 0;
constexpr int SKIP_IDENTITY = 1;
constexpr int SKIP_CONV = 2;
constexpr int CK = 16;  // input channels per chunk, both dtypes

struct Args {
  const void* x;
  const float* scale;  // null: no pre-activation
  const float* shift;
  const void* wpack;   // the device layout of w9 and skip_w
  const float* bias;
  const void* skip;
  void* out;
  float* partial;  // splits x (N, H, W, Cout) f32 where the chunks are split
  int n, h, w, cin, cout, cs, skip_mode, tiles_x, splits, chunks_per_split;
};

__device__ __forceinline__ int conv_chunks(const Args& a) { return (a.cin + CK - 1) / CK; }
__device__ __forceinline__ int skip_chunks(const Args& a) {
  return a.skip_mode == SKIP_CONV ? (a.cs + CK - 1) / CK : 0;
}

// A block's share of the chunks: the 3x3 conv's Cin in CK-channel chunks,
// then (1x1 skip) the skip's Cs, taken in order, chunks_per_split at a time.
struct ChunkRange {
  int begin, end, conv_chunks;
};

__device__ __forceinline__ ChunkRange chunk_range(const Args& a, int split) {
  const int conv = conv_chunks(a);
  const int total = conv + skip_chunks(a);
  const int begin = split * a.chunks_per_split;
  return ChunkRange{begin, min(total, begin + a.chunks_per_split), conv};
}

// Chunk q's weights in the device layout, and their count: per Cout block
// of BN channels, (9 * conv_chunks + skip_chunks) x CK x BN elements.
template <typename T, int BN>
__device__ __forceinline__ const T* chunk_weights(const Args& a, int cblock, int q, int& elems) {
  const int conv = conv_chunks(a);
  const T* base = static_cast<const T*>(a.wpack) + static_cast<long long>(cblock) * (9 * conv + skip_chunks(a)) * CK * BN;
  if (q < conv) {
    elems = 9 * CK * BN;
    return base + static_cast<long long>(q) * 9 * CK * BN;
  }
  elems = CK * BN;
  return base + (static_cast<long long>(conv) * 9 + (q - conv)) * CK * BN;
}

// The activation is silu(__fadd_rn(__fmul_rn(x, scale), shift)) in f32: two
// roundings, as the plain version's multiply and add, with no contraction
// into an FMA; expf and an IEEE division, in both kernels.
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ bool in_image(const Args& a, int y, int x) {
  return y >= 0 && y < a.h && x >= 0 && x < a.w;
}

// Channels c .. c + 7 of a row that starts at ``row`` as f32; channels at or
// past ``limit`` read as 0.  One 16-byte load where the address allows it.
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c, int limit, float v[8]) {
  const __nv_bfloat16* src = row + c;
  if (c + 8 <= limit && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h2[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = c + k < limit ? tha4::ldg_f32<__nv_bfloat16>(src + k) : 0.0f;
  }
}

__device__ __forceinline__ void load4(const float* row, int c, int limit, float v[4]) {
  const float* src = row + c;
  if (c + 4 <= limit && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c + k < limit ? __ldg(src + k) : 0.0f;
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return raw;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float v[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// --- the epilogue, shared by both kernels ---

// The staged f32 sums of the tile, out_sm[pixel][channel] with row stride
// BN + 4 (pixel = row * TWD + column), plus bias (and the identity skip),
// rounded once and stored, eight channels a 16-byte vector where Cout
// allows it.
template <typename T, int BN, int TH, int TWD, int NT>
__device__ __forceinline__ void epilogue(const Args& a, const float* out_sm, int b, int ty0, int tx0, int n0) {
  constexpr int OS = BN + 4;
  if ((a.cout & 7) == 0) {  // eight channels an item: 16-byte loads and stores
    for (int idx = threadIdx.x; idx < TH * TWD * (BN / 8); idx += NT) {
      const int pix = idx / (BN / 8);
      const int c8 = (idx % (BN / 8)) * 8;
      const int y = ty0 + pix / TWD;
      const int x = tx0 + pix % TWD;
      const int co = n0 + c8;
      if (y >= a.h || x >= a.w || co >= a.cout) continue;
      const long long o = ((static_cast<long long>(b) * a.h + y) * a.w + x) * a.cout + co;
      const float4 s0 = *reinterpret_cast<const float4*>(out_sm + pix * OS + c8);
      const float4 s1 = *reinterpret_cast<const float4*>(out_sm + pix * OS + c8 + 4);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.bias + co));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.bias + co + 4));
      float v[8] = {__fadd_rn(s0.x, b0.x), __fadd_rn(s0.y, b0.y), __fadd_rn(s0.z, b0.z), __fadd_rn(s0.w, b0.w),
                    __fadd_rn(s1.x, b1.x), __fadd_rn(s1.y, b1.y), __fadd_rn(s1.z, b1.z), __fadd_rn(s1.w, b1.w)};
      T* dst = static_cast<T*>(a.out) + o;
      if constexpr (sizeof(T) == 2) {
        if (a.skip_mode == SKIP_IDENTITY) {
          float r[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(a.skip) + o)), r);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(v[k], r[k]);
        }
        *reinterpret_cast<uint4*>(dst) = pack8(v);
      } else {
        if (a.skip_mode == SKIP_IDENTITY) {
          const float4* sk = reinterpret_cast<const float4*>(static_cast<const T*>(a.skip) + o);
          const float4 r0 = __ldg(sk), r1 = __ldg(sk + 1);
          const float r[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(v[k], r[k]);
        }
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    return;
  }
  // Any other Cout: one channel at a time.
  for (int idx = threadIdx.x; idx < TH * TWD * BN; idx += NT) {
    const int pix = idx / BN;
    const int c = idx % BN;
    const int y = ty0 + pix / TWD;
    const int x = tx0 + pix % TWD;
    const int co = n0 + c;
    if (y >= a.h || x >= a.w || co >= a.cout) continue;
    const long long o = ((static_cast<long long>(b) * a.h + y) * a.w + x) * a.cout + co;
    float v = __fadd_rn(out_sm[pix * OS + c], __ldg(a.bias + co));
    if (a.skip_mode == SKIP_IDENTITY) v = __fadd_rn(v, tha4::ldg_f32<T>(static_cast<const T*>(a.skip) + o));
    static_cast<T*>(a.out)[o] = tha4::from_f32<T>(v);
  }
}

// A split block's staged f32 sums, raw, to its plane of the workspace.
template <int BN, int TH, int TWD, int NT>
__device__ void store_partial(const Args& a, const float* out_sm, int split, int b, int ty0, int tx0, int n0) {
  constexpr int OS = BN + 4;
  for (int idx = threadIdx.x; idx < TH * TWD * BN; idx += NT) {
    const int pix = idx / BN;
    const int c = idx % BN;
    const int y = ty0 + pix / TWD;
    const int x = tx0 + pix % TWD;
    const int co = n0 + c;
    if (y >= a.h || x >= a.w || co >= a.cout) continue;
    a.partial[(((static_cast<long long>(split) * a.n + b) * a.h + y) * a.w + x) * a.cout + co] = out_sm[pix * OS + c];
  }
}

// The split sums added in split order, then bias and skip, one rounding.
template <typename T>
__global__ void __launch_bounds__(256)
affine_silu_conv3_reduce_kernel(Args a) {
  const long long total = static_cast<long long>(a.n) * a.h * a.w * a.cout;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    float v = a.partial[i];
    for (int s = 1; s < a.splits; ++s) v = __fadd_rn(v, a.partial[s * total + i]);
    v = __fadd_rn(v, __ldg(a.bias + i % a.cout));
    if (a.skip_mode == SKIP_IDENTITY) v = __fadd_rn(v, tha4::ldg_f32<T>(static_cast<const T*>(a.skip) + i));
    static_cast<T*>(a.out)[i] = tha4::from_f32<T>(v);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int TW = 64;        // tile columns: one m64 per tile row
constexpr int HWID = TW + 2;  // halo columns
constexpr int ASTAGES = 3;    // halo stages: computed, being activated, in flight
constexpr int AHEAD = ASTAGES - 1;  // chunks whose halo is loaded ahead of the one computed
constexpr int WSTAGES = 2;    // weight stages
constexpr int BARS = 128;     // bytes before the stages: the weight stages' mbarriers

template <int ROWS>
__host__ __device__ constexpr int a_stage_bytes() {
  return (ROWS + 2) * 2 * HWID * 16;
}
template <int BN>
__host__ __device__ constexpr int w_stage_bytes() {
  return 9 * CK * BN * 2;
}
template <int BN, int ROWS>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int pipeline = ASTAGES * a_stage_bytes<ROWS>() + WSTAGES * w_stage_bytes<BN>();
  constexpr int staging = ROWS * TW * (BN + 4) * 4;
  return BARS + (pipeline > staging ? pipeline : staging);
}

// A 16-byte piece of the halo (8 channels of one pixel) in the stage layout
// [halo row][k group][halo column][8].
__device__ __forceinline__ int piece_offset(int hr, int g, int p) { return ((hr * 2 + g) * HWID + p) * 16; }

// Chunk q's A operand into ``stage``, raw.  conv: the 66-column halo of
// ROWS + 2 rows, channels c0 .. c0 + 15 (cp.async; zeros outside the image
// and past Cin); 1x1 skip: the skip's values at the tile's own pixels,
// which is all the centre tap reads.
template <int ROWS, int NT>
__device__ void load_a(const Args& a, unsigned char* stage, int b, int y0, int x0, int c0, bool skip_phase) {
  const int channels = skip_phase ? a.cs : a.cin;
  const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(skip_phase ? a.skip : a.x);
  const int pieces = skip_phase ? ROWS * TW * 2 : (ROWS + 2) * HWID * 2;
  const bool vec = (channels & 7) == 0;
  for (int i = threadIdx.x; i < pieces; i += NT) {
    const int g = i & 1;
    const int rest = i >> 1;
    const int hr = skip_phase ? rest / TW + 1 : rest / HWID;
    const int p = skip_phase ? rest % TW + 1 : rest % HWID;
    const int y = y0 - 1 + hr;
    const int x = x0 - 1 + p;
    const int c = c0 + 8 * g;
    unsigned char* dst = stage + piece_offset(hr, g, p);
    if (in_image(a, y, x) && c < channels) {
      const __nv_bfloat16* row = src + ((static_cast<long long>(b) * a.h + y) * a.w + x) * channels;
      if (vec) {
        cp_async16(dst, row + c);
      } else {
        float v[8];
        load8(row, c, channels, v);
        *reinterpret_cast<uint4*>(dst) = pack8(v);
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);  // zero padding, after the activation
    }
  }
}

// The activation of a conv chunk, in place, over the pieces this thread
// loaded (so its own cp.async wait makes them visible): each element once,
// rounded once to bf16.  Pieces outside the image and channels past Cin stay
// 0.  The block's thread count is even, so all of a thread's pieces lie in
// one k group, and it reads that group's eight scales and shifts once.
template <int ROWS, int NT>
__device__ void activate_a(const Args& a, unsigned char* stage, int b, int y0, int x0, int c0) {
  constexpr int pieces = (ROWS + 2) * HWID * 2;
  const int c = c0 + 8 * (threadIdx.x & 1);
  if (c >= a.cin) return;
  float sc[8], sh[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = b * a.cin + c + k;
    sc[k] = c + k < a.cin ? __ldg(a.scale + i) : 0.0f;
    sh[k] = c + k < a.cin ? __ldg(a.shift + i) : 0.0f;
  }
  for (int i = threadIdx.x; i < pieces; i += NT) {
    const int rest = i >> 1;
    const int hr = rest / HWID;
    const int p = rest % HWID;
    if (!in_image(a, y0 - 1 + hr, x0 - 1 + p)) continue;
    uint4* piece = reinterpret_cast<uint4*>(stage + piece_offset(hr, i & 1, p));
    float v[8];
    unpack8(*piece, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = c + k < a.cin ? silu(__fadd_rn(__fmul_rn(v[k], sc[k]), sh[k])) : 0.0f;
    *piece = pack8(v);
  }
}

// One chunk's products: for every tap and every row this warpgroup owns,
// D[row] += A(row shifted by the tap) x B(tap).
template <int BN, int RPW>
__device__ __forceinline__ void mma_chunk(float (&acc)[RPW][BN / 2], const unsigned char* astage,
                                          const unsigned char* wstage, int wgi, bool skip_phase) {
  const int taps = skip_phase ? 1 : 9;
  for (int t = 0; t < taps; ++t) {
    const int dy = skip_phase ? 1 : t / 3;
    const int dx = skip_phase ? 1 : t % 3;
    const uint64_t desc_b = smem_desc(wstage + t * 2 * BN * 16, BN * 16, 128);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = wgi * RPW + r;
      const uint64_t desc_a = smem_desc(astage + piece_offset(row + dy, 0, dx), HWID * 16, 128);
      wgmma<BN>(acc[r], desc_a, desc_b);
    }
  }
}

}  // namespace wg

template <int BN, int RPW, int NWG>
__global__ void __launch_bounds__(128 * NWG)
affine_silu_conv3_wgmma_kernel(Args a) {
  using namespace wg;
  constexpr int ROWS = NWG * RPW;
  constexpr int NT = 128 * NWG;
  constexpr int ASB = a_stage_bytes<ROWS>();
  constexpr int WSB = w_stage_bytes<BN>();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* abase = smem + BARS;
  unsigned char* wbase = abase + ASTAGES * ASB;
  const int y0 = (blockIdx.x / a.tiles_x) * ROWS;
  const int x0 = (blockIdx.x % a.tiles_x) * TW;
  const int cblock = blockIdx.y;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int wgi = threadIdx.x / 128;
  const ChunkRange range = chunk_range(a, split);
  const int nq = range.end - range.begin;

  auto load_w = [&](int i) {  // one thread: chunk range.begin + i into weight stage i % 2
    int elems;
    const __nv_bfloat16* src = chunk_weights<__nv_bfloat16, BN>(a, cblock, range.begin + i, elems);
    bulk_load(wbase + (i & 1) * WSB, src, elems * 2, bars + (i & 1));
  };
  auto load_chunk = [&](int i) {
    const int q = range.begin + i;
    const bool skip_phase = q >= range.conv_chunks;
    load_a<ROWS, NT>(a, abase + (i % ASTAGES) * ASB, b, y0, x0, (skip_phase ? q - range.conv_chunks : q) * CK, skip_phase);
  };
  auto activate_chunk = [&](int i) {
    const int q = range.begin + i;
    if (q < range.conv_chunks && a.scale != nullptr) activate_a<ROWS, NT>(a, abase + (i % ASTAGES) * ASB, b, y0, x0, q * CK);
  };

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[RPW][BN / 2];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[r][k] = 0.0f;

  // Prologue: chunks 0 .. AHEAD - 1 in flight, chunk 0 activated.
  for (int i = 0; i < AHEAD; ++i) {
    if (i < nq) {
      if (threadIdx.x == 0 && i < WSTAGES) load_w(i);
      load_chunk(i);
    }
    cp_async_commit();
  }
  cp_async_wait<AHEAD - 1>();
  activate_chunk(0);
  fence_proxy_async();
  __syncthreads();

  for (int i = 0; i < nq; ++i) {
    const bool skip_phase = range.begin + i >= range.conv_chunks;
    mbar_wait(bars + (i & 1), (i >> 1) & 1);
#pragma unroll
    for (int r = 0; r < RPW; ++r) fence_regs(acc[r]);
    wgmma_fence();
    mma_chunk<BN, RPW>(acc, abase + (i % ASTAGES) * ASB, wbase + (i & 1) * WSB, wgi, skip_phase);
    wgmma_commit();
    // While the tensor cores work: chunk i + AHEAD's halo into the stage
    // chunk i - 1 has left, and chunk i + 1 activated.
    if (i + AHEAD < nq) load_chunk(i + AHEAD);
    cp_async_commit();
    if (i + 1 < nq) {
      cp_async_wait<AHEAD - 1>();
      activate_chunk(i + 1);
      fence_proxy_async();
    }
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < RPW; ++r) fence_regs(acc[r]);
    __syncthreads();  // weight stage i % 2 and halo stage i % 3 are free
    if (threadIdx.x == 0 && i + 2 < nq) load_w(i + 2);
  }

  // Accumulator k of row r: pixel 16 * warp + lane / 4 (+ 8 for k & 2),
  // channel 8 * (k / 4) + 2 * (lane % 4) + (k & 1).
  float* out_sm = reinterpret_cast<float*>(abase);
  constexpr int OS = BN + 4;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int m = 16 * warp + lane / 4;
  const int n = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int pix = (wgi * RPW + r) * TW + m;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(out_sm + pix * OS + 8 * j + n) = make_float2(acc[r][4 * j], acc[r][4 * j + 1]);
      *reinterpret_cast<float2*>(out_sm + (pix + 8) * OS + 8 * j + n) = make_float2(acc[r][4 * j + 2], acc[r][4 * j + 3]);
    }
  }
  __syncthreads();
  if (a.splits > 1) {
    store_partial<BN, ROWS, TW, NT>(a, out_sm, split, b, y0, x0, cblock * BN);
  } else {
    epilogue<__nv_bfloat16, BN, ROWS, TW, NT>(a, out_sm, b, y0, x0, cblock * BN);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

namespace cc {

constexpr int THREADS = 256;
constexpr int TILE = 16;                // 16 x 16 output pixels
constexpr int HALO = TILE + 2;          // 18
constexpr int HALO_PIX = HALO * HALO;   // 324
constexpr int ROW = 20;                 // act row stride in floats
constexpr int PLANE = HALO * ROW + 4;   // act channel stride: 364, spreads the transposing writes over banks
constexpr int RAW_BYTES = HALO_PIX * CK * 4;
constexpr int ACT_BYTES = CK * PLANE * 4;

template <int BN>
__host__ __device__ constexpr int w_bytes() {
  return 9 * CK * BN * 4;
}
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int pipeline = 2 * RAW_BYTES + ACT_BYTES + 2 * w_bytes<BN>();
  constexpr int staging = TILE * TILE * (BN + 4) * 4;
  return pipeline > staging ? pipeline : staging;
}

// Chunk q's raw halo ([pixel][16 channels]: conv, the 18 x 18 halo; 1x1
// skip, the tile's own pixels at their halo positions) and weights
// ([tap][16][BN], contiguous in the device layout) into one buffer.
template <int BN>
__device__ void load_chunk(const Args& a, float* raw, float* wsm, int b, int y0, int x0, int cblock, int q,
                           int conv_chunks_) {
  const bool skip_phase = q >= conv_chunks_;
  const int c0 = (skip_phase ? q - conv_chunks_ : q) * CK;
  const int channels = skip_phase ? a.cs : a.cin;
  const float* src = static_cast<const float*>(skip_phase ? a.skip : a.x);
  const int pixels = skip_phase ? TILE * TILE : HALO_PIX;
  const bool vec = (channels & 3) == 0;
  for (int i = threadIdx.x; i < pixels * (CK / 4); i += THREADS) {
    const int p = i / (CK / 4);
    const int grp = i % (CK / 4);
    const int hy = skip_phase ? p / TILE + 1 : p / HALO;
    const int hx = skip_phase ? p % TILE + 1 : p % HALO;
    const int y = y0 - 1 + hy;
    const int x = x0 - 1 + hx;
    const int c = c0 + grp * 4;
    float* dst = raw + (hy * HALO + hx) * CK + grp * 4;
    if (in_image(a, y, x) && c < channels) {
      const float* row = src + ((static_cast<long long>(b) * a.h + y) * a.w + x) * channels;
      if (vec) {
        cp_async16(dst, row + c);
      } else {
        float v[4];
        load4(row, c, channels, v);
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  int elems;
  const float* wsrc = chunk_weights<float, BN>(a, cblock, q, elems);
  for (int i = threadIdx.x; i < elems / 4; i += THREADS) cp_async16(wsm + 4 * i, wsrc + 4 * i);
}

}  // namespace cc

template <int BN>
__global__ void __launch_bounds__(cc::THREADS)
affine_silu_conv3_fma_kernel(Args a) {
  using namespace cc;
  constexpr int CPT = BN / 8;  // output channels per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);                    // 2 x RAW_BYTES
  float* act = raw + 2 * RAW_BYTES / 4;                           // ACT_BYTES
  float* wsm = act + ACT_BYTES / 4;                               // 2 x w_bytes
  const int y0 = (blockIdx.x / a.tiles_x) * TILE;
  const int x0 = (blockIdx.x % a.tiles_x) * TILE;
  const int cblock = blockIdx.y;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  // Thread (warp w, lane l): channels cg * CPT .. of pixels px0 .. px0 + 7
  // of tile row py.  A warp's four rows fall on distinct banks.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;
  const int py = (lane >> 3) + 4 * (warp & 3);
  const int px0 = 8 * (warp >> 2);

  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;

  const ChunkRange range = chunk_range(a, split);
  const int nq = range.end - range.begin;
  if (nq > 0) load_chunk<BN>(a, raw, wsm, b, y0, x0, cblock, range.begin, range.conv_chunks);
  cp_async_commit();
  for (int i = 0; i < nq; ++i) {
    const int q = range.begin + i;
    const bool skip_phase = q >= range.conv_chunks;
    const float* raw_i = raw + (i & 1) * (RAW_BYTES / 4);
    const float* w_i = wsm + (i & 1) * (w_bytes<BN>() / 4);
    if (i + 1 < nq) {
      load_chunk<BN>(a, raw + ((i + 1) & 1) * (RAW_BYTES / 4), wsm + ((i + 1) & 1) * (w_bytes<BN>() / 4), b, y0, x0,
                     cblock, q + 1, range.conv_chunks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // Activate (conv chunks) and transpose to act[channel][row][column].
    // THREADS is a multiple of CK, so a thread always sees one channel.
    const int ci = threadIdx.x % CK;
    const int c = (skip_phase ? q - range.conv_chunks : q) * CK + ci;
    const bool act_on = !skip_phase && a.scale != nullptr && c < a.cin;
    const float sc = act_on ? __ldg(a.scale + b * a.cin + c) : 0.0f;
    const float sh = act_on ? __ldg(a.shift + b * a.cin + c) : 0.0f;
    for (int e = threadIdx.x; e < HALO_PIX * CK; e += THREADS) {
      const int p = e / CK;
      const int hy = p / HALO;
      const int hx = p % HALO;
      float v = raw_i[e];
      if (act_on && in_image(a, y0 - 1 + hy, x0 - 1 + hx)) v = silu(__fadd_rn(__fmul_rn(v, sc), sh));
      act[ci * PLANE + hy * ROW + hx] = v;
    }
    __syncthreads();
    if (skip_phase) {
#pragma unroll 4
      for (int ci = 0; ci < CK; ++ci) {
        const float* arow = act + ci * PLANE + (py + 1) * ROW + px0 + 1;
        float av[8], wv[CPT];
#pragma unroll
        for (int k = 0; k < 8; ++k) av[k] = arow[k];
#pragma unroll
        for (int j = 0; j < CPT; j += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(w_i + ci * BN + cg * CPT + j);
          wv[j] = w4.x; wv[j + 1] = w4.y; wv[j + 2] = w4.z; wv[j + 3] = w4.w;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[k][j] = fmaf(av[k], wv[j], acc[k][j]);
      }
    } else {
      for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* arow = act + ci * PLANE + (py + dy) * ROW + px0;
          float av[10];
#pragma unroll
          for (int k = 0; k < 10; ++k) av[k] = arow[k];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float wv[CPT];
#pragma unroll
            for (int j = 0; j < CPT; j += 4) {
              const float4 w4 = *reinterpret_cast<const float4*>(w_i + ((dy * 3 + dx) * CK + ci) * BN + cg * CPT + j);
              wv[j] = w4.x; wv[j + 1] = w4.y; wv[j + 2] = w4.z; wv[j + 3] = w4.w;
            }
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
              for (int j = 0; j < CPT; ++j) acc[k][j] = fmaf(av[k + dx], wv[j], acc[k][j]);
          }
        }
      }
    }
    __syncthreads();  // raw, weights and act of this chunk free for the next loads
  }

  float* out_sm = reinterpret_cast<float*>(smem);
  constexpr int OS = BN + 4;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < CPT; j += 4)
      *reinterpret_cast<float4*>(out_sm + (py * TILE + px0 + k) * OS + cg * CPT + j) =
          make_float4(acc[k][j], acc[k][j + 1], acc[k][j + 2], acc[k][j + 3]);
  __syncthreads();
  if (a.splits > 1) {
    store_partial<BN, TILE, TILE, THREADS>(a, out_sm, split, b, y0, x0, cblock * BN);
  } else {
    epilogue<float, BN, TILE, TILE, THREADS>(a, out_sm, b, y0, x0, cblock * BN);
  }
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

// Above 48 KB a block's shared memory must be asked for: once per kernel.
int launch(void (*kernel)(Args), int threads, int smem, bool& configured, const Args& a, dim3 grid, cudaStream_t s) {
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// Tiling and split of one call.  bf16: BN the smallest of 32, 64, 128, 256
// that holds Cout (wider layers take Cout blocks of 256), ROWS 8, 8, 2, 2
// image rows x 64 columns a block; f32: BN 32 or 64, 16 x 16 pixels.  The
// chunks split among blocks until the grid holds two blocks per SM, each
// split taking the same number of chunks.
struct Plan {
  int bn, rows, tile_w, tiles_x, tiles, cblocks, splits, chunks_per_split, wpack_elems;
};

bool valid(int n, int h, int w, int cin, int cout, int cs, int skip_mode) {
  return n >= 1 && h >= 1 && w >= 1 && cin >= 1 && cout >= 1 && skip_mode >= SKIP_NONE && skip_mode <= SKIP_CONV &&
         (skip_mode != SKIP_CONV || cs >= 1) && (skip_mode != SKIP_IDENTITY || cs == cout);
}

Plan make_plan(int n, int h, int w, int cin, int cout, int cs, int skip_mode, int is_bf16) {
  Plan p;
  if (is_bf16) {
    p.bn = cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
    p.rows = p.bn <= 64 ? 8 : 2;
    p.tile_w = wg::TW;
  } else {
    p.bn = cout <= 32 ? 32 : 64;
    p.rows = cc::TILE;
    p.tile_w = cc::TILE;
  }
  p.tiles_x = (w + p.tile_w - 1) / p.tile_w;
  p.tiles = p.tiles_x * ((h + p.rows - 1) / p.rows);
  p.cblocks = (cout + p.bn - 1) / p.bn;
  const int conv = (cin + CK - 1) / CK;
  const int skip = skip_mode == SKIP_CONV ? (cs + CK - 1) / CK : 0;
  const int chunks = conv + skip;
  p.wpack_elems = p.cblocks * (9 * conv + skip) * CK * p.bn;
  const long long blocks = static_cast<long long>(p.tiles) * p.cblocks * n;
  const long long target = 2LL * sm_count();
  long long splits = blocks < target ? (target + blocks - 1) / blocks : 1;
  splits = splits < chunks ? splits : chunks;
  p.chunks_per_split = static_cast<int>((chunks + splits - 1) / splits);
  p.splits = (chunks + p.chunks_per_split - 1) / p.chunks_per_split;
  return p;
}

}  // namespace

// A call's plan, for the wrapper to cache per size: plan[0] the number of
// splits (above 1 the call needs a workspace of splits x N x H x W x Cout
// floats), plan[1] BN, plan[2] CK, plan[3] the elements of the weights'
// device layout.  Returns a cudaError_t (invalid value for sizes the kernel
// refuses).
extern "C" int tha4_affine_conv3_plan(int n, int h, int w, int cin, int cout, int cs, int skip_mode, int is_bf16,
                                      int* plan) {
  if (!valid(n, h, w, cin, cout, cs, skip_mode) || plan == nullptr) return cudaErrorInvalidValue;
  const Plan p = make_plan(n, h, w, cin, cout, cs, skip_mode, is_bf16);
  plan[0] = p.splits;
  plan[1] = p.bn;
  plan[2] = CK;
  plan[3] = p.wpack_elems;
  return 0;
}

// x (N, H, W, Cin), skip (N, H, W, Cs) and out (N, H, W, Cout) NHWC in the
// compute dtype (f32 or bf16); scale, shift (N, Cin) f32 or both null;
// wpack the weights in the device layout of the plan's BN, in the compute
// dtype; bias (Cout,) f32; workspace f32 as the plan's splits ask, else
// null.  skip_mode: 0 none, 1 identity (Cs = Cout), 2 1x1 conv.  Every
// pointer 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int tha4_affine_conv3_forward(const void* x, const void* scale, const void* shift, const void* wpack,
                                         const void* bias, const void* skip, void* out, int n, int h, int w, int cin,
                                         int cout, int cs, int skip_mode, int is_bf16, void* workspace, void* stream) {
  if (!valid(n, h, w, cin, cout, cs, skip_mode) || (skip_mode != SKIP_NONE && skip == nullptr) ||
      ((scale == nullptr) != (shift == nullptr)))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(n, h, w, cin, cout, cs, skip_mode, is_bf16);
  if ((p.splits > 1 && workspace == nullptr) || static_cast<long long>(n) * p.splits > 65535)
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(scale), static_cast<const float*>(shift), wpack,
               static_cast<const float*>(bias), skip, out, static_cast<float*>(workspace),
               n, h, w, cin, cout, cs, skip_mode, p.tiles_x, p.splits, p.chunks_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.tiles, p.cblocks, n * p.splits);
  static bool configured[6] = {false, false, false, false, false, false};
  int status;
  if (is_bf16) {
    switch (p.bn) {
      case 32:
        status = launch(affine_silu_conv3_wgmma_kernel<32, 4, 2>, 256, wg::smem_bytes<32, 8>(), configured[0], a, grid, s);
        break;
      case 64:
        status = launch(affine_silu_conv3_wgmma_kernel<64, 2, 4>, 512, wg::smem_bytes<64, 8>(), configured[1], a, grid, s);
        break;
      case 128:
        status = launch(affine_silu_conv3_wgmma_kernel<128, 1, 2>, 256, wg::smem_bytes<128, 2>(), configured[2], a, grid, s);
        break;
      default:
        status = launch(affine_silu_conv3_wgmma_kernel<256, 1, 2>, 256, wg::smem_bytes<256, 2>(), configured[3], a, grid, s);
    }
  } else {
    status = p.bn == 32 ? launch(affine_silu_conv3_fma_kernel<32>, cc::THREADS, cc::smem_bytes<32>(), configured[4], a, grid, s)
                        : launch(affine_silu_conv3_fma_kernel<64>, cc::THREADS, cc::smem_bytes<64>(), configured[5], a, grid, s);
  }
  if (status != 0 || p.splits == 1) return status;
  const long long total = static_cast<long long>(n) * h * w * cout;
  const long long blocks = (total + 255) / 256;
  const unsigned reduce_blocks = static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
  if (is_bf16) {
    affine_silu_conv3_reduce_kernel<__nv_bfloat16><<<reduce_blocks, 256, 0, s>>>(a);
  } else {
    affine_silu_conv3_reduce_kernel<float><<<reduce_blocks, 256, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
