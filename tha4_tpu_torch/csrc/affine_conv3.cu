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
// FiLMs folded together; the 3x3 weight comes as w9 (Cout, 9 * Cin), k
// ordered (dy, dx, ci), which is the "col" B operand of mma.sync as it is.
//
// Arithmetic, the plain version's (fused_affine_conv3_plain): v = x * scale
// + shift and the SiLU in f32, rounded once to x's dtype; zero padding
// after the activation (SiLU(shift) != 0); products of those operands with
// f32 sums; bias, then the identity skip, added in f32; one rounding to x's
// dtype.  A 1x1 skip is more of the same GEMM: its Cs channels are extra K
// columns over the tile's own pixels, summed into the same accumulators.
//
// What bounds it on an H100.  In bf16 the teacher's ResBlocks sit near the
// card's ridge: at (8, 512^2, 64 -> 64) with an identity skip a call moves
// 805 MB and does 77 G multiply-adds, 0.24 ms of bytes against 0.16 ms of
// tensor-core time; the wide deep levels (Cin up to 512, 32^2 and 16^2) are
// bound by operations.  The design answers both: the activation is applied
// once per loaded element as the halo goes to shared memory (never per tap,
// never through device memory), and the products run on the tensor cores.
//   * A block owns 8 x 16 output pixels and 32 or 64 output channels, and
//     walks Cin in chunks of 32 (bf16) or 16 (f32) channels.
//   * Per chunk it loads the 10 x 18 halo (activated, zeroed outside the
//     image) and the chunk's (9 * chunk) x BN weight slice into shared
//     memory, padded so that every ldmatrix row read is bank-conflict free.
//   * bf16: warp w computes tile row w (16 pixels = one m16 tile) against
//     all BN channels with mma.sync.m16n8k16 (bf16 operands through
//     ldmatrix, f32 accumulators), nine taps x two k16 steps per chunk.
//   * f32: CUDA-core FMAs (no TF32, no tensor cores), each thread 4 pixels
//     x BN / 8 channels.
//   * The epilogue stages the f32 sums through shared memory so that bias,
//     skip and the store run over whole 8- or 16-byte channel vectors.
//   * Where the grid would not fill the card (the U-Nets' 16^2-64^2 levels,
//     whose few tiles carry Cin up to 512), the chunks are split among
//     several blocks, which write f32 partial sums to a workspace; a second
//     kernel adds them in split order (deterministic, no atomics), then the
//     bias and skip, and rounds.
// Not yet done (a later PR's work): wgmma and TMA, a multi-stage cp.async
// pipeline (each chunk is loaded, then computed, with two barriers), reuse
// of one activated halo across the Cout blocks of a wide layer.

#include "common.cuh"

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 16;
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int HALO_PIX = HALO_H * HALO_W;
constexpr int TILE_PIX = TILE_H * TILE_W;
constexpr int THREADS = 256;  // 8 warps: one tile row each in the bf16 kernel

constexpr int SKIP_NONE = 0;
constexpr int SKIP_IDENTITY = 1;
constexpr int SKIP_CONV = 2;

struct Args {
  const void* x;
  const float* scale;  // null: no pre-activation
  const float* shift;
  const void* w9;
  const float* bias;
  const void* skip;
  const void* skip_w;
  void* out;
  float* partial;  // splits x (N, H, W, Cout) f32 where the chunks are split
  int n, h, w, cin, cout, cs, skip_mode, tiles_x, splits, chunks_per_split;
};

// A block's share of the chunks: the 3x3 conv's Cin in CK-channel chunks,
// then (1x1 skip) the skip's Cs, taken in order, chunks_per_split at a time.
struct ChunkRange {
  int begin, end, conv_chunks;
};

template <int CK>
__device__ __forceinline__ ChunkRange chunk_range(const Args& a, int split) {
  const int conv = (a.cin + CK - 1) / CK;
  const int total = conv + (a.skip_mode == SKIP_CONV ? (a.cs + CK - 1) / CK : 0);
  const int begin = split * a.chunks_per_split;
  return ChunkRange{begin, min(total, begin + a.chunks_per_split), conv};
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// x * scale + shift, SiLU, in f32: two roundings, as the plain version's
// multiply and add, with no contraction into an FMA.
__device__ __forceinline__ float activate(float v, const Args& a, int b, int c) {
  if (a.scale == nullptr) return v;
  const int i = b * a.cin + c;
  return silu(__fadd_rn(__fmul_rn(v, __ldg(a.scale + i)), __ldg(a.shift + i)));
}

__device__ __forceinline__ bool in_image(const Args& a, int y, int x) {
  return y >= 0 && y < a.h && x >= 0 && x < a.w;
}

// Channels c .. c + 7 of a row that starts at ``row`` (channel 0 of one
// pixel, or of one output channel's weights) as f32; channels at or past
// ``limit`` read as 0.  One 16-byte load where the address allows it.
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D += A (16 x 16, row) * B (16 x 8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The staged f32 sums of the tile, out_sm[pixel][channel] with row stride
// BN + 4, plus bias (and the identity skip), rounded once and stored as
// whole channel vectors.
template <typename T, int BN>
__device__ __forceinline__ void epilogue(const Args& a, const float* out_sm, int b, int ty0, int tx0, int n0) {
  constexpr int OS = BN + 4;
  const bool vec = (a.cout & 3) == 0;
  for (int idx = threadIdx.x; idx < TILE_PIX * (BN / 4); idx += THREADS) {
    const int pix = idx / (BN / 4);
    const int c4 = (idx % (BN / 4)) * 4;
    const int y = ty0 + pix / TILE_W;
    const int x = tx0 + pix % TILE_W;
    const int co = n0 + c4;
    if (y >= a.h || x >= a.w || co >= a.cout) continue;
    const long long o = ((static_cast<long long>(b) * a.h + y) * a.w + x) * a.cout + co;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = co + k < a.cout ? __fadd_rn(out_sm[pix * OS + c4 + k], __ldg(a.bias + co + k)) : 0.0f;
    if (a.skip_mode == SKIP_IDENTITY) {
      const T* s = static_cast<const T*>(a.skip) + o;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (co + k < a.cout) v[k] = __fadd_rn(v[k], tha4::ldg_f32<T>(s + k));
    }
    T* dst = static_cast<T*>(a.out) + o;
    if (vec) {
      if constexpr (sizeof(T) == 2) {
        uint2 raw;
        *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
        *reinterpret_cast<uint2*>(dst) = raw;
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (co + k < a.cout) dst[k] = tha4::from_f32<T>(v[k]);
    }
  }
}

// A split block's staged f32 sums, raw, to its plane of the workspace.
template <int BN>
__device__ void store_partial(const Args& a, const float* out_sm, int split, int b, int ty0, int tx0, int n0) {
  constexpr int OS = BN + 4;
  for (int idx = threadIdx.x; idx < TILE_PIX * BN; idx += THREADS) {
    const int pix = idx / BN;
    const int c = idx % BN;
    const int y = ty0 + pix / TILE_W;
    const int x = tx0 + pix % TILE_W;
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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int CK16 = 32;             // input channels per chunk
constexpr int APIX16 = CK16 + 8;     // halo pixel stride in elements: 80 B
constexpr int KROW16 = 9 * CK16 + 8; // weight row stride in elements: 592 B

template <int BN>
constexpr int smem_bytes_bf16() {
  return (HALO_PIX * APIX16 + BN * KROW16) * 2;
}

// The chunk's operands into shared memory.  conv: the activated 10 x 18
// halo of channels c0 .. c0 + 31 and w9's nine taps for them; 1x1 skip: the
// tile's own skip pixels at the halo's interior positions and skip_w's
// columns, as tap 0.
template <int BN>
__device__ void stage_bf16(const Args& a, __nv_bfloat16* halo, __nv_bfloat16* wsm, int b, int ty0, int tx0,
                           int n0, int c0, bool skip_phase) {
  const int channels = skip_phase ? a.cs : a.cin;
  const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(skip_phase ? a.skip : a.x);
  const int pixels = skip_phase ? TILE_PIX : HALO_PIX;
  for (int idx = threadIdx.x; idx < pixels * (CK16 / 8); idx += THREADS) {
    const int p = idx / (CK16 / 8);
    const int grp = idx % (CK16 / 8);
    const int hy = skip_phase ? p / TILE_W + 1 : p / HALO_W;
    const int hx = skip_phase ? p % TILE_W + 1 : p % HALO_W;
    const int y = ty0 - 1 + hy;
    const int x = tx0 - 1 + hx;
    const int c = c0 + grp * 8;
    float v[8];
    if (in_image(a, y, x)) {
      load8(src + ((static_cast<long long>(b) * a.h + y) * a.w + x) * channels, c, channels, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // Channels past the input's are 0 after the activation too.
        v[k] = c + k < channels ? (skip_phase ? v[k] : activate(v[k], a, b, c + k)) : 0.0f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.0f;  // zero padding, after the activation
    }
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(halo + (hy * HALO_W + hx) * APIX16 + grp * 8) = raw;
  }
  const int taps = skip_phase ? 1 : 9;
  const __nv_bfloat16* wsrc = static_cast<const __nv_bfloat16*>(skip_phase ? a.skip_w : a.w9);
  const int row = taps * channels;  // elements per output channel in global memory
  for (int idx = threadIdx.x; idx < BN * taps * (CK16 / 8); idx += THREADS) {
    const int nl = idx / (taps * (CK16 / 8));
    const int rem = idx % (taps * (CK16 / 8));
    const int t = rem / (CK16 / 8);
    const int grp = rem % (CK16 / 8);
    const int co = n0 + nl;
    const int c = c0 + grp * 8;
    float v[8];
    if (co < a.cout) {
      load8(wsrc + static_cast<long long>(co) * row + t * channels, c, channels, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.0f;
    }
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(wsm + nl * KROW16 + t * CK16 + grp * 8) = raw;
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
affine_silu_conv3_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = halo + HALO_PIX * APIX16;
  const int ty0 = (blockIdx.x / a.tiles_x) * TILE_H;
  const int tx0 = (blockIdx.x % a.tiles_x) * TILE_W;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;

  // ldmatrix row addresses: A rows are the warp's 16 pixels (lanes 0-15 at
  // k 0-7, lanes 16-31 at k 8-15); B rows are output channels, two n8 tiles
  // per x4 load (lanes 0-7 / 8-15: tile 0 at k 0-7 / 8-15; 16-31: tile 1).
  const int a_px = lane & 15;
  const int a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;

  const ChunkRange range = chunk_range<CK16>(a, split);
  for (int q = range.begin; q < range.end; ++q) {
    const bool skip_phase = q >= range.conv_chunks;
    const int c0 = (skip_phase ? q - range.conv_chunks : q) * CK16;
    const int taps = skip_phase ? 1 : 9;
    stage_bf16<BN>(a, halo, wsm, b, ty0, tx0, n0, c0, skip_phase);
    __syncthreads();
    for (int t = 0; t < taps; ++t) {
      const int dy = skip_phase ? 1 : t / 3;
      const int dx = skip_phase ? 1 : t % 3;
#pragma unroll
      for (int ks = 0; ks < CK16 / 16; ++ks) {
        unsigned af[4];
        ldmatrix_x4(af, smem_addr(halo + ((warp + dy) * HALO_W + a_px + dx) * APIX16 + ks * 16 + a_k));
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          unsigned bf[4];
          ldmatrix_x4(bf, smem_addr(wsm + (j * 16 + b_n) * KROW16 + t * CK16 + ks * 16 + b_k));
          mma_bf16(acc[2 * j], af, bf[0], bf[1]);
          mma_bf16(acc[2 * j + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // Accumulator (j, k): pixel (lane >> 2) + 8 * (k >> 1) of the warp's row,
  // channel j * 8 + 2 * (lane & 3) + (k & 1).
  float* out_sm = reinterpret_cast<float*>(smem);
  constexpr int OS = BN + 4;
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(out_sm + (warp * TILE_W + g) * OS + j * 8 + 2 * q) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out_sm + (warp * TILE_W + g + 8) * OS + j * 8 + 2 * q) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  if (a.splits > 1) {
    store_partial<BN>(a, out_sm, split, b, ty0, tx0, n0);
  } else {
    epilogue<__nv_bfloat16, BN>(a, out_sm, b, ty0, tx0, n0);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int CK32 = 16;          // input channels per chunk
constexpr int HP32 = CK32 + 1;    // halo pixel stride in floats (conflict-free pixel reads)

template <int BN>
constexpr int smem_bytes_f32() {
  return (HALO_PIX * HP32 + 9 * CK32 * (BN + 4)) * 4;
}

template <int BN>
__device__ void stage_f32(const Args& a, float* halo, float* wsm, int b, int ty0, int tx0, int n0, int c0,
                          bool skip_phase) {
  constexpr int WROW = BN + 4;
  const int channels = skip_phase ? a.cs : a.cin;
  const float* src = static_cast<const float*>(skip_phase ? a.skip : a.x);
  const int pixels = skip_phase ? TILE_PIX : HALO_PIX;
  for (int idx = threadIdx.x; idx < pixels * (CK32 / 4); idx += THREADS) {
    const int p = idx / (CK32 / 4);
    const int grp = idx % (CK32 / 4);
    const int hy = skip_phase ? p / TILE_W + 1 : p / HALO_W;
    const int hx = skip_phase ? p % TILE_W + 1 : p % HALO_W;
    const int y = ty0 - 1 + hy;
    const int x = tx0 - 1 + hx;
    const int c = c0 + grp * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (in_image(a, y, x)) {
      load4(src + ((static_cast<long long>(b) * a.h + y) * a.w + x) * channels, c, channels, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = c + k < channels ? (skip_phase ? v[k] : activate(v[k], a, b, c + k)) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) halo[(hy * HALO_W + hx) * HP32 + grp * 4 + k] = v[k];
  }
  // wsm[t][ci][n]: k-major, output channels contiguous; global reads run
  // along ci.
  const int taps = skip_phase ? 1 : 9;
  const float* wsrc = static_cast<const float*>(skip_phase ? a.skip_w : a.w9);
  for (int idx = threadIdx.x; idx < BN * taps * CK32; idx += THREADS) {
    const int ci = idx % CK32;
    const int t = (idx / CK32) % taps;
    const int nl = idx / (CK32 * taps);
    const int co = n0 + nl;
    const int c = c0 + ci;
    wsm[(t * CK32 + ci) * WROW + nl] =
        co < a.cout && c < channels ? __ldg(wsrc + static_cast<long long>(co) * taps * channels + t * channels + c) : 0.0f;
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
affine_silu_conv3_fma_kernel(Args a) {
  constexpr int CPT = BN / 8;  // output channels per thread
  constexpr int WROW = BN + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  float* wsm = halo + HALO_PIX * HP32;
  const int ty0 = (blockIdx.x / a.tiles_x) * TILE_H;
  const int tx0 = (blockIdx.x % a.tiles_x) * TILE_W;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int cg = threadIdx.x & 7;   // channels cg * CPT .. + CPT - 1
  const int pg = threadIdx.x >> 3;  // pixels px0 .. px0 + 3 of row py
  const int py = pg >> 2;
  const int px0 = (pg & 3) * 4;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;

  const ChunkRange range = chunk_range<CK32>(a, split);
  for (int q = range.begin; q < range.end; ++q) {
    const bool skip_phase = q >= range.conv_chunks;
    const int c0 = (skip_phase ? q - range.conv_chunks : q) * CK32;
    const int taps = skip_phase ? 1 : 9;
    stage_f32<BN>(a, halo, wsm, b, ty0, tx0, n0, c0, skip_phase);
    __syncthreads();
    for (int t = 0; t < taps; ++t) {
      const int dy = skip_phase ? 1 : t / 3;
      const int dx = skip_phase ? 1 : t % 3;
      const float* hrow = halo + ((py + dy) * HALO_W + px0 + dx) * HP32;
#pragma unroll 4
      for (int ci = 0; ci < CK32; ++ci) {
        float av[4], wv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = hrow[i * HP32 + ci];
#pragma unroll
        for (int j = 0; j < CPT; j += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wsm + (t * CK32 + ci) * WROW + cg * CPT + j);
          wv[j] = w4.x; wv[j + 1] = w4.y; wv[j + 2] = w4.z; wv[j + 3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out_sm = reinterpret_cast<float*>(smem);
  constexpr int OS = BN + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; j += 4)
      *reinterpret_cast<float4*>(out_sm + (py * TILE_W + px0 + i) * OS + cg * CPT + j) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  __syncthreads();
  if (a.splits > 1) {
    store_partial<BN>(a, out_sm, split, b, ty0, tx0, n0);
  } else {
    epilogue<float, BN>(a, out_sm, b, ty0, tx0, n0);
  }
}

// Above 48 KB a block's shared memory must be asked for: once per kernel.
int launch(void (*kernel)(Args), int smem, bool& configured, const Args& a, dim3 grid, cudaStream_t s) {
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<grid, THREADS, smem, s>>>(a);
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

// Tiling and split of one call: BN 32 for Cout <= 32, else 64; the chunks
// split among blocks until the grid holds two blocks per SM, each split
// taking the same number of chunks.
struct Plan {
  int bn, tiles_x, tiles, splits, chunks_per_split;
};

bool valid(int n, int h, int w, int cin, int cout, int cs, int skip_mode) {
  return n >= 1 && h >= 1 && w >= 1 && cin >= 1 && cout >= 1 && skip_mode >= SKIP_NONE && skip_mode <= SKIP_CONV &&
         (skip_mode != SKIP_CONV || cs >= 1) && (skip_mode != SKIP_IDENTITY || cs == cout);
}

Plan make_plan(int n, int h, int w, int cin, int cout, int cs, int skip_mode, int is_bf16) {
  Plan p;
  p.bn = cout <= 32 ? 32 : 64;
  p.tiles_x = (w + TILE_W - 1) / TILE_W;
  p.tiles = p.tiles_x * ((h + TILE_H - 1) / TILE_H);
  const int ck = is_bf16 ? CK16 : CK32;
  const int chunks = (cin + ck - 1) / ck + (skip_mode == SKIP_CONV ? (cs + ck - 1) / ck : 0);
  const long long blocks = static_cast<long long>(p.tiles) * ((cout + p.bn - 1) / p.bn) * n;
  const long long target = 2LL * sm_count();
  long long splits = blocks < target ? (target + blocks - 1) / blocks : 1;
  splits = splits < chunks ? splits : chunks;
  p.chunks_per_split = static_cast<int>((chunks + splits - 1) / splits);
  p.splits = (chunks + p.chunks_per_split - 1) / p.chunks_per_split;
  return p;
}

}  // namespace

// The number of splits a call with these sizes takes (0 for sizes the
// kernel refuses); above 1 it needs a workspace of splits x N x H x W x Cout
// floats.
extern "C" int tha4_affine_conv3_splits(int n, int h, int w, int cin, int cout, int cs, int skip_mode, int is_bf16) {
  if (!valid(n, h, w, cin, cout, cs, skip_mode)) return 0;
  return make_plan(n, h, w, cin, cout, cs, skip_mode, is_bf16).splits;
}

// x (N, H, W, Cin), skip (N, H, W, Cs) and out (N, H, W, Cout) NHWC in the
// compute dtype (f32 or bf16); scale, shift (N, Cin) f32 or both null; w9
// (Cout, 9 * Cin) and skip_w (Cout, Cs) in the compute dtype; bias (Cout,)
// f32; workspace f32 as tha4_affine_conv3_splits asks, else null.
// skip_mode: 0 none, 1 identity (Cs = Cout), 2 1x1 conv.  Every pointer
// 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int tha4_affine_conv3_forward(const void* x, const void* scale, const void* shift, const void* w9,
                                         const void* bias, const void* skip, const void* skip_w, void* out, int n,
                                         int h, int w, int cin, int cout, int cs, int skip_mode, int is_bf16,
                                         void* workspace, void* stream) {
  if (!valid(n, h, w, cin, cout, cs, skip_mode) || (skip_mode != SKIP_NONE && skip == nullptr) ||
      (skip_mode == SKIP_CONV && skip_w == nullptr) || ((scale == nullptr) != (shift == nullptr)))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(n, h, w, cin, cout, cs, skip_mode, is_bf16);
  if ((p.splits > 1 && workspace == nullptr) || static_cast<long long>(n) * p.splits > 65535)
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(scale), static_cast<const float*>(shift), w9,
               static_cast<const float*>(bias), skip, skip_w, out, static_cast<float*>(workspace),
               n, h, w, cin, cout, cs, skip_mode, p.tiles_x, p.splits, p.chunks_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.tiles, (cout + p.bn - 1) / p.bn, n * p.splits);
  static bool configured[4] = {false, false, false, false};
  int status;
  if (is_bf16) {
    status = p.bn == 32 ? launch(affine_silu_conv3_mma_kernel<32>, smem_bytes_bf16<32>(), configured[0], a, grid, s)
                        : launch(affine_silu_conv3_mma_kernel<64>, smem_bytes_bf16<64>(), configured[1], a, grid, s);
  } else {
    status = p.bn == 32 ? launch(affine_silu_conv3_fma_kernel<32>, smem_bytes_f32<32>(), configured[2], a, grid, s)
                        : launch(affine_silu_conv3_fma_kernel<64>, smem_bytes_f32<64>(), configured[3], a, grid, s);
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
