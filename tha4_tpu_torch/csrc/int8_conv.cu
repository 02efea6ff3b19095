// Q1: the int8 teacher's stride-1 convolution (3x3 pad 1, or 1x1 pad 0) as
// an implicit GEMM on Hopper's int8 tensor cores (wgmma s8 x s8 -> s32),
// after a pass that quantizes the activation once, with a per-output-channel
// dequantize epilogue.
//
// Replaces tha4_tpu/ops/quant.py:conv2d_int8, which the JAX package leaves to
// XLA (lax.conv_general_dilated on int8 operands into int32; no pallas_call):
//   xq  = clip(rint(x.f32 * inv), -127, 127)             inv = f32(1 / x_scale)
//   acc = sum over taps and Cin of xq * w8                (int32, exact)
//   out = T(acc.f32 * (xs * w_scale[co])) [+ T(bias[co])]  xs = f32(x_scale)
// T is x's dtype (f32 or bf16); the bias is added in T after the rounding,
// as the JAX conv adds it (ops/nn.py:172-176).  The sum is exact, so the
// kernel equals its plain version (ops/cuda_int8_conv.py int8_conv_plain)
// bit for bit, whatever the tiling, the order of the products or the split
// of the K chunks among blocks; two calls give the same bits.
//
// What bounds it on an H100: the int8 tensor cores (1979 TOP/s dense) at the
// teachers' wide levels, the bytes of x and of the output at the narrow
// ones.  Measured on the card, a quantize in shared memory by the threads
// that also issue the products, or by a producer warpgroup beside them,
// cost as much as the products; so does a dequantize whose stores scatter
// 4 bytes a lane.  So the design takes them off the tensor cores' path:
//   * int8_quantize_kernel writes x once as int8 NHWC, its channels
//     zero-padded to a multiple of 32 (a bandwidth-bound pass).
//   * int8_conv_wgmma_kernel: one block per SM walks its work items (image,
//     ROWS image rows x 64 columns, BN output channels: 32, 64 or 128, the
//     whole Cout up to 128), in chunks of 32 input channels with all their
//     taps.  Warpgroup 0, the producer, brings each chunk's int8 halo by
//     cp.async into a free stage laid out [row][k group][66 columns][16
//     channels] (every tap's A operand, 64 pixels shifted by dx and rows
//     shifted by dy, is then a run of whole no-swizzle core matrices, 8
//     pixels x 16 bytes, a descriptor at any shift; zero fill outside the
//     image) and the chunk's weights by one bulk copy (the TMA engine) of a
//     contiguous block of the device layout, [Cout block][chunk][tap][k
//     group][BN][16 bytes] (ops/cuda_int8_conv.py weight_layout, made once
//     per conv).  Warpgroups 1 and 2, the consumers, own ROWS / 2 rows each
//     (one row, one m64 of wgmma.m64nBNk32 with s32 accumulators in
//     registers): they issue a full stage's products, then give the
//     previous chunk's stage back once its products are done, so the tensor
//     cores always have the next chunk queued.  After an item's last chunk
//     they dequantize through a table of the block's per-channel scales and
//     biases and store from registers, each quad of lanes transposing its
//     channels so that a lane writes 16 or 32 contiguous bytes, while the
//     producer fills the next item's stages.
//   * Small grids (fewer items than half the SMs: the deep levels at
//     B = 1) split the chunks among items, which write int32 partial sums
//     to a workspace; a third kernel adds them (exact, any order) and
//     dequantizes.
//
// Layouts: x NHWC (N, H, W, Cin), contiguous; xq (N, H, W, Cpad) int8;
// w_scale f32 (Cout); bias T (Cout) or null; out NHWC (N, H, W, Cout).

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace tha4;

constexpr int CK = 32;        // input channels a chunk: one k32 of wgmma
constexpr int TW = 64;        // tile columns: one m64 per tile row
constexpr int HWID = TW + 2;  // halo columns
constexpr int BARS = 128;     // bytes before the tables: the mbarriers
constexpr int PRODUCER = 128;            // the producer warpgroup's threads
constexpr int THREADS = PRODUCER + 256;  // and two consumer warpgroups
constexpr int SMEM_MAX = 232448;         // a block's shared memory on an H100

struct Args {
  const void* x;
  int8_t* xq;            // x quantized, (N, H, W, Cpad)
  const int8_t* wl;      // the weights' device layout
  const float* w_scale;
  const void* bias;      // x's dtype, or null
  void* out;
  int* partial;          // splits x (N, H, W, Cout) int32 where the chunks are split
  int n, h, w, cin, cpad, cout, k, bn, rows, tiles_x, tiles, cblocks, splits, chunks, chunks_per_split, items;
  float inv, xs;
};

// ---------------------------------------------------------------------------
// The quantize pass
// ---------------------------------------------------------------------------

// x * inv rounded half to even and clipped to [-127, 127], as the low byte
// of the result: clip(rint(v)) = rint(clip(v)) on [-127, 127], and adding
// 1.5 * 2^23 rounds to an integer (round to nearest even) whose two's
// complement low byte is the float's.  NaN clips to -127, as fmaxf does.
__device__ __forceinline__ uint32_t quantize_bits(float v, float inv) {
  const float r = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(r, 12582912.0f));
}

// Four quantized values' low bytes packed in order.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// 16 channels of a pixel as the raw bits of their f32 values: a bf16 is the
// high half of its f32.  Channels at or past ``valid`` read as 0.
__device__ __forceinline__ void load16(const float* src, int valid, bool vec, uint32_t v[16]) {
  if (vec && valid >= 16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + q);
      v[4 * q] = u.x;
      v[4 * q + 1] = u.y;
      v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = i < valid ? __float_as_uint(__ldg(src + i)) : 0u;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, int valid, bool vec, uint32_t v[16]) {
  if (vec && valid >= 16) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + q);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[8 * q + 2 * k] = w[k] << 16;
        v[8 * q + 2 * k + 1] = w[k] & 0xffff0000u;
      }
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = i < valid ? static_cast<uint32_t>(__ldg(s + i)) << 16 : 0u;
  }
}

// One thread a 16-channel group of a pixel: 16 bytes of xq.
template <typename T>
__global__ void __launch_bounds__(256) int8_quantize_kernel(Args a) {
  const int groups = a.cpad / 16;
  const long long total = static_cast<long long>(a.n) * a.h * a.w * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool vec = a.cin % (16 / static_cast<int>(sizeof(T))) == 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long pixel = i / groups;
    const int c = static_cast<int>(i % groups) * 16;
    uint32_t v[16];
    load16(static_cast<const T*>(a.x) + pixel * a.cin + c, a.cin - c, vec, v);
    uint32_t q[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) q[k] = quantize_bits(__uint_as_float(v[k]), a.inv);
    reinterpret_cast<uint4*>(a.xq)[i] = make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                                                   pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
  }
}

// ---------------------------------------------------------------------------
// The convolution
// ---------------------------------------------------------------------------

template <int ROWS>
__host__ __device__ constexpr int a_stage_bytes() {
  return (ROWS + 2) * 2 * HWID * 16;
}
template <int BN>
__host__ __device__ constexpr int w_stage_bytes() {
  return 9 * 2 * BN * 16;
}
template <int BN, int ROWS, int S>
__host__ __device__ constexpr int stage_bytes() {
  return BARS + S * (w_stage_bytes<BN>() + a_stage_bytes<ROWS>());
}

// The dynamic shared memory of a call: the stages, then a scale and a bias
// per (padded) output channel for the dequantize.
int smem_bytes(int stages, int cblocks, int bn) { return stages + 2 * cblocks * bn * 4; }

// A 16-byte piece of the int8 halo (16 channels of one pixel) in the stage
// layout [halo row][k group][halo column][16].
__device__ __forceinline__ int piece_offset(int hr, int g, int p) { return ((hr * 2 + g) * HWID + p) * 16; }

// A work item: one image, tile of ROWS x 64 pixels and block of BN output
// channels, and its split's range of chunks.  Items are numbered with the
// split fastest, then the Cout block, so that the items reading the same
// halo run side by side.
struct Item {
  int b, y0, x0, cblock, split, begin, nq;
};

__device__ __forceinline__ Item item_at(const Args& a, int idx) {
  Item it;
  it.split = idx % a.splits;
  idx /= a.splits;
  it.cblock = idx % a.cblocks;
  idx /= a.cblocks;
  const int tile = idx % a.tiles;
  it.b = idx / a.tiles;
  it.y0 = (tile / a.tiles_x) * a.rows;
  it.x0 = (tile % a.tiles_x) * TW;
  it.begin = it.split * a.chunks_per_split;
  it.nq = min(a.chunks, it.begin + a.chunks_per_split) - it.begin;
  return it;
}

// Chunk q of item ``it``: its int8 halo (channels c0 .. c0 + 31 of xq) into
// the stage ``a8`` by cp.async, zero fill outside the image.  3x3: (ROWS +
// 2) rows x 66 columns; 1x1: the tile's own ROWS x 64 pixels at their halo
// positions, all the centre tap reads.  A producer thread keeps its k group
// and steps through the pixels 64 at a time.
template <int ROWS>
__device__ void load_halo(const Args& a, unsigned char* a8, const Item& it, int q) {
  const int g = threadIdx.x & 1;
  const bool k3 = a.k == 3;
  const int width = k3 ? HWID : TW;
  const int pixels = k3 ? (ROWS + 2) * HWID : ROWS * TW;
  const int8_t* base = a.xq + static_cast<long long>(it.b) * a.h * a.w * a.cpad + (it.begin + q) * CK + 16 * g;
  int s = threadIdx.x >> 1;
  int hr = s / width + (k3 ? 0 : 1);
  int p = s % width + (k3 ? 0 : 1);
  for (; s < pixels; s += PRODUCER / 2) {
    const int y = it.y0 - 1 + hr;
    const int x = it.x0 - 1 + p;
    const bool inside = y >= 0 && y < a.h && x >= 0 && x < a.w;
    const int8_t* src = inside ? base + (static_cast<long long>(y) * a.w + x) * a.cpad : base;
    cp_async16_zfill(a8 + piece_offset(hr, g, p), src, inside);
    p += PRODUCER / 2;  // 64: at most one row's wrap
    if (p >= (k3 ? HWID : TW + 1)) {
      p -= width;
      ++hr;
    }
  }
}

// One chunk's products: for every tap and every row this consumer
// warpgroup owns, D[row] += A(row shifted by the tap) x B(tap).
template <int BN, int RPW>
__device__ __forceinline__ void mma_chunk(int (&acc)[RPW][BN / 2], const unsigned char* a8,
                                          const unsigned char* wstage, int cw, int k) {
  const int taps = k * k;
  for (int t = 0; t < taps; ++t) {
    const int dy = k == 3 ? t / 3 : 1;
    const int dx = k == 3 ? t % 3 : 1;
    const uint64_t desc_b = smem_desc(wstage + t * 2 * BN * 16, BN * 16, 128);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const uint64_t desc_a = smem_desc(a8 + piece_offset(cw * RPW + r + dy, 0, dx), HWID * 16, 128);
      wgmma_s8<BN>(acc[r], desc_a, desc_b);
    }
  }
}

// Two channels' outputs, T(acc.f32 * scale) [+ T(bias)] with scale =
// f32(xs * w_scale[co]) and each rounding as int8_conv_plain's, packed as
// stored: one 32-bit word of two bf16, two of f32.
__device__ __forceinline__ uint32_t dequantize2(__nv_bfloat16*, int s0, int s1, float2 sc, float2 bi, bool bias) {
  __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(__int2float_rn(s0), sc.x), __fmul_rn(__int2float_rn(s1), sc.y));
  if (bias) {
    const float2 f = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(__fadd_rn(f.x, bi.x), __fadd_rn(f.y, bi.y));
  }
  return *reinterpret_cast<const uint32_t*>(&y);
}

__device__ __forceinline__ uint2 dequantize2(float*, int s0, int s1, float2 sc, float2 bi, bool bias) {
  float v0 = __fmul_rn(__int2float_rn(s0), sc.x), v1 = __fmul_rn(__int2float_rn(s1), sc.y);
  if (bias) {
    v0 = __fadd_rn(v0, bi.x);
    v1 = __fadd_rn(v1, bi.y);
  }
  return make_uint2(__float_as_uint(v0), __float_as_uint(v1));
}

__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int mask) { return __shfl_xor_sync(0xffffffffu, v, mask); }
__device__ __forceinline__ uint2 shfl_xor(uint2 v, int mask) {
  return make_uint2(__shfl_xor_sync(0xffffffffu, v.x, mask), __shfl_xor_sync(0xffffffffu, v.y, mask));
}

// A 4 x 4 transpose across the lanes of a quad (lane t = lane % 4): lane t
// holds v[j] = its two channels of channel group j0 + j, and ends with the
// two channels of lane s of group j0 + t in v[s], that is the group's eight
// channels in order.  Two butterfly steps, partners t ^ 2 then t ^ 1.
template <typename U>
__device__ __forceinline__ void quad_transpose(U (&v)[4], int t) {
  const bool hi = t & 2;
  U r0 = shfl_xor(hi ? v[0] : v[2], 2), r1 = shfl_xor(hi ? v[1] : v[3], 2);
  U c0 = hi ? r0 : v[0], c1 = hi ? r1 : v[1], c2 = hi ? v[2] : r0, c3 = hi ? v[3] : r1;
  const bool odd = t & 1;
  r0 = shfl_xor(odd ? c0 : c1, 1);
  r1 = shfl_xor(odd ? c2 : c3, 1);
  v[0] = odd ? r0 : c0;
  v[1] = odd ? c1 : r0;
  v[2] = odd ? r1 : c2;
  v[3] = odd ? c3 : r1;
}

// Eight consecutive channels (a transposed group) to ``dst``: 16 bytes at a
// time where ``aligned``, else the channels below ``valid`` one by one.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const uint32_t (&v)[4], bool aligned, int valid) {
  if (aligned && valid >= 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // unrolled: v stays in registers
    if (c < valid) reinterpret_cast<unsigned short*>(dst)[c] = static_cast<unsigned short>(v[c / 2] >> (16 * (c & 1)));
  }
}

__device__ __forceinline__ void store8(uint32_t* dst, const uint2 (&v)[4], bool aligned, int valid) {
  if (aligned && valid >= 8) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0].x, v[0].y, v[1].x, v[1].y);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[2].x, v[2].y, v[3].x, v[3].y);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // unrolled: v stays in registers
    if (c < valid) dst[c] = c & 1 ? v[c / 2].y : v[c / 2].x;
  }
}

// A consumer's accumulators to the output, dequantized through the block's
// table of scales and biases, or, for a split item, raw to its plane of the
// workspace.  Accumulator k of row r: pixel 16 * warp + lane / 4 (+ 8 for
// k & 2), channel 8 * (k / 4) + 2 * (lane % 4) + (k & 1).  Each quad's
// channels are transposed in groups of four 8-channel groups, so that a
// lane stores whole groups of 16 or 32 contiguous bytes.
template <typename T, int BN, int RPW>
__device__ void store_item(const Args& a, const int (&acc)[RPW][BN / 2], const Item& it, int cw, const float* table) {
  using U = typename std::conditional<sizeof(T) == 2, uint32_t, uint2>::type;  // a lane's two channels, as stored
  static_assert(BN % 32 == 0, "whole transposed groups");
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const bool split = a.splits > 1;
  const bool aligned = a.cout % (split || sizeof(T) == 4 ? 4 : 8) == 0;
  const float* sc_row = table + it.cblock * BN;
  const float* bi_row = sc_row + a.cblocks * BN;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int y = it.y0 + cw * RPW + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = it.x0 + 16 * warp + lane / 4 + 8 * half;
      const bool inside = y < a.h && x < a.w;
      const long long pix = ((static_cast<long long>(it.b) * a.h + y) * a.w + x) * a.cout;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 4) {
        U v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s0 = acc[r][4 * (j0 + j) + 2 * half], s1 = acc[r][4 * (j0 + j) + 2 * half + 1];
          if (split) {
            if constexpr (sizeof(T) == 4) v[j] = make_uint2(s0, s1);
          } else {
            const int c = 8 * (j0 + j) + 2 * t;
            v[j] = dequantize2(static_cast<T*>(nullptr), s0, s1, *reinterpret_cast<const float2*>(sc_row + c),
                               *reinterpret_cast<const float2*>(bi_row + c), a.bias != nullptr);
          }
        }
        quad_transpose(v, t);
        const int co = it.cblock * BN + 8 * (j0 + t);
        if (!inside || co >= a.cout) continue;
        if constexpr (sizeof(T) == 4) {
          const long long plane = static_cast<long long>(a.n) * a.h * a.w * a.cout;
          uint32_t* dst = split ? reinterpret_cast<uint32_t*>(a.partial + it.split * plane) : static_cast<uint32_t*>(a.out);
          store8(dst + pix + co, v, aligned, a.cout - co);
        } else {
          store8(static_cast<__nv_bfloat16*>(a.out) + pix + co, v, aligned, a.cout - co);
        }
      }
    }
  }
}

// The split sums added (integers: exact in any order), then dequantized.
template <typename T>
__global__ void __launch_bounds__(256) int8_conv_reduce_kernel(Args a) {
  const long long total = static_cast<long long>(a.n) * a.h * a.w * a.cout;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    int s = a.partial[i];
    for (int k = 1; k < a.splits; ++k) s += a.partial[k * total + i];
    const int co = static_cast<int>(i % a.cout);
    const float scale = __fmul_rn(a.xs, __ldg(a.w_scale + co));
    T y = from_f32<T>(__fmul_rn(__int2float_rn(s), scale));
    if (a.bias != nullptr) y = from_f32<T>(__fadd_rn(to_f32<T>(y), ldg_f32<T>(static_cast<const T*>(a.bias) + co)));
    static_cast<T*>(a.out)[i] = y;
  }
}

// One block per SM walks its items, a chunk at a time through S stages.
// full[s]: the producer's threads (each once its own copies have landed)
// and the weights' transaction; empty[s]: every consumer thread, once the
// stage's products are done.
template <typename T, int BN, int RPW, int S>
__global__ void __launch_bounds__(THREADS, 1) int8_conv_wgmma_kernel(Args a) {
  constexpr int ROWS = 2 * RPW;
  constexpr int WSB = w_stage_bytes<BN>();
  constexpr int ASB = a_stage_bytes<ROWS>();
  static_assert(2 * S <= BARS / 8, "the mbarriers fit before the stages");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* wbase = smem + BARS;
  unsigned char* abase = wbase + S * WSB;
  float* table = reinterpret_cast<float*>(abase + S * ASB);  // scales, then biases, of every Cout block
  const int wbytes = a.k * a.k * 2 * BN * 16;  // one chunk's weights

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, PRODUCER + 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < PRODUCER) {
    // The producer: chunk ``step`` issued into stage step % S once its last
    // users gave it back; a thread's full arrival for it once that thread's
    // copies have landed, one chunk later (two chunks' copies in flight).
    int step = 0;
    for (int idx = blockIdx.x; idx < a.items; idx += gridDim.x) {
      const Item it = item_at(a, idx);
      for (int q = 0; q < it.nq; ++q, ++step) {
        const int s = step % S;
        if (step >= S) mbar_wait(empty + s, ((step / S) + 1) & 1);
        if (threadIdx.x == 0) {
          const int8_t* src = a.wl + (static_cast<long long>(it.cblock) * a.chunks + it.begin + q) * wbytes;
          bulk_load(wbase + s * WSB, src, wbytes, full + s);
        }
        load_halo<ROWS>(a, abase + s * ASB, it, q);
        cp_async_commit();
        if (step > 0) {
          cp_async_wait<1>();
          fence_proxy_async();
          mbar_arrive(full + (step - 1) % S);
        }
      }
    }
    if (step > 0) {
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(full + (step - 1) % S);
    }
    return;
  }

  // The consumers' table, once: named barrier 1, their 256 threads.
  const int cw = threadIdx.x / 128 - 1;
  for (int c = threadIdx.x - PRODUCER; c < a.cblocks * BN; c += 256) {
    table[c] = c < a.cout ? __fmul_rn(a.xs, __ldg(a.w_scale + c)) : 0.0f;
    table[a.cblocks * BN + c] = c < a.cout && a.bias != nullptr ? ldg_f32<T>(static_cast<const T*>(a.bias) + c) : 0.0f;
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  int acc[RPW][BN / 2];
  int step = 0;
  for (int idx = blockIdx.x; idx < a.items; idx += gridDim.x) {
    const Item it = item_at(a, idx);
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) acc[r][k] = 0;
    for (int q = 0; q < it.nq; ++q, ++step) {
      const int s = step % S;
      mbar_wait(full + s, (step / S) & 1);
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_regs(acc[r]);
      wgmma_fence();
      mma_chunk<BN, RPW>(acc, abase + s * ASB, wbase + s * WSB, cw, a.k);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_regs(acc[r]);
      if (q > 0) mbar_arrive(empty + (step - 1) % S);  // the previous chunk's products are done
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < RPW; ++r) fence_regs(acc[r]);
    mbar_arrive(empty + (step - 1) % S);
    if (a.splits > 1) {
      store_item<float, BN, RPW>(a, acc, it, cw, nullptr);  // raw int32 sums, 4 bytes a channel as f32's
    } else {
      store_item<T, BN, RPW>(a, acc, it, cw, table);
    }
  }
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

// The SMs of the current device, asked once.
cudaError_t sm_count(int* count) {
  static int cached = 0;
  if (cached == 0) {
    int device = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    cached = sms;
  }
  *count = cached;
  return cudaSuccess;
}

// Tiling and split of one call.  BN is the layout's (32, 64 or 128); image
// rows an item: 4 at BN 128, else 8.  Only a grid of fewer items than half
// the SMs splits its chunks among items (each split the same number of
// chunks): measured on an H100, the partial sums' traffic and the reduce
// cost more than idle SMs above that.
struct Plan {
  int sms, rows, tiles_x, tiles, cblocks, chunks, splits, chunks_per_split, items;
};

bool valid(int n, int h, int w, int cin, int cout, int k, int bn) {
  return n >= 1 && h >= 1 && w >= 1 && cin >= 1 && cout >= 1 && (k == 1 || k == 3) && (bn == 32 || bn == 64 || bn == 128);
}

cudaError_t make_plan(int n, int h, int w, int cin, int cout, int bn, Plan* p) {
  const cudaError_t e = sm_count(&p->sms);
  if (e != cudaSuccess) return e;
  p->rows = bn == 128 ? 4 : 8;
  p->tiles_x = (w + TW - 1) / TW;
  p->tiles = p->tiles_x * ((h + p->rows - 1) / p->rows);
  p->cblocks = (cout + bn - 1) / bn;
  p->chunks = (cin + CK - 1) / CK;
  const long long blocks = static_cast<long long>(p->tiles) * p->cblocks * n;
  const long long target = p->sms / 2;
  long long splits = blocks < target ? (target + blocks - 1) / blocks : 1;
  splits = splits < p->chunks ? splits : p->chunks;
  p->chunks_per_split = static_cast<int>((p->chunks + splits - 1) / splits);
  p->splits = (p->chunks + p->chunks_per_split - 1) / p->chunks_per_split;
  p->items = static_cast<int>(blocks * p->splits);
  return cudaSuccess;
}

// Above 48 KB a block's shared memory must be asked for: once per kernel,
// for all it can have.
template <typename T, int BN, int RPW, int S>
int launch(bool& configured, const Args& a, int sms, cudaStream_t s) {
  const int smem = smem_bytes(stage_bytes<BN, 2 * RPW, S>(), a.cblocks, BN);
  auto kernel = int8_conv_wgmma_kernel<T, BN, RPW, S>;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  kernel<<<a.items < sms ? a.items : sms, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for a layout block: 2 rows a consumer at BN 128, else 4; four
// stages.
template <typename T>
int launch_bn(const Args& a, int sms, cudaStream_t s) {
  static bool configured[3] = {false, false, false};
  if (a.bn == 32) return launch<T, 32, 4, 4>(configured[0], a, sms, s);
  if (a.bn == 64) return launch<T, 64, 4, 4>(configured[1], a, sms, s);
  return launch<T, 128, 2, 4>(configured[2], a, sms, s);
}

unsigned grid_for(long long total, long long cap) {
  const long long blocks = (total + 255) / 256;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename T>
int forward(const Args& a, int sms, cudaStream_t s) {
  int8_quantize_kernel<T><<<grid_for(static_cast<long long>(a.n) * a.h * a.w * (a.cpad / 16), sms * 32LL), 256, 0, s>>>(a);
  int status = static_cast<int>(cudaGetLastError());
  if (status == 0) status = launch_bn<T>(a, sms, s);
  if (status != 0 || a.splits == 1) return status;
  int8_conv_reduce_kernel<T><<<grid_for(static_cast<long long>(a.n) * a.h * a.w * a.cout, sms * 16LL), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A call's split, for the wrapper to cache per size: the number of
// work items that share one tile's K chunks (above 1 the call needs an
// int32 workspace of splits x N x H x W x Cout).  bn is the weight layout's
// block of output channels.  Returns a cudaError_t (invalid value for sizes
// the kernel refuses).
extern "C" int tha4_int8_conv_plan(int n, int h, int w, int cin, int cout, int k, int bn, int* splits) {
  if (!valid(n, h, w, cin, cout, k, bn) || splits == nullptr) return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = make_plan(n, h, w, cin, cout, bn, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  *splits = p.splits;
  return 0;
}

// x NHWC (n, h, w, cin) f32 (is_bf16 = 0) or bf16 (1), 16-byte aligned; xq
// int8 scratch of n x h x w x (cin rounded up to 32) bytes, 16-byte
// aligned; wl the device layout (ceil(cout / bn), ceil(cin / 32), k * k, 2,
// bn, 16) int8, 16-byte aligned; w_scale f32 (cout); bias in x's dtype
// (cout) or null; out NHWC (n, h, w, cout); workspace int32 as the plan's
// splits ask, else null.  k is 3 (padding 1) or 1 (padding 0).  Returns a
// cudaError_t (0 on success).
extern "C" int tha4_int8_conv_forward(const void* x, void* xq, const void* wl, const void* w_scale, const void* bias,
                                      void* out, void* workspace, int n, int h, int w, int cin, int cout, int k, int bn,
                                      float inv, float xs, int is_bf16, void* stream) {
  if (!valid(n, h, w, cin, cout, k, bn) || xq == nullptr) return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = make_plan(n, h, w, cin, cout, bn, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  const Args a{x, static_cast<int8_t*>(xq), static_cast<const int8_t*>(wl), static_cast<const float*>(w_scale), bias, out,
               static_cast<int*>(workspace), n, h, w, cin, p.chunks * CK, cout, k, bn, p.rows, p.tiles_x, p.tiles,
               p.cblocks, p.splits, p.chunks, p.chunks_per_split, p.items, inv, xs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? forward<__nv_bfloat16>(a, p.sms, s) : forward<float>(a, p.sms, s);
}
