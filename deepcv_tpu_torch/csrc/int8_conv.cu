// int8_conv: w8a8 convolution over 1-3 spatial dims for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes its w8a8 convolutions
// (deepcv_tpu/compression.py, int8_conv_general_dilated) with XLA's
// lax.conv_general_dilated on int8 operands and int32 accumulation, and no
// Pallas kernel lies on that path. PyTorch has no int8 convolution on CUDA,
// so the port writes its own: it is what int8 serving (bench.py config 8,
// `serve --quantize int8`, `predict --quantize int8`) runs its convs on.
//
// What it computes: int8 activations x in channels-last layout (N, D, H, W,
// C; a 2-d map has D = 1, a 1-d signal D = H = 1), int8 weights (O, C /
// groups, *kernel), stride, zero padding and dilation per spatial dim,
// feature groups. Each output is the int32 sum of its window's products,
// then either that sum itself (acc_out, for bit-exact checks) or
// float(acc) * (s_act * s_w[o]) rounded to the output type (float32 or
// bfloat16). The product of the two scales is taken first and the int32 ->
// float conversion rounds to nearest even, which is XLA's
// `y.astype(f32) * (s_act * s_w)`. The sums are exact in any order (127^2 x
// K stays below 2^31 for K up to 133,000; config 8's largest K is 4,608), so
// both routes give the plain version's sums and outputs to the bit. The bias
// is not fused: the caller adds it in the output type, as flax's Conv does.
//
// What bounds it at config 8's shapes (the wide classifier's six 3x3 convs
// at batch 4096, ResNet-50's 53 convs at batch 256; H100 SXM: 1,979 int8
// TOP/s dense on the tensor cores through wgmma, about half of that through
// mma.sync, 3.35 TB/s): per forward the bytes, int8 in and bf16 out (0.90 ms
// and 2.71 ms against 0.63 and 1.06 ms of operations). Shape by shape, the
// 1x1s and the 64-channel 3x3s are bound by bytes, the 3x3s at 128-512
// channels by operations; the 7x7 stem (C = 3) by bytes, but its K of 147
// wastes a quarter of a padded tile.
//
// Two routes, chosen by the wrapper from the groups alone:
//
// * Tensor cores, every ungrouped conv (groups == 1): int8_conv_tc_kernel,
//   an implicit GEMM on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
//   M is the output pixels (N OD OH OW), N the output channels O, K the
//   taps x C in the packed weight's order (O, KD, KH, KW, C), zero-padded to
//   a multiple of 64 (int8_conv.py pack_weight_tc): both operands are
//   K-major, the layout int8 MMA takes (wgmma's s8 form takes no other).
//   - A block of 8 warps computes a 128-pixel x BN-channel tile (BN 128 or
//     64, int8_conv.py tc_plan: 64 for the 64-channel layers, so that they
//     do not pay for half a tile of zeros), K in 64-byte stages. Warps
//     2 x 4 (BN 128: a warp 64 x 32, 4 x 4 m16n8 tiles) or 4 x 2 (BN 64: 32
//     x 32, 2 x 4); int32 accumulators in registers.
//   - Loads: cp.async 16-byte copies into a ring of 4 stages (A 8 KB + B 8
//     or 4 KB each: 64 or 48 KB of dynamic shared memory, set above 48 KB by
//     cudaFuncSetAttribute; at BN 128 the staged epilogue tile, 68 KB, sets
//     the size), so that 3 stages are in flight while one is multiplied;
//     2 blocks an SM at BN 128 (registers capped at 128), 3 at BN 64 (85).
//     Loads along K wait on one another only through the ring. A thread
//     copies the same two pixel rows and 16-byte column of A at every
//     stage: the pixels' coordinates are decoded once, and the column's
//     (tap, channel) advances by 64 bytes a stage without a division. A
//     16-byte chunk lies in one tap when C is a multiple of 16; zero
//     padding, pixels past the edge or past M and the K tail are the
//     zero-fill form (source size 0), so a padded tap costs no branch in
//     the math. Channel counts that are not a multiple of 16 (the
//     3-channel stems, 5 -> 7) gather A byte by byte into the same stage
//     layout (VEC false), with the same zeros: synchronous loads, a
//     division a stage and a branch a byte, which leaves the stems far from
//     their bytes.
//   - Fragments by ldmatrix.x4 from shared memory whose 16-byte chunks are
//     XOR-swizzled (chunk ^ (row / 2 % 4) in 64-byte rows), so that the 8
//     rows of each 8x16-byte matrix fall in distinct bank groups.
//   - Epilogue: the int32 tile staged through shared memory (rows padded by
//     8 words, conflict-free), then each thread writes 16 bytes of a pixel's
//     channels: the int32 sums (acc_out), or the rescale above rounded
//     once. Channel counts whose row is not a multiple of 16 bytes store
//     element by element.
//   - Blocks launched at config 8 (128-pixel tiles x O / BN): the wide
//     classifier 32,768 (BN 64), 32,768 (64), 8,192, 8,192, 4,096 and
//     4,096 (128); ResNet-50 from 25,088 (the stem, BN 64) down to 392 for
//     the 7x7 stage's 512-channel convs (12,544 pixels, 98 tiles x 4), 1.5
//     waves at two blocks an SM on the 132 SMs.
// * CUDA cores, grouped convs (groups > 1: depthwise, grouped; no config 8
//   path runs one): int8_conv_kernel, __dp4a, one thread an output pixel
//   and OCT output channels of one group, so that each activation load (16,
//   4 or 1 bytes of the group's input channels) feeds OCT dot products, and
//   the weights, the same for all threads of a block, are broadcast loads.
//   Far from its bound (a depthwise 3x3 is 100x from it); a depthwise route
//   of its own is later work.
//
// Next: wgmma with TMA's im2col tensor maps feeding the ring (no address
// arithmetic in the loader, the full int8 rate), and the activation
// quantization fused into the previous op's epilogue, each for a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct ConvParams {
  int n, d, h, w, c;      // input, channels last
  int o, od, oh, ow;      // output channels and spatial size
  int kd, kh, kw;         // kernel
  int sd, sh, sw;         // strides
  int pd, ph, pw;         // zero padding before each spatial dim
  int dd, dh, dw;         // dilations
  int cin_g, cout_g;      // channels of one group, in and out
  int taps;               // kd * kh * kw
  long long pixels;       // n * od * oh * ow
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One chunk of VEC consecutive input channels: loaded once, dotted with the
// same chunk of each of the thread's OCT weight rows.
template <int VEC>
struct Chunk;

template <>
struct Chunk<16> {
  int4 v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ int dot(const int8_t* wp, int acc) const {
    const int4 b = __ldg(reinterpret_cast<const int4*>(wp));
    acc = __dp4a(v.x, b.x, acc);
    acc = __dp4a(v.y, b.y, acc);
    acc = __dp4a(v.z, b.z, acc);
    return __dp4a(v.w, b.w, acc);
  }
};

template <>
struct Chunk<4> {
  int v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = __ldg(reinterpret_cast<const int*>(p));
  }
  __device__ __forceinline__ int dot(const int8_t* wp, int acc) const {
    return __dp4a(v, __ldg(reinterpret_cast<const int*>(wp)), acc);
  }
};

template <>
struct Chunk<1> {
  int v;
  __device__ __forceinline__ void load(const int8_t* p) { v = static_cast<int>(*p); }
  __device__ __forceinline__ int dot(const int8_t* wp, int acc) const {
    return acc + v * static_cast<int>(*wp);
  }
};

// Grid: x over output pixels (kThreads a block), y over tiles of OCT output
// channels, all in one group (the launcher checks cout_g % OCT == 0). VEC
// divides cin_g and C, so every chunk load is aligned.
template <int VEC, int OCT, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s_act, const float* __restrict__ s_w,
                 OutT* __restrict__ y, int32_t* __restrict__ acc_out, ConvParams p) {
  const long long pix = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= p.pixels) return;
  const int o0 = blockIdx.y * OCT;
  long long r = pix;
  const int ox = static_cast<int>(r % p.ow);
  r /= p.ow;
  const int oy = static_cast<int>(r % p.oh);
  r /= p.oh;
  const int oz = static_cast<int>(r % p.od);
  const long long nb = r / p.od;
  const long long cbase = static_cast<long long>(o0 / p.cout_g) * p.cin_g;
  const long long wrow = static_cast<long long>(p.taps) * p.cin_g;  // bytes per output channel
  const int8_t* wbase = w + static_cast<long long>(o0) * wrow;

  int acc[OCT];
#pragma unroll
  for (int j = 0; j < OCT; ++j) acc[j] = 0;

  int t = 0;
  for (int kz = 0; kz < p.kd; ++kz) {
    const int iz = oz * p.sd - p.pd + kz * p.dd;
    const bool zin = iz >= 0 && iz < p.d;
    for (int ky = 0; ky < p.kh; ++ky) {
      const int iy = oy * p.sh - p.ph + ky * p.dh;
      const bool yin = zin && iy >= 0 && iy < p.h;
      for (int kx = 0; kx < p.kw; ++kx, ++t) {
        const int ix = ox * p.sw - p.pw + kx * p.dw;
        if (!yin || ix < 0 || ix >= p.w) continue;  // zero padding adds nothing
        const int8_t* xp = x + (((nb * p.d + iz) * p.h + iy) * p.w + ix) * p.c + cbase;
        const int8_t* wp = wbase + static_cast<long long>(t) * p.cin_g;
        for (int ci = 0; ci < p.cin_g; ci += VEC) {
          Chunk<VEC> a;
          a.load(xp + ci);
#pragma unroll
          for (int j = 0; j < OCT; ++j) acc[j] = a.dot(wp + j * wrow + ci, acc[j]);
        }
      }
    }
  }

  const long long ybase = pix * p.o + o0;
  if (acc_out != nullptr) {
#pragma unroll
    for (int j = 0; j < OCT; ++j) acc_out[ybase + j] = acc[j];
    return;
  }
  const float sa = *s_act;
#pragma unroll
  for (int j = 0; j < OCT; ++j) {
    const float scale = sa * s_w[o0 + j];
    y[ybase + j] = from_float<OutT>(__int2float_rn(acc[j]) * scale);
  }
}

template <int VEC, int OCT>
cudaError_t launch_vec_oct(const int8_t* x, const int8_t* w, const float* s_act,
                           const float* s_w, void* y, int32_t* acc_out, int out_dtype,
                           const ConvParams& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.pixels + kThreads - 1) / kThreads),
                  static_cast<unsigned>(p.o / OCT));
  switch (out_dtype) {
    case 0:
      int8_conv_kernel<VEC, OCT, float><<<grid, kThreads, 0, stream>>>(
          x, w, s_act, s_w, static_cast<float*>(y), acc_out, p);
      break;
    case 1:
      int8_conv_kernel<VEC, OCT, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          x, w, s_act, s_w, static_cast<__nv_bfloat16*>(y), acc_out, p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// 16-byte loads only with 8 or 4 output channels a thread: with one, the
// loaded chunk feeds a single dot product and ptxas spilled it (8 bytes)
template <int VEC>
cudaError_t launch_vec(int oct, const int8_t* x, const int8_t* w, const float* s_act,
                       const float* s_w, void* y, int32_t* acc_out, int out_dtype,
                       const ConvParams& p, cudaStream_t stream) {
  switch (oct) {
    case 8: return launch_vec_oct<VEC, 8>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    case 4: return launch_vec_oct<VEC, 4>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_vec<4>(int oct, const int8_t* x, const int8_t* w, const float* s_act,
                          const float* s_w, void* y, int32_t* acc_out, int out_dtype,
                          const ConvParams& p, cudaStream_t stream) {
  switch (oct) {
    case 8: return launch_vec_oct<4, 8>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    case 4: return launch_vec_oct<4, 4>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    case 1: return launch_vec_oct<4, 1>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_vec<1>(int oct, const int8_t* x, const int8_t* w, const float* s_act,
                          const float* s_w, void* y, int32_t* acc_out, int out_dtype,
                          const ConvParams& p, cudaStream_t stream) {
  switch (oct) {
    case 8: return launch_vec_oct<1, 8>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    case 4: return launch_vec_oct<1, 4>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    case 1: return launch_vec_oct<1, 1>(x, w, s_act, s_w, y, acc_out, out_dtype, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------- tensor cores, groups == 1 ---- //

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcBM = 128;       // output pixels a block
constexpr int kTcBK = 64;        // bytes of K a stage (two m16n8k32 steps)
constexpr int kTcStages = 4;

template <int BN>
struct TcTile {
  static constexpr int WM = BN == 128 ? 2 : 4;   // warps along the pixels
  static constexpr int WN = 8 / WM;              // warps along O
  static constexpr int MF = kTcBM / (WM * 16);   // m16 tiles a warp: 4 or 2
  static constexpr int NF = BN / (WN * 8);       // n8 tiles a warp: 4
  static constexpr int A_BYTES = kTcBM * kTcBK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * kTcBK;
  static constexpr int LDC = BN + 8;             // staged row stride, 32-bit words
  static constexpr int PIPE_BYTES = kTcStages * STAGE_BYTES;
  static constexpr int EPI_BYTES = kTcBM * LDC * 4;
  static constexpr int SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  // BN 64 keeps half the accumulators, and room for a third block an SM
  static constexpr int MIN_BLOCKS = BN == 128 ? 2 : 3;
};

struct TcParams {
  ConvParams p;     // groups 1
  int kdim;         // taps * C
  int kpad;         // kdim rounded up to kTcBK: the packed weight's row length
  int ktiles;       // kpad / kTcBK
  int nblk;         // blocks along O
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// byte offset of 16-byte chunk `chunk` (0-3) of row `row` in a stage of
// 64-byte rows: the chunk XOR (row / 2) % 4, so that the 8 rows an ldmatrix
// reads at one chunk column fill all 32 banks
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kTcBK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// 16 bytes from src into shared memory, or 16 zeros (source size 0) when !in
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for one m16n8k32 tile: a 16x32 s8 (row), b 32x8 s8 (col), d s32.
// Lane l holds a's rows l / 4 and l / 4 + 8, bytes 4 (l % 4) .. + 3 and 16
// + 4 (l % 4) .. + 3; b's column l / 4, the same bytes of K; d's rows l / 4
// and l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A K position (a tap and a channel in it) and the tap's offsets
struct KPos {
  int c, kx, ky, kz;
  __device__ __forceinline__ void decode(int k, const ConvParams& p) {
    const int tap = k / p.c;
    c = k - tap * p.c;
    kx = tap % p.kw;
    const int t2 = tap / p.kw;
    ky = t2 % p.kh;
    kz = t2 / p.kh;
  }
  // one channel on, into the next tap at C
  __device__ __forceinline__ void step(const ConvParams& p) {
    if (++c == p.c) {
      c = 0;
      if (++kx == p.kw) {
        kx = 0;
        if (++ky == p.kh) {
          ky = 0;
          ++kz;
        }
      }
    }
  }
  // kTcBK channels on (C a multiple of 16: at most 4 taps)
  __device__ __forceinline__ void advance(const ConvParams& p) {
    c += kTcBK;
    while (c >= p.c) {
      c -= p.c;
      if (++kx == p.kw) {
        kx = 0;
        if (++ky == p.kh) {
          ky = 0;
          ++kz;
        }
      }
    }
  }
};

// One output pixel of the tile, as the loader needs it: its window's first
// input position and the offset of that position's channel 0 (neither need
// lie inside the input); a pixel past M gets a window that is never inside.
struct RowPos {
  long long base;
  int iz0, iy0, ix0;
  __device__ __forceinline__ void decode(long long m, const ConvParams& p) {
    if (m >= p.pixels) {
      base = 0;
      iz0 = iy0 = ix0 = -(1 << 30);
      return;
    }
    const int ox = static_cast<int>(m % p.ow);
    long long r = m / p.ow;
    const int oy = static_cast<int>(r % p.oh);
    r /= p.oh;
    const int oz = static_cast<int>(r % p.od);
    const long long nb = r / p.od;
    iz0 = oz * p.sd - p.pd;
    iy0 = oy * p.sh - p.ph;
    ix0 = ox * p.sw - p.pw;
    base = (((nb * p.d + iz0) * p.h + iy0) * p.w + ix0) * p.c;
  }
  // offset of (tap position, channel) kp, or -1 outside the input
  __device__ __forceinline__ long long offset(const KPos& kp, const ConvParams& p) const {
    const int dz = kp.kz * p.dd, dy = kp.ky * p.dh, dx = kp.kx * p.dw;
    const bool in = static_cast<unsigned>(iz0 + dz) < static_cast<unsigned>(p.d) &&
                    static_cast<unsigned>(iy0 + dy) < static_cast<unsigned>(p.h) &&
                    static_cast<unsigned>(ix0 + dx) < static_cast<unsigned>(p.w);
    return in ? base + ((static_cast<long long>(dz) * p.h + dy) * p.w + dx) * p.c + kp.c : -1;
  }
};

template <typename T>
struct Pack16;  // 16 bytes of output: 4 floats or 8 bf16

template <>
struct Pack16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Pack16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static uint32_t two(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[8]) {
    return make_uint4(two(v[0], v[1]), two(v[2], v[3]), two(v[4], v[5]), two(v[6], v[7]));
  }
};

// Grid: x over (128-pixel tile, BN-channel block), a tile's channel blocks
// adjacent so that they read its pixels from L2. w is pack_weight_tc's (O,
// kpad). VEC: C % 16 == 0 (16-byte cp.async of A), else A byte by byte.
template <int BN, bool VEC, typename OutT>
__global__ void __launch_bounds__(kTcThreads, TcTile<BN>::MIN_BLOCKS)
int8_conv_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s_act, const float* __restrict__ s_w,
                    OutT* __restrict__ y, int32_t* __restrict__ acc_out, const TcParams tp) {
  using T = TcTile<BN>;
  constexpr int MF = T::MF, NF = T::NF;
  extern __shared__ __align__(128) unsigned char smem[];
  const ConvParams& p = tp.p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % T::WM, wn = warp / T::WM;
  const long long tile = blockIdx.x / tp.nblk;
  const int n0 = (blockIdx.x - static_cast<int>(tile) * tp.nblk) * BN;
  const long long m0 = tile * kTcBM;
  const uint32_t sbase = smem_u32(smem);

  // the loader: rows lrow and lrow + 64 of A (and of B), 16-byte column lcol
  const int lrow = tid >> 2, lcol = tid & 3;
  RowPos rows[2];
  rows[0].decode(m0 + lrow, p);
  rows[1].decode(m0 + lrow + 64, p);
  KPos kp;
  kp.decode(lcol * 16, p);
  int kload = lcol * 16;  // K position of this thread's chunk in the next stage to load
  const int8_t* wrow[BN / 64];
  bool wrow_in[BN / 64];
#pragma unroll
  for (int i = 0; i < BN / 64; ++i) {
    const int n = n0 + lrow + 64 * i;
    wrow_in[i] = n < p.o;
    wrow[i] = w + static_cast<long long>(wrow_in[i] ? n : 0) * tp.kpad + lcol * 16;
  }

  auto load_stage = [&](int slot, int kt) {
    const uint32_t a_st = sbase + slot * T::STAGE_BYTES;
    const uint32_t b_st = a_st + T::A_BYTES;
#pragma unroll
    for (int i = 0; i < BN / 64; ++i)
      cp_async16_cg(b_st + swz(lrow + 64 * i, lcol), wrow[i] + kt * kTcBK, wrow_in[i]);
    if constexpr (VEC) {
      const bool kin = kload < tp.kdim;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long off = kin ? rows[i].offset(kp, p) : -1;
        cp_async16_ca(a_st + swz(lrow + 64 * i, lcol), x + (off >= 0 ? off : 0), off >= 0);
      }
      kp.advance(p);
    } else {
      // byte by byte: 16 K positions from kload, each in its own tap and
      // channel; zeros outside the input and from K on
      KPos kb;
      kb.decode(kload, p);
      uint32_t v[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (kload + b < tp.kdim) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const long long off = rows[i].offset(kb, p);
            const uint32_t byte = off >= 0 ? static_cast<uint8_t>(__ldg(x + off)) : 0u;
            v[i][b >> 2] |= byte << (8 * (b & 3));
          }
        }
        kb.step(p);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t dst = a_st + swz(lrow + 64 * i, lcol);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[i][0]),
                     "r"(v[i][1]), "r"(v[i][2]), "r"(v[i][3]));
      }
    }
    kload += kTcBK;
  };

  int acc[MF][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) acc[mf][nf][0] = acc[mf][nf][1] = acc[mf][nf][2] = acc[mf][nf][3] = 0;

  // this lane's ldmatrix rows: A's row (lane % 16) of each m16 tile at
  // chunk 2 kk + lane / 16; B's row lane % 8 of n8 tile 2 np + lane / 16 at
  // chunk 2 kk + (lane / 8) % 2. The swizzle term (row / 2) % 4 is the
  // same for every tile of the lane (tiles start at multiples of 8 rows).
  const int a_row = wm * (MF * 16) + (lane & 15);
  const int b_row = wn * (NF * 8) + ((lane >> 4) << 3) + (lane & 7);
  uint32_t a_off[2], b_off[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a_off[kk] = swz(a_row, 2 * kk + (lane >> 4));
    b_off[kk] = T::A_BYTES + swz(b_row, 2 * kk + ((lane >> 3) & 1));
  }

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < tp.ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < tp.ktiles; ++kt) {
    cp_async_wait<kTcStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                 // everyone's, and stage kt - 1 is free
    const int next = kt + kTcStages - 1;
    if (next < tp.ktiles) load_stage(next % kTcStages, next);
    cp_async_commit();
    const uint32_t st = sbase + (kt % kTcStages) * T::STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t bfr[NF][2];
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, st + b_off[kk] + np * 16 * kTcBK);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        uint32_t af[4];
        ldmatrix_x4(af, st + a_off[kk] + mf * 16 * kTcBK);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) mma_s8(acc[mf][nf], af, bfr[nf][0], bfr[nf][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the int32 tile over it

  int32_t* cs = reinterpret_cast<int32_t*>(smem);
  {
    const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const int r = wm * (MF * 16) + mf * 16 + g;
        const int col = wn * (NF * 8) + nf * 8 + c2;
        *reinterpret_cast<int2*>(cs + r * T::LDC + col) = make_int2(acc[mf][nf][0], acc[mf][nf][1]);
        *reinterpret_cast<int2*>(cs + (r + 8) * T::LDC + col) =
            make_int2(acc[mf][nf][2], acc[mf][nf][3]);
      }
  }
  __syncthreads();

  // 16 bytes a thread: 4 int32 sums, 4 floats or 8 bf16 of one pixel;
  // consecutive threads on consecutive chunks of a pixel's channels
  const long long mrows = p.pixels - m0 < kTcBM ? p.pixels - m0 : kTcBM;
  if (acc_out != nullptr) {
    constexpr int CPR = BN / 4;  // chunks a row
    const bool vec = p.o % 4 == 0;
    for (int idx = tid; idx < kTcBM * CPR; idx += kTcThreads) {
      const int r = idx / CPR, col = (idx % CPR) * 4, o = n0 + col;
      if (r >= mrows || o >= p.o) continue;
      const int32_t* src = cs + r * T::LDC + col;
      int32_t* dst = acc_out + (m0 + r) * p.o + o;
      if (vec) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (o + e < p.o) dst[e] = src[e];
      }
    }
    return;
  }
  constexpr int E = Pack16<OutT>::N;
  constexpr int CPR = BN / E;
  const bool vec = p.o % E == 0;
  const float sa = *s_act;
  for (int idx = tid; idx < kTcBM * CPR; idx += kTcThreads) {
    const int r = idx / CPR, col = (idx % CPR) * E, o = n0 + col;
    if (r >= mrows || o >= p.o) continue;
    const int32_t* src = cs + r * T::LDC + col;
    OutT* dst = y + (m0 + r) * p.o + o;
    int q[E];
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const int4 t = *reinterpret_cast<const int4*>(src + e);
      q[e] = t.x;
      q[e + 1] = t.y;
      q[e + 2] = t.z;
      q[e + 3] = t.w;
    }
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float scale = o + e < p.o ? __fmul_rn(sa, __ldg(s_w + o + e)) : 0.f;
      v[e] = __fmul_rn(__int2float_rn(q[e]), scale);
    }
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = Pack16<OutT>::pack(v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (o + e < p.o) dst[e] = from_float<OutT>(v[e]);
    }
  }
}

template <int BN, bool VEC, typename OutT>
cudaError_t launch_tc_typed(const int8_t* x, const int8_t* w, const float* s_act,
                            const float* s_w, OutT* y, int32_t* acc_out, const TcParams& tp,
                            long long blocks, cudaStream_t stream) {
  constexpr int smem = TcTile<BN>::SMEM;
  const auto kernel = int8_conv_tc_kernel<BN, VEC, OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(x, w, s_act, s_w, y,
                                                                       acc_out, tp);
  return cudaGetLastError();
}

template <int BN, bool VEC>
cudaError_t launch_tc_vec(const int8_t* x, const int8_t* w, const float* s_act,
                          const float* s_w, void* y, int32_t* acc_out, int out_dtype,
                          const TcParams& tp, long long blocks, cudaStream_t st) {
  // the int32 sums take the float32 instantiation (acc_out set, y unused)
  if (acc_out != nullptr || out_dtype == 0)
    return launch_tc_typed<BN, VEC, float>(x, w, s_act, s_w, static_cast<float*>(y), acc_out,
                                           tp, blocks, st);
  if (out_dtype == 1)
    return launch_tc_typed<BN, VEC, __nv_bfloat16>(
        x, w, s_act, s_w, static_cast<__nv_bfloat16*>(y), nullptr, tp, blocks, st);
  return cudaErrorInvalidValue;
}

template <int BN>
cudaError_t launch_tc_bn(bool vec, const int8_t* x, const int8_t* w, const float* s_act,
                         const float* s_w, void* y, int32_t* acc_out, int out_dtype,
                         const TcParams& tp, long long blocks, cudaStream_t st) {
  return vec ? launch_tc_vec<BN, true>(x, w, s_act, s_w, y, acc_out, out_dtype, tp, blocks, st)
             : launch_tc_vec<BN, false>(x, w, s_act, s_w, y, acc_out, out_dtype, tp, blocks, st);
}

// the 22 geometry values of both launchers (see int8_conv_launch)
int parse_dims(const long long* dims, ConvParams& p) {
  p.n = static_cast<int>(dims[0]);
  p.d = static_cast<int>(dims[1]);
  p.h = static_cast<int>(dims[2]);
  p.w = static_cast<int>(dims[3]);
  p.c = static_cast<int>(dims[4]);
  p.o = static_cast<int>(dims[5]);
  p.od = static_cast<int>(dims[6]);
  p.oh = static_cast<int>(dims[7]);
  p.ow = static_cast<int>(dims[8]);
  p.kd = static_cast<int>(dims[9]);
  p.kh = static_cast<int>(dims[10]);
  p.kw = static_cast<int>(dims[11]);
  p.sd = static_cast<int>(dims[12]);
  p.sh = static_cast<int>(dims[13]);
  p.sw = static_cast<int>(dims[14]);
  p.pd = static_cast<int>(dims[15]);
  p.ph = static_cast<int>(dims[16]);
  p.pw = static_cast<int>(dims[17]);
  p.dd = static_cast<int>(dims[18]);
  p.dh = static_cast<int>(dims[19]);
  p.dw = static_cast<int>(dims[20]);
  const int groups = static_cast<int>(dims[21]);
  if (groups > 0 && p.c % groups == 0 && p.o % groups == 0) {
    p.cin_g = p.c / groups;
    p.cout_g = p.o / groups;
  }
  p.taps = p.kd * p.kh * p.kw;
  p.pixels = static_cast<long long>(p.n) * p.od * p.oh * p.ow;
  return groups;
}

}  // namespace

// dims: n, d, h, w, c, o, od, oh, ow, kd, kh, kw, sd, sh, sw, pd, ph, pw,
// dd, dh, dw, groups (22 values, host memory). vec (16, 4 or 1) must divide
// C / groups and C; oct (8, 4 or 1) must divide O / groups, and vec 16 takes
// oct 8 or 4 only. out_dtype: 0
// float32, 1 bfloat16. With acc_out non-null the kernel writes
// the int32 sums there and leaves y alone. Returns the launch's CUDA error
// code (0 on success).
extern "C" int int8_conv_launch(const void* x, const void* w, const void* s_act,
                                const void* s_w, void* y, void* acc_out,
                                const long long* dims, int vec, int oct, int out_dtype,
                                void* stream) {
  ConvParams p;
  const int groups = parse_dims(dims, p);
  if (groups <= 0 || p.c % groups || p.o % groups) return cudaErrorInvalidValue;
  if (p.cin_g % vec || p.cout_g % oct) return cudaErrorInvalidValue;
  if (p.pixels == 0) return cudaSuccess;
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sa = static_cast<const float*>(s_act);
  const float* sw = static_cast<const float*>(s_w);
  int32_t* acc = static_cast<int32_t*>(acc_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch_vec<16>(oct, xi, wi, sa, sw, y, acc, out_dtype, p, st);
    case 4: return launch_vec<4>(oct, xi, wi, sa, sw, y, acc, out_dtype, p, st);
    case 1: return launch_vec<1>(oct, xi, wi, sa, sw, y, acc, out_dtype, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core route, for groups == 1: the same pointers and 22 dims as
// int8_conv_launch (groups must be 1), w pack_weight_tc's (O, kpad) with
// kpad the taps x C rounded up to 64 and zeros from taps x C on; bn (128 or
// 64) the output channels a block. x, w and y (or acc_out) 16-byte aligned.
// Returns the launch's CUDA error code (0 on success).
extern "C" int int8_conv_tc_launch(const void* x, const void* w, const void* s_act,
                                   const void* s_w, void* y, void* acc_out,
                                   const long long* dims, int kpad, int bn, int out_dtype,
                                   void* stream) {
  TcParams tp;
  if (parse_dims(dims, tp.p) != 1) return cudaErrorInvalidValue;
  const ConvParams& p = tp.p;
  tp.kdim = p.taps * p.c;
  tp.kpad = kpad;
  if (kpad % kTcBK || kpad < tp.kdim || kpad - tp.kdim >= kTcBK) return cudaErrorInvalidValue;
  tp.ktiles = kpad / kTcBK;
  if (bn != 128 && bn != 64) return cudaErrorInvalidValue;
  tp.nblk = (p.o + bn - 1) / bn;
  if (p.pixels == 0) return cudaSuccess;
  const long long blocks = (p.pixels + kTcBM - 1) / kTcBM * tp.nblk;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sa = static_cast<const float*>(s_act);
  const float* sw = static_cast<const float*>(s_w);
  int32_t* acc = static_cast<int32_t*>(acc_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = p.c % 16 == 0;
  return bn == 128 ? launch_tc_bn<128>(vec, xi, wi, sa, sw, y, acc, out_dtype, tp, blocks, st)
                   : launch_tc_bn<64>(vec, xi, wi, sa, sw, y, acc, out_dtype, tp, blocks, st);
}
