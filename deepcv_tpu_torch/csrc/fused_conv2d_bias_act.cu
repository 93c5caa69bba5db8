// Fused stride-1 'same' conv2d + bias + activation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deepcv_tpu/ops/pallas/fused_layer.py::_kernel
// (called through _forward_pallas / fused_conv2d_bias_act): it computes
// act(conv(x, w, 'same') + b) with float32 accumulation for any odd kh x kw
// at stride 1, 1x1 included, on NHWC activations. The weight comes packed
// once by the caller to (kh*kw*Cin, Cout), row (r*kw + q)*Cin + c: the order
// of w.reshape in _forward_pallas. The TPU kernel's kw pre-shifted copies of
// x and its lane padding (Mosaic alignment workarounds) are not carried over.
//
// What bounds it on an H100 SXM (80 GB HBM3 at 3.35 TB/s):
//   time >= max(FLOPs / peak, bytes / 3.35 TB/s), with
//   FLOPs = 2 * N * H * W * kh * kw * Cin * Cout and
//   bytes = x + w + y (+ b), each read or written once.
// The two shape families on the port's main paths sit on both sides:
//   - image_classifier (Cin 3, 4, 16; Cout 4, 16; 5x5 and 3x3 at 32x32 and
//     16x16, batch 4096): ~15 GFLOP against ~0.3 GB a forward, bound by
//     the bytes (0.090 ms);
//   - ResNet-50's stride-1 convs (64-2048 channels): hundreds of FLOPs per
//     byte, bound by the arithmetic rate (989 TFLOP/s for bf16 on the tensor
//     cores; float32 by 3xTF32, three TF32 products per FLOP at 494.7
//     TFLOP/s: 2.83 ms for one ResNet-50 forward's 46 convs at batch 64,
//     against 6.34 ms on the CUDA cores at 67 TFLOP/s).
//
// bfloat16: fused_conv2d_bias_act_tc_kernel<BN, EXT_ACT>, an implicit GEMM on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async, the
// plumbing of flash_attention.cu's tensor-core kernels):
//   M = output pixels, N = Cout, K = kh*kw*Cin.
//   - Tile width from Cout: BN in {8, 16, 32, 64, 128}, the smallest
//     BN >= Cout (128 above that, Cout tiled over the grid), so Cout 4
//     wastes half of one n8 fragment rather than 60 of 64 columns.
//   - Spatial output tiles: a block owns BM output pixels (256 for BN <= 16,
//     whose warps take 4 m16 tiles each so that one B fragment serves 4
//     mma; 128 above), as TI images x TH x TW pixels (TI > 1 only when a
//     whole image has at most BM pixels, as ResNet-50's 7x7 maps); the tile
//     follows H and W (the wrapper's tc_plan picks it). For each chunk of
//     64, 32 or 16 input channels the block stages its (TH+kh-1) x
//     (TW+kw-1) input patch once in shared memory, 'same' padding as
//     zero-filled pixels, channels zero-padded to a multiple of 16 (so one
//     k16 step is one tap x 16 channels). The A fragment of tap (r, q) is
//     ldmatrix'ed straight from the patch, one row address per lane = pixel
//     (oh+r, ow+q): im2col in shared memory, each input read from L2 or
//     device memory (TH+kh-1)(TW+kw-1)/(TH*TW) times, not kh*kw times. 1x1
//     convs have no halo and take a flat tile of BM consecutive pixels,
//     across images.
//   - The weight slices of each (chunk, group of taps) stream through a
//     two-stage ring in shared memory, the next one loading while this one
//     computes; a group holds as many taps as fit 24 KB (all of them for
//     image_classifier's convs, one or two at ResNet-50's widths), with the
//     columns zero-padded to BN in shared memory (pack_weight's rows of 4 or
//     16 bf16 are not 16-byte aligned for ldmatrix). The next chunk's patch
//     loads during the current chunk's first tap group.
//   - Loads by alignment, for x and for the weight apart: 16-byte cp.async
//     (zero-fill past the image) where the channel count (Cout for the
//     weight), the pointer and every pixel stride keep 16 bytes; 8-byte
//     cp.async where they keep 8 (Cin or Cout 4); else 2-byte loads put
//     together into 16-byte shared-memory stores of the padded layout (Cin
//     3, 5, 33), two pixels a thread at a time so both are in flight.
//   - Rows of the patch and of the weight slice are padded by 16 bytes
//     (none for BN = 8, whose 16-byte rows are already conflict-free), so
//     the 8 rows of one ldmatrix fall in distinct banks.
//   - Epilogue in f32: bias, activation, one bf16 rounding, predicated
//     stores for Cout < BN and for tile pixels past the image.
//   - Warps: 4 (BN <= 64: 64 pixels x BN each at BN <= 16, else 32 x BN) or
//     8 (BN = 128, 32 pixels x 64); __launch_bounds__ per BN, registers and
//     spills reported by chip_smoke.py's build line.
//   mma.sync and not wgmma: the classifier's convs are bound by bytes and a
//   single n8 fragment, where a 64-row warpgroup tile would waste most of
//   its work; wgmma and TMA are for a later design at ResNet-50's widths.
//   What was learned bringing it up on an H100 (chip_smoke.py and scratch
//   timings of variants with one phase cut out):
//   - At Cin <= 16 and BN = 8 (image_classifier's 5x5 convs) every phase of
//     a block was latency-bound and cost alike (the patch and weight loads,
//     the 25-tap loop, the epilogue); what paid: 256-pixel tiles, walking
//     pixels by a mixed-radix counter instead of dividing per element,
//     32-bit index math (each 64-bit division is a long subroutine), the
//     8-byte cp.async for Cin or Cout 4, and the bias read once into
//     registers after the main loop (read at each store, the compiler read
//     it again after every store to y, which may alias it).
//   - What bounds those convs now is instruction issue and latency per
//     block, not shared memory: reading only the nonzero half of A at
//     Cin <= 8 (ldmatrix.x2; an A fragment is three quarters zeros at Cin 3
//     or 4 and feeds a single n8 mma at BN = 8) made them slower.
//   - At ResNet-50's 7x7 and 14x14 maps the grid has 100-256 blocks for
//     132 SMs and K up to 4,608 through a two-stage ring: that is where
//     the kernel loses most to cuDNN.
//   - Registers: the cap of 128 (2 blocks of 256 threads or 4 of 128 per
//     SM) holds BN 64 and 128 with their 64 accumulators; unrolling the tap
//     loop spilled them, and a cap of 80 spilled BN 16.
//
// float32: fused_conv2d_bias_act_f32tc_kernel<BN, EXT_ACT>, the same implicit GEMM
// on the tensor cores by 3xTF32 (mma.sync m16n8k8 tf32 -> f32):
//   - Arithmetic, as flash_attention.cu's f32 K3: every f32 operand x is
//     split into hi = rna(x) and lo = rna(x - hi) (rna: cvt.rna.tf32.f32's
//     rounding, done in integer operations), and each product is lo*hi +
//     hi*lo + hi*hi; lo*lo (about 2^-22 relative) is dropped. The three
//     mmas of one k8 step sum from zero, and the step's result is added to
//     the f32 accumulator by an FADD: the tensor cores round their own sums
//     toward zero, and a chain of 3 x 576 mmas in one accumulator (K =
//     4,608) drifted to 4e-5 of max|ref| on the card, twice the f32 bound.
//     That holds f32 accuracy (2e-5 of max|ref| against the f32 plain
//     version) where one TF32 product would not. This is the kernel's own
//     arithmetic: torch.backends.cudnn.allow_tf32 and
//     torch.backends.cuda.matmul.allow_tf32 do not reach it.
//   - The bf16 route's tiling carries over: BN from Cout (8 to 64), the same
//     warps and BM, spatial tiles with their halo staged once per channel
//     chunk, flat tiles for 1x1, the two-stage weight ring, the next chunk's
//     patch loaded during the current chunk's first tap group, the f32
//     epilogue with predicated stores. Cin is padded to a multiple of 8 (one
//     k8 step is one tap x 8 channels) and the chunk is 64, 32, 16 or 8
//     channels.
//   - Tiles are at most 64 channels wide (Cout above 64 is tiled over the
//     grid, a tile's Cout blocks adjacent so they read its patch from L2):
//     with A and B split into hi and lo and each k8 step's sum in its own
//     registers, the bf16 route's BN 128 warp tile (32 pixels x 64 columns,
//     8 warps, 2 blocks an SM) needs more than its 128 registers and
//     spilled, and at 1 block an SM it was 6-8 % slower per ResNet-50
//     forward than BN 64 tiles (scratch variants timed on an H100).
//   - A stage is twice the bf16 bytes, so the plan (tc_plan with itemsize 4)
//     takes the chunk that lets the most blocks share an SM (up to the
//     blocks its registers allow: 4 at BN <= 16, 3 at 32 and 64) at no
//     extra tiles, the widest of those: 16-64 channels at ResNet-50's
//     widths, 3 blocks an SM.
//   - There is no ldmatrix for 32-bit operands, so fragments are read from
//     padded rows, with the k index of each k8 step permuted the same way in
//     A and B (mma k c <- channel 2c, k c + 4 <- channel 2c + 1): a lane's
//     two A values are adjacent channels of one patch pixel, one 8-byte load
//     (row stride ck + 8 floats, or 8 at ck = 8); its two B values are
//     weight rows 2c and 2c + 1 at column g, two 4-byte loads (row stride
//     BN + 4 floats). Banks: half a warp's 8-byte A loads read 4 pixels'
//     32-byte runs, conflict-free when the 4 pixels are consecutive in the
//     patch (the row stride is 8 or 24 mod 32 words); at a spatial tile's
//     row end the patch index jumps by kw, which can put two of the 4 on one
//     bank group (a 2-way conflict for that load; none when TW is a multiple
//     of 4, as in flat tiles). A warp's B loads fall in banks 8c + g:
//     conflict-free at every BN.
//   - A is split after each fragment load, B after each load, in registers:
//     the split costs instructions, not shared memory (hi/lo planes would
//     double the stages again and halve the blocks an SM holds).
//   - The k8 steps are unrolled fully, but by two at BN 64, whose full
//     unroll needed more than the 168 registers of 3 blocks an SM.
//   What was learned bringing it up on an H100 (scratch variants of this
//   source, one phase cut out or one choice changed, per ResNet-50 forward
//   of 13.1-13.3 ms): without the loads of every stage after the first it
//   took 9.8 ms, with one TF32 product instead of three 9.5, with neither
//   5.6; rounding lo toward zero (no second rna) saved 1 %; chunks wide
//   enough for 2 blocks an SM (14.0 ms), BN 32 tiles (15.1), and load rings
//   3 or 4 steps deep (14.6-15.2, against 13.7-13.8 for the same code at
//   2) were slower. So the kernel is neither issue- nor bandwidth-bound
//   alone: the three mma phases and the loads each stall 12 warps an SM.
//   - Loads by alignment, in f32 units: 16-byte cp.async (4 floats) where
//     the channel count (Cout for the weight), the pointer and every stride
//     keep 16 bytes, 8-byte cp.async where they keep 8, 4-byte cp.async
//     otherwise (Cin 3 or 5, Cout 5 or 7), all with zero-fill. Lanes take
//     consecutive 16-byte groups of a pixel's channels.
//
// Plain C interface, no PyTorch headers: the wrapper in
// deepcv_tpu_torch/ops/kernels/fused_layer.py loads the library with ctypes
// and passes device pointers, shapes, strides, the tile plan and the
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Act {
  kActNone = 0,
  kActRelu = 1,
  kActLeakyRelu = 2,
  kActRelu6 = 3,
  kActHardSwish = 4,
  kActSilu = 5
};
enum DType { kFloat32 = 0, kBFloat16 = 1 };

struct ConvShape {
  int n, h, w, cin, cout, kh, kw;
  long long sxn, sxh, sxw;  // x strides in elements; the channel stride is 1
  long long syn, syh, syw;  // y strides in elements; the channel stride is 1
};

// ------------------------------------------ tensor cores, both dtypes ---- //
constexpr int TC_CK_MAX = 64;  // input channels per chunk at most
constexpr int TC_SMEM_MAX = 227 * 1024;

using bf16 = __nv_bfloat16;

// warps: WM along the pixels (MF m16 tiles each), WN along Cout (NF n8 tiles);
// T is the element type (bf16: m16n8k16, float: m16n8k8 by 3xTF32)
template <int BN, typename T = bf16>
struct Tc {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WN = BN == 128 ? 2 : 1;
  static constexpr int WM = 4;
  // narrow tiles take more pixels per warp: B is loaded once per 4 m16 tiles
  static constexpr int MF = BN <= 16 ? 4 : 2;
  static constexpr int NF = BN / (WN * 8);
  static constexpr int BM = WM * MF * 16;  // output pixels per block: 256 or 128
  static constexpr int THREADS = 32 * WM * WN;
  // weight row stride (elements): bf16 rows padded by 16 bytes for ldmatrix
  // (none at BN 8); f32 rows by 4 floats, so that B's 4-byte loads of rows
  // 2c and 2c + 1 fall in banks 8c + g
  static constexpr int LDB = F32 ? BN + 4 : BN == 8 ? 8 : BN + 8;
  // channels of one k step, the unit Cin is padded to
  static constexpr int KSTEP = F32 ? 8 : 16;
  // blocks per SM the registers must leave room for. bf16: caps of 80 at
  // BN 8, else 128 (a cap of 80 spills at BN 16). f32: 4 at BN <= 16, 3 at
  // 32 and 64 (caps of 128 and 168), which its plan fills with shared
  // memory (fused_layer.F32_TC_BLOCKS)
  static constexpr int MIN_BLOCKS = F32 ? (BN <= 16 ? 4 : 3) : (BN == 8 ? 6 : BN == 128 ? 2 : 4);
};

template <typename T>
struct TcArgs {
  const T* x;
  const T* wp;
  const T* bias;
  T* y;
  int n, h, w, cin, cout, kh, kw;
  long long sxn, sxh, sxw, syn, syh, syw;
  int flat;                 // 1x1: a tile of BM consecutive pixels, across images
  int ti, th, tw;           // spatial: images x rows x columns of a tile
  int pph, ppw;             // the patch's rows and columns per image
  int tiles_h, tiles_w;     // spatial tiles per image along H and W
  int nblk;                 // blocks along Cout
  int ck, cp, nchunks;      // channels per chunk, Cin padded to one k step, chunks
  int lda;                  // patch row stride (elements)
  int tg, ngroups;          // taps per weight stage, stages per chunk
  int patch_elems, wstage_elems;
  int xvec, wvec;           // loads of x, of the weight: 2 cp.async 16 B, 1 cp.async 8 B,
                            // 0 bf16: scalar, f32: cp.async 4 B
  int act;
  float slope;
};

// the epilogue's activation, in f32 before the one rounding to the output
// type. EXT_ACT false: none, relu, leaky_relu; true: the JAX package's relu6
// min(max(v, 0), 6), hard_swish v relu6(v + 3) / 6 and silu v sigmoid(v),
// each rounded as torch's CPU kernels round it. Each kernel is instantiated
// for both, so that the first three compile without the others' divisions
// and exp (which cost them ~10 % of their time when they shared one switch).
template <bool EXT_ACT>
__device__ __forceinline__ float epilogue_act(float v, int act, float slope) {
  if constexpr (!EXT_ACT) {
    if (act == kActRelu) return v < 0.f ? 0.f : v;
    if (act == kActLeakyRelu) return v < 0.f ? v * slope : v;
    return v;
  } else {
    if (act == kActRelu6) return fminf(fmaxf(v, 0.f), 6.f);
    if (act == kActHardSwish) return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) / 6.f;
    return v / (1.f + expf(-v));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const int n = in ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  const int n = in ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const int n = in ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// d += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), d f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 from src[0..lim) (zeros from lim on), by 2-byte loads
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ src, int lim) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < lim ? s[2 * e] : 0u;
    const uint32_t hi = 2 * e + 1 < lim ? s[2 * e + 1] : 0u;
    v[e] = lo | (hi << 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// 8 bf16 from src[0..lim) (zeros from lim on) into dst, by the widest loads
// the operand's alignment allows (vec: 2 cp.async of 16 B, 1 of 8 B, 0 scalar;
// lim is 0 or at least 8 for vec 2, a multiple of 4 for vec 1)
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int lim, int vec) {
  if (vec == 2) {
    cp_async16(dst, src, lim > 0);
  } else if (vec == 1) {
    cp_async8(dst, src, lim > 0);
    cp_async8(dst + 4, src + 4, lim > 4);
  } else {
    *reinterpret_cast<uint4*>(dst) = load8(src, lim);
  }
}

// A position (hi, mid, lo) in a count with radices (mid_n, lo_n) (hi
// unbounded) and a fixed step, split into the same digits once: walking
// pixels by the step takes no division after the first. 32-bit throughout
// (the launcher keeps N*H*W below 2^31): a 64-bit division is a long
// subroutine, and each block builds four walks.
struct Walk {
  int hi, mid, lo;
  int mid_n, lo_n;
  int s_hi, s_mid, s_lo;
  __device__ __forceinline__ Walk(int idx, int step, int mid_n_, int lo_n_)
      : mid_n(mid_n_), lo_n(lo_n_) {
    const int plane = mid_n * lo_n;
    hi = idx / plane;
    const int r = idx - hi * plane;
    mid = r / lo_n;
    lo = r - mid * lo_n;
    s_hi = step / plane;
    const int sr = step - s_hi * plane;
    s_mid = sr / lo_n;
    s_lo = sr - s_mid * lo_n;
  }
  __device__ __forceinline__ void next() {
    lo += s_lo;
    mid += s_mid;
    hi += s_hi;
    if (lo >= lo_n) {
      lo -= lo_n;
      ++mid;
    }
    if (mid >= mid_n) {
      mid -= mid_n;
      ++hi;
    }
  }
};

// where a tile starts: spatial (first image, output row and column) or flat
// (first pixel)
struct TileOrigin {
  int img0, oh0, ow0, m0;
};

// x's offset of pixel (channel 0), or -1 outside the image ('same' padding)
// or past the batch; wk walks (image, row, column) of the image (flat) or
// of the patch
template <typename T>
__device__ __forceinline__ long long patch_pixel(const TcArgs<T>& a, const TileOrigin& o,
                                                 const Walk& wk) {
  const int img = a.flat ? wk.hi : o.img0 + wk.hi;
  const int ih = a.flat ? wk.mid : o.oh0 - a.kh / 2 + wk.mid;
  const int iw = a.flat ? wk.lo : o.ow0 - a.kw / 2 + wk.lo;
  if (img >= a.n || ih < 0 || ih >= a.h || iw < 0 || iw >= a.w) return -1;
  return img * a.sxn + ih * a.sxh + iw * a.sxw;
}

// channels [c0, c0 + live) of every patch pixel into dst (row stride ck + 8),
// zero outside the image, past the batch and from Cin on; a thread takes two
// pixels at a time, so that the scalar loads of both are in flight together
template <int THREADS>
__device__ __forceinline__ void load_patch(const TcArgs<bf16>& a, const TileOrigin& o, bf16* dst,
                                           int c0, int live, int tid) {
  const int groups = live / 8;
  const int lda = a.lda;
  const int np = a.ti * a.pph * a.ppw;
  Walk wk = a.flat ? Walk(o.m0 + tid, THREADS, a.h, a.w) : Walk(tid, THREADS, a.pph, a.ppw);
  for (int p = tid; p < np; p += 2 * THREADS) {
    const long long off0 = patch_pixel(a, o, wk);
    wk.next();
    const bool two = p + THREADS < np;
    const long long off1 = two ? patch_pixel(a, o, wk) : -1;
    wk.next();
    bf16* d0 = dst + p * lda;
    bf16* d1 = d0 + THREADS * lda;
    for (int gq = 0; gq < groups; ++gq) {
      const int c = c0 + gq * 8;
      const int lim0 = off0 >= 0 ? a.cin - c : 0, lim1 = off1 >= 0 ? a.cin - c : 0;
      const bf16* s0 = a.x + (lim0 > 0 ? off0 + c : 0);
      const bf16* s1 = a.x + (lim1 > 0 ? off1 + c : 0);
      if (a.xvec == 0) {
        const uint4 v0 = load8(s0, lim0), v1 = load8(s1, lim1);
        *reinterpret_cast<uint4*>(d0 + gq * 8) = v0;
        if (two) *reinterpret_cast<uint4*>(d1 + gq * 8) = v1;
      } else {
        copy8(d0 + gq * 8, s0, lim0, a.xvec);
        if (two) copy8(d1 + gq * 8, s1, lim1, a.xvec);
      }
    }
  }
}

// the weight rows of taps [tap0, tap0 + ntaps) x channels [c0, c0 + live),
// columns [n0, n0 + BN), into dst: row tt * ck + cc, zero from Cin and Cout on
template <int BN, int THREADS>
__device__ __forceinline__ void load_weight(const TcArgs<bf16>& a, bf16* dst, int c0, int live,
                                            int tap0, int ntaps, int n0, int tid) {
  constexpr int GROUPS = BN / 8;
  const int jobs = ntaps * live * GROUPS;
  Walk wk(tid, THREADS, live, GROUPS);  // (tap, channel, column group)
  for (int j = tid; j < jobs; j += THREADS, wk.next()) {
    const int c = c0 + wk.mid;
    const int col = n0 + wk.lo * 8;
    const long long src = ((long long)(tap0 + wk.hi) * a.cin + c) * a.cout + col;
    bf16* d = dst + (wk.hi * a.ck + wk.mid) * Tc<BN>::LDB + wk.lo * 8;
    const int lim = c < a.cin ? a.cout - col : 0;
    copy8(d, a.wp + (lim > 0 ? src : 0), lim, a.wvec);
  }
}

// Lane l of a warp holds, in an m16n8 accumulator, rows g = l / 4 and g + 8
// and columns 2c, 2c + 1 with c = l % 4 ([0..1] row g, [2..3] row g + 8).
template <int BN, bool EXT_ACT>
__global__ void __launch_bounds__(Tc<BN>::THREADS, Tc<BN>::MIN_BLOCKS)
fused_conv2d_bias_act_tc_kernel(const TcArgs<bf16> a) {
  using C = Tc<BN>;
  constexpr int MF = C::MF, NF = C::NF, LDB = C::LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ps = reinterpret_cast<bf16*>(smem_raw);                  // patch stages
  bf16* ws = ps + (a.nchunks > 1 ? 2 : 1) * a.patch_elems;       // weight stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane / 4, c4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: lane l gives row l % 8 of matrix l / 8

  // block -> (tile, Cout block); a tile's Cout blocks are adjacent, so they
  // read its input from L2
  const int tile = (int)blockIdx.x / a.nblk;
  const int n0 = ((int)blockIdx.x - tile * a.nblk) * BN;
  TileOrigin o{0, 0, 0, 0};
  if (a.flat) {
    o.m0 = tile * C::BM;
  } else {
    const int r = tile / a.tiles_w;
    o.ow0 = (tile - r * a.tiles_w) * a.tw;
    o.oh0 = (r % a.tiles_h) * a.th;
    o.img0 = (r / a.tiles_h) * a.ti;
  }
  const int lda = a.lda;

  // shared-memory byte offsets of this lane's ldmatrix rows: A at tap (0, 0)
  // and channel 0 for each m16 tile (the patch pixel under the tile's row;
  // pixel 0 for rows past the tile, whose results are never stored), B at
  // channel 0 of a weight stage
  uint32_t a_lane[MF];
  {
    Walk wk((wm * MF) * 16 + mr + (mi & 1) * 8, 16, a.th, a.tw);  // (image, row, column)
#pragma unroll
    for (int mf = 0; mf < MF; ++mf, wk.next()) {
      const int pb = wk.hi < a.ti ? (wk.hi * a.pph + wk.mid) * a.ppw + wk.lo : 0;
      a_lane[mf] = (uint32_t)(pb * lda + (mi >> 1) * 8) * 2;
    }
  }
  const uint32_t b_lane =
      (uint32_t)((NF == 1 ? (lane & 15) * LDB : (mr + (mi & 1) * 8) * LDB + (mi >> 1) * 8) +
                 wn * NF * 8) * 2;
  // a warp whose pixels all lie past the tile does no arithmetic (it still
  // loads and meets every barrier)
  const bool live = wm * MF * 16 < a.ti * a.th * a.tw;

  float acc[MF][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) acc[mf][nf][0] = acc[mf][nf][1] = acc[mf][nf][2] = acc[mf][nf][3] = 0.f;

  const int taps = a.kh * a.kw;
  const int steps = a.nchunks * a.ngroups;
  auto chunk_live = [&](int ci) { return min(a.ck, a.cp - ci * a.ck); };
  auto stage_weight = [&](int s) {
    const int ci = s / a.ngroups;
    const int tap0 = (s - ci * a.ngroups) * a.tg;
    load_weight<BN, C::THREADS>(a, ws + (s & 1) * a.wstage_elems, ci * a.ck, chunk_live(ci),
                                tap0, min(a.tg, taps - tap0), n0, tid);
  };

  load_patch<C::THREADS>(a, o, ps, 0, chunk_live(0), tid);
  stage_weight(0);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    const int ci = s / a.ngroups;
    const int gi = s - ci * a.ngroups;
    // every warp is done with the buffers the next loads overwrite (step
    // s - 1's weight stage, chunk ci - 1's patch)
    __syncthreads();
    if (s + 1 < steps) stage_weight(s + 1);
    if (gi == 0 && ci + 1 < a.nchunks)
      load_patch<C::THREADS>(a, o, ps + ((ci + 1) & 1) * a.patch_elems, (ci + 1) * a.ck,
                             chunk_live(ci + 1), tid);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the loads just issued has landed
    __syncthreads();
    if (!live) continue;

    const uint32_t pt = smem_u32(ps + (ci & 1) * a.patch_elems);
    const uint32_t wt = smem_u32(ws + (s & 1) * a.wstage_elems) + b_lane;
    const int tap0 = gi * a.tg;
    const int ntaps = min(a.tg, taps - tap0);
    const int ksteps = chunk_live(ci) / 16;
    int r = tap0 / a.kw, q = tap0 - r * a.kw;
    for (int tt = 0; tt < ntaps; ++tt) {
      const uint32_t at = pt + (uint32_t)((r * a.ppw + q) * lda) * 2;
      const uint32_t bt = wt + (uint32_t)(tt * a.ck * LDB) * 2;
#pragma unroll
      for (int kk = 0; kk < TC_CK_MAX / 16; ++kk) {
        if (kk >= ksteps) break;
        // B: this tap's 16 channels x this warp's columns
        uint32_t bfr[NF][2];
        if constexpr (NF == 1) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, bt + kk * 16 * LDB * 2);
          bfr[0][0] = b[0];
          bfr[0][1] = b[1];
        } else {
#pragma unroll
          for (int np = 0; np < NF / 2; ++np) {
            // matrices: channels (0-7 | 8-15) x columns (0-7 | 8-15), transposed
            uint32_t b[4];
            ldmatrix_x4_trans(b, bt + kk * 16 * LDB * 2 + np * 32);
            bfr[2 * np][0] = b[0];
            bfr[2 * np][1] = b[1];
            bfr[2 * np + 1][0] = b[2];
            bfr[2 * np + 1][1] = b[3];
          }
        }
        // A: matrices (pixels 0-7 | 8-15) x (channels 0-7 | 8-15) of the patch
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          uint32_t af[4];
          ldmatrix_x4(af, at + a_lane[mf] + kk * 32);
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) mma_bf16(acc[mf][nf], af, bfr[nf][0], bfr[nf][1]);
        }
      }
      if (++q == a.kw) {
        q = 0;
        ++r;
      }
    }
  }

  // epilogue: bias, activation, one bf16 rounding; the lane's rows are
  // g + 8k, k = 0 .. 2 MF - 1 (m16 tile k / 2, its upper half for odd k);
  // pixels past the tile or the image and columns past Cout are not stored
  if (!live) return;
  // the bias of this lane's columns in registers, read once: read at each
  // store, it would be read again after every store to y (which may alias
  // it), and held through the main loop, it would cost registers there
  float bias[NF][2];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + (wn * NF + nf) * 8 + 2 * c4 + e;
      bias[nf][e] = a.bias != nullptr && co < a.cout ? __bfloat162float(a.bias[co]) : 0.f;
    }
  Walk wk = a.flat ? Walk(o.m0 + wm * MF * 16 + g, 8, a.h, a.w)
                   : Walk(wm * MF * 16 + g, 8, a.th, a.tw);
#pragma unroll
  for (int k = 0; k < 2 * MF; ++k, wk.next()) {
    const int img = a.flat ? wk.hi : o.img0 + wk.hi;
    const int oh = a.flat ? wk.mid : o.oh0 + wk.mid;
    const int ow = a.flat ? wk.lo : o.ow0 + wk.lo;
    if ((!a.flat && wk.hi >= a.ti) || img >= a.n || oh >= a.h || ow >= a.w) continue;
    bf16* yrow = a.y + img * a.syn + oh * a.syh + ow * a.syw;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const int co = n0 + (wn * NF + nf) * 8 + 2 * c4;
      if (co >= a.cout) continue;
      float v[2] = {acc[k / 2][nf][2 * (k % 2)] + bias[nf][0],
                    acc[k / 2][nf][2 * (k % 2) + 1] + bias[nf][1]};
#pragma unroll
      for (int e = 0; e < 2; ++e) v[e] = epilogue_act<EXT_ACT>(v[e], a.act, a.slope);
      if (co + 1 < a.cout && (reinterpret_cast<uintptr_t>(yrow + co) & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yrow + co) = __floats2bfloat162_rn(v[0], v[1]);
      } else {
        yrow[co] = __float2bfloat16(v[0]);
        if (co + 1 < a.cout) yrow[co + 1] = __float2bfloat16(v[1]);
      }
    }
  }
}

// ------------------------------------------ f32, tensor cores, 3xTF32 ---- //

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero: the
// rounding of cvt.rna.tf32.f32, by adding half a tf32 ulp to the magnitude
// bits and clearing the 13 low ones. rna_tf32, split_tf32 and mma_tf32 are
// copies of their twins in flash_attention.cu (each library is one source
// file, whose bytes alone name its build); mma_3xtf32_step differs from its
// mma_3xtf32 in starting from zero.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (|x| 2^-22 or less): hi and lo rounded to tf32 to nearest,
// ties away from zero; x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: a 16x8 tf32 (row), b 8x8 tf32 (col), d f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b of one k8 step at f32 accuracy (3xTF32), from zero: the small
// products first, then hi * hi. The tensor cores round their f32 sums toward
// zero, so a K of thousands accumulated in the mma's own accumulator drifts
// (4e-5 of max|ref| at K = 4,608); the caller adds each step's d to its
// accumulator with an f32 add, which rounds to nearest.
__device__ __forceinline__ void mma_3xtf32_step(float (&d)[4], const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                                const uint32_t (&bl)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh[0]), "r"(bh[1]), "f"(0.f));
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// 4 floats from src[0..lim) (zeros from lim on) into dst by cp.async, as wide
// as the operand's alignment allows (vec: 2 one of 16 B, 1 two of 8 B, 0 four
// of 4 B; lim is 0 or at least 4 for vec 2, even for vec 1)
__device__ __forceinline__ void copy4f(float* dst, const float* src, int lim, int vec) {
  if (vec == 2) {
    cp_async16(dst, src, lim > 0);
  } else if (vec == 1) {
    cp_async8(dst, src, lim > 0);
    cp_async8(dst + 2, src + 2, lim > 2);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, lim > e);
  }
}

// channels [c0, c0 + live) of every patch pixel into dst (row stride lda),
// zero outside the image, past the batch and from Cin on. Thread t takes the
// 4-channel group t % G of pixels t / G, t / G + THREADS / G, ... (G = ck / 4
// groups a pixel, a power of two), so neighbouring lanes read neighbouring
// 16 bytes of a pixel's channels; groups from live on (the last chunk's
// unused columns) are neither loaded nor read.
template <int THREADS>
__device__ __forceinline__ void load_patch_f32(const TcArgs<float>& a, const TileOrigin& o,
                                               float* dst, int c0, int live, int tid) {
  const int G = a.ck / 4;
  const int gq = tid & (G - 1);
  if (gq * 4 >= live) return;
  const int c = c0 + gq * 4;
  const int step = THREADS / G;
  const int np = a.ti * a.pph * a.ppw;
  int p = tid / G;
  Walk wk = a.flat ? Walk(o.m0 + p, step, a.h, a.w) : Walk(p, step, a.pph, a.ppw);
  for (float* d = dst + p * a.lda + gq * 4; p < np; p += step, d += step * a.lda, wk.next()) {
    const long long off = patch_pixel(a, o, wk);
    const int lim = off >= 0 ? a.cin - c : 0;
    copy4f(d, a.x + (lim > 0 ? off + c : 0), lim, a.xvec);
  }
}

// the weight rows of taps [tap0, tap0 + ntaps) x channels [c0, c0 + live),
// columns [n0, n0 + BN), into dst: row tt * ck + cc, zero from Cin and Cout on
template <int BN, int THREADS>
__device__ __forceinline__ void load_weight_f32(const TcArgs<float>& a, float* dst, int c0,
                                                int live, int tap0, int ntaps, int n0, int tid) {
  constexpr int GROUPS = BN / 4;
  const int jobs = ntaps * live * GROUPS;
  Walk wk(tid, THREADS, live, GROUPS);  // (tap, channel, column group)
  for (int j = tid; j < jobs; j += THREADS, wk.next()) {
    const int c = c0 + wk.mid;
    const int col = n0 + wk.lo * 4;
    const long long src = ((long long)(tap0 + wk.hi) * a.cin + c) * a.cout + col;
    float* d = dst + (wk.hi * a.ck + wk.mid) * Tc<BN, float>::LDB + wk.lo * 4;
    const int lim = c < a.cin ? a.cout - col : 0;
    copy4f(d, a.wp + (lim > 0 ? src : 0), lim, a.wvec);
  }
}

// In an m16n8k8 tf32 mma, lane l (g = l / 4, c = l % 4) holds A at (row g |
// g + 8, k c | c + 4) as a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8,
// c + 4); B at (k c | c + 4, n g); the accumulator at rows g, g + 8 and
// columns 2c, 2c + 1 ([0..1] row g, [2..3] row g + 8). The k index of each k8
// step is permuted in both operands (k c <- channel 2c, k c + 4 <- channel
// 2c + 1): a0, a2 are channels 2c, 2c + 1 of the pixel under row g (one
// 8-byte load), a1, a3 those of row g + 8; b0, b1 weight rows 2c, 2c + 1 at
// column g.
template <int BN, bool EXT_ACT>
__global__ void __launch_bounds__(Tc<BN, float>::THREADS, Tc<BN, float>::MIN_BLOCKS)
fused_conv2d_bias_act_f32tc_kernel(const TcArgs<float> a) {
  using C = Tc<BN, float>;
  constexpr int MF = C::MF, NF = C::NF, LDB = C::LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);                // patch stages
  float* ws = ps + (a.nchunks > 1 ? 2 : 1) * a.patch_elems;      // weight stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane / 4, c4 = lane % 4;

  // block -> (tile, Cout block), as the bf16 kernel
  const int tile = (int)blockIdx.x / a.nblk;
  const int n0 = ((int)blockIdx.x - tile * a.nblk) * BN;
  TileOrigin o{0, 0, 0, 0};
  if (a.flat) {
    o.m0 = tile * C::BM;
  } else {
    const int r = tile / a.tiles_w;
    o.ow0 = (tile - r * a.tiles_w) * a.tw;
    o.oh0 = (r % a.tiles_h) * a.th;
    o.img0 = (r / a.tiles_h) * a.ti;
  }
  const int lda = a.lda;

  // this lane's A offsets (floats) at tap (0, 0), channel 2c of a chunk: the
  // patch pixel under tile row wm * MF * 16 + g + 8k, k = 0 .. 2 MF - 1 (m16
  // tile k / 2, its upper half for odd k; pixel 0 for rows past the tile,
  // whose results are never stored); B's at channel 2c, column g
  int a_off[2 * MF];
  {
    Walk wk(wm * MF * 16 + g, 8, a.th, a.tw);  // (image, row, column)
#pragma unroll
    for (int k = 0; k < 2 * MF; ++k, wk.next()) {
      const int pb = wk.hi < a.ti ? (wk.hi * a.pph + wk.mid) * a.ppw + wk.lo : 0;
      a_off[k] = pb * lda + 2 * c4;
    }
  }
  const int b_off = 2 * c4 * LDB + wn * NF * 8 + g;
  // a warp whose pixels all lie past the tile does no arithmetic (it still
  // loads and meets every barrier)
  const bool live = wm * MF * 16 < a.ti * a.th * a.tw;

  float acc[MF][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) acc[mf][nf][0] = acc[mf][nf][1] = acc[mf][nf][2] = acc[mf][nf][3] = 0.f;

  const int taps = a.kh * a.kw;
  const int steps = a.nchunks * a.ngroups;
  auto chunk_live = [&](int ci) { return min(a.ck, a.cp - ci * a.ck); };
  auto stage_weight = [&](int s) {
    const int ci = s / a.ngroups;
    const int tap0 = (s - ci * a.ngroups) * a.tg;
    load_weight_f32<BN, C::THREADS>(a, ws + (s & 1) * a.wstage_elems, ci * a.ck,
                                    chunk_live(ci), tap0, min(a.tg, taps - tap0), n0, tid);
  };

  load_patch_f32<C::THREADS>(a, o, ps, 0, chunk_live(0), tid);
  stage_weight(0);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    const int ci = s / a.ngroups;
    const int gi = s - ci * a.ngroups;
    // every warp is done with the buffers the next loads overwrite (step
    // s - 1's weight stage, chunk ci - 1's patch)
    __syncthreads();
    if (s + 1 < steps) stage_weight(s + 1);
    if (gi == 0 && ci + 1 < a.nchunks)
      load_patch_f32<C::THREADS>(a, o, ps + ((ci + 1) & 1) * a.patch_elems, (ci + 1) * a.ck,
                                 chunk_live(ci + 1), tid);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the loads just issued has landed
    __syncthreads();
    if (!live) continue;

    const float* pt = ps + (ci & 1) * a.patch_elems;
    const float* wt = ws + (s & 1) * a.wstage_elems + b_off;
    const int tap0 = gi * a.tg;
    const int ntaps = min(a.tg, taps - tap0);
    const int ksteps = chunk_live(ci) / 8;
    int r = tap0 / a.kw, q = tap0 - r * a.kw;
    for (int tt = 0; tt < ntaps; ++tt) {
      const float* at = pt + (r * a.ppw + q) * lda;
      const float* bt = wt + tt * a.ck * LDB;
      const auto k8_step = [&](int kk) {
        // A: channels 2c, 2c + 1 of this k8 step under rows g and g + 8 of
        // each m16 tile, split once for all of the warp's n8 tiles
        uint32_t ah[MF][4], al[MF][4];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const float2 x0 = *reinterpret_cast<const float2*>(at + a_off[2 * mf] + kk * 8);
          const float2 x1 = *reinterpret_cast<const float2*>(at + a_off[2 * mf + 1] + kk * 8);
          split_tf32(x0.x, ah[mf][0], al[mf][0]);
          split_tf32(x1.x, ah[mf][1], al[mf][1]);
          split_tf32(x0.y, ah[mf][2], al[mf][2]);
          split_tf32(x1.y, ah[mf][3], al[mf][3]);
        }
        // B: weight rows 2c, 2c + 1 of this k8 step at column g of each n8
        // tile, split after each load and used by the warp's m16 tiles
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const float* b = bt + kk * 8 * LDB + nf * 8;
          uint32_t bh[2], bl[2];
          split_tf32(b[0], bh[0], bl[0]);
          split_tf32(b[LDB], bh[1], bl[1]);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) {
            float d[4];
            mma_3xtf32_step(d, ah[mf], al[mf], bh, bl);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mf][nf][i] += d[i];
          }
        }
      };
      // the k8 steps fully unrolled, but at BN 64 by two: unrolled fully it
      // needs more than the 168 registers of 3 blocks an SM and spills
      if constexpr (BN == 64) {
#pragma unroll 2
        for (int kk = 0; kk < ksteps; ++kk) k8_step(kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < TC_CK_MAX / 8; ++kk) {
          if (kk >= ksteps) break;
          k8_step(kk);
        }
      }
      if (++q == a.kw) {
        q = 0;
        ++r;
      }
    }
  }

  // epilogue: bias, activation, f32 stores (two columns at once where
  // aligned); pixels past the tile or the image and columns past Cout are
  // not stored
  if (!live) return;
  float bias[NF][2];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + (wn * NF + nf) * 8 + 2 * c4 + e;
      bias[nf][e] = a.bias != nullptr && co < a.cout ? a.bias[co] : 0.f;
    }
  Walk wk = a.flat ? Walk(o.m0 + wm * MF * 16 + g, 8, a.h, a.w)
                   : Walk(wm * MF * 16 + g, 8, a.th, a.tw);
#pragma unroll
  for (int k = 0; k < 2 * MF; ++k, wk.next()) {
    const int img = a.flat ? wk.hi : o.img0 + wk.hi;
    const int oh = a.flat ? wk.mid : o.oh0 + wk.mid;
    const int ow = a.flat ? wk.lo : o.ow0 + wk.lo;
    if ((!a.flat && wk.hi >= a.ti) || img >= a.n || oh >= a.h || ow >= a.w) continue;
    float* yrow = a.y + img * a.syn + oh * a.syh + ow * a.syw;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const int co = n0 + (wn * NF + nf) * 8 + 2 * c4;
      if (co >= a.cout) continue;
      float v[2] = {acc[k / 2][nf][2 * (k % 2)] + bias[nf][0],
                    acc[k / 2][nf][2 * (k % 2) + 1] + bias[nf][1]};
#pragma unroll
      for (int e = 0; e < 2; ++e) v[e] = epilogue_act<EXT_ACT>(v[e], a.act, a.slope);
      if (co + 1 < a.cout && (reinterpret_cast<uintptr_t>(yrow + co) & 7) == 0) {
        *reinterpret_cast<float2*>(yrow + co) = make_float2(v[0], v[1]);
      } else {
        yrow[co] = v[0];
        if (co + 1 < a.cout) yrow[co + 1] = v[1];
      }
    }
  }
}

// ------------------------------------------------------------ launchers ---- //

template <int BN, typename T>
cudaError_t launch_tc_bn(TcArgs<T>& a, int flat, int ti, int th, int tw, int ck, int tg,
                         cudaStream_t st) {
  using C = Tc<BN, T>;
  const int cp = (a.cin + C::KSTEP - 1) / C::KSTEP * C::KSTEP;
  const int taps = a.kh * a.kw;
  if ((ck != 16 && ck != 32 && ck != 64 && !(C::F32 && ck == 8)) || ck > cp || tg < 1 ||
      tg > taps || ti < 1 || th < 1 || tw < 1 || ti * th * tw > C::BM ||
      (flat && (a.kh != 1 || a.kw != 1)))
    return cudaErrorInvalidValue;
  long long tiles;
  if (flat) {
    // one row of BM pixels, walked in image coordinates
    a.ti = a.th = a.pph = 1;
    a.tw = a.ppw = C::BM;
    tiles = ((long long)a.n * a.h * a.w + C::BM - 1) / C::BM;
  } else {
    a.ti = ti;
    a.th = th;
    a.tw = tw;
    a.pph = th + a.kh - 1;
    a.ppw = tw + a.kw - 1;
    a.tiles_h = (a.h + th - 1) / th;
    a.tiles_w = (a.w + tw - 1) / tw;
    tiles = (long long)((a.n + ti - 1) / ti) * a.tiles_h * a.tiles_w;
  }
  a.flat = flat;
  a.nblk = (a.cout + BN - 1) / BN;
  a.ck = ck;
  a.cp = cp;
  a.nchunks = (cp + ck - 1) / ck;
  // patch rows padded by 8 elements, so that the rows of one ldmatrix (bf16)
  // or of half a warp's 8-byte loads (f32) fall in distinct banks; an f32
  // chunk of 8 channels needs no padding (32-byte rows)
  a.lda = C::F32 && ck == 8 ? 8 : ck + 8;
  a.tg = tg;
  a.ngroups = (taps + tg - 1) / tg;
  const long long patch = (long long)a.ti * a.pph * a.ppw * a.lda;
  const long long wstage = (long long)tg * ck * C::LDB;
  const long long smem = (long long)sizeof(T) * ((a.nchunks > 1 ? 2 : 1) * patch +
                                                 (a.nchunks * a.ngroups > 1 ? 2 : 1) * wstage);
  const long long blocks = tiles * a.nblk;
  if (smem > TC_SMEM_MAX || blocks > 0x7fffffffLL ||
      (long long)a.n * a.h * a.w > 0x7fffffffLL - C::BM)
    return cudaErrorInvalidValue;
  a.patch_elems = (int)patch;
  a.wstage_elems = (int)wstage;
  const bool ext = a.act >= kActRelu6;
  void (*kernel)(TcArgs<T>);
  if constexpr (C::F32)
    kernel = ext ? fused_conv2d_bias_act_f32tc_kernel<BN, true>
                 : fused_conv2d_bias_act_f32tc_kernel<BN, false>;
  else
    kernel = ext ? fused_conv2d_bias_act_tc_kernel<BN, true>
                 : fused_conv2d_bias_act_tc_kernel<BN, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, C::THREADS, (int)smem, st>>>(a);
  return cudaGetLastError();
}

// Both routes: checks the tile plan (bn, flat, ti, th, tw, ck, tg) that the
// wrapper's tc_plan chose, derives the launch from it and launches; T is
// bf16 (m16n8k16) or float (m16n8k8 by 3xTF32).
template <typename T>
cudaError_t launch_tc(const void* x, const void* wp, const void* bias, void* y,
                      const ConvShape& s, int act, float slope, int bn, int flat, int ti,
                      int th, int tw, int ck, int tg, cudaStream_t st) {
  // bn is the smallest tile width at or above Cout, the widest (bf16 128,
  // f32 64) above that
  constexpr int BN_MAX = std::is_same<T, float>::value ? 64 : 128;
  if (bn != 8 && bn != 16 && bn != 32 && bn != 64 && bn != 128) return cudaErrorInvalidValue;
  if (bn > BN_MAX || (bn < BN_MAX && bn < s.cout) || (bn > 8 && bn / 2 >= s.cout))
    return cudaErrorInvalidValue;
  TcArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.wp = static_cast<const T*>(wp);
  a.bias = static_cast<const T*>(bias);
  a.y = static_cast<T*>(y);
  a.n = s.n; a.h = s.h; a.w = s.w; a.cin = s.cin; a.cout = s.cout; a.kh = s.kh; a.kw = s.kw;
  a.sxn = s.sxn; a.sxh = s.sxh; a.sxw = s.sxw; a.syn = s.syn; a.syh = s.syh; a.syw = s.syw;
  a.act = act;
  a.slope = slope;
  // the widest load (2: 16 B, 1: 8 B, 0: one element) that the channel
  // count, the pointer and every pixel stride keep aligned
  const auto vec = [](int ch, const void* p, long long s0, long long s1, long long s2) {
    const uintptr_t bits =
        reinterpret_cast<uintptr_t>(p) | (uintptr_t)(sizeof(T) * (ch | s0 | s1 | s2));
    return (bits & 15) == 0 ? 2 : (bits & 7) == 0 ? 1 : 0;
  };
  a.xvec = vec(s.cin, x, s.sxn, s.sxh, s.sxw);
  a.wvec = vec(s.cout, wp, s.cout, 0, 0);
  switch (bn) {
    case 8: return launch_tc_bn<8>(a, flat, ti, th, tw, ck, tg, st);
    case 16: return launch_tc_bn<16>(a, flat, ti, th, tw, ck, tg, st);
    case 32: return launch_tc_bn<32>(a, flat, ti, th, tw, ck, tg, st);
    case 64: return launch_tc_bn<64>(a, flat, ti, th, tw, ck, tg, st);
    default:
      if constexpr (BN_MAX == 128) return launch_tc_bn<128>(a, flat, ti, th, tw, ck, tg, st);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Launches nothing for
// an empty output. `bias` may be null. Both dtypes take a tensor-core kernel
// with the tile plan (bn, flat, ti, th, tw, ck, tg) of the wrapper's tc_plan:
// float32 fused_conv2d_bias_act_f32tc_kernel (3xTF32), bfloat16
// fused_conv2d_bias_act_tc_kernel.
extern "C" int fused_conv2d_bias_act_launch(
    const void* x, const void* w_packed, const void* bias, void* y,
    int n, int h, int w, int cin, int cout, int kh, int kw,
    long long sxn, long long sxh, long long sxw,
    long long syn, long long syh, long long syw,
    int dtype, int act, float slope,
    int bn, int flat, int ti, int th, int tw, int ck, int tg, void* stream) {
  if (n < 0 || h < 0 || w < 0 || cin < 1 || cout < 0 || kh < 1 || kw < 1 ||
      kh % 2 == 0 || kw % 2 == 0 || act < kActNone || act > kActSilu)
    return (int)cudaErrorInvalidValue;
  if ((long long)n * h * w == 0 || cout == 0) return 0;
  const ConvShape s{n, h, w, cin, cout, kh, kw, sxn, sxh, sxw, syn, syh, syw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_tc<float>(x, w_packed, bias, y, s, act, slope, bn, flat, ti, th, tw,
                                   ck, tg, st);
    case kBFloat16:
      return (int)launch_tc<bf16>(x, w_packed, bias, y, s, act, slope, bn, flat, ti, th, tw,
                                  ck, tg, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
