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
//     cores, 67 TFLOP/s for float32 on the CUDA cores).
//
// bfloat16: fused_conv2d_bias_act_tc_kernel<BN>, an implicit GEMM on the
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
// float32: fused_conv2d_bias_act_kernel<float>, the first design, an
// implicit GEMM on the CUDA cores (67 TFLOP/s at most):
//   A (M x K) is never materialised: each block gathers its 64 x 16 slice of
//   patches straight from NHWC x, and the 'same' halo comes from predicated
//   zero loads. B (K x Cout) is the packed weight. Both slices are staged in
//   shared memory as float32; each of the 256 threads keeps a 4 x 4 tile of
//   the 64 x 64 output block in registers. The epilogue adds the bias,
//   applies the activation and writes y once.
//
// Plain C interface, no PyTorch headers: the wrapper in
// deepcv_tpu_torch/ops/kernels/fused_layer.py loads the library with ctypes
// and passes device pointers, shapes, strides, the bf16 tile plan and the
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // reduction slice per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4;
constexpr int TN = 4;

enum Act { kActNone = 0, kActRelu = 1, kActLeakyRelu = 2 };
enum DType { kFloat32 = 0, kBFloat16 = 1 };

struct ConvShape {
  int n, h, w, cin, cout, kh, kw;
  long long sxn, sxh, sxw;  // x strides in elements; the channel stride is 1
  long long syn, syh, syw;  // y strides in elements; the channel stride is 1
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_conv2d_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ wp,
                             const T* __restrict__ bias, T* __restrict__ y,
                             ConvShape s, int act, float slope) {
  // A is stored k-major so that the compute loop reads a row of pixels;
  // the +4 pad spreads the k-strided stores over the banks.
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long hw = (long long)s.h * s.w;
  const long long M = (long long)s.n * hw;
  const int K = s.kh * s.kw * s.cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ph = s.kh / 2;
  const int pw = s.kw / 2;

  // Gather role: column ka of the A slice, rows ma + 16 * i.
  const int ka = tid % BK;
  const int ma = tid / BK;
  long long a_base[TM];
  int a_oh[TM], a_ow[TM];
  bool a_ok[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ma + 16 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const long long img = mm / hw;
    const int rem = (int)(mm - img * hw);
    a_oh[i] = rem / s.w;
    a_ow[i] = rem - a_oh[i] * s.w;
    a_base[i] = img * s.sxn;
  }
  // Weight role: row kb + 4 * i of the B slice, column nb.
  const int nb = tid % BN;
  const int kb = tid / BN;

  // Compute role: rows ty + 16 * i, columns tx + 16 * j of the output block.
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + ka;
    int c = 0, r = 0, q = 0;
    if (k < K) {
      c = k % s.cin;
      const int rq = k / s.cin;
      r = rq / s.kw;
      q = rq - r * s.kw;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = 0.f;
      if (k < K && a_ok[i]) {
        const int ih = a_oh[i] + r - ph;
        const int iw = a_ow[i] + q - pw;
        if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w)
          v = to_f32(x[a_base[i] + ih * s.sxh + iw * s.sxw + c]);
      }
      As[ka][ma + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int kk = kb + 4 * i;
      const int kg = k0 + kk;
      const int co = n0 + nb;
      Bs[kk][nb] = (kg < K && co < s.cout) ? to_f32(wp[(long long)kg * s.cout + co]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const long long img = m / hw;
    const int rem = (int)(m - img * hw);
    const int oh = rem / s.w;
    const int ow = rem - oh * s.w;
    T* yrow = y + img * s.syn + oh * s.syh + ow * s.syw;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co >= s.cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f32(bias[co]);
      if (act == kActRelu) {
        v = v < 0.f ? 0.f : v;
      } else if (act == kActLeakyRelu) {
        v = v < 0.f ? v * slope : v;
      }
      yrow[co] = from_f32<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wp, const void* bias, void* y,
                   const ConvShape& s, int act, float slope, cudaStream_t stream) {
  const long long M = (long long)s.n * s.h * s.w;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((s.cout + BN - 1) / BN));
  fused_conv2d_bias_act_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), static_cast<const T*>(bias),
      static_cast<T*>(y), s, act, slope);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, tensor cores ---- //
constexpr int TC_CK_MAX = 64;  // input channels per chunk at most
constexpr int TC_SMEM_MAX = 227 * 1024;

using bf16 = __nv_bfloat16;

// warps: WM along the pixels (MF m16 tiles each), WN along Cout (NF n8 tiles)
template <int BN>
struct Tc {
  static constexpr int WN = BN == 128 ? 2 : 1;
  static constexpr int WM = 4;
  // narrow tiles take more pixels per warp: B is loaded once per 4 m16 tiles
  static constexpr int MF = BN <= 16 ? 4 : 2;
  static constexpr int NF = BN / (WN * 8);
  static constexpr int BM = WM * MF * 16;  // output pixels per block: 256 or 128
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int LDB = BN == 8 ? 8 : BN + 8;  // weight row stride (elements)
  // blocks per SM the registers must leave room for (caps of 80 at BN 8,
  // else 128; a cap of 80 spills at BN 16)
  static constexpr int MIN_BLOCKS = BN == 8 ? 6 : BN == 128 ? 2 : 4;
};

struct TcArgs {
  const bf16* x;
  const bf16* wp;
  const bf16* bias;
  bf16* y;
  int n, h, w, cin, cout, kh, kw;
  long long sxn, sxh, sxw, syn, syh, syw;
  int flat;                 // 1x1: a tile of BM consecutive pixels, across images
  int ti, th, tw;           // spatial: images x rows x columns of a tile
  int pph, ppw;             // the patch's rows and columns per image
  int tiles_h, tiles_w;     // spatial tiles per image along H and W
  int nblk;                 // blocks along Cout
  int ck, cp, nchunks;      // channels per chunk, Cin padded to 16, chunks
  int tg, ngroups;          // taps per weight stage, stages per chunk
  int patch_elems, wstage_elems;
  int xvec, wvec;           // loads of x, of the weight: 2 cp.async 16 B, 1 cp.async 8 B, 0 scalar
  int act;
  float slope;
};

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
__device__ __forceinline__ long long patch_pixel(const TcArgs& a, const TileOrigin& o,
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
__device__ __forceinline__ void load_patch(const TcArgs& a, const TileOrigin& o, bf16* dst,
                                           int c0, int live, int tid) {
  const int groups = live / 8;
  const int lda = a.ck + 8;
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
__device__ __forceinline__ void load_weight(const TcArgs& a, bf16* dst, int c0, int live,
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
template <int BN>
__global__ void __launch_bounds__(Tc<BN>::THREADS, Tc<BN>::MIN_BLOCKS)
fused_conv2d_bias_act_tc_kernel(const TcArgs a) {
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
  const int lda = a.ck + 8;

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
      for (int e = 0; e < 2; ++e) {
        if (a.act == kActRelu) {
          v[e] = v[e] < 0.f ? 0.f : v[e];
        } else if (a.act == kActLeakyRelu) {
          v[e] = v[e] < 0.f ? v[e] * a.slope : v[e];
        }
      }
      if (co + 1 < a.cout && (reinterpret_cast<uintptr_t>(yrow + co) & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yrow + co) = __floats2bfloat162_rn(v[0], v[1]);
      } else {
        yrow[co] = __float2bfloat16(v[0]);
        if (co + 1 < a.cout) yrow[co + 1] = __float2bfloat16(v[1]);
      }
    }
  }
}

template <int BN>
cudaError_t launch_tc_bn(TcArgs& a, int flat, int ti, int th, int tw, int ck, int tg,
                         cudaStream_t st) {
  using C = Tc<BN>;
  const int cp = (a.cin + 15) / 16 * 16;
  const int taps = a.kh * a.kw;
  if ((ck != 16 && ck != 32 && ck != 64) || ck > cp || tg < 1 || tg > taps || ti < 1 ||
      th < 1 || tw < 1 || ti * th * tw > C::BM || (flat && (a.kh != 1 || a.kw != 1)))
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
  a.tg = tg;
  a.ngroups = (taps + tg - 1) / tg;
  const long long patch = (long long)a.ti * a.pph * a.ppw * (ck + 8);
  const long long wstage = (long long)tg * ck * C::LDB;
  const long long smem = 2 * ((a.nchunks > 1 ? 2 : 1) * patch +
                              (a.nchunks * a.ngroups > 1 ? 2 : 1) * wstage);
  const long long blocks = tiles * a.nblk;
  if (smem > TC_SMEM_MAX || blocks > 0x7fffffffLL ||
      (long long)a.n * a.h * a.w > 0x7fffffffLL - C::BM)
    return cudaErrorInvalidValue;
  a.patch_elems = (int)patch;
  a.wstage_elems = (int)wstage;
  auto kernel = fused_conv2d_bias_act_tc_kernel<BN>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, C::THREADS, (int)smem, st>>>(a);
  return cudaGetLastError();
}

// The bf16 route: checks the tile plan (bn, flat, ti, th, tw, ck, tg) that
// the wrapper's tc_plan chose, derives the launch from it and launches.
cudaError_t launch_tc(const void* x, const void* wp, const void* bias, void* y,
                      const ConvShape& s, int act, float slope, int bn, int flat, int ti,
                      int th, int tw, int ck, int tg, cudaStream_t st) {
  // bn is the smallest tile width at or above Cout, 128 above that
  if (bn != 8 && bn != 16 && bn != 32 && bn != 64 && bn != 128) return cudaErrorInvalidValue;
  if ((bn < 128 && bn < s.cout) || (bn > 8 && bn / 2 >= s.cout)) return cudaErrorInvalidValue;
  TcArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.wp = static_cast<const bf16*>(wp);
  a.bias = static_cast<const bf16*>(bias);
  a.y = static_cast<bf16*>(y);
  a.n = s.n; a.h = s.h; a.w = s.w; a.cin = s.cin; a.cout = s.cout; a.kh = s.kh; a.kw = s.kw;
  a.sxn = s.sxn; a.sxh = s.sxh; a.sxw = s.sxw; a.syn = s.syn; a.syh = s.syh; a.syw = s.syw;
  a.act = act;
  a.slope = slope;
  // the widest load (2: 16 B, 1: 8 B, 0: 2 B) that the channel count, the
  // pointer and every pixel stride keep aligned
  const auto vec = [](int ch, const void* p, long long s0, long long s1, long long s2) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | (uintptr_t)(2 * (ch | s0 | s1 | s2));
    return (bits & 15) == 0 ? 2 : (bits & 7) == 0 ? 1 : 0;
  };
  a.xvec = vec(s.cin, x, s.sxn, s.sxh, s.sxw);
  a.wvec = vec(s.cout, wp, s.cout, 0, 0);
  switch (bn) {
    case 8: return launch_tc_bn<8>(a, flat, ti, th, tw, ck, tg, st);
    case 16: return launch_tc_bn<16>(a, flat, ti, th, tw, ck, tg, st);
    case 32: return launch_tc_bn<32>(a, flat, ti, th, tw, ck, tg, st);
    case 64: return launch_tc_bn<64>(a, flat, ti, th, tw, ck, tg, st);
    default: return launch_tc_bn<128>(a, flat, ti, th, tw, ck, tg, st);
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Launches nothing for
// an empty output. `bias` may be null. float32 takes the CUDA-core kernel
// and ignores the tile plan; bfloat16 takes the tensor-core kernel with the
// tile plan (bn, flat, ti, th, tw, ck, tg) of the wrapper's tc_plan.
extern "C" int fused_conv2d_bias_act_launch(
    const void* x, const void* w_packed, const void* bias, void* y,
    int n, int h, int w, int cin, int cout, int kh, int kw,
    long long sxn, long long sxh, long long sxw,
    long long syn, long long syh, long long syw,
    int dtype, int act, float slope,
    int bn, int flat, int ti, int th, int tw, int ck, int tg, void* stream) {
  if (n < 0 || h < 0 || w < 0 || cin < 1 || cout < 0 || kh < 1 || kw < 1 ||
      kh % 2 == 0 || kw % 2 == 0 || act < kActNone || act > kActLeakyRelu)
    return (int)cudaErrorInvalidValue;
  if ((long long)n * h * w == 0 || cout == 0) return 0;
  if (((long long)n * h * w + BM - 1) / BM > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, w, cin, cout, kh, kw, sxn, sxh, sxw, syn, syh, syw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch<float>(x, w_packed, bias, y, s, act, slope, st);
    case kBFloat16:
      return (int)launch_tc(x, w_packed, bias, y, s, act, slope, bn, flat, ti, th, tw, ck,
                            tg, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
