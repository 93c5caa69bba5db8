// int8_conv: w8a8 convolution over 1-3 spatial dims for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes its w8a8 convolutions
// (deepcv_tpu/compression.py, int8_conv_general_dilated) with XLA's
// lax.conv_general_dilated on int8 operands and int32 accumulation, and no
// Pallas kernel lies on that path. PyTorch has no int8 convolution on CUDA,
// so the port writes its own.
//
// What it computes: int8 activations x in channels-last layout (N, D, H, W,
// C; a 2-d map has D = 1, a 1-d signal D = H = 1), int8 weights packed as
// (O, KD, KH, KW, C / groups), stride, zero padding and dilation per spatial
// dim, feature groups. Each output is the int32 sum of its window's
// products, then either that sum itself (acc_out, for bit-exact checks) or
// float(acc) * (s_act * s_w[o]) rounded to the output type (float32 or
// bfloat16). The product of the two scales is taken first and
// the int32 -> float conversion rounds to nearest even, which is XLA's
// `y.astype(f32) * (s_act * s_w)`. The bias is not fused: the caller adds
// it in the output type, as flax's Conv does after the op.
//
// What bounds it: at the shapes the port serves (the wide classifier's
// 3x3 convs at 64-256 channels, ResNet-50's), int8 operations at the
// tensor cores' 1,979 TOP/s; the bytes (int8 in, bf16 out) bound it only
// for the 1x1s of small depth. This first version is simple on purpose and
// runs on the CUDA cores with __dp4a: one thread an output pixel and OCT
// output channels of one group, so that each activation load (16, 4 or 1
// bytes of the group's input channels) feeds OCT dot products, and the
// weights, the same for all threads of a block, are broadcast loads. It is
// far from the bound; mma.sync.m16n8k32.s8, then wgmma, are later work.
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
  if (groups <= 0 || p.c % groups || p.o % groups) return cudaErrorInvalidValue;
  p.cin_g = p.c / groups;
  p.cout_g = p.o / groups;
  p.taps = p.kd * p.kh * p.kw;
  p.pixels = static_cast<long long>(p.n) * p.od * p.oh * p.ow;
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
