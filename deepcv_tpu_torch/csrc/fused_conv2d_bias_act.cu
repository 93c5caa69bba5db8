// Fused stride-1 'same' conv2d + bias + activation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deepcv_tpu/ops/pallas/fused_layer.py::_kernel
// (called through _forward_pallas / fused_conv2d_bias_act): it computes
// act(conv(x, w, 'same') + b) with float32 accumulation for any odd kh x kw
// at stride 1, 1x1 included, on NHWC activations.
//
// What bounds it on an H100 SXM (80 GB HBM3 at 3.35 TB/s):
//   time >= max(FLOPs / peak, bytes / 3.35 TB/s), with
//   FLOPs = 2 * N * H * W * kh * kw * Cin * Cout and
//   bytes = x + w + y (+ b), each read or written once.
// At ResNet-50's widths every conv has hundreds of FLOPs per byte, so the
// bound is the arithmetic rate: 67 TFLOP/s for float32 outside the tensor
// cores, 989 TFLOP/s for bf16 on the tensor cores.
//
// This first design is an implicit GEMM on the CUDA cores and makes no claim
// on that bound:
//   M = N*H*W output pixels, N = Cout, K = kh*kw*Cin.
//   A (M x K) is never materialised: each block gathers its 64 x 16 slice of
//   patches straight from NHWC x, and the 'same' halo comes from predicated
//   zero loads (no padded copy of x, and none of the TPU kernel's kw shifted
//   copies, which were a Mosaic alignment workaround).
//   B (K x Cout) is the weight packed once by the caller to
//   (kh*kw*Cin, Cout), the order of w.reshape in _forward_pallas.
//   Both slices are staged in shared memory as float32; each of the 256
//   threads keeps a 4 x 4 tile of the 64 x 64 output block in registers.
//   The epilogue adds the bias, applies the activation and writes y once.
// bf16 inputs are widened to float32 on load, so bf16 runs at the float32
// CUDA-core rate too. Tensor cores (wgmma), TMA and a multi-stage pipeline
// are what would close the gap to the bound; they come later.
//
// Plain C interface, no PyTorch headers: the wrapper in
// deepcv_tpu_torch/ops/kernels/fused_layer.py loads the library with ctypes
// and passes device pointers, shapes, strides and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// Returns the CUDA error of the launch (0 on success). Launches nothing for
// an empty output. `bias` may be null.
extern "C" int fused_conv2d_bias_act_launch(
    const void* x, const void* w_packed, const void* bias, void* y,
    int n, int h, int w, int cin, int cout, int kh, int kw,
    long long sxn, long long sxh, long long sxw,
    long long syn, long long syh, long long syw,
    int dtype, int act, float slope, void* stream) {
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
      return (int)launch<__nv_bfloat16>(x, w_packed, bias, y, s, act, slope, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
