// Fused photometric augmentation + per-channel normalize for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel deepcv_tpu/ops/pallas/fused_augment.py::_kernel
// (called through fused_augment_normalize). On a uint8 NHWC batch with three
// channels and per-image factors it computes
//
//   x = u8 / 255
//   x = clip(brightness * x)                          PIL Brightness
//   x = clip(m + contrast * (x - m))                  PIL Contrast, m the
//       image's mean PIL 'L' grey, (R*299 + G*587 + B*114) // 1000 of the
//       post-brightness values rounded to uint8, averaged and rounded half up
//   x = clip(g + saturation * (x - g))                PIL Color, g the 601 luma
//   x = clip(clip(x) ** gamma)
//   x = clip(x + sigma * N(0, 1))                     only when sigma is given
//   y = (x - mean[c]) / std[c]
//
// What bounds it on an H100 SXM (80 GB HBM3 at 3.35 TB/s): bytes. Each
// element is read once as 1 byte and written once as 4 (float32) or 2
// (bfloat16); the arithmetic, a few dozen flops and one powf per element, is
// far below the card's rate. At 4096x32x32x3 to float32 that is 62.9 MB, a
// bound of 18.8 us.
//
// This first design is simple and right, not yet fast:
//   one block per image, two passes over its H*W*3 bytes. Pass 1 applies the
//   brightness and sums the integer luma in int32 (exact; a float32 sum is
//   exact only below 2^24) with a warp-shuffle block reduction; the grey
//   level is then (2*sum + HW) / (2*HW) in integers. Pass 2 reads the image
//   again (from L2 for a small image) and applies every step and the
//   normalize, writing each output once.
// The plain version (deepcv_tpu_torch/data/transforms.py) rounds the grey
// level through the same integers and the same IEEE quotients, and every
// add and multiply here is an explicit __fadd_rn/__fmul_rn, so no FMA
// contraction moves a value across a rint() boundary: with noise off the
// kernel and the plain version agree to float32 rounding of the unquantized
// steps.
// Noise: Box-Muller normals from Philox4x32-10 (curand's header-only device
// API), one stream per (seed, image, thread); the seed is read from device
// memory so that a caller can draw it on the card without a synchronise.
// Not carried over from the TPU kernel: its NCHW transpose and batch tiling,
// both Mosaic/VMEM layout rules.
//
// Plain C interface, no PyTorch headers: the wrapper in
// deepcv_tpu_torch/ops/kernels/fused_augment.py loads the library with
// ctypes and passes device pointers, sizes, the normalize constants and the
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

struct Normalize {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// PIL Image.blend: b + f * (a - b), clipped; each operation rounded alone
__device__ __forceinline__ float blend(float a, float b, float f) {
  return clip01(__fadd_rn(b, __fmul_rn(f, __fsub_rn(a, b))));
}

// to_tensor then brightness: clip(0 + f * (u / 255 - 0)) == clip(f * (u / 255))
__device__ __forceinline__ float bright_px(uint8_t u, float f) {
  return clip01(__fmul_rn(f, __fdiv_rn((float)u, 255.f)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_augment_normalize_kernel(const uint8_t* __restrict__ x,
                               const float* __restrict__ bright,
                               const float* __restrict__ contrast,
                               const float* __restrict__ sat,
                               const float* __restrict__ gamma,
                               const float* __restrict__ sigma,
                               const long long* __restrict__ seed,
                               T* __restrict__ out, int hw, Normalize nrm) {
  __shared__ int warp_sums[WARPS];
  __shared__ long long block_sum;
  const long long img = blockIdx.x;
  const uint8_t* xi = x + img * hw * 3;
  T* oi = out + img * hw * 3;
  const float fb = bright[img];

  // pass 1: integer PIL 'L' luma of the post-brightness image
  int lsum = 0;
  for (int i = threadIdx.x; i < hw; i += THREADS) {
    const uint8_t* px = xi + 3LL * i;
    const int r = (int)rintf(__fmul_rn(bright_px(px[0], fb), 255.f));
    const int g = (int)rintf(__fmul_rn(bright_px(px[1], fb), 255.f));
    const int b = (int)rintf(__fmul_rn(bright_px(px[2], fb), 255.f));
    lsum += (r * 299 + g * 587 + b * 114) / 1000;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = lsum;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < WARPS ? warp_sums[threadIdx.x] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) block_sum = v;
  }
  __syncthreads();
  // floor(sum / hw + 0.5), exactly
  const long long grey_q = (2 * block_sum + hw) / (2LL * hw);
  const float grey = __fdiv_rn((float)grey_q, 255.f);

  const float fc = contrast[img], fs = sat[img], fg = gamma[img];
  const bool noisy = sigma != nullptr;
  const float sg = noisy ? sigma[img] : 0.f;
  curandStatePhilox4_32_10_t rng;
  if (noisy) {
    curand_init((unsigned long long)seed[0],
                (unsigned long long)img * THREADS + threadIdx.x, 0ULL, &rng);
  }
  // luma weights as Python's doubles rounded to float, as the plain version has them
  const float w0 = (float)0.299, w1 = (float)0.587, w2 = (float)0.114;

  // pass 2: every step, then the normalize; one write per element
  for (int i = threadIdx.x; i < hw; i += THREADS) {
    const uint8_t* px = xi + 3LL * i;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = blend(bright_px(px[c], fb), grey, fc);
    const float luma = __fadd_rn(__fadd_rn(__fmul_rn(v[0], w0), __fmul_rn(v[1], w1)),
                                 __fmul_rn(v[2], w2));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float y = blend(v[c], luma, fs);
      y = clip01(powf(clip01(y), fg));
      if (noisy) y = clip01(__fadd_rn(y, __fmul_rn(sg, curand_normal(&rng))));
      store(oi + 3LL * i + c, __fdiv_rn(__fsub_rn(y, nrm.mean[c]), nrm.std[c]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bright, const void* contrast,
                   const void* sat, const void* gamma, const void* sigma,
                   const void* seed, void* out, int n, int hw, const Normalize& nrm,
                   cudaStream_t stream) {
  fused_augment_normalize_kernel<T><<<n, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(bright),
      static_cast<const float*>(contrast), static_cast<const float*>(sat),
      static_cast<const float*>(gamma), static_cast<const float*>(sigma),
      static_cast<const long long*>(seed), static_cast<T*>(out), hw, nrm);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). `x` is uint8
// (n, hw, 3) contiguous, the five factors float32 (n,), `seed` one int64;
// `sigma` and `seed` are null for no noise. Launches nothing for n == 0.
extern "C" int fused_augment_normalize_launch(
    const void* x, const void* bright, const void* contrast, const void* sat,
    const void* gamma, const void* sigma, const void* seed, void* out,
    int n, int hw, float mean0, float mean1, float mean2,
    float std0, float std1, float std2, int dtype, void* stream) {
  if (n < 0 || hw < 1 || (long long)hw * 255 > 0x7fffffffLL ||
      (sigma != nullptr && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Normalize nrm{{mean0, mean1, mean2}, {std0, std1, std2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch<float>(x, bright, contrast, sat, gamma, sigma, seed, out,
                                n, hw, nrm, st);
    case kBFloat16:
      return (int)launch<__nv_bfloat16>(x, bright, contrast, sat, gamma, sigma, seed,
                                        out, n, hw, nrm, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
