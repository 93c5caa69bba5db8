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
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): bytes. Each element is
// read once as 1 byte and written once as 4 (float32) or 2 (bfloat16). At
// 4096x32x32x3 to float32 (the augment_train batch) that is 63.0 MB, 18.8 us;
// at 256x224x224x3 it is 192.7 MB, 57.5 us. The instruction count comes
// near it: the compiled loops hold about 45 instructions an element
// without noise (pass 1 about 10, pass 2 about 33), which keep the card's
// 132 SMs x 4 schedulers busy for 19 us at 4096x32x32x3, and the noise
// adds about 17 more (Philox4x32-10's ten rounds for four elements,
// Box-Muller for two).
//
// Design: one kernel template, instantiated for float32 and bfloat16 out.
// 1. Plans, chosen by the launcher from H*W alone (no argument picks them):
//    - warp plan, H*W <= kWarpPlanMaxPixels (1,024: CIFAR's 32x32): one warp
//      an image, kWarps (8) images a block. An image's bytes, its table and
//      its warp's output stage take 5,632 bytes at 32x32, so a block takes
//      45 KB, under the 48 KB a block gets without opting in, and five
//      blocks (40 warps) share an SM: 4096 images are 512 blocks, all
//      resident at once. The luma sum is a warp shuffle; no block barrier.
//    - block plan, larger images: one block of 8 warps an image; warp w
//      takes chunks w, w + 8, ... The luma sum is a warp shuffle, then the
//      8 warp sums through shared memory.
//    Both plans run the same per-lane code below.
// 2. Per-image byte tables. Everything before saturation depends on one
//    byte u of one image: A[u] = clip(fb * (u / 255)) and its quantized
//    luma term Q[u] = rint(A[u] * 255); once the grey level is known,
//    B[u] = blend(A[u], grey, fc). Each image builds Q, then B over it, in
//    shared memory (256 words) with exactly the per-element expressions
//    (__fdiv_rn, __fmul_rn, rintf), so each entry is bit-identical to the
//    value computed per element: one ulp there could flip a rint and move
//    the grey level by 1/255, 1.6e-2 after the normalize.
//    Pass 1 sums the integer luma (Q[r]*299 + Q[g]*587 + Q[b]*114) / 1000
//    in int32 (exact: the launcher's hw * 255 guard keeps it below 2^31);
//    the grey level is (2*sum + HW) / (2*HW) in integers. Pass 2 starts
//    from B: saturation, gamma, noise and the normalize are all that is
//    left an element.
// 3. One read of a small image. A warp-plan image's bytes are copied once
//    into shared memory by 16-byte cp.async (by bytes when the image does
//    not start on 16 bytes, as at 13x29), and both passes read them there.
//    A block-plan image's lanes read their bytes from global memory in each
//    pass (pass 2 from L2), as words when the image starts on 4 bytes.
// 4. Whole pixels a lane, coalesced stores. Saturation needs a pixel's
//    three channels, so a lane owns PIX whole pixels a chunk (4 in float32,
//    8 in bfloat16: 48 output bytes). It writes them to its warp's 1,536-
//    byte stage as three 16-byte stores at a 48-byte stride (no bank
//    conflict), and the warp writes the stage out in NHWC order as three
//    16-byte stores a lane at neighbouring addresses. An image whose output
//    does not start on 16 bytes, and an image's last partial chunk, take
//    scalar stores from the same stage.
// 5. After the grey level, one form of the arithmetic, picked by
//    measurement (chip_smoke.py --k1; the accurate powf and the correctly
//    rounded quotient took 2.2-2.5x as long): the saturation blend and luma
//    rounded as the plain version rounds them, the power as
//    ex2.approx(g * lg2.approx(y)) with pow(y, 0) = 1 and pow(1, g) = 1 by a
//    select (0 * -inf is NaN), and the normalize as one FMA by 1/std and
//    -mean/std. Within 1e-5 of the plain version (chip_smoke.py's AUG_TOL):
//    the power's relative error is about 2^-22 (1 + |ln y^g|), at most
//    1.4 * 2^-22 on [0, 1], times 1/std < 4.
// 6. Noise keyed by element. Philox4x32-10 (curand's) with key = the seed,
//    read from device memory so that a caller can draw it on the card
//    without a synchronise; elements 4j..4j+3 of image i take the four words
//    of curand_Philox4x32_10((j, 0, i, 0), seed), the first draw of
//    curand_init(seed, i, 4j): whatever the plan or the lane, a seed gives
//    the same noise. Box-Muller on each pair of words: u in (0, 1] from the
//    first, so log u is finite and sigma 0 adds exactly 0.
//
// What was hard.
// - Exactness: every step up to the grey level must round as the plain
//   version does; the tables keep that by being built from the same
//   expressions, and cost one shared-memory gather an element a pass
//   instead of a division. The power's input must round so too: where the
//   saturation blend cancels to a few ulps, y ** g with g < 1 magnifies
//   them (sqrt(3e-8) - sqrt(1.5e-8) is 5e-5). An FMA blend and luma saved
//   two instructions an element and put the error at 9.4e-6, against
//   8.3e-7 with the plain version's roundings.
// - Alignment: at 32x32 and 224x224 every image's bytes and outputs start
//   on 16 bytes; at 13x29 (1,131 bytes an image) they do not. Such an image
//   is staged by bytes and stored by scalars; a lane past the image's end
//   reads no byte.
// - Timing: a launch at these sizes is shorter than the wrapper's host
//   time, so chip_smoke.py reads the kernel's device time from the
//   profiler, beside CUDA events.
//
// Not carried over from the TPU kernel: its NCHW transpose and batch
// tiling, both Mosaic/VMEM layout rules.
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

enum DType { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kThreads = 256;               // both plans: 8 warps a block
constexpr int kWarps = kThreads / 32;       // warp plan: images a block
constexpr int kWarpPlanMaxPixels = 1024;    // warp plan: H*W at most this
constexpr int kTableBytes = 256 * 4;        // Q, then B over it
constexpr int kStageBytes = 32 * 48;        // a warp's output stage
constexpr int kBlockPlanSmem = kTableBytes + kWarps * kStageBytes + kWarps * 4;

// pixels a lane owns in a chunk: 48 output bytes
template <typename T>
struct Pix {
  static constexpr int value = 16 / (int)sizeof(T);
};

// warp plan: shared memory of one image (table, stage, its bytes)
__host__ __device__ inline int warp_slot_bytes(int hw) {
  return kTableBytes + kStageBytes + (3 * hw + 15) / 16 * 16;
}

struct Args {
  const uint8_t* x;
  const float* bright;
  const float* contrast;
  const float* sat;
  const float* gamma;
  const float* sigma;           // null: no noise
  const long long* seed;
  void* out;
  int n, hw;
  float inv_std[3], nbias[3];   // the normalize as y * inv_std + nbias
};

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// PIL Image.blend: b + f * (a - b), clipped; each operation rounded alone
__device__ __forceinline__ float blend(float a, float b, float f) {
  return clip01(__fadd_rn(b, __fmul_rn(f, __fsub_rn(a, b))));
}

// y ** g for y in [0, 1], clipped; pow(y, 0) and pow(1, g) are 1. Both
// approximations flush subnormals (below 1.2e-38) to 0: such a y needs a
// brightness factor below about 1e-30, and the non-flushing lg2 costs four
// instructions an element
__device__ __forceinline__ float pow01(float y, float g) {
  float l, r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(y));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(g, l)));
  return clip01((g == 0.f || y == 1.f) ? 1.f : r);
}

// two normals from two Philox words: u in (0, 1], theta in [-pi, pi)
__device__ __forceinline__ float2 box_muller(uint32_t a, uint32_t b) {
  const float u = fmaf((float)a, 2.3283064365386963e-10f, 1.1641532182693481e-10f);
  const float t = fmaf((float)b, 1.4629180792671596e-09f, -3.14159265358979f);
  float l, r, s, c;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(u));  // u >= 2^-33: never subnormal
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(-1.3862943611198906f * l, 0.f)));
  __sincosf(t, &s, &c);
  return make_float2(r * c, r * s);
}

// byte i of the packed words, by one PRMT
template <int NW>
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[NW], int i) {
  return __byte_perm(w[i >> 2], 0u, 0x4440u | (unsigned)(i & 3));
}

// The 3 * PIX bytes of a lane's pixels at `p` (shared or global memory) as
// little-endian words; only the first `valid` are read, the rest are 0.
template <int NW>
__device__ __forceinline__ void load_pixels(const uint8_t* p, int valid, bool words,
                                            uint32_t (&w)[NW]) {
  if (words && valid >= 4 * NW) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < valid) v |= (uint32_t)p[4 * i + b] << (8 * b);
      w[i] = v;
    }
  }
}

// Q[u] = rint(A[u] * 255), A[u] = clip(fb * (u / 255)), entries tid,
// tid + NT, ...; the thread keeps its A[u] for the B table
template <int NT>
__device__ __forceinline__ void build_q(uint32_t* tab, float (&keep)[256 / NT], float fb,
                                        int tid) {
#pragma unroll
  for (int k = 0; k < 256 / NT; ++k) {
    const int u = tid + k * NT;
    keep[k] = clip01(__fmul_rn(fb, __fdiv_rn((float)u, 255.f)));
    tab[u] = (uint32_t)(int)rintf(__fmul_rn(keep[k], 255.f));
  }
}

// B[u] = blend(A[u], grey, fc), over Q
template <int NT>
__device__ __forceinline__ void build_b(uint32_t* tab, const float (&keep)[256 / NT],
                                        float grey, float fc, int tid) {
#pragma unroll
  for (int k = 0; k < 256 / NT; ++k) tab[tid + k * NT] = __float_as_uint(blend(keep[k], grey, fc));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// floor(sum / hw + 0.5) / 255, exactly
__device__ __forceinline__ float grey_level(int sum, int hw) {
  const long long q = (2LL * sum + hw) / (2LL * hw);
  return __fdiv_rn((float)q, 255.f);
}

// Pass 1 over the chunks first, first + stride, ... of an image of `hw`
// pixels whose bytes start at `px`: this lane's share of the integer luma sum.
template <typename T>
__device__ __forceinline__ int luma_sum(const uint8_t* px, bool words, const uint32_t* tab,
                                        int hw, int first, int stride, int lane) {
  constexpr int PIX = Pix<T>::value, CH = 32 * PIX;
  int sum = 0;
  for (int q0 = first * CH; q0 < hw; q0 += stride * CH) {
    const int p = q0 + lane * PIX;
    const int valid = 3 * min(PIX, hw - p);  // bytes; <= 0 past the image
    uint32_t w[3 * PIX / 4];
    load_pixels(px + 3 * p, valid, words, w);
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const uint32_t l = tab[byte_at(w, 3 * k)] * 299u + tab[byte_at(w, 3 * k + 1)] * 587u +
                         tab[byte_at(w, 3 * k + 2)] * 114u;
      if (3 * k < valid) sum += (int)(l / 1000u);
    }
  }
  return sum;
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// Pass 2 over the chunks first, first + stride, ... of image `img`: every
// step from B on, the normalize, the warp's stage, and the stores.
template <typename T, bool NOISE>
__device__ __forceinline__ void pixels_out(const Args& a, long long img, const uint8_t* px,
                                           bool words, const uint32_t* tab, uint4* stage,
                                           int first, int stride, int lane) {
  constexpr int PIX = Pix<T>::value, CH = 32 * PIX, NE = 3 * PIX;
  const int hw = a.hw;
  const float fs = a.sat[img], fg = a.gamma[img];
  float sg = 0.f;
  uint2 key = make_uint2(0u, 0u);
  if (NOISE) {
    sg = a.sigma[img];
    const unsigned long long s = (unsigned long long)a.seed[0];
    key = make_uint2((uint32_t)s, (uint32_t)(s >> 32));
  }
  const float w0 = (float)0.299, w1 = (float)0.587, w2 = (float)0.114;
  T* out = static_cast<T*>(a.out) + img * hw * 3;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int q0 = first * CH; q0 < hw; q0 += stride * CH) {
    const int p = q0 + lane * PIX;
    uint32_t w[NE / 4];
    load_pixels(px + 3 * p, 3 * min(PIX, hw - p), words, w);
    // elements 4j..4j+3 of the image take Philox call j; p is a multiple
    // of 4, so the lane's first element 3p starts a call
    const uint32_t j0 = 3u * (uint32_t)p / 4u;
    float r[NE], z[4];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = __uint_as_float(tab[byte_at(w, 3 * k + c)]);
      const float luma = __fadd_rn(__fadd_rn(__fmul_rn(v[0], w0), __fmul_rn(v[1], w1)),
                                   __fmul_rn(v[2], w2));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int i = 3 * k + c;
        float y = pow01(blend(v[c], luma, fs), fg);
        if (NOISE) {
          if (i % 4 == 0) {
            const uint4 bits = curand_Philox4x32_10(
                make_uint4(j0 + i / 4, 0u, (uint32_t)img, 0u), key);
            const float2 z01 = box_muller(bits.x, bits.y), z23 = box_muller(bits.z, bits.w);
            z[0] = z01.x, z[1] = z01.y, z[2] = z23.x, z[3] = z23.y;
          }
          y = clip01(__fadd_rn(y, __fmul_rn(sg, z[i % 4])));
        }
        r[i] = __fmaf_rn(y, a.inv_std[c], a.nbias[c]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if constexpr (sizeof(T) == 4) {
        stage[3 * lane + k] = make_uint4(__float_as_uint(r[4 * k]), __float_as_uint(r[4 * k + 1]),
                                         __float_as_uint(r[4 * k + 2]),
                                         __float_as_uint(r[4 * k + 3]));
      } else {
        stage[3 * lane + k] = make_uint4(pack(r[8 * k], r[8 * k + 1]),
                                         pack(r[8 * k + 2], r[8 * k + 3]),
                                         pack(r[8 * k + 4], r[8 * k + 5]),
                                         pack(r[8 * k + 6], r[8 * k + 7]));
      }
    }
    __syncwarp();
    T* dst = out + 3LL * q0;
    const int nvalid = 3 * min(CH, hw - q0);
    if (vec && nvalid == 3 * CH) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        reinterpret_cast<uint4*>(dst)[32 * k + lane] = stage[32 * k + lane];
    } else {
      const T* st = reinterpret_cast<const T*>(stage);
      for (int e = lane; e < nvalid; e += 32) dst[e] = st[e];
    }
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ void pass2(const Args& a, long long img, const uint8_t* px,
                                      bool words, const uint32_t* tab, uint4* stage,
                                      int first, int stride, int lane) {
  if (a.sigma != nullptr)
    pixels_out<T, true>(a, img, px, words, tab, stage, first, stride, lane);
  else
    pixels_out<T, false>(a, img, px, words, tab, stage, first, stride, lane);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_augment_normalize_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (a.hw <= kWarpPlanMaxPixels) {
    // warp plan: warp w of block b takes image b * kWarps + w alone
    const long long img = (long long)blockIdx.x * kWarps + warp;
    if (img >= a.n) return;  // the whole warp; this plan has no block barrier
    uint8_t* slot = smem + warp * warp_slot_bytes(a.hw);
    uint32_t* tab = reinterpret_cast<uint32_t*>(slot);
    uint4* stage = reinterpret_cast<uint4*>(slot + kTableBytes);
    uint8_t* bytes = slot + kTableBytes + kStageBytes;
    const uint8_t* src = a.x + img * a.hw * 3;
    const int nbytes = 3 * a.hw;
    const int nvec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? nbytes / 16 : 0;
    for (int i = lane; i < nvec; i += 32) cp_async16(bytes + 16 * i, src + 16 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = 16 * nvec + lane; i < nbytes; i += 32) bytes[i] = src[i];
    float keep[256 / 32];
    build_q<32>(tab, keep, a.bright[img], lane);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    const float grey = grey_level(warp_sum(luma_sum<T>(bytes, true, tab, a.hw, 0, 1, lane)),
                                  a.hw);
    __syncwarp();  // every Q read ended before B overwrites it
    build_b<32>(tab, keep, grey, a.contrast[img], lane);
    __syncwarp();
    pass2<T>(a, img, bytes, true, tab, stage, 0, 1, lane);
  } else {
    // block plan: block b takes image b, warp w its chunks w, w + 8, ...
    const long long img = blockIdx.x;
    uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
    uint4* stage = reinterpret_cast<uint4*>(smem + kTableBytes) + warp * (kStageBytes / 16);
    int* sums = reinterpret_cast<int*>(smem + kTableBytes + kWarps * kStageBytes);
    const uint8_t* src = a.x + img * a.hw * 3;
    const bool words = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
    float keep[1];
    build_q<kThreads>(tab, keep, a.bright[img], threadIdx.x);
    __syncthreads();
    const int sum = warp_sum(luma_sum<T>(src, words, tab, a.hw, warp, kWarps, lane));
    if (lane == 0) sums[warp] = sum;
    __syncthreads();  // also: every Q read ended before B overwrites it
    int total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += sums[k];
    build_b<kThreads>(tab, keep, grey_level(total, a.hw), a.contrast[img], threadIdx.x);
    __syncthreads();
    pass2<T>(a, img, src, words, tab, stage, warp, kWarps, lane);
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool warp_plan = a.hw <= kWarpPlanMaxPixels;
  const unsigned grid = warp_plan ? (unsigned)((a.n + kWarps - 1) / kWarps) : (unsigned)a.n;
  const int smem = warp_plan ? kWarps * warp_slot_bytes(a.hw) : kBlockPlanSmem;
  fused_augment_normalize_kernel<T><<<grid, kThreads, smem, stream>>>(a);
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
  const float mean[3] = {mean0, mean1, mean2}, sd[3] = {std0, std1, std2};
  Args a{static_cast<const uint8_t*>(x), static_cast<const float*>(bright),
         static_cast<const float*>(contrast), static_cast<const float*>(sat),
         static_cast<const float*>(gamma), static_cast<const float*>(sigma),
         static_cast<const long long*>(seed), out, n, hw, {}, {}};
  for (int c = 0; c < 3; ++c) {
    a.inv_std[c] = (float)(1.0 / (double)sd[c]);
    a.nbias[c] = (float)(-(double)mean[c] / (double)sd[c]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch<float>(a, st);
    case kBFloat16:
      return (int)launch<__nv_bfloat16>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
