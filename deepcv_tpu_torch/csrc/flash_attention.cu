// Flash attention for NVIDIA Hopper (sm_90a): the forward (K3) and the two
// backward kernels (K4: dQ, K5: dK and dV), with no mask and no dropout.
//
// Replaces the TPU kernels of deepcv_tpu/ops/attention.py:
//   K3 flash_fwd_kernel      <- _flash_kernel (called by _flash_fwd_impl)
//   K4 flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel (called by _flash_bwd_impl)
//   K5 flash_bwd_dkv_kernel  <- _flash_bwd_dkv_kernel (called by _flash_bwd_impl)
// q, k, v, o, dO, dQ, dK, dV are (B, T, Dh) row-major with B = batch * heads;
// lse and delta are (B, T) float32. The scale is 1/sqrt(Dh).
//
//   K3: s = (q * scale) k^T, o = softmax(s) v, lse = logsumexp(s) per row,
//       by the online-softmax recurrence over key tiles (running max m,
//       running sum l, f32 accumulator), so the (T, T) scores never exist.
//   K4: p = exp(q k^T * scale - lse), dS = p * (dO v^T - delta),
//       dQ = scale * dS k, over key tiles for a block of q rows.
//   K5: dV = p^T dO and dK = scale * dS^T q, over q tiles for a block of
//       key rows. delta = rowsum(dO * o) comes from the caller.
//
// What bounds them on an H100 SXM: each reads q, k, v (and dO, lse, delta)
// once and writes its outputs once, 4 (K3), 5 (K4) and 7 (K5) * B * T^2 * Dh
// FLOPs (the TPU kernels' cost estimates). ViT-B/16 (T = 197, Dh = 64) does
// ~100 FLOPs per byte, so the bound is the arithmetic rate: 989 TFLOP/s for
// bf16 on the tensor cores, 67 TFLOP/s for float32 outside them.
//
// This first design is simple and makes no claim on that bound. It runs on
// the CUDA cores in float32 whatever the input type:
//   - a block owns 64 rows (q rows for K3/K4, key rows for K5); each row is
//     shared by Dh/16 threads, each holding 16 of the row's dims in
//     registers as four float4 chunks interleaved across the threads (chunk
//     c = i * Dh/16 + g), so the shared-memory reads of a warp hit distinct
//     banks; dot products are summed across the row's threads with xor
//     shuffles inside aligned lane groups;
//   - the streamed operand (k and v, or q, dO, lse and delta) is staged in
//     shared memory one tile of 4096 / Dh rows at a time, widened to f32;
//   - T needs no padding in memory: tile loads past T read zeros, rows past
//     T are computed but never stored, and chunks of keys that lie wholly
//     past T are skipped. Inside a partial chunk, K3 gives the keys past T
//     the finite score -1e30 (never -inf, so no all-padding tile can make
//     exp(-inf - -inf) = NaN, as attention.py:95-100 explains); K4 and K5
//     set p = 0 for keys (K4) and q rows (K5) past T.
// The TPU kernels' 8-lane lse layout (a Mosaic tiling constraint) is not
// carried over: lse and delta are plain (B, T) float32. Tensor cores
// (wgmma), TMA and a pipelined producer/consumer split are what would close
// the gap to the bound; they come later.
//
// Plain C interface, no PyTorch headers: the wrappers in
// deepcv_tpu_torch/ops/kernels/flash_attention.py load the library with
// ctypes and pass device pointers, sizes and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;          // rows a block owns
constexpr int DPT = 16;           // head dims per thread
constexpr int TILE_ELEMS = 4096;  // f32 elements of one staged tile (16 KB)
constexpr float kMaskScore = -1e30f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// sum over the TPR consecutive lanes that share one row
template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// this thread's 16 dims of row `r` of a (rows, DH) matrix, f32; zeros when
// the row is not live
template <typename T, int DH>
__device__ __forceinline__ void load_row(float (&dst)[DPT], const T* __restrict__ src,
                                         long long r, bool live, int g, float mul) {
  constexpr int TPR = DH / DPT;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) x = load4(src + r * DH + (i * TPR + g) * 4);
    dst[4 * i + 0] = x.x * mul;
    dst[4 * i + 1] = x.y * mul;
    dst[4 * i + 2] = x.z * mul;
    dst[4 * i + 3] = x.w * mul;
  }
}

template <typename T, int DH>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const float (&src)[DPT],
                                          long long r, int g, float mul) {
  constexpr int TPR = DH / DPT;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    store4(dst + r * DH + (i * TPR + g) * 4,
           make_float4(src[4 * i] * mul, src[4 * i + 1] * mul, src[4 * i + 2] * mul,
                       src[4 * i + 3] * mul));
  }
}

// partial dot product of this thread's 16 dims with row `j` of a staged tile
template <int DH>
__device__ __forceinline__ float dot_tile(const float (&a)[DPT], const float* __restrict__ tile,
                                          int j, int g) {
  constexpr int TPR = DH / DPT;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 b = smem4(tile + j * DH + (i * TPR + g) * 4);
    s = fmaf(a[4 * i], b.x, s);
    s = fmaf(a[4 * i + 1], b.y, s);
    s = fmaf(a[4 * i + 2], b.z, s);
    s = fmaf(a[4 * i + 3], b.w, s);
  }
  return s;
}

// acc += w * row `j` of a staged tile (this thread's 16 dims)
template <int DH>
__device__ __forceinline__ void axpy_tile(float (&acc)[DPT], float w, const float* __restrict__ tile,
                                          int j, int g) {
  constexpr int TPR = DH / DPT;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 b = smem4(tile + j * DH + (i * TPR + g) * 4);
    acc[4 * i] = fmaf(w, b.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, b.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, b.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, b.w, acc[4 * i + 3]);
  }
}

// rows [r0, r0 + nrows) of a (t_len, DH) matrix into shared memory as f32;
// rows at or past t_len read as zeros
template <typename T, int DH, int NT>
__device__ __forceinline__ void stage_tile(float* __restrict__ dst, const T* __restrict__ src,
                                           int r0, int nrows, int t_len, int tid) {
  constexpr int C4 = DH / 4;
  for (int c = tid; c < nrows * C4; c += NT) {
    const int r = c / C4, k4 = c - r * C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t_len) x = load4(src + (long long)(r0 + r) * DH + k4 * 4);
    store4(dst + r * DH + k4 * 4, x);
  }
}

// ---------------------------------------------------------------- K3 ---- //
template <typename T, int DH>
__global__ void __launch_bounds__(ROWS * (DH / DPT))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t_len, float scale) {
  constexpr int TPR = DH / DPT;
  constexpr int NT = ROWS * TPR;
  constexpr int BK = TILE_ELEMS / DH;
  constexpr int CH = 16;  // keys per online-softmax step
  __shared__ __align__(16) float ks[BK * DH];
  __shared__ __align__(16) float vs[BK * DH];

  const int tid = threadIdx.x, g = tid % TPR;
  const long long bh = blockIdx.x;
  const int qi = blockIdx.y * ROWS + tid / TPR;
  const bool live = qi < t_len;
  const long long base = bh * t_len * DH;

  float qr[DPT], acc[DPT];
  load_row<T, DH>(qr, q + base, qi, live, g, scale);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();
    stage_tile<T, DH, NT>(ks, k + base, k0, BK, t_len, tid);
    stage_tile<T, DH, NT>(vs, v + base, k0, BK, t_len, tid);
    __syncthreads();
    for (int j0 = 0; j0 < BK && k0 + j0 < t_len; j0 += CH) {
      float s[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) s[j] = dot_tile<DH>(qr, ks, j0 + j, g);
      float mc = m;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        s[j] = group_sum<TPR>(s[j]);
        if (k0 + j0 + j >= t_len) s[j] = kMaskScore;
        mc = fmaxf(mc, s[j]);
      }
      const float alpha = expf(m - mc);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = expf(s[j] - mc);
        l += p;
        axpy_tile<DH>(acc, p, vs, j0 + j, g);
      }
      m = mc;
    }
  }
  if (live) {
    store_row<T, DH>(o + base, acc, qi, g, 1.f / l);
    if (g == 0) lse[bh * t_len + qi] = m + logf(l);
  }
}

// ---------------------------------------------------------------- K4 ---- //
template <typename T, int DH>
__global__ void __launch_bounds__(ROWS * (DH / DPT))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int t_len,
                    float scale) {
  constexpr int TPR = DH / DPT;
  constexpr int NT = ROWS * TPR;
  constexpr int BK = TILE_ELEMS / DH;
  constexpr int CH = 8;
  __shared__ __align__(16) float ks[BK * DH];
  __shared__ __align__(16) float vs[BK * DH];

  const int tid = threadIdx.x, g = tid % TPR;
  const long long bh = blockIdx.x;
  const int qi = blockIdx.y * ROWS + tid / TPR;
  const bool live = qi < t_len;
  const long long base = bh * t_len * DH;

  float qr[DPT], dor[DPT], acc[DPT];
  load_row<T, DH>(qr, q + base, qi, live, g, 1.f);
  load_row<T, DH>(dor, dout + base, qi, live, g, 1.f);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  const float lse_i = live ? lse[bh * t_len + qi] : 0.f;
  const float delta_i = live ? delta[bh * t_len + qi] : 0.f;

  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();
    stage_tile<T, DH, NT>(ks, k + base, k0, BK, t_len, tid);
    stage_tile<T, DH, NT>(vs, v + base, k0, BK, t_len, tid);
    __syncthreads();
    for (int j0 = 0; j0 < BK && k0 + j0 < t_len; j0 += CH) {
      float s[CH], dp[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        s[j] = dot_tile<DH>(qr, ks, j0 + j, g);
        dp[j] = dot_tile<DH>(dor, vs, j0 + j, g);
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float sj = group_sum<TPR>(s[j]);
        const float dpj = group_sum<TPR>(dp[j]);
        const float p = k0 + j0 + j < t_len ? expf(sj * scale - lse_i) : 0.f;
        axpy_tile<DH>(acc, p * (dpj - delta_i), ks, j0 + j, g);
      }
    }
  }
  if (live) store_row<T, DH>(dq + base, acc, qi, g, scale);
}

// ---------------------------------------------------------------- K5 ---- //
template <typename T, int DH>
__global__ void __launch_bounds__(ROWS * (DH / DPT))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int t_len, float scale) {
  constexpr int TPR = DH / DPT;
  constexpr int NT = ROWS * TPR;
  constexpr int BQ = TILE_ELEMS / DH;
  constexpr int CH = 8;
  __shared__ __align__(16) float qs[BQ * DH];
  __shared__ __align__(16) float dos[BQ * DH];
  __shared__ float lses[BQ];
  __shared__ float dels[BQ];

  const int tid = threadIdx.x, g = tid % TPR;
  const long long bh = blockIdx.x;
  const int kj = blockIdx.y * ROWS + tid / TPR;
  const bool live = kj < t_len;
  const long long base = bh * t_len * DH;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  load_row<T, DH>(kr, k + base, kj, live, g, 1.f);
  load_row<T, DH>(vr, v + base, kj, live, g, 1.f);
#pragma unroll
  for (int d = 0; d < DPT; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < t_len; q0 += BQ) {
    __syncthreads();
    stage_tile<T, DH, NT>(qs, q + base, q0, BQ, t_len, tid);
    stage_tile<T, DH, NT>(dos, dout + base, q0, BQ, t_len, tid);
    for (int c = tid; c < BQ; c += NT) {
      const bool in = q0 + c < t_len;
      lses[c] = in ? lse[bh * t_len + q0 + c] : 0.f;
      dels[c] = in ? delta[bh * t_len + q0 + c] : 0.f;
    }
    __syncthreads();
    for (int i0 = 0; i0 < BQ && q0 + i0 < t_len; i0 += CH) {
      float s[CH], dp[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        s[i] = dot_tile<DH>(kr, qs, i0 + i, g);
        dp[i] = dot_tile<DH>(vr, dos, i0 + i, g);
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float si = group_sum<TPR>(s[i]);
        const float dpi = group_sum<TPR>(dp[i]);
        const float p = q0 + i0 + i < t_len ? expf(si * scale - lses[i0 + i]) : 0.f;
        axpy_tile<DH>(dva, p, dos, i0 + i, g);
        axpy_tile<DH>(dka, p * (dpi - dels[i0 + i]), qs, i0 + i, g);
      }
    }
  }
  if (live) {
    store_row<T, DH>(dk + base, dka, kj, g, scale);
    store_row<T, DH>(dv + base, dva, kj, g, 1.f);
  }
}

// ------------------------------------------------------------ launch ---- //
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int bh, t_len;
  float scale;
};

template <typename T, int DH>
cudaError_t launch(int which, const Args& a, cudaStream_t st) {
  const dim3 grid((unsigned)a.bh, (unsigned)((a.t_len + ROWS - 1) / ROWS));
  const dim3 block(ROWS * (DH / DPT));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if (which == 0) {
    flash_fwd_kernel<T, DH><<<grid, block, 0, st>>>(
        q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.lse_out), a.t_len, a.scale);
  } else if (which == 1) {
    flash_bwd_dq_kernel<T, DH><<<grid, block, 0, st>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.t_len, a.scale);
  } else {
    flash_bwd_dkv_kernel<T, DH><<<grid, block, 0, st>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.t_len, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int which, int dh, const Args& a, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(which, a, st);
    case 32: return launch<T, 32>(which, a, st);
    case 64: return launch<T, 64>(which, a, st);
    case 128: return launch<T, 128>(which, a, st);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, int dh, int dtype, const Args& a, void* stream) {
  if (a.bh < 0 || a.t_len < 0 || (a.t_len + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.bh == 0 || a.t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return (int)dispatch_dh<float>(which, dh, a, st);
    case kBFloat16: return (int)dispatch_dh<__nv_bfloat16>(which, dh, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns the CUDA error of its launch (0 on success) and launches
// nothing for an empty input. Pointers are device pointers to contiguous
// tensors; dh is 16, 32, 64 or 128.

// K3: o (B, T, Dh) in the input type and lse (B, T) float32
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int bh, int t_len, int dh,
                                          float scale, int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         bh, t_len, scale};
  return run(0, dh, dtype, a, stream);
}

// K4: dq (B, T, Dh)
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int bh, int t_len,
                                             int dh, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         bh, t_len, scale};
  return run(1, dh, dtype, a, stream);
}

// K5: dk and dv (B, T, Dh)
extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int bh,
                                              int t_len, int dh, float scale, int dtype,
                                              void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
         bh, t_len, scale};
  return run(2, dh, dtype, a, stream);
}
