// Flash attention for NVIDIA Hopper (sm_90a): the forward (K3) and the two
// backward kernels (K4: dQ, K5: dK and dV), with no mask and no dropout.
// Every kernel runs on the tensor cores: bf16 by mma.sync m16n8k16, f32 by
// 3xTF32 on mma.sync m16n8k8.
//
// Replaces the TPU kernels of deepcv_tpu/ops/attention.py:
//   K3 flash_fwd_f32tc_kernel (f32),
//      flash_fwd_tc_kernel (bf16)         <- _flash_kernel (called by _flash_fwd_impl)
//   K4 flash_bwd_dq_f32tc_kernel (f32),
//      flash_bwd_dq_tc_kernel (bf16)      <- _flash_bwd_dq_kernel (called by _flash_bwd_impl)
//   K5 flash_bwd_dkv_f32tc_kernel (f32),
//      flash_bwd_dkv_tc_kernel (bf16)     <- _flash_bwd_dkv_kernel (called by _flash_bwd_impl)
// q, k, v, o, dO, dQ, dK, dV are (B, T, Dh) row-major with B = batch * heads;
// lse and delta are (B, T) float32. The scale is 1/sqrt(Dh). Every kernel is
// instantiated for each head dim in HEAD_DIMS (16, 32, 64, 80, 128; 80 is
// ViT-H/14's 1280 / 16).
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
// ~100 FLOPs per byte: in bf16 (989 TFLOP/s) the bound is the bytes, about
// 295 FLOPs per byte being the card's balance point; in f32 by 3xTF32
// (three products per FLOP at 494.7 TFLOP/s) the two bounds meet.
//
// K3 on bfloat16 inputs: flash_fwd_tc_kernel.
//   Bound at ViT's training shape (B = 256 * 12, T = 197, Dh = 64): 310 MB
//   read and written, 0.093 ms at 3.35 TB/s, against 30.5 GFLOP, 0.031 ms at
//   989 TFLOP/s: bytes. So the design reads each operand once from device
//   memory and keeps the scores in registers:
//   - a block of 4 warps owns 64 q rows, a warp 16 (one m16 tile); the grid
//     is 1-D over (head, q-block) with a head's q-blocks adjacent, so they
//     read the head's K and V from L2 rather than device memory; a warp
//     whose 16 rows all lie past T does no arithmetic (it still loads and
//     meets the block's barriers);
//   - K and V stream in 64-key tiles into shared memory by cp.async (16 B a
//     thread, zero-fill past T), two stages, so the next tile loads while
//     this one computes; rows are padded by 16 B so the 8 rows of one
//     ldmatrix fall in distinct banks;
//   - S = Q K^T and O += P V by mma.sync m16n8k16 bf16 -> f32: Q's
//     fragments stay in registers for the whole loop, K comes by ldmatrix, V
//     by ldmatrix.trans, and P goes from the S accumulator straight into A
//     fragments (bf16x2 pairs); the row max and sum reduce over the 4 lanes
//     of a quad;
//   - numerics: S, m, l and O in f32; the scale is applied to the f32
//     scores (folded with log2(e) into exp2f's argument; q * scale is never
//     rounded to bf16); only P is rounded to bf16 before P V, l sums the f32
//     p; keys past T inside a computed n8 fragment get the finite score
//     -1e30 (an all-padding tile must not give exp(-inf - -inf) = NaN, as
//     attention.py:95-100 explains), and fragments wholly past T are not
//     computed;
//   - every head dim in HEAD_DIMS is an instantiation (80: five k16 steps
//     and five 16-column ldmatrix.x4 groups; its 88-element, 176-byte row
//     stride puts an ldmatrix's 8 rows in distinct 16-byte bank groups, as
//     the 16-byte padding does at every Dh); the buffers are dynamic shared
//     memory (55 KB at Dh = 80, 87 KB at 128, set by cudaFuncSetAttribute
//     in the launcher).
//   mma.sync and not wgmma: the shape is bound by bytes, and mma.sync's
//   peak (roughly half of wgmma's) is still some 10 times what the bytes
//   allow here; wgmma, TMA and warp specialisation are for a later design,
//   if this one ends far from its bound.
//
// K3 on float32 inputs: flash_fwd_f32tc_kernel, by 3xTF32.
//   Arithmetic: mma.sync m16n8k8 tf32 -> f32. Every f32 operand x is split
//   into hi = rna(x) and lo = rna(x - hi), rna being cvt.rna.tf32.f32's
//   rounding done in integer operations (x - hi is exact; handing the mma
//   raw f32 bits would truncate instead of round), and each
//   product is lo*hi + hi*lo + hi*hi, accumulated in f32; lo*lo, about
//   2^-22 relative, is dropped. So S = Q K^T and O += P V (P split as well)
//   keep f32 accuracy (within 2e-5 of the f32 plain version), where one
//   TF32 product (10 mantissa bits) would not. This is the kernel's own
//   arithmetic: torch.backends.cuda.matmul.allow_tf32, which governs cuBLAS,
//   does not reach it.
//   Bound at ViT-B/16's serving shape (B = 64 * 12, T = 197, Dh = 64): 155.5
//   MB read and written, 0.046 ms at 3.35 TB/s, against 3 * 7.6 GFLOP of
//   TF32 products, 0.046 ms at 494.7 TFLOP/s: the two agree, so the design
//   reads every operand once and keeps the three products on the tensor
//   cores. K3's bf16 plumbing carries over:
//   - a block of 4 warps owns 64 q rows, a warp one m16 tile; the same 1-D
//     grid over (head, q-block), a head's blocks adjacent (K and V from L2);
//   - K and V stream in 32-key tiles by cp.async (16 B = 4 floats, zero-fill
//     past T), two stages: 53 KB of shared memory at Dh = 64, so 4 blocks
//     (16 warps) share an SM, 3 at Dh = 80 and 2 at 128;
//   - there is no ldmatrix for 32-bit operands, so fragments are read from
//     padded rows: Q and K (stride Dh + 8 floats) by 8-byte loads, with the
//     head-dim index of Q K^T permuted (mma k t <- dim 2t, k t + 4 <- dim
//     2t + 1 of each 8) so that a lane's two A and two B values are adjacent;
//     V (stride Dh + 4) by 4-byte loads of rows 2t and 2t + 1. Half a warp's
//     8-byte loads fall in rows 8g apart mod 32 banks and a warp's V loads
//     in 8t + g: no bank conflict at any head dim;
//   - P's A fragment is the S accumulator, with the key index of P V
//     permuted the same way (a0 = c0, a1 = c2, a2 = c1, a3 = c3: mma k t <-
//     key 2t, k t + 4 <- key 2t + 1) and V's B fragment read from keys 2t
//     and 2t + 1 to match: no shuffle, no shared memory;
//   - Q's fragments are read from shared memory and split once per key tile
//     (per k8 step, then used by the tile's 4 key fragments), and K's and V's
//     after each load: no register holds Q for the whole loop, which keeps
//     Dh = 128 out of spills;
//   - the online softmax runs in f32 on raw scores, the scale folded with
//     log2(e) into exp2f's FMA; keys past T inside a computed n8 fragment get
//     the finite score -1e30 and P = 0 by a select after exp2f; fragments
//     wholly past T are not computed.
//   mma.sync and not wgmma: the kernel's first tensor-core design. Its
//   three TF32 mmas per product, not the bytes, hold it from the bound;
//   wgmma's tf32 form (m64nNk8) is the way past them.
//
// K4 and K5 on bfloat16 inputs: flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel, with K3's plumbing.
//   Bound at ViT's training shape: bytes, 392 MB (K4) and 470 MB (K5) read
//   and written, 0.117 and 0.140 ms at 3.35 TB/s, against 38 and 53 GFLOP,
//   0.039 and 0.054 ms at 989 TFLOP/s. So again every operand is read once
//   from device memory and P, dP and dS live only in registers:
//   - K4 (dQ): a block of 4 warps owns 64 q rows, a warp 16; Q's and dO's A
//     fragments, and the rows' lse * log2(e) and delta, stay in registers;
//     K and V stream in 64-key tiles (cp.async, two stages, zero-fill past
//     T, rows padded by 16 B). Per 16 keys: S = Q K^T and dP = dO V^T (K and
//     V by ldmatrix), P = exp2(S * scale * log2(e) - lse * log2(e)),
//     dS = P (dP - delta), then dQ += dS K (K by ldmatrix.trans) with dS
//     packed from the accumulators into A fragments; dQ * scale written
//     once. K5 (dK, dV): a block owns 64 key rows; K's and V's A fragments
//     stay in registers; Q, dO and the tile's lse and delta stream in
//     64-row tiles. Per 16 q rows: S^T = K Q^T, dP^T = V dO^T (Q and dO by
//     ldmatrix), P^T with lse per column, dS^T, then dV += P^T dO and
//     dK += dS^T Q (dO and Q by ldmatrix.trans); dK * scale and dV written
//     once. Both grids are 1-D over (head, row block), a head's blocks
//     adjacent, so the streamed operands come from L2.
//   - The tile is walked 16 rows (K4: keys, K5: q rows) at a time, one k16
//     step of the second products, rather than a whole 64-row tile of S and
//     dP at once: 16 accumulator registers live instead of 64, which keeps
//     K4 at 4 blocks per SM (16 warps) at Dh <= 64.
//   - numerics (FlashAttention-2's): S, dP, P, dS and the dQ, dK, dV
//     accumulators in f32; only P and dS are rounded to bf16, and only as
//     A operands of the second products; the scale is folded into exp2f's
//     FMA on the raw f32 scores. P = 0 for keys past T (K4) and q rows
//     past T (K5), by a select after exp2f, and whole n8 fragments past T
//     are not computed. Zero-filled rows make V and dO NaN-free. Rows that
//     a block owns past T (lse and delta read as 0 in K4) compute finite or
//     unused values that never reach memory: an mma's output row depends on
//     its A row alone; a warp whose 16 rows all lie past T does no
//     arithmetic but loads and meets every barrier.
//   - shared memory: K4 holds its Q and dO rows plus two stages of K and V
//     (55 KB at Dh = 64, 66 KB at 80, 104 KB at 128), K5 the mirror plus two stages of
//     lse and delta (1 KB more): dynamic, as K3's.
//
// K4 and K5 on float32 inputs: flash_bwd_dq_f32tc_kernel and
// flash_bwd_dkv_f32tc_kernel, by K3 f32's 3xTF32 in K4 and K5 bf16's
// structure.
//   Bound at ViT-B/16's serving shape (B = 64 * 12, T = 197, Dh = 64), per
//   launch: K4 moves 195 MB, 0.058 ms at 3.35 TB/s, against 3 * 9.5 GFLOP
//   of TF32 products, 0.058 ms at 494.7 TFLOP/s; K5 234 MB, 0.070 ms,
//   against 3 * 13.4 GFLOP, 0.081 ms: operations, just. (On the CUDA cores
//   the same f32 work would be bound at 0.142 and 0.199 ms by 67 TFLOP/s.)
//   So, as in K3 f32, every operand is read once and the products stay on
//   the tensor cores:
//   - a block of 4 warps owns 64 rows (K4: q rows, K5: key rows), a warp 16;
//     the rows' lse * log2(e) and delta (K4) stay in registers; the streamed
//     operands (K4: K, V; K5: Q, dO and the tile's lse and delta) come in
//     32-row tiles by cp.async, two stages, zero-fill past T; the same 1-D
//     grid over (head, row block), a head's blocks adjacent;
//   - each 32-row tile is walked 16 rows at a time: S and dP (K5: S^T, dP^T)
//     of 16 x 16, then P = exp2(S * scale * log2(e) - lse * log2(e)) in one
//     FMA, dS = P (dP - delta), P = 0 by a select for keys (K4) or q rows
//     (K5) past T; then the second products one k8 step per n8 fragment:
//     dQ += dS K, and dV += P^T dO, dK += dS^T Q, whose A fragments are the
//     S and dP accumulators with K3 f32's permutation (a0 = c0, a1 = c2,
//     a2 = c1, a3 = c3) and whose B fragments are read from rows 2t and
//     2t + 1 of the tile at head dim g to match;
//   - the first products read A (K4: Q, dO; K5: K, V) and B (the tile's
//     rows) by 8-byte loads with the head dim permuted as K3 f32's Q K^T;
//   - the one hard part of the layout: the streamed tile is read both ways,
//     8-byte loads of rows g and 4-byte loads of rows 2t and 2t + 1. A row
//     stride of Dh + 8 floats suits the first and puts rows 0 and 4 on the
//     same banks for the second; Dh + 4 the reverse. So every tile has
//     stride Dh + 8 and stores rows 4-7 of each 8 with their 8-column groups
//     swapped in pairs (column d at d ^ 8), set as cp.async writes the rows:
//     both reads are then free of bank conflicts at every head dim, and
//     each lane's swizzle is one of two constants;
//   - registers: K5 holds dK and dV, Dh floats a lane (64 at Dh = 64). The
//     resident operand's A fragments (K4: Q, dO; K5: K, V) are therefore
//     read from shared memory and split at every 16-row step, as K3 f32
//     reads Q, and not held across the loop; 16 rows of S and dP live at a
//     time. The register cap follows the blocks an SM that shared memory
//     allows (72 KB at Dh = 64: 3, 168 registers; 88 KB at 80: 2);
//   - numerics: in every product (S and dP over the head dim; dQ, dK and
//     dV over T rows, 197 at ViT-B/16 and 1,024 in chip_smoke.py) each k8
//     step's three products sum from zero and an FADD adds them to the f32
//     accumulator (K2 f32's lesson at K = 4,608): the tensor cores' own sums
//     round toward zero. Chaining the products in the accumulator, as K3
//     f32 does, was 11 % faster but 4e-6 from the plain version at ViT's
//     shape (1.4e-5 at T = 1,024) against 1.2e-6 (2.4e-6), and its scores
//     drift: with scores of standard deviation 64 (and the caller's lse),
//     dV was 1.5e-4 from a float64 reference, the plain version 2e-5. dQ * scale,
//     dK * scale and dV are written once.
//   mma.sync and not wgmma, as in K3 f32: three TF32 mmas per product, and
//   here two products per score, not the bytes, hold them from the bound.
//
// The TPU kernels' 8-lane lse layout (a Mosaic tiling constraint) is not
// carried over: lse and delta are plain (B, T) float32.
//
// Plain C interface, no PyTorch headers: the wrappers in
// deepcv_tpu_torch/ops/kernels/flash_attention.py load the library with
// ctypes and pass device pointers, sizes and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 64;  // rows a block owns
constexpr float kMaskScore = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// ------------------------------------------------- K3, bf16, tensor cores //
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BK = 64;  // keys per tile

// shared-memory layout of flash_fwd_tc_kernel: the block's Q rows, then two
// stages of K and V tiles; rows padded by 8 elements (16 B)
template <int DH>
struct TcLayout {
  static constexpr int LD = DH + 8;
  static constexpr int Q = ROWS * LD;
  static constexpr int TILE = TC_BK * LD;
  static constexpr int BYTES = (Q + 4 * TILE) * (int)sizeof(__nv_bfloat16);
  // blocks per SM the registers must leave room for: shared memory allows 4
  // up to Dh = 80 (46 KB each at 64, 55 KB at 80) and 2 at Dh = 128 (87 KB);
  // asking for 4 at Dh = 128 would cap it at 128 registers and spill, and at
  // Dh = 80 (O and Q's fragments 25 % larger than at 64) 3 keeps 168
  static constexpr int MIN_BLOCKS = DH <= 64 ? 4 : DH <= 80 ? 3 : 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [r0, r0 + nrows) of a (t_len, DH) matrix into shared memory with row
// stride DH + 8, by cp.async; rows at or past t_len are zero-filled
template <int DH, int NROWS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                        int r0, int t_len, int tid) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  constexpr int LD = DH + 8;
  static_assert((NROWS * CPR) % TC_THREADS == 0, "chunks must split evenly");
#pragma unroll
  for (int i = 0; i < NROWS * CPR / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int r = c / CPR, ch = c % CPR;
    const bool in = r0 + r < t_len;
    cp_async16(dst + r * LD + ch * 8, src + (long long)(in ? r0 + r : 0) * DH + ch * 8, in);
  }
}

// Lane l of a warp holds, in an m16n8 accumulator, rows g = l / 4 and g + 8
// and columns 2c, 2c + 1 with c = l % 4 ([0..1] row g, [2..3] row g + 8).
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, TcLayout<DH>::MIN_BLOCKS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int t_len, int n_qblocks, float scale) {
  using L = TcLayout<DH>;
  constexpr int LD = L::LD;
  constexpr int KS = DH / 16;    // k16 steps over the head dim
  constexpr int NK = TC_BK / 8;  // n8 key fragments of a tile
  constexpr int ND = DH / 8;     // n8 head-dim fragments of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + L::Q;
  __nv_bfloat16* vs = ks + 2 * L::TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x / n_qblocks;
  const int q0 = (int)(blockIdx.x % n_qblocks) * ROWS;
  const long long base = bh * t_len * DH;
  const int n_tiles = (t_len + TC_BK - 1) / TC_BK;
  const bool live = q0 + warp * 16 < t_len;
  // scores are raw q.k in f32; p = 2^((s - m) * scale * log2(e))
  const float sl2 = scale * kLog2e;

  cp_rows<DH, ROWS>(qs, q + base, q0, t_len, tid);
  cp_async_commit();
  cp_rows<DH, TC_BK>(ks, k + base, 0, t_len, tid);
  cp_rows<DH, TC_BK>(vs, v + base, 0, t_len, tid);
  cp_async_commit();

  // ldmatrix row addresses: lane l supplies row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;
  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      cp_rows<DH, TC_BK>(ks + nxt * L::TILE, k + base, (t + 1) * TC_BK, t_len, tid);
      cp_rows<DH, TC_BK>(vs + nxt * L::TILE, v + base, (t + 1) * TC_BK, t_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (t == 0) {
        // Q's A fragments: matrices (rows 0-7 | 8-15) x (dims 0-7 | 8-15)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], qs + (warp * 16 + mr + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8);
      }
      const __nv_bfloat16* kt = ks + (t & 1) * L::TILE;
      const __nv_bfloat16* vt = vs + (t & 1) * L::TILE;
      const int nlive = t_len - t * TC_BK;  // keys of this tile before T (>= 1)

      // S = Q K^T over this tile's key fragments that hold a key before T
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NK / 2; ++jj) {
        if (jj * 16 >= nlive) break;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          // matrices: keys (0-7 | 8-15) x dims (0-7 | 8-15) of this group
          uint32_t b[4];
          ldmatrix_x4(b, kt + (jj * 16 + mr + (mi >> 1) * 8) * LD + kk * 16 + (mi & 1) * 8);
          mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
          if (jj * 16 + 8 < nlive) mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
        }
      }
      if (nlive < TC_BK) {
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int key = j * 8 + 2 * c;
          if (key >= nlive) s[j][0] = s[j][2] = kMaskScore;
          if (key + 1 >= nlive) s[j][1] = s[j][3] = kMaskScore;
        }
      }

      // online softmax: new running max, rescale, p in f32
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = exp2f((m0 - mx0) * sl2), a1 = exp2f((m1 - mx1) * sl2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * sl2, mb1 = mx1 * sl2;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][0] = exp2f(fmaf(s[j][0], sl2, -mb0));
        s[j][1] = exp2f(fmaf(s[j][1], sl2, -mb0));
        s[j][2] = exp2f(fmaf(s[j][2], sl2, -mb1));
        s[j][3] = exp2f(fmaf(s[j][3], sl2, -mb1));
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }

      // O += P V over 16-key steps that hold a key before T; P's A fragment
      // for keys 16kk.. is the S accumulators of fragments 2kk and 2kk + 1
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        if (kk * 16 >= nlive) break;
        const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND / 2; ++n) {
          // matrices: keys (0-7 | 8-15) x dims (0-7 | 8-15), transposed
          uint32_t b[4];
          ldmatrix_x4_trans(b, vt + (kk * 16 + mr + (mi & 1) * 8) * LD + n * 16 + (mi >> 1) * 8);
          mma_bf16(acc[2 * n], pa, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage read here is the one the next tile fills
  }
  if (!live) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (long long)r0 * DH + d) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (long long)r1 * DH + d) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (c == 0) {
    if (r0 < t_len) lse[bh * t_len + r0] = m0 * scale + logf(l0);
    if (r1 < t_len) lse[bh * t_len + r1] = m1 * scale + logf(l1);
  }
}

// ------------------------------------------------ K3, f32, tensor cores //
constexpr int F32_BK = 32;  // rows of a streamed f32 tile (K3, K4: keys; K5: q rows)

// shared-memory layout of flash_fwd_f32tc_kernel: the block's Q rows, then
// two stages of K tiles and two of V tiles, f32; Q and K rows padded by 8
// floats (8-byte fragment loads), V rows by 4 (4-byte loads)
template <int DH>
struct F32TcLayout {
  static constexpr int LDK = DH + 8;
  static constexpr int LDV = DH + 4;
  static constexpr int Q = ROWS * LDK;
  static constexpr int KT = F32_BK * LDK;
  static constexpr int VT = F32_BK * LDV;
  static constexpr int BYTES = (Q + 2 * KT + 2 * VT) * (int)sizeof(float);
  // blocks per SM that shared memory allows (53 KB at Dh = 64, 65 KB at 80,
  // 101 KB at 128), which the registers must leave room for
  static constexpr int MIN_BLOCKS = DH <= 64 ? 4 : DH <= 80 ? 3 : 2;
};

// rows [r0, r0 + NROWS) of a (t_len, DH) f32 matrix into shared memory with
// row stride LD, by cp.async; rows at or past t_len are zero-filled
template <int DH, int NROWS, int LD>
__device__ __forceinline__ void cp_rows_f32(float* dst, const float* __restrict__ src, int r0,
                                            int t_len, int tid) {
  constexpr int CPR = DH / 4;  // 16-byte chunks per row
  static_assert((NROWS * CPR) % TC_THREADS == 0, "chunks must split evenly");
#pragma unroll
  for (int i = 0; i < NROWS * CPR / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int r = c / CPR, ch = c % CPR;
    const bool in = r0 + r < t_len;
    cp_async16(dst + r * LD + ch * 4, src + (long long)(in ? r0 + r : 0) * DH + ch * 4, in);
  }
}

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero: the
// rounding of cvt.rna.tf32.f32, by adding half a tf32 ulp to the magnitude
// bits and clearing the 13 low ones (it equals cvt.rna on every finite float
// and on the infinities; ptxas expands cvt.rna into a longer sequence of
// compares and selects)
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

// d += a b at f32 accuracy (3xTF32): the small products first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// K3 on f32. In an m16n8k8 tf32 mma, lane l (g = l / 4, c = l % 4) holds A
// at (row g | g + 8, k c | c + 4) as a0 (g, c), a1 (g + 8, c), a2 (g, c + 4),
// a3 (g + 8, c + 4); B at (k c | c + 4, n g); the accumulator at rows g,
// g + 8 and columns 2c, 2c + 1 ([0..1] row g, [2..3] row g + 8). The k index
// is permuted in both products (k c <- 2c, k c + 4 <- 2c + 1 of each 8), so
// a lane's A and B values are adjacent dims of Q and K and its S
// accumulator is already P's A fragment.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, F32TcLayout<DH>::MIN_BLOCKS)
flash_fwd_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int t_len, int n_qblocks, float scale) {
  using L = F32TcLayout<DH>;
  constexpr int LDK = L::LDK, LDV = L::LDV;
  constexpr int KS = DH / 8;      // k8 steps over the head dim
  constexpr int NK = F32_BK / 8;  // n8 key fragments of a tile (k8 steps of P V)
  constexpr int ND = DH / 8;      // n8 head-dim fragments of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + L::Q;
  float* vs = ks + 2 * L::KT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x / n_qblocks;
  const int q0 = (int)(blockIdx.x % n_qblocks) * ROWS;
  const long long base = bh * t_len * DH;
  const int n_tiles = (t_len + F32_BK - 1) / F32_BK;
  const bool live = q0 + warp * 16 < t_len;
  // scores are raw q.k in f32; p = 2^((s - m) * scale * log2(e))
  const float sl2 = scale * kLog2e;

  cp_rows_f32<DH, ROWS, LDK>(qs, q + base, q0, t_len, tid);
  cp_rows_f32<DH, F32_BK, LDK>(ks, k + base, 0, t_len, tid);
  cp_rows_f32<DH, F32_BK, LDV>(vs, v + base, 0, t_len, tid);
  cp_async_commit();

  // this lane's Q rows g and g + 8 of the warp's tile, dims 2c and 2c + 1
  // of each k8 step
  const float* qw = qs + (warp * 16 + g) * LDK + 2 * c;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      cp_rows_f32<DH, F32_BK, LDK>(ks + nxt * L::KT, k + base, (t + 1) * F32_BK, t_len, tid);
      cp_rows_f32<DH, F32_BK, LDV>(vs + nxt * L::VT, v + base, (t + 1) * F32_BK, t_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* kt = ks + (t & 1) * L::KT;
      const float* vt = vs + (t & 1) * L::VT;
      const int nlive = t_len - t * F32_BK;  // keys of this tile before T (>= 1)

      // S = Q K^T over this tile's key fragments that hold a key before T;
      // Q's A fragment read and split once per k8 step for all of them
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(qw + kk * 8);
        const float2 x1 = *reinterpret_cast<const float2*>(qw + 8 * LDK + kk * 8);
        uint32_t ah[4], al[4];
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          if (j * 8 >= nlive) break;
          // key j * 8 + g, dims 2c and 2c + 1 of this k8 step
          const float2 y = *reinterpret_cast<const float2*>(kt + (j * 8 + g) * LDK + kk * 8 + 2 * c);
          uint32_t bh2[2], bl2[2];
          split_tf32(y.x, bh2[0], bl2[0]);
          split_tf32(y.y, bh2[1], bl2[1]);
          mma_3xtf32(s[j], ah, al, bh2, bl2);
        }
      }
      if (nlive < F32_BK) {
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int key = j * 8 + 2 * c;
          if (key >= nlive) s[j][0] = s[j][2] = kMaskScore;
          if (key + 1 >= nlive) s[j][1] = s[j][3] = kMaskScore;
        }
      }

      // online softmax: new running max, rescale, p in f32
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = exp2f((m0 - mx0) * sl2), a1 = exp2f((m1 - mx1) * sl2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * sl2, mb1 = mx1 * sl2;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int key = j * 8 + 2 * c;
        s[j][0] = key < nlive ? exp2f(fmaf(s[j][0], sl2, -mb0)) : 0.f;
        s[j][1] = key + 1 < nlive ? exp2f(fmaf(s[j][1], sl2, -mb0)) : 0.f;
        s[j][2] = key < nlive ? exp2f(fmaf(s[j][2], sl2, -mb1)) : 0.f;
        s[j][3] = key + 1 < nlive ? exp2f(fmaf(s[j][3], sl2, -mb1)) : 0.f;
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }

      // O += P V over the k8 steps that hold a key before T: P's A fragment
      // is S accumulator j (a0 = c0, a1 = c2, a2 = c1, a3 = c3: k c <- key
      // 2c, k c + 4 <- key 2c + 1), V's B fragment keys 2c and 2c + 1 at dim g
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (j * 8 >= nlive) break;
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* v0 = vt + (j * 8 + 2 * c) * LDV + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh2[2], bl2[2];
          split_tf32(v0[n * 8], bh2[0], bl2[0]);
          split_tf32(v0[LDV + n * 8], bh2[1], bl2[1]);
          mma_3xtf32(acc[n], ph, pl, bh2, bl2);
        }
      }
    }
    __syncthreads();  // the stage read here is the one the next tile fills
  }
  if (!live) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < t_len)
      *reinterpret_cast<float2*>(o + base + (long long)r0 * DH + d) =
          make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < t_len)
      *reinterpret_cast<float2*>(o + base + (long long)r1 * DH + d) =
          make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (c == 0) {
    if (r0 < t_len) lse[bh * t_len + r0] = m0 * scale + logf(l0);
    if (r1 < t_len) lse[bh * t_len + r1] = m1 * scale + logf(l1);
  }
}

// ------------------------------------------- K4 and K5, bf16, tensor cores //
// shared-memory layout of the two backward kernels: the 64 rows a block owns
// of two operands (K4: Q, dO; K5: K, V), then two stages of 64-row tiles of
// the two it streams (K4: K, V; K5: Q, dO), rows padded by 8 elements; K5
// adds two stages of the tile's lse and delta (f32)
template <int DH>
struct BwdLayout {
  static constexpr int LD = DH + 8;
  static constexpr int OWN = ROWS * LD;
  static constexpr int TILE = TC_BK * LD;
  static constexpr int DQ_BYTES = (2 * OWN + 4 * TILE) * (int)sizeof(__nv_bfloat16);
  static constexpr int STATS = 2 * TC_BK;  // lse then delta, f32, one stage
  static constexpr int DKV_BYTES = DQ_BYTES + 2 * STATS * (int)sizeof(float);
  // blocks per SM the registers must leave room for; shared memory allows 4
  // up to Dh = 64, 3 at Dh = 80 (66 KB and 67 KB) and 2 at Dh = 128; K5
  // holds twice K4's accumulators and needs 2 at Dh = 80 (167 registers at
  // 64 already)
  static constexpr int DQ_MIN_BLOCKS = DH <= 64 ? 4 : DH <= 80 ? 3 : 2;
  static constexpr int DKV_MIN_BLOCKS = DH <= 32 ? 4 : DH == 64 ? 3 : 2;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

// lse (thread < NR) and delta (NR <= thread < 2 NR) of rows [r0, r0 + NR)
// into one stage of K5's statistics, by cp.async; rows at or past t_len
// read as 0
template <int NR>
__device__ __forceinline__ void cp_stats(float* dst, const float* __restrict__ lse,
                                         const float* __restrict__ delta, int r0, int t_len,
                                         int tid) {
  static_assert(2 * NR <= TC_THREADS, "one statistic per thread");
  if (tid >= 2 * NR) return;
  const int r = tid % NR;
  const bool in = r0 + r < t_len;
  cp_async4(dst + tid, (tid < NR ? lse : delta) + (in ? r0 + r : 0), in);
}

// K4 on bf16. Lane l holds, in an m16n8 accumulator, rows g = l / 4 and
// g + 8 and columns 2c, 2c + 1 with c = l % 4, as in flash_fwd_tc_kernel.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, BwdLayout<DH>::DQ_MIN_BLOCKS)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int t_len, int n_qblocks, float scale) {
  using L = BwdLayout<DH>;
  constexpr int LD = L::LD;
  constexpr int KS = DH / 16;     // k16 steps over the head dim
  constexpr int NC = TC_BK / 16;  // 16-key chunks of a tile
  constexpr int ND = DH / 8;      // n8 head-dim fragments of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + L::OWN;
  __nv_bfloat16* ks = dos + L::OWN;
  __nv_bfloat16* vs = ks + 2 * L::TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x / n_qblocks;
  const int q0 = (int)(blockIdx.x % n_qblocks) * ROWS;
  const long long base = bh * t_len * DH;
  const int n_tiles = (t_len + TC_BK - 1) / TC_BK;
  const bool live = q0 + warp * 16 < t_len;
  const float sl2 = scale * kLog2e;

  cp_rows<DH, ROWS>(qs, q + base, q0, t_len, tid);
  cp_rows<DH, ROWS>(dos, dout + base, q0, t_len, tid);
  cp_async_commit();
  cp_rows<DH, TC_BK>(ks, k + base, 0, t_len, tid);
  cp_rows<DH, TC_BK>(vs, v + base, 0, t_len, tid);
  cp_async_commit();

  // this lane's rows: lse * log2(e) and delta (0 past T)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float lb0 = r0 < t_len ? lse[bh * t_len + r0] * kLog2e : 0.f;
  const float lb1 = r1 < t_len ? lse[bh * t_len + r1] * kLog2e : 0.f;
  const float d0 = r0 < t_len ? delta[bh * t_len + r0] : 0.f;
  const float d1 = r1 < t_len ? delta[bh * t_len + r1] : 0.f;

  // ldmatrix row addresses: lane l supplies row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;
  uint32_t qf[KS][4], df[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      cp_rows<DH, TC_BK>(ks + nxt * L::TILE, k + base, (t + 1) * TC_BK, t_len, tid);
      cp_rows<DH, TC_BK>(vs + nxt * L::TILE, v + base, (t + 1) * TC_BK, t_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (t == 0) {
        // Q's and dO's A fragments: matrices (rows 0-7 | 8-15) x (dims 0-7 | 8-15)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int off = (warp * 16 + mr + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8;
          ldmatrix_x4(qf[kk], qs + off);
          ldmatrix_x4(df[kk], dos + off);
        }
      }
      const __nv_bfloat16* kt = ks + (t & 1) * L::TILE;
      const __nv_bfloat16* vt = vs + (t & 1) * L::TILE;
      const int nlive = t_len - t * TC_BK;  // keys of this tile before T (>= 1)

#pragma unroll
      for (int j0 = 0; j0 < NC; ++j0) {
        if (j0 * 16 >= nlive) break;
        const bool hi = j0 * 16 + 8 < nlive;  // the second n8 fragment holds a key
        // S = Q K^T and dP = dO V^T for keys 16 j0 ..; matrices: keys
        // (0-7 | 8-15) x dims (0-7 | 8-15)
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int off = (j0 * 16 + mr + (mi >> 1) * 8) * LD + kk * 16 + (mi & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, kt + off);
          mma_bf16(s[0], qf[kk], b[0], b[1]);
          if (hi) mma_bf16(s[1], qf[kk], b[2], b[3]);
          ldmatrix_x4(b, vt + off);
          mma_bf16(dp[0], df[kk], b[0], b[1]);
          if (hi) mma_bf16(dp[1], df[kk], b[2], b[3]);
        }
        // dS = P (dP - delta) in f32, P = 0 for keys past T, packed to bf16
        // as the A fragment of dS K (keys 2c, 2c + 1 of fragment h are its k
        // 8h + 2c, 8h + 2c + 1)
        uint32_t da[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = j0 * 16 + h * 8 + 2 * c;
          float p0 = exp2f(fmaf(s[h][0], sl2, -lb0)), p1 = exp2f(fmaf(s[h][1], sl2, -lb0));
          float p2 = exp2f(fmaf(s[h][2], sl2, -lb1)), p3 = exp2f(fmaf(s[h][3], sl2, -lb1));
          if (key >= nlive) p0 = p2 = 0.f;
          if (key + 1 >= nlive) p1 = p3 = 0.f;
          da[2 * h] = pack_bf16x2(p0 * (dp[h][0] - d0), p1 * (dp[h][1] - d0));
          da[2 * h + 1] = pack_bf16x2(p2 * (dp[h][2] - d1), p3 * (dp[h][3] - d1));
        }
        // dQ += dS K; matrices: keys (0-7 | 8-15) x dims (0-7 | 8-15), transposed
#pragma unroll
        for (int n = 0; n < ND / 2; ++n) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, kt + (j0 * 16 + mr + (mi & 1) * 8) * LD + n * 16 + (mi >> 1) * 8);
          mma_bf16(acc[2 * n], da, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage read here is the one the next tile fills
  }
  if (!live) return;

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (long long)r0 * DH + d) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (r1 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (long long)r1 * DH + d) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// K5 on bf16: the accumulators hold key rows g, g + 8 and q columns 2c, 2c + 1
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, BwdLayout<DH>::DKV_MIN_BLOCKS)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t_len,
                        int n_kblocks, float scale) {
  using L = BwdLayout<DH>;
  constexpr int LD = L::LD;
  constexpr int KS = DH / 16;     // k16 steps over the head dim
  constexpr int NC = TC_BK / 16;  // 16-row chunks of a q tile
  constexpr int ND = DH / 8;      // n8 head-dim fragments of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + L::OWN;
  __nv_bfloat16* qs = vs + L::OWN;
  __nv_bfloat16* dos = qs + 2 * L::TILE;
  float* stats = reinterpret_cast<float*>(dos + 2 * L::TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x / n_kblocks;
  const int k0 = (int)(blockIdx.x % n_kblocks) * ROWS;
  const long long base = bh * t_len * DH;
  const float* lse_bh = lse + bh * t_len;
  const float* delta_bh = delta + bh * t_len;
  const int n_tiles = (t_len + TC_BK - 1) / TC_BK;
  const bool live = k0 + warp * 16 < t_len;
  const float sl2 = scale * kLog2e;

  cp_rows<DH, ROWS>(ks, k + base, k0, t_len, tid);
  cp_rows<DH, ROWS>(vs, v + base, k0, t_len, tid);
  cp_async_commit();
  cp_rows<DH, TC_BK>(qs, q + base, 0, t_len, tid);
  cp_rows<DH, TC_BK>(dos, dout + base, 0, t_len, tid);
  cp_stats<TC_BK>(stats, lse_bh, delta_bh, 0, t_len, tid);
  cp_async_commit();

  const int mi = lane / 8, mr = lane % 8;
  uint32_t kf[KS][4], vf[KS][4];
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      cp_rows<DH, TC_BK>(qs + nxt * L::TILE, q + base, (t + 1) * TC_BK, t_len, tid);
      cp_rows<DH, TC_BK>(dos + nxt * L::TILE, dout + base, (t + 1) * TC_BK, t_len, tid);
      cp_stats<TC_BK>(stats + nxt * L::STATS, lse_bh, delta_bh, (t + 1) * TC_BK, t_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (t == 0) {
        // K's and V's A fragments: matrices (rows 0-7 | 8-15) x (dims 0-7 | 8-15)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int off = (warp * 16 + mr + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8;
          ldmatrix_x4(kf[kk], ks + off);
          ldmatrix_x4(vf[kk], vs + off);
        }
      }
      const __nv_bfloat16* qt = qs + (t & 1) * L::TILE;
      const __nv_bfloat16* dt = dos + (t & 1) * L::TILE;
      const float* lt = stats + (t & 1) * L::STATS;
      const float* et = lt + TC_BK;
      const int nlive = t_len - t * TC_BK;  // q rows of this tile before T (>= 1)

#pragma unroll
      for (int i0 = 0; i0 < NC; ++i0) {
        if (i0 * 16 >= nlive) break;
        const bool hi = i0 * 16 + 8 < nlive;  // the second n8 fragment holds a q row
        // S^T = K Q^T and dP^T = V dO^T for q rows 16 i0 ..; matrices: q
        // rows (0-7 | 8-15) x dims (0-7 | 8-15)
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int off = (i0 * 16 + mr + (mi >> 1) * 8) * LD + kk * 16 + (mi & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, qt + off);
          mma_bf16(s[0], kf[kk], b[0], b[1]);
          if (hi) mma_bf16(s[1], kf[kk], b[2], b[3]);
          ldmatrix_x4(b, dt + off);
          mma_bf16(dp[0], vf[kk], b[0], b[1]);
          if (hi) mma_bf16(dp[1], vf[kk], b[2], b[3]);
        }
        // P^T with each column's lse and dS^T = P^T (dP^T - delta), in f32;
        // P = 0 for q rows past T; both packed to bf16 A fragments
        uint32_t pa[4], da[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qi = i0 * 16 + h * 8 + 2 * c;
          const float2 l2 = *reinterpret_cast<const float2*>(lt + qi);
          const float2 e2 = *reinterpret_cast<const float2*>(et + qi);
          const float la = l2.x * kLog2e, lb = l2.y * kLog2e;
          float p0 = exp2f(fmaf(s[h][0], sl2, -la)), p1 = exp2f(fmaf(s[h][1], sl2, -lb));
          float p2 = exp2f(fmaf(s[h][2], sl2, -la)), p3 = exp2f(fmaf(s[h][3], sl2, -lb));
          if (qi >= nlive) p0 = p2 = 0.f;
          if (qi + 1 >= nlive) p1 = p3 = 0.f;
          pa[2 * h] = pack_bf16x2(p0, p1);
          pa[2 * h + 1] = pack_bf16x2(p2, p3);
          da[2 * h] = pack_bf16x2(p0 * (dp[h][0] - e2.x), p1 * (dp[h][1] - e2.y));
          da[2 * h + 1] = pack_bf16x2(p2 * (dp[h][2] - e2.x), p3 * (dp[h][3] - e2.y));
        }
        // dV += P^T dO and dK += dS^T Q; matrices: q rows (0-7 | 8-15) x
        // dims (0-7 | 8-15), transposed
#pragma unroll
        for (int n = 0; n < ND / 2; ++n) {
          const int off = (i0 * 16 + mr + (mi & 1) * 8) * LD + n * 16 + (mi >> 1) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, dt + off);
          mma_bf16(dva[2 * n], pa, b[0], b[1]);
          mma_bf16(dva[2 * n + 1], pa, b[2], b[3]);
          ldmatrix_x4_trans(b, qt + off);
          mma_bf16(dka[2 * n], da, b[0], b[1]);
          mma_bf16(dka[2 * n + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage read here is the one the next tile fills
  }
  if (!live) return;

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < t_len) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (long long)r0 * DH + d) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (long long)r0 * DH + d) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (r1 < t_len) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (long long)r1 * DH + d) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (long long)r1 * DH + d) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// ------------------------------------------- K4 and K5, f32, tensor cores //

// shared-memory layout of the two f32 backward kernels: the 64 rows a block
// owns of two operands (K4: Q, dO; K5: K, V), then two stages of 32-row tiles
// of the two it streams (K4: K, V; K5: Q, dO), rows of DH + 8 floats; K5 adds
// two stages of the tile's lse and delta. Column d of row r lies at column
// d ^ f32_swz(r) of its row (see cp_rows_f32_swz)
template <int DH>
struct F32BwdLayout {
  static_assert(DH % 16 == 0, "the swizzle pairs 8-column groups");
  static constexpr int LD = DH + 8;
  static constexpr int OWN = ROWS * LD;
  static constexpr int TILE = F32_BK * LD;
  static constexpr int DQ_BYTES = (2 * OWN + 4 * TILE) * (int)sizeof(float);
  static constexpr int STATS = 2 * F32_BK;  // lse then delta, one stage
  static constexpr int DKV_BYTES = DQ_BYTES + 2 * STATS * (int)sizeof(float);
  // blocks per SM that shared memory allows (72 KB at Dh = 64, 88 KB at 80,
  // 136 KB at 128), which the registers must leave room for
  static constexpr int MIN_BLOCKS = DH <= 32 ? 4 : DH <= 64 ? 3 : DH <= 80 ? 2 : 1;
};

// 0 or 8: the backward's f32 tiles store rows 4-7 of every 8 with their
// 8-column groups swapped in pairs (d ^ 8), so that both fragment reads are
// free of bank conflicts: 8-byte reads of columns 2c, 2c + 1 from rows g
// (half a warp: rows 8 apart mod 32 banks) and 4-byte reads of column g from
// rows 2c and 2c + 1 (a warp: row stride DH + 8 alone puts rows 0 and 4 on
// the same banks)
__device__ __forceinline__ int f32_swz(int r) { return (r & 4) << 1; }

// rows [r0, r0 + NROWS) of a (t_len, DH) f32 matrix into a swizzled tile of
// row stride DH + 8, by cp.async; rows at or past t_len are zero-filled
template <int DH, int NROWS>
__device__ __forceinline__ void cp_rows_f32_swz(float* dst, const float* __restrict__ src, int r0,
                                                int t_len, int tid) {
  constexpr int CPR = DH / 4;  // 16-byte chunks per row
  constexpr int LD = DH + 8;
  static_assert((NROWS * CPR) % TC_THREADS == 0, "chunks must split evenly");
#pragma unroll
  for (int i = 0; i < NROWS * CPR / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int r = c / CPR, ch = c % CPR;
    const bool in = r0 + r < t_len;
    cp_async16(dst + r * LD + ((ch * 4) ^ f32_swz(r)),
               src + (long long)(in ? r0 + r : 0) * DH + ch * 4, in);
  }
}

// In a swizzled row read at lane offset s (f32_swz of the row), 8-column
// group n starts at n * 8 + s when n is even and n * 8 - s when it is odd
template <int N>
__device__ __forceinline__ int swz_col(int s) {
  return N * 8 + ((N & 1) ? -s : s);
}

// A fragment of rows g and g + 8 at the k8 step KK (columns 2c, 2c + 1,
// the head-dim permutation of K3 f32's Q K^T), split into TF32 hi and lo;
// p points at row g, column 2c of the swizzled tile, s is f32_swz(g)
template <int KK, int LD>
__device__ __forceinline__ void a_frag_f32(uint32_t (&ah)[4], uint32_t (&al)[4], const float* p,
                                           int s) {
  const float2 x0 = *reinterpret_cast<const float2*>(p + swz_col<KK>(s));
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * LD + swz_col<KK>(s));
  split_tf32(x0.x, ah[0], al[0]);
  split_tf32(x1.x, ah[1], al[1]);
  split_tf32(x0.y, ah[2], al[2]);
  split_tf32(x1.y, ah[3], al[3]);
}

// B fragment of row g at the k8 step KK (columns 2c, 2c + 1), split
template <int KK>
__device__ __forceinline__ void b_frag_rows(uint32_t (&bh)[2], uint32_t (&bl)[2], const float* p,
                                            int s) {
  const float2 y = *reinterpret_cast<const float2*>(p + swz_col<KK>(s));
  split_tf32(y.x, bh[0], bl[0]);
  split_tf32(y.y, bh[1], bl[1]);
}

// B fragment of rows 2c and 2c + 1 (the row index permuted as the A
// fragment taken from an accumulator is) at column g of the n8 group N,
// split; p points at row 2c, column g, s is f32_swz(2c)
template <int N, int LD>
__device__ __forceinline__ void b_frag_cols(uint32_t (&bh)[2], uint32_t (&bl)[2], const float* p,
                                            int s) {
  split_tf32(p[swz_col<N>(s)], bh[0], bl[0]);
  split_tf32(p[LD + swz_col<N>(s)], bh[1], bl[1]);
}

// an m16n8 accumulator as the A fragment of the next product, split: a0 =
// c0, a1 = c2, a2 = c1, a3 = c3 (mma k t <- column 2t, k t + 4 <- 2t + 1)
__device__ __forceinline__ void acc_as_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                         const float (&x)[4]) {
  split_tf32(x[0], ah[0], al[0]);
  split_tf32(x[2], ah[1], al[1]);
  split_tf32(x[1], ah[2], al[2]);
  split_tf32(x[3], ah[3], al[3]);
}

// d += a b at f32 accuracy: the three products of the k8 step summed from
// zero, then added to d by an FADD (round to nearest; the tensor cores' own
// sums round toward zero, which drifts over the steps of a sum)
__device__ __forceinline__ void mma_3xtf32_add(float (&d)[4], const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                               const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, ah, al, bh, bl);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// the scores S (K5: S^T) and dP (K5: dP^T) of a block's 16 rows against a
// tile's 32: s[j] += A1 B1_j^T and dp[j] += A2 B2_j^T over the head dim, for
// the tile's n8 fragments j that hold a row before T (nlive of them live).
// Each A fragment is read and split once per k8 step for all four; a1, a2
// point at the A operands' row g, column 2c; b1, b2 at the tile's row g;
// sa, sb are the lanes' swizzle offsets of those rows
template <int DH, int KK = 0>
__device__ __forceinline__ void scores_f32(float (&s)[F32_BK / 8][4], float (&dp)[F32_BK / 8][4],
                                           const float* a1, const float* a2, const float* b1,
                                           const float* b2, int sa, int sb, int nlive) {
  if constexpr (KK < DH / 8) {
    constexpr int LD = DH + 8;
    uint32_t ah[4], al[4], bh[2], bl[2];
    a_frag_f32<KK, LD>(ah, al, a1, sa);
#pragma unroll
    for (int j = 0; j < F32_BK / 8; ++j) {
      if (j * 8 >= nlive) break;
      b_frag_rows<KK>(bh, bl, b1 + j * 8 * LD, sb);
      mma_3xtf32_add(s[j], ah, al, bh, bl);
    }
    a_frag_f32<KK, LD>(ah, al, a2, sa);
#pragma unroll
    for (int j = 0; j < F32_BK / 8; ++j) {
      if (j * 8 >= nlive) break;
      b_frag_rows<KK>(bh, bl, b2 + j * 8 * LD, sb);
      mma_3xtf32_add(dp[j], ah, al, bh, bl);
    }
    scores_f32<DH, KK + 1>(s, dp, a1, a2, b1, b2, sa, sb, nlive);
  }
}

// acc[n] += X B_n over one k8 step of 8 rows, for every n8 head-dim group
// n: xh, xl the split A fragment, p the B operand's row 2c, column g
template <int DH, int N = 0>
__device__ __forceinline__ void accumulate_f32(float (&acc)[DH / 8][4], const uint32_t (&xh)[4],
                                               const uint32_t (&xl)[4], const float* p, int s) {
  if constexpr (N < DH / 8) {
    uint32_t bh[2], bl[2];
    b_frag_cols<N, DH + 8>(bh, bl, p, s);
    mma_3xtf32_add(acc[N], xh, xl, bh, bl);
    accumulate_f32<DH, N + 1>(acc, xh, xl, p, s);
  }
}

// K4 on f32. Lane l (g = l / 4, c = l % 4) holds, in an m16n8 accumulator,
// rows g and g + 8 and columns 2c, 2c + 1, as in flash_fwd_f32tc_kernel.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, F32BwdLayout<DH>::MIN_BLOCKS)
flash_bwd_dq_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int t_len, int n_qblocks, float scale) {
  using L = F32BwdLayout<DH>;
  constexpr int LD = L::LD;
  constexpr int NK = F32_BK / 8;  // n8 key fragments of a tile (k8 steps of dS K)
  constexpr int ND = DH / 8;      // n8 head-dim fragments of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + L::OWN;
  float* ks = dos + L::OWN;
  float* vs = ks + 2 * L::TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x / n_qblocks;
  const int q0 = (int)(blockIdx.x % n_qblocks) * ROWS;
  const long long base = bh * t_len * DH;
  const int n_tiles = (t_len + F32_BK - 1) / F32_BK;
  const bool live = q0 + warp * 16 < t_len;
  const float sl2 = scale * kLog2e;

  cp_rows_f32_swz<DH, ROWS>(qs, q + base, q0, t_len, tid);
  cp_rows_f32_swz<DH, ROWS>(dos, dout + base, q0, t_len, tid);
  cp_rows_f32_swz<DH, F32_BK>(ks, k + base, 0, t_len, tid);
  cp_rows_f32_swz<DH, F32_BK>(vs, v + base, 0, t_len, tid);
  cp_async_commit();

  // this lane's rows: lse * log2(e) and delta (0 past T)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float lb0 = r0 < t_len ? lse[bh * t_len + r0] * kLog2e : 0.f;
  const float lb1 = r1 < t_len ? lse[bh * t_len + r1] * kLog2e : 0.f;
  const float d0 = r0 < t_len ? delta[bh * t_len + r0] : 0.f;
  const float d1 = r1 < t_len ? delta[bh * t_len + r1] : 0.f;

  // the swizzle offsets of rows g and 2c (mod 8); Q's and dO's A fragments
  // (rows g, g + 8 of the warp's 16) are read from shared memory and split
  // at every step: no register holds them across the loop
  const int sg = f32_swz(g), sc = f32_swz(2 * c);
  const float* qw = qs + (warp * 16 + g) * LD + 2 * c;
  const float* dw = dos + (warp * 16 + g) * LD + 2 * c;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      cp_rows_f32_swz<DH, F32_BK>(ks + nxt * L::TILE, k + base, (t + 1) * F32_BK, t_len, tid);
      cp_rows_f32_swz<DH, F32_BK>(vs + nxt * L::TILE, v + base, (t + 1) * F32_BK, t_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* kt = ks + (t & 1) * L::TILE;
      const float* vt = vs + (t & 1) * L::TILE;
      const int nlive = t_len - t * F32_BK;  // keys of this tile before T (>= 1)

      // S = Q K^T and dP = dO V^T over the tile's key fragments
      float s[NK][4] = {}, dp[NK][4] = {};
      scores_f32<DH>(s, dp, qw, dw, kt + g * LD + 2 * c, vt + g * LD + 2 * c, sg, sg, nlive);
      // dS = P (dP - delta) in f32, P = exp2(S scale log2(e) - lse log2(e)),
      // 0 for keys past T (by a select: exp2 of the padding may be inf)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int key = j * 8 + 2 * c;
        const float p0 = key < nlive ? exp2f(fmaf(s[j][0], sl2, -lb0)) : 0.f;
        const float p1 = key + 1 < nlive ? exp2f(fmaf(s[j][1], sl2, -lb0)) : 0.f;
        const float p2 = key < nlive ? exp2f(fmaf(s[j][2], sl2, -lb1)) : 0.f;
        const float p3 = key + 1 < nlive ? exp2f(fmaf(s[j][3], sl2, -lb1)) : 0.f;
        s[j][0] = p0 * (dp[j][0] - d0);
        s[j][1] = p1 * (dp[j][1] - d0);
        s[j][2] = p2 * (dp[j][2] - d1);
        s[j][3] = p3 * (dp[j][3] - d1);
      }
      // dQ += dS K, one k8 step per key fragment: dS's A fragment from its
      // accumulator, K's B fragment from keys 2c and 2c + 1 at dim g
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (j * 8 >= nlive) break;
        uint32_t xh[4], xl[4];
        acc_as_a(xh, xl, s[j]);
        accumulate_f32<DH>(acc, xh, xl, kt + (j * 8 + 2 * c) * LD + g, sc);
      }
    }
    __syncthreads();  // the stage read here is the one the next tile fills
  }
  if (!live) return;

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < t_len)
      *reinterpret_cast<float2*>(dq + base + (long long)r0 * DH + d) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (r1 < t_len)
      *reinterpret_cast<float2*>(dq + base + (long long)r1 * DH + d) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// K5 on f32: the accumulators hold key rows g, g + 8 and q columns 2c, 2c + 1
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, F32BwdLayout<DH>::MIN_BLOCKS)
flash_bwd_dkv_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int t_len,
                           int n_kblocks, float scale) {
  using L = F32BwdLayout<DH>;
  constexpr int LD = L::LD;
  constexpr int NQ = F32_BK / 8;  // n8 q fragments of a tile (k8 steps of the second products)
  constexpr int ND = DH / 8;      // n8 head-dim fragments of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + L::OWN;
  float* qs = vs + L::OWN;
  float* dos = qs + 2 * L::TILE;
  float* stats = dos + 2 * L::TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x / n_kblocks;
  const int k0 = (int)(blockIdx.x % n_kblocks) * ROWS;
  const long long base = bh * t_len * DH;
  const float* lse_bh = lse + bh * t_len;
  const float* delta_bh = delta + bh * t_len;
  const int n_tiles = (t_len + F32_BK - 1) / F32_BK;
  const bool live = k0 + warp * 16 < t_len;
  const float sl2 = scale * kLog2e;

  cp_rows_f32_swz<DH, ROWS>(ks, k + base, k0, t_len, tid);
  cp_rows_f32_swz<DH, ROWS>(vs, v + base, k0, t_len, tid);
  cp_rows_f32_swz<DH, F32_BK>(qs, q + base, 0, t_len, tid);
  cp_rows_f32_swz<DH, F32_BK>(dos, dout + base, 0, t_len, tid);
  cp_stats<F32_BK>(stats, lse_bh, delta_bh, 0, t_len, tid);
  cp_async_commit();

  // K's and V's A fragments (key rows g, g + 8 of the warp's 16) are read
  // from shared memory and split at every step, as Q's and dO's in K4
  const int sg = f32_swz(g), sc = f32_swz(2 * c);
  const float* kw = ks + (warp * 16 + g) * LD + 2 * c;
  const float* vw = vs + (warp * 16 + g) * LD + 2 * c;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      cp_rows_f32_swz<DH, F32_BK>(qs + nxt * L::TILE, q + base, (t + 1) * F32_BK, t_len, tid);
      cp_rows_f32_swz<DH, F32_BK>(dos + nxt * L::TILE, dout + base, (t + 1) * F32_BK, t_len,
                                  tid);
      cp_stats<F32_BK>(stats + nxt * L::STATS, lse_bh, delta_bh, (t + 1) * F32_BK, t_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* qt = qs + (t & 1) * L::TILE;
      const float* dt = dos + (t & 1) * L::TILE;
      const float* lt = stats + (t & 1) * L::STATS;
      const float* et = lt + F32_BK;
      const int nlive = t_len - t * F32_BK;  // q rows of this tile before T (>= 1)

      // S^T = K Q^T and dP^T = V dO^T over the tile's q fragments
      float s[NQ][4] = {}, dp[NQ][4] = {};
      scores_f32<DH>(s, dp, kw, vw, qt + g * LD + 2 * c, dt + g * LD + 2 * c, sg, sg, nlive);
      // P^T with each column's lse and dS^T = P^T (dP^T - delta) in f32;
      // P = 0 for q rows past T
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int qi = j * 8 + 2 * c;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + qi);
        const float2 e2 = *reinterpret_cast<const float2*>(et + qi);
        const float la = l2.x * kLog2e, lb = l2.y * kLog2e;
        const float p0 = qi < nlive ? exp2f(fmaf(s[j][0], sl2, -la)) : 0.f;
        const float p1 = qi + 1 < nlive ? exp2f(fmaf(s[j][1], sl2, -lb)) : 0.f;
        const float p2 = qi < nlive ? exp2f(fmaf(s[j][2], sl2, -la)) : 0.f;
        const float p3 = qi + 1 < nlive ? exp2f(fmaf(s[j][3], sl2, -lb)) : 0.f;
        s[j][0] = p0;
        s[j][1] = p1;
        s[j][2] = p2;
        s[j][3] = p3;
        dp[j][0] = p0 * (dp[j][0] - e2.x);
        dp[j][1] = p1 * (dp[j][1] - e2.y);
        dp[j][2] = p2 * (dp[j][2] - e2.x);
        dp[j][3] = p3 * (dp[j][3] - e2.y);
      }
      // dV += P^T dO and dK += dS^T Q, one k8 step per q fragment: the A
      // fragments from the accumulators, dO's and Q's B fragments from q
      // rows 2c and 2c + 1 at dim g
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        if (j * 8 >= nlive) break;
        const int off = (j * 8 + 2 * c) * LD + g;
        uint32_t xh[4], xl[4];
        acc_as_a(xh, xl, s[j]);
        accumulate_f32<DH>(dva, xh, xl, dt + off, sc);
        acc_as_a(xh, xl, dp[j]);
        accumulate_f32<DH>(dka, xh, xl, qt + off, sc);
      }
    }
    __syncthreads();  // the stage read here is the one the next tile fills
  }
  if (!live) return;

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * c;
    if (r0 < t_len) {
      *reinterpret_cast<float2*>(dk + base + (long long)r0 * DH + d) =
          make_float2(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<float2*>(dv + base + (long long)r0 * DH + d) =
          make_float2(dva[n][0], dva[n][1]);
    }
    if (r1 < t_len) {
      *reinterpret_cast<float2*>(dk + base + (long long)r1 * DH + d) =
          make_float2(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<float2*>(dv + base + (long long)r1 * DH + d) =
          make_float2(dva[n][2], dva[n][3]);
    }
  }
}

// ------------------------------------------------------------ launch ---- //
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int bh, t_len;
  float scale;
};

// a tensor-core kernel: one block of TC_THREADS per (head, 64-row block), a
// head's blocks adjacent; dynamic shared memory above 48 KB is opted into
template <typename Kernel, typename... Ptrs>
cudaError_t launch_tc(Kernel kernel, int smem, const Args& a, cudaStream_t st, Ptrs... ptrs) {
  const int n_blocks = (a.t_len + ROWS - 1) / ROWS;
  if ((long long)a.bh * n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)(a.bh * n_blocks), TC_THREADS, smem, st>>>(ptrs..., a.t_len, n_blocks,
                                                                a.scale);
  return cudaGetLastError();
}

// every kernel is a tensor-core one: bf16 by mma.sync m16n8k16, f32 by
// 3xTF32 on mma.sync m16n8k8
template <typename T, int DH>
cudaError_t launch(int which, const Args& a, cudaStream_t st) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (which == 0)
      return launch_tc(flash_fwd_tc_kernel<DH>, TcLayout<DH>::BYTES, a, st, q, k, v,
                       static_cast<T*>(a.o), static_cast<float*>(a.lse_out));
    if (which == 1)
      return launch_tc(flash_bwd_dq_tc_kernel<DH>, BwdLayout<DH>::DQ_BYTES, a, st, q, k, v,
                       dout, lse, delta, static_cast<T*>(a.dq));
    return launch_tc(flash_bwd_dkv_tc_kernel<DH>, BwdLayout<DH>::DKV_BYTES, a, st, q, k, v,
                     dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv));
  } else {
    if (which == 0)
      return launch_tc(flash_fwd_f32tc_kernel<DH>, F32TcLayout<DH>::BYTES, a, st, q, k, v,
                       static_cast<T*>(a.o), static_cast<float*>(a.lse_out));
    if (which == 1)
      return launch_tc(flash_bwd_dq_f32tc_kernel<DH>, F32BwdLayout<DH>::DQ_BYTES, a, st, q, k,
                       v, dout, lse, delta, static_cast<T*>(a.dq));
    return launch_tc(flash_bwd_dkv_f32tc_kernel<DH>, F32BwdLayout<DH>::DKV_BYTES, a, st, q, k,
                     v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv));
  }
}

template <typename T>
cudaError_t dispatch_dh(int which, int dh, const Args& a, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(which, a, st);
    case 32: return launch<T, 32>(which, a, st);
    case 64: return launch<T, 64>(which, a, st);
    case 80: return launch<T, 80>(which, a, st);
    case 128: return launch<T, 128>(which, a, st);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, int dh, int dtype, const Args& a, void* stream) {
  if (a.bh < 0 || a.t_len < 0) return (int)cudaErrorInvalidValue;
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
// tensors; dh is 16, 32, 64, 80 or 128.

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
