// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the two backward Pallas kernels of the JAX package
// (alpa_tpu/ops/flash_attention.py): `_flash_bwd_dq_kernel` (:244) and
// `_flash_bwd_dkv_kernel` (:290).  The two-kernel split is kept, so no block
// writes what another block writes and no atomics are needed: the gradients
// are deterministic.
//
// Contract (the JAX kernels' own math, :244-339):
//   * P = exp(sm_scale * Q K^T - lse), masked scores (q_pos + q_offset <
//     k_pos under the causal mask) are -1e9, which makes P exactly 0;
//   * dS = P * (dO V^T - delta), with delta = rowsum(dO * O) taken from O as
//     saved (in q's dtype) with fp32 products, as the JAX package computes it
//     in XLA outside Pallas (:359-361).  The dq kernel computes delta for its
//     rows and writes it to a (B*H, Sq) fp32 buffer; the dk/dv kernel,
//     launched after it on the same stream, reads it;
//   * dq = sm_scale * dS K, dk = sm_scale * dS^T Q, dv = P^T dO, each
//     accumulated in fp32 and written once in the inputs' dtype.
// Beyond it: q, k, v, dO and O are (B, S, H, D) tensors taken with their
// strides (the head dimension must be contiguous), lse and delta are
// contiguous fp32 (B*H, Sq), and ragged tiles are masked here, so no length
// has to divide the tile.  A padded q row adds nothing to dk/dv (its P is set
// to 0, since its lse and delta are not defined); a key past Sk adds nothing
// to dq.  The dk/dv rows of a k tile that no q row can see are written as
// zeros.
//
// bf16 (the training path) runs on the tensor cores.  Bound on an H100: at
// the training shape (B=8, H=32, S=1024, D=64, causal) the two kernels do
// seven products over the visible (q, k) pairs (S and dP are formed in
// both), 1.2e11 FLOP, 0.12 ms at the 989 TFLOP/s bf16 peak; their bytes need
// 0.11 ms at 3.35 TB/s.  The design:
//   * blocks of 128 rows, two warpgroups of 64; each warpgroup keeps its
//     fp32 accumulators in registers (S, dP and dq in the dq kernel; S^T,
//     dP^T, dk and dv in the dk/dv kernel);
//   * S and dP (S^T and dP^T) are `wgmma` products of bf16 tiles in shared
//     memory.  P and dS stay in registers and are the A operand of the
//     second products (dS K; P^T dO and dS^T Q), whose B operand is read
//     transposed from the same row-major tiles through the descriptor, so
//     nothing is staged twice;
//   * P and dS enter those products as two bf16 values each, hi = bf16(x)
//     and lo = bf16(x - hi), so the products see 16 significant bits.  One
//     bf16 rounding (the library backward's) breaks the 1e-2 tolerance at
//     head dim 128, where |dP| reaches tens and the dS of a causal row with
//     few keys nearly cancel; the pair costs one more pass of each second
//     product, ten products' work in all;
//   * tiles sit in shared memory as bf16 with the 128-byte swizzle, filled by
//     16-byte `cp.async` into a ring of three stages, two tiles ahead of the
//     products, with one barrier per tile;
//   * dq block: 128 q rows, a loop over 64-key tiles up to the causal
//     diagonal, the last q tiles (most keys) launched first.  dk/dv block:
//     128 keys, a loop over 64-row q tiles from the first that can see
//     them, the first k tiles (most rows) launched first.  A warpgroup whose
//     rows are all masked in a tile skips it, and only tiles on an edge or
//     the diagonal compute masks.
// What bounds them in practice is the fixed work of each 64 x 64 tile: the
// exponentials, the bf16 splits, the wgmma and cp.async waits and the
// barrier, in one block of eight warps per SM (the accumulators take 166 to
// 255 registers a thread): at head dim 128, with half the tiles for the same
// FLOPs, the pair takes well under half the time (chip_smoke.py's
// "train-d128" case).  Left for later: a producer warp with TMA loads,
// mbarriers in place of the block barrier and `setmaxnreg`, overlap of one
// tile's softmax with the next tile's products within a warpgroup, a
// persistent grid that hides each block's prologue, clusters that share the
// streamed tiles, and a split over k for long contexts with few blocks.
//
// fp32 keeps the JAX kernels' arithmetic on the CUDA cores: 256 threads per
// block, each owning a 4x4 patch of a 64x64 tile of scores, as in
// flash_fwd.cu.
//   dq kernel:  one block per (batch*head, 64-row q tile).  q and dO sit
//     transposed in shared memory; the loop over 64-row k tiles stops at the
//     last key the tile's last row can see under the causal mask.  Per tile
//     it forms S and dP in one pass over D, turns them into dS, stages dS^T
//     in shared memory and adds dS K to a 4 x D/16 fp32 accumulator.
//   dk/dv kernel: one block per (batch*head, 64-row k tile).  k and v stay
//     transposed in shared memory; the loop over 64-row q tiles starts at the
//     first tile that can see the k tile, (k_start - q_offset) / 64 (:333).
//     Per q tile it forms S^T and dP^T, stages P^T and adds P^T dO to dv,
//     then reuses the buffer for dS^T and adds dS^T Q to dk.
// These are bound by fp32 FMA issue (67 TFLOP/s peak, fewer in practice
// because every FMA pair needs a shared-memory load); they serve the fp32
// fidelity checks, where TF32's ~3 digits would not do.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 score patch each
constexpr int PAD = 4;        // row padding of the transposed tiles (floats)
constexpr int QS = BQ + PAD;  // row stride of q^T, dO^T and dS^T
constexpr int KS = BK + PAD;  // row stride of k^T, v^T and the P^T buffer
constexpr float MASKED = -1e9f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;
  const float* lse;
  float* delta;  // written by the dq kernel, read by the dk/dv kernel
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_ss, q_sh;  // element strides of q over (B, S, H)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // of dO
  int64_t y_sb, y_ss, y_sh;  // of O, the forward's output
  int B, H, Sq, Sk;
  int causal;
  int q_offset;
  float scale;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// as fp32: transposed into t[D][stride] and, when r is given, also row-major
// into r[64][D].  Rows at or past `valid` are zeros.
template <int D>
__device__ __forceinline__ void stage(float* t, int stride, float* r,
                                      const float* src, int64_t row_stride,
                                      int row0, int valid) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int row = i / D, d = i % D;
    float x = 0.f;
    if (row < valid) x = src[(int64_t)(row0 + row) * row_stride + d];
    t[d * stride + row] = x;
    if (r != nullptr) r[row * D + d] = x;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * D * QS + 2 * D * KS + BK * D + BK * QS);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * D * KS + 2 * D * QS + 2 * BQ * D + BQ * KS + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int NC = D / 16;  // dq columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;           // [D][QS]  q^T
  float* ot = qt + D * QS;    // [D][QS]  dO^T
  float* kt = ot + D * QS;    // [D][KS]  k^T of the current tile
  float* vt = kt + D * KS;    // [D][KS]  v^T of the current tile
  float* ks = vt + D * KS;    // [BK][D]  k of the current tile
  float* dst = ks + BK * D;   // [BK][QS] dS^T of the current tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx*4.., dq columns tx*4 (+64)
  const int ty = tid / 16;  // rows ty*4..ty*4+3
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int rows = min(BQ, p.Sq - q0);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* out = static_cast<const float*>(p.out) + b * p.y_sb + h * p.y_sh;

  stage<D>(qt, QS, nullptr, q, p.q_ss, q0, rows);
  stage<D>(ot, QS, nullptr, dout, p.o_ss, q0, rows);
  __syncthreads();  // dO^T is read for delta

  float lse[4], delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    // delta over the 16 threads (one half-warp) that share row r
    float dl = 0.f;
    if (r < rows)
      for (int d = tx; d < D; d += 16)
        dl = fmaf(ot[d * QS + r], out[(int64_t)(q0 + r) * p.y_ss + d], dl);
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) dl += __shfl_xor_sync(0xffffffffu, dl, m);
    delta[i] = dl;
    if (r < rows && tx == 0) p.delta[(int64_t)bh * p.Sq + q0 + r] = dl;
    lse[i] = r < rows ? p.lse[(int64_t)bh * p.Sq + q0 + r] : 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + rows + p.q_offset);
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int keys = min(BK, p.Sk - k0);
    __syncthreads();  // previous tile's kt/vt/ks/dst are consumed
    stage<D>(kt, KS, ks, k, p.k_ss, k0, keys);
    stage<D>(vt, KS, nullptr, v, p.v_ss, k0, keys);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = ld4(qt + d * QS + ty * 4);
      const float4 o = ld4(ot + d * QS + ty * 4);
      const float4 c = ld4(kt + d * KS + tx * 4);
      const float4 w = ld4(vt + d * KS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float ov[4] = {o.x, o.y, o.z, o.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], cv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], wv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int q_pos = q0 + r + p.q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx * 4 + j;
        float ds = 0.f;
        if (r < rows && k_pos < p.Sk) {
          float x = s[i][j] * p.scale;
          if (p.causal && q_pos < k_pos) x = MASKED;
          ds = expf(x - lse[i]) * (dp[i][j] - delta[i]);
        }
        s[i][j] = ds;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (tx * 4 + j) * QS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int c = 0; c < keys; ++c) {
      const float4 a = ld4(dst + c * QS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int half = 0; half < NC / 4; ++half) {
        const float4 w = ld4(ks + c * D + half * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][half * 4 + j] = fmaf(av[i], wv[j], acc[i][half * 4 + j]);
      }
    }
  }

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const int64_t row = ((int64_t)b * p.Sq + q0 + r) * p.H + h;
#pragma unroll
    for (int half = 0; half < NC / 4; ++half)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dq[row * D + half * 64 + tx * 4 + j] = acc[i][half * 4 + j] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Params p) {
  constexpr int NC = D / 16;  // dk/dv columns per thread
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // [D][KS]  k^T of this block's tile
  float* vt = kt + D * KS;       // [D][KS]  v^T of this block's tile
  float* qt = vt + D * KS;       // [D][QS]  q^T of the current q tile
  float* ot = qt + D * QS;       // [D][QS]  dO^T of the current q tile
  float* qs = ot + D * QS;       // [BQ][D]  q of the current q tile
  float* os = qs + BQ * D;       // [BQ][D]  dO of the current q tile
  float* pt = os + BQ * D;       // [BQ][KS] P, then dS, laid out [q row][key]
  float* lse_s = pt + BQ * KS;   // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns (q rows) tx*4.., dk/dv columns
  const int ty = tid / 16;  // keys ty*4..ty*4+3
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int keys = min(BK, p.Sk - k0);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;

  stage<D>(kt, KS, nullptr, k, p.k_ss, k0, keys);
  stage<D>(vt, KS, nullptr, v, p.v_ss, k0, keys);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk[i][n] = dv[i][n] = 0.f;

  // the first q tile with a row that can see key k0 (all of them if not
  // causal); a tile whose keys no row can see runs no iteration
  const int first = p.causal ? max(k0 - p.q_offset, 0) / BQ : 0;
  const int n_q_tiles = (p.Sq + BQ - 1) / BQ;

  for (int qb = first; qb < n_q_tiles; ++qb) {
    const int q0 = qb * BQ;
    const int rows = min(BQ, p.Sq - q0);
    __syncthreads();  // previous tile's buffers are consumed
    stage<D>(qt, QS, qs, q, p.q_ss, q0, rows);
    stage<D>(ot, QS, os, dout, p.o_ss, q0, rows);
    for (int i = tid; i < BQ; i += THREADS) {
      lse_s[i] = i < rows ? p.lse[(int64_t)bh * p.Sq + q0 + i] : 0.f;
      delta_s[i] = i < rows ? p.delta[(int64_t)bh * p.Sq + q0 + i] : 0.f;
    }
    __syncthreads();

    // s[i][j] = S[q row tx*4+j][key ty*4+i], dp likewise
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = ld4(kt + d * KS + ty * 4);
      const float4 w = ld4(vt + d * KS + ty * 4);
      const float4 c = ld4(qt + d * QS + tx * 4);
      const float4 o = ld4(ot + d * QS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], cv[j], s[i][j]);
          dp[i][j] = fmaf(wv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k_pos = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        float pv = 0.f, ds = 0.f;
        if (r < rows && k_pos < p.Sk) {
          float x = s[i][j] * p.scale;
          if (p.causal && q0 + r + p.q_offset < k_pos) x = MASKED;
          pv = expf(x - lse_s[r]);
          ds = pv * (dp[i][j] - delta_s[r]);
        }
        s[i][j] = pv;
        dp[i][j] = ds;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * KS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int r = 0; r < rows; ++r) {  // dv += P^T dO
      const float4 a = ld4(pt + r * KS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int half = 0; half < NC / 4; ++half) {
        const float4 w = ld4(os + r * D + half * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dv[i][half * 4 + j] = fmaf(av[i], wv[j], dv[i][half * 4 + j]);
      }
    }
    __syncthreads();  // P is consumed; the buffer takes dS
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * KS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

    for (int r = 0; r < rows; ++r) {  // dk += dS^T Q
      const float4 a = ld4(pt + r * KS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int half = 0; half < NC / 4; ++half) {
        const float4 w = ld4(qs + r * D + half * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dk[i][half * 4 + j] = fmaf(av[i], wv[j], dk[i][half * 4 + j]);
      }
    }
  }

  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty * 4 + i;
    if (c >= keys) continue;
    const int64_t row = ((int64_t)b * p.Sk + k0 + c) * p.H + h;
#pragma unroll
    for (int half = 0; half < NC / 4; ++half)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t at = row * D + half * 64 + tx * 4 + j;
        dk_out[at] = dk[i][half * 4 + j] * p.scale;
        dv_out[at] = dv[i][half * 4 + j];
      }
  }
}

}  // namespace

namespace {

constexpr int STAGES = 3;  // streamed tiles in shared memory

template <int D>
constexpr int dq_bf16_smem_bytes() {  // q and dO; stages of k and v
  return 1024 + 2 * BM * D * 2 + STAGES * 2 * BN * D * 2;
}

template <int D>
constexpr int dkv_bf16_smem_bytes() {  // k and v; stages of q, dO, lse, delta
  return 1024 + 2 * BM * D * 2 + STAGES * (2 * BN * D * 2 + 2 * BN * 4);
}

// sum of the products of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// s = A B^T and dp = C E^T for one warpgroup: A, C rows of a BM-row tile
// (this warpgroup's 64), B, E 64-row tiles, all K-major over D
template <int D>
__device__ __forceinline__ void mma_ss_pair(float (&s)[32], float (&dp)[32],
                                            uint32_t a, uint32_t c,
                                            uint32_t b, uint32_t e, int wg) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ao = (kk / 4) * (BM * 128) + wg * (64 * 128) + (kk % 4) * 32;
    const uint32_t bo = (kk / 4) * (BN * 128) + (kk % 4) * 32;
    sm90::wgmma_ss_n64(s, sm90::kmajor_desc(a + ao),
                       sm90::kmajor_desc(b + bo), kk > 0);
    sm90::wgmma_ss_n64(dp, sm90::kmajor_desc(c + ao),
                       sm90::kmajor_desc(e + bo), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr uint32_t Q_TILE = BM * D * 2;  // bytes of the q and dO tiles
  constexpr uint32_t K_TILE = BN * D * 2;  // bytes of one k or v stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t q_s = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t o_s = q_s + Q_TILE;
  const uint32_t k_s = o_s + Q_TILE;           // STAGES k tiles
  const uint32_t v_s = k_s + STAGES * K_TILE;  // STAGES v tiles

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // the last q tiles see the most keys: they take the first blocks
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int rows = min(BM, p.Sq - q0);

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const bf16* out = static_cast<const bf16*>(p.out) + b * p.y_sb + h * p.y_sh;

  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + rows + p.q_offset);
  const int n_tiles = (k_end + BN - 1) / BN;
  auto load_kv = [&](int t) {
    const uint32_t stage = (t % STAGES) * K_TILE;
    load_tile<BN, D>(k_s + stage, k, p.k_ss, t * BN, p.Sk - t * BN);
    load_tile<BN, D>(v_s + stage, v, p.v_ss, t * BN, p.Sk - t * BN);
  };
  load_tile<BM, D>(q_s, q, p.q_ss, q0, rows);
  load_tile<BM, D>(o_s, dout, p.o_ss, q0, rows);
  load_kv(0);
  sm90::cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  sm90::cp_async_commit();

  // this thread's accumulator rows: r0 and r0 + 8; delta and lse for them
  const int r0 = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  float lse[2], delta[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 8 * e;
    float acc = 0.f;
    if (r < rows) {
      const bf16* orow = out + (int64_t)(q0 + r) * p.y_ss;
      const bf16* grow = dout + (int64_t)(q0 + r) * p.o_ss;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {  // the 4 threads of a row share it
        const int c = (j * 4 + lane % 4) * 8;
        acc += dot8(*reinterpret_cast<const uint4*>(orow + c),
                    *reinterpret_cast<const uint4*>(grow + c));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    const int64_t at = (int64_t)bh * p.Sq + q0 + r;
    if (r < rows && lane % 4 == 0) p.delta[at] = acc;
    delta[e] = acc;
    lse[e] = r < rows ? p.lse[at] * LOG2E : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float scale_log2 = p.scale * LOG2E;
  const int wg_last = min(rows, wg * 64 + 64) - 1;  // last row that exists

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    const uint32_t ks = k_s + (t % STAGES) * K_TILE;
    const uint32_t vs = v_s + (t % STAGES) * K_TILE;
    ring_wait();
    if (t + 2 < n_tiles) load_kv(t + 2);  // overlaps the next two tiles
    sm90::cp_async_commit();
    // a warpgroup whose rows are all padding or all masked skips the tile
    if (wg_last < wg * 64 || (p.causal && q0 + wg_last + p.q_offset < k0))
      continue;
    float s[32], dp[32];
    mma_ss_pair<D>(s, dp, q_s, o_s, ks, vs, wg);
    uint32_t hi[4][4], lo[4][4];  // dS = hi + lo, the A operand of dS K
    auto fragments = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int e = (i / 2) % 2;
        const int r = r0 + 8 * e;
        const int key = k0 + (i / 4) * 8 + (lane % 4) * 2;
        float x[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool seen =
              !decltype(masked)::value ||
              (r < rows && key + u < p.Sk &&
               !(p.causal && q0 + r + p.q_offset < key + u));
          const float pv = seen ? exp2f(s[i + u] * scale_log2 - lse[e]) : 0.f;
          x[u] = pv * (dp[i + u] - delta[e]);
        }
        sm90::split_bf16(x[0], x[1], hi[i / 8][(i % 8) / 2],
                         lo[i / 8][(i % 8) / 2]);
      }
    };
    if (wg * 64 + 64 > rows || k0 + BN > p.Sk ||
        (p.causal && q0 + wg * 64 + p.q_offset < k0 + BN - 1))
      fragments(std::true_type());
    else
      fragments(std::false_type());
    sm90::wgmma_fence();
    mma_rs<D>(dq, hi, ks);
    mma_rs<D>(dq, lo, ks);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::fence_regs(hi);
    sm90::fence_regs(lo);
  }

  bf16* dq_out = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = r0 + 8 * ((i / 2) % 2);
    if (r >= rows) continue;
    const int c = (i / 4) * 8 + (lane % 4) * 2;
    const int64_t row = ((int64_t)b * p.Sq + q0 + r) * p.H + h;
    *reinterpret_cast<__nv_bfloat162*>(dq_out + row * D + c) =
        __floats2bfloat162_rn(dq[i] * p.scale, dq[i + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr uint32_t K_TILE = BM * D * 2;  // bytes of the k and v tiles
  constexpr uint32_t Q_TILE = BN * D * 2;  // bytes of one q or dO stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + K_TILE;
  const uint32_t q_s = v_s + K_TILE;           // STAGES q tiles
  const uint32_t o_s = q_s + STAGES * Q_TILE;  // STAGES dO tiles
  // STAGES of [lse (BN), delta (BN)]
  float* const rows_s =
      reinterpret_cast<float*>(smem_raw + (o_s + STAGES * Q_TILE - raw));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BM;  // the first k tiles see the most rows
  const int keys = min(BM, p.Sk - k0);

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + (int64_t)bh * p.Sq;
  const float* delta = p.delta + (int64_t)bh * p.Sq;

  // the first q tile with a row that can see key k0 (all of them if not
  // causal); a tile whose keys no row can see runs no iteration
  const int first = p.causal ? max(k0 - p.q_offset, 0) / BN : 0;
  const int n_q_tiles = (p.Sq + BN - 1) / BN;
  auto load_q = [&](int qb) {  // q tile qb into stage (qb - first) % STAGES
    const int stage = (qb - first) % STAGES, q0 = qb * BN;
    load_tile<BN, D>(q_s + stage * Q_TILE, q, p.q_ss, q0, p.Sq - q0);
    load_tile<BN, D>(o_s + stage * Q_TILE, dout, p.o_ss, q0, p.Sq - q0);
    if (tid < 2 * BN) {
      const float* src = tid < BN ? lse : delta;
      const int i = q0 + tid % BN;
      sm90::cp_async4(sm90::smem_u32(rows_s + stage * 2 * BN + tid),
                      i < p.Sq ? src + i : src, i < p.Sq);
    }
  };
  load_tile<BM, D>(k_s, k, p.k_ss, k0, keys);
  load_tile<BM, D>(v_s, v, p.v_ss, k0, keys);
  if (first < n_q_tiles) load_q(first);
  sm90::cp_async_commit();
  if (first + 1 < n_q_tiles) load_q(first + 1);
  sm90::cp_async_commit();

  // this thread's accumulator rows (keys): r0 and r0 + 8
  const int r0 = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float scale_log2 = p.scale * LOG2E;

  for (int qb = first; qb < n_q_tiles; ++qb) {
    const int stage = (qb - first) % STAGES, q0 = qb * BN;
    const uint32_t qs = q_s + stage * Q_TILE;
    const uint32_t os = o_s + stage * Q_TILE;
    const float* lse_t = rows_s + stage * 2 * BN;
    const float* delta_t = lse_t + BN;
    ring_wait();
    if (qb + 2 < n_q_tiles) load_q(qb + 2);  // overlaps the next two tiles
    sm90::cp_async_commit();
    // a warpgroup whose keys are all padding or all masked skips the tile
    const int q_last = min(p.Sq, q0 + BN) - 1;
    if (wg * 64 >= keys ||
        (p.causal && q_last + p.q_offset < k0 + wg * 64))
      continue;
    float s[32], dp[32];  // S^T and dP^T: keys x q rows
    mma_ss_pair<D>(s, dp, k_s, v_s, qs, os, wg);
    // P^T and dS^T as A operands, each a bf16 hi + lo pair
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    auto fragments = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = k0 + r0 + 8 * ((i / 2) % 2);
        const int c = (i / 4) * 8 + (lane % 4) * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
        const float lv[2] = {l2.x, l2.y}, dl[2] = {d2.x, d2.y};
        float pv[2], ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = q0 + c + u;
          const bool seen = !decltype(masked)::value ||
                            (key < p.Sk && row < p.Sq &&
                             !(p.causal && row + p.q_offset < key));
          pv[u] = seen ? exp2f(s[i + u] * scale_log2 - lv[u] * LOG2E) : 0.f;
          ds[u] = pv[u] * (dp[i + u] - dl[u]);
        }
        const int f = i / 8, g = (i % 8) / 2;
        sm90::split_bf16(pv[0], pv[1], p_hi[f][g], p_lo[f][g]);
        sm90::split_bf16(ds[0], ds[1], ds_hi[f][g], ds_lo[f][g]);
      }
    };
    if (q0 + BN > p.Sq || k0 + wg * 64 + 64 > p.Sk ||
        (p.causal && q0 + p.q_offset < k0 + wg * 64 + 63))
      fragments(std::true_type());
    else
      fragments(std::false_type());
    sm90::wgmma_fence();
    mma_rs<D>(dv, p_hi, os);
    mma_rs<D>(dv, p_lo, os);
    mma_rs<D>(dk, ds_hi, qs);
    mma_rs<D>(dk, ds_lo, qs);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(p_hi);
    sm90::fence_regs(p_lo);
    sm90::fence_regs(ds_hi);
    sm90::fence_regs(ds_lo);
  }

  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = r0 + 8 * ((i / 2) % 2);
    if (r >= keys) continue;
    const int c = (i / 4) * 8 + (lane % 4) * 2;
    const int64_t at = (((int64_t)b * p.Sk + k0 + r) * p.H + h) * D + c;
    *reinterpret_cast<__nv_bfloat162*>(dk_out + at) =
        __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
    *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
        __floats2bfloat162_rn(dv[i], dv[i + 1]);
  }
}

template <int D>
cudaError_t launch_dq(const Params& p, bool bf16_inputs, cudaStream_t s) {
  if (bf16_inputs)
    return launch(flash_bwd_dq_bf16_kernel<D>,
                  dim3(p.B * p.H, (p.Sq + BM - 1) / BM), WG_THREADS,
                  dq_bf16_smem_bytes<D>(), p, s);
  return launch(flash_bwd_dq_kernel<D>, dim3(p.B * p.H, (p.Sq + BQ - 1) / BQ),
                THREADS, dq_smem_bytes<D>(), p, s);
}

template <int D>
cudaError_t launch_dkv(const Params& p, bool bf16_inputs, cudaStream_t s) {
  if (bf16_inputs)
    return launch(flash_bwd_dkv_bf16_kernel<D>,
                  dim3(p.B * p.H, (p.Sk + BM - 1) / BM), WG_THREADS,
                  dkv_bf16_smem_bytes<D>(), p, s);
  return launch(flash_bwd_dkv_kernel<D>, dim3(p.B * p.H, (p.Sk + BK - 1) / BK),
                THREADS, dkv_smem_bytes<D>(), p, s);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, void* delta, int B,
                   int H, int Sq, int Sk, const int64_t* strides, int causal,
                   int q_offset, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.out = nullptr;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.y_sb = p.y_ss = p.y_sh = 0;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  return p;
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16; head_dim 64 or 128.
// `strides` holds the element strides over (B, S, H) of q, k, v and dO, in
// that order, and for the dq kernel then of O: 15 values, 12 for dk/dv.  The
// head dimension of each must be contiguous; for bfloat16 every pointer and
// stride must also be a multiple of 16 bytes.  lse and delta are contiguous
// fp32 (B*H, Sq).  Outputs are contiguous (B, S, H, D) tensors of the
// inputs' dtype.  Each returns the launch's cudaError_t (0 on success).

// dq: (B, Sq, H, D); also writes delta = rowsum(dO * O) for the dk/dv kernel.
extern "C" int alpa_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* lse, void* delta, void* dq, int dtype,
    int B, int H, int Sq, int Sk, int head_dim, const int64_t* strides,
    int causal, int q_offset, float scale, void* stream) {
  if (B * H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Sk <= 0 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Sq, Sk, strides,
                         causal, q_offset, scale);
  p.out = out;
  p.y_sb = strides[12]; p.y_ss = strides[13]; p.y_sh = strides[14];
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch_dq<64>(p, dtype == 1, s);
  if (head_dim == 128) return (int)launch_dq<128>(p, dtype == 1, s);
  return (int)cudaErrorInvalidValue;
}

// dk, dv: (B, Sk, H, D), from the delta the dq kernel wrote.
extern "C" int alpa_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int H, int Sq, int Sk, int head_dim, const int64_t* strides, int causal,
    int q_offset, float scale, void* stream) {
  if (B * H == 0 || Sk == 0) return (int)cudaSuccess;
  if (Sq < 0 || q_offset < 0 || (Sk + BK - 1) / BK > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, const_cast<void*>(delta), B, H,
                         Sq, Sk, strides, causal, q_offset, scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch_dkv<64>(p, dtype == 1, s);
  if (head_dim == 128) return (int)launch_dkv<128>(p, dtype == 1, s);
  return (int)cudaErrorInvalidValue;
}
