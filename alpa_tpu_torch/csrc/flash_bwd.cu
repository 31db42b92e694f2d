// Flash-attention backward for Hopper (sm_90a), fp32 accumulation.
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
//   * dS = P * (dO V^T - delta), with delta = rowsum(dO * O) computed by the
//     caller from O as saved (in q's dtype), as the JAX package computes it in
//     XLA outside Pallas (:359-361);
//   * dq = sm_scale * dS K, dk = sm_scale * dS^T Q, dv = P^T dO, each
//     accumulated in fp32 and written once in the inputs' dtype.
// Beyond it: q, k, v and dO are (B, S, H, D) tensors taken with their strides
// (the head dimension must be contiguous), lse and delta are contiguous fp32
// (B*H, Sq), and ragged tiles are masked here, so no length has to divide
// the tile.  A padded q row adds nothing to dk/dv (its P is set to 0, since
// its lse and delta are not defined); a key past Sk adds nothing to dq.  The
// dk/dv rows of a k tile that no q row can see are written as zeros.
//
// Design: 256 threads per block, each owning a 4x4 patch of a 64x64 tile of
// scores, as in flash_fwd.cu.
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
// Products run on the CUDA cores in fp32, the Pallas kernels' arithmetic
// (they cast bf16 inputs to fp32 before every product).
//
// Bound on an H100: at the training shape (B=8, H=32, S=1024, D=64, causal,
// bf16) the backward needs ~8.6e10 FLOP (five products over the visible
// pairs) and ~270 MB, so the card's floor is ~0.087 ms at the bf16 tensor
// core peak, just above the ~0.081 ms that memory needs.  These kernels do
// seven products (S and dP are formed in both) in fp32 on the CUDA cores
// (67 TFLOP/s peak, fewer in practice because every FMA pair needs a
// shared-memory load), so they are bound by FMA issue.  Left on the table:
// bf16 tensor-core products (mma.sync or wgmma), TMA loads into a multi-stage
// ring, and conflict-free transposed staging.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_ss, q_sh;  // element strides of q over (B, S, H)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // of dO
  int B, H, Sq, Sk;
  int causal;
  int q_offset;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// as fp32: transposed into t[D][stride] and, when r is given, also row-major
// into r[64][D].  Rows at or past `valid` are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* t, int stride, float* r,
                                      const T* src, int64_t row_stride,
                                      int row0, int valid) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int row = i / D, d = i % D;
    float x = 0.f;
    if (row < valid) x = load_f32(src + (int64_t)(row0 + row) * row_stride + d);
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

template <typename T, int D>
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  stage<T, D>(qt, QS, nullptr, q, p.q_ss, q0, rows);
  stage<T, D>(ot, QS, nullptr, dout, p.o_ss, q0, rows);

  float lse[4], delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    lse[i] = r < rows ? p.lse[(int64_t)bh * p.Sq + q0 + r] : 0.f;
    delta[i] = r < rows ? p.delta[(int64_t)bh * p.Sq + q0 + r] : 0.f;
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
    stage<T, D>(kt, KS, ks, k, p.k_ss, k0, keys);
    stage<T, D>(vt, KS, nullptr, v, p.v_ss, k0, keys);
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

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const int64_t row = ((int64_t)b * p.Sq + q0 + r) * p.H + h;
#pragma unroll
    for (int half = 0; half < NC / 4; ++half)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_from_f32(dq + row * D + half * 64 + tx * 4 + j,
                       acc[i][half * 4 + j] * p.scale);
  }
}

template <typename T, int D>
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  stage<T, D>(kt, KS, nullptr, k, p.k_ss, k0, keys);
  stage<T, D>(vt, KS, nullptr, v, p.v_ss, k0, keys);

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
    stage<T, D>(qt, QS, qs, q, p.q_ss, q0, rows);
    stage<T, D>(ot, QS, os, dout, p.o_ss, q0, rows);
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

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
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
        store_from_f32(dk_out + at, dk[i][half * 4 + j] * p.scale);
        store_from_f32(dv_out + at, dv[i][half * 4 + j]);
      }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int B, int H, int Sq, int Sk, const int64_t* strides,
                   int causal, int q_offset, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  return p;
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16; head_dim 64 or 128.
// `strides` holds 12 element strides, (B, S, H) of q, k, v and dO in that
// order; the head dimension of each must be contiguous.  lse and delta are
// contiguous fp32 (B*H, Sq).  Outputs are contiguous (B, S, H, D) tensors of
// the inputs' dtype.  Each returns the launch's cudaError_t (0 on success).

// dq: (B, Sq, H, D).
extern "C" int alpa_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int H,
    int Sq, int Sk, int head_dim, const int64_t* strides, int causal,
    int q_offset, float scale, void* stream) {
  if (B * H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Sk <= 0 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Sq, Sk, strides,
                         causal, q_offset, scale);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch_dq<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return (int)launch_dq<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_dq<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_dq<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

// dk, dv: (B, Sk, H, D).
extern "C" int alpa_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int H, int Sq, int Sk, int head_dim, const int64_t* strides, int causal,
    int q_offset, float scale, void* stream) {
  if (B * H == 0 || Sk == 0) return (int)cudaSuccess;
  if (Sq < 0 || q_offset < 0 || (Sk + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Sq, Sk, strides,
                         causal, q_offset, scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch_dkv<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return (int)launch_dkv<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_dkv<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_dkv<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
