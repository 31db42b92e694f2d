// Flash-attention forward for Hopper (sm_90a), fp32 accumulation.
//
// Replaces both forward Pallas kernels of the JAX package
// (alpa_tpu/ops/flash_attention.py): `_flash_fwd_kernel` (:62, k/v resident
// in VMEM) and `_flash_streaming_kernel` (:110, k/v streamed through a
// sequential grid dimension once they exceed the 4 MiB VMEM budget).  The
// two compute one function; the split was a limit of the TPU's VMEM.  Here a
// loop over k tiles inside the block takes the place of the sequential grid
// dimension, so one kernel covers every sequence length.
//
// Contract (the JAX kernels' `_online_softmax_update`, :37-102):
//   * q is scaled by 1/sqrt(D) in fp32 before Q K^T;
//   * causal mask q_pos + q_offset >= k_pos, masked scores are -1e9;
//   * m, l, acc accumulate in fp32, l is clamped at 1e-20;
//   * out = acc / l in q's dtype, lse = m + log(l) in fp32, laid out (B*H, Sq);
//   * under the causal mask no k tile past the last key the q tile can see
//     is read (the early exit of :95-96).
// Beyond it: q, k, v are (B, S, H, D) tensors taken with their strides (the
// head dimension must be contiguous), and ragged tiles are masked here, so
// no sequence length has to divide the tile.
//
// Design: one block of 256 threads per (batch*head, 64-row q tile).  The
// q tile sits transposed in shared memory; k and v are staged 64 rows at a
// time; each thread owns a 4x4 patch of the 64x64 score tile and 4 rows by
// D/16 columns of the output accumulator, all in fp32 registers, and the
// 16 threads that share rows reduce the row max and sum with shuffles.
// Products run on the CUDA cores in fp32, which keeps the JAX kernels'
// arithmetic (they also cast bf16 k/v to fp32 before both products).
//
// Bound on an H100: at the serving prefill shape (B=4, H=32, Sq=512,
// causal, D=64, bf16) the function needs ~4.3 GFLOP and ~34 MB, so the
// card's floor is set by memory (~10 us at 3.35 TB/s) and tensor-core peak
// would need ~4 us.  This kernel is instead bound by fp32 FMA issue on the
// CUDA cores (67 TFLOP/s peak, fewer in practice because every FMA pair
// needs a shared-memory load).  Left on the table: bf16 tensor-core
// products (mma.sync or wgmma, with P rounded to bf16), TMA loads into a
// multi-stage ring so that loads overlap the math, and warp specialisation.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 score patch each
constexpr int PAD = 4;        // row padding of the transposed tiles (floats)
constexpr int QS = BQ + PAD;  // row stride of q^T and p^T
constexpr int KS = BK + PAD;  // row stride of k^T
constexpr float MASKED = -1e9f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int64_t q_sb, q_ss, q_sh;  // element strides of q over (B, S, H)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
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

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * QS + D * KS + BK * D + BK * QS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;           // [D][QS]  q^T, scaled
  float* kt = qt + D * QS;    // [D][KS]  k^T of the current tile
  float* vs = kt + D * KS;    // [BK][D]  v of the current tile
  float* pt = vs + BK * D;    // [BK][QS] p^T of the current tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx*4.., output columns tx*4 (+64)
  const int ty = tid / 16;  // rows ty*4..ty*4+3
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int rows = min(BQ, p.Sq - q0);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < rows) x = load_f32(q + (int64_t)(q0 + r) * p.q_ss + d) * p.scale;
    qt[d * QS + r] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  // keys past k_end are never needed: out of range, or (causal) after the
  // last position the tile's last row can see
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + rows + p.q_offset);
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's kt/vs/pt are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < p.Sk) {
        kx = load_f32(k + (int64_t)(k0 + c) * p.k_ss + d);
        vx = load_f32(v + (int64_t)(k0 + c) * p.v_ss + d);
      }
      kt[d * KS + c] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * QS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * KS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i + p.q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx * 4 + j;
        if (k_pos >= p.Sk)
          s[i][j] = -INFINITY;  // ragged edge: no key at all
        else if (p.causal && q_pos < k_pos)
          s[i][j] = MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * QS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int c_end = min(BK, p.Sk - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pt + c * QS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int half = 0; half < NC / 4; ++half) {
        const float4 w =
            *reinterpret_cast<const float4*>(vs + c * D + half * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][half * 4 + j] = fmaf(av[i], wv[j], acc[i][half * 4 + j]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const float lc = fmaxf(l[i], 1e-20f);
    const int64_t row = ((int64_t)b * p.Sq + q0 + r) * p.H + h;
#pragma unroll
    for (int half = 0; half < NC / 4; ++half)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_from_f32(out + row * D + half * 64 + tx * 4 + j,
                       acc[i][half * 4 + j] / lc);
    if (tx == 0) p.lse[(int64_t)bh * p.Sq + q0 + r] = m[i] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Strides are in
// elements; the head dimension of q, k and v must be contiguous.  out is a
// contiguous (B, Sq, H, D) tensor of q's dtype, lse a contiguous fp32
// (B*H, Sq) tensor.  Returns the launch's cudaError_t (0 on success).
extern "C" int alpa_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int B, int H, int Sq, int Sk, int head_dim,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int causal, int q_offset, float scale, void* stream) {
  if (B * H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Sk <= 0 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return (int)launch<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return (int)launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
