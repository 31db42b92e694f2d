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
//   * scores are sm_scale * Q K^T in fp32;
//   * causal mask q_pos + q_offset >= k_pos, masked scores are -1e9;
//   * m, l, acc accumulate in fp32, l is clamped at 1e-20;
//   * out = acc / l in q's dtype, lse = m + log(l) in fp32, laid out (B*H, Sq);
//   * under the causal mask no k tile past the last key the q tile can see
//     is read (the early exit of :95-96).
// Beyond it: q, k, v are (B, S, H, D) tensors taken with their strides (the
// head dimension must be contiguous), and ragged tiles are masked here, so
// no sequence length has to divide the tile.
//
// bf16 (serving prefill and the training step) runs on the tensor cores.
// Bound on an H100: at the training shape (B=8, H=32, S=1024, D=64,
// causal) the function reads and writes 0.135 GB, 0.040 ms at 3.35 TB/s;
// its two products over the visible (q, k) pairs are 3.5e10 FLOP, 0.035 ms
// at the 989 TFLOP/s bf16 peak.  The design (that of the backward's dq
// kernel, whose loop this is):
//   * blocks of 128 q rows, two warpgroups of 64, the last q tiles (most
//     keys) launched first; at head dim 64 two blocks share an SM (at most
//     128 registers a thread), at 128 one;
//   * the q tile sits in shared memory as bf16 with the 128-byte swizzle;
//     64-key k and v tiles stream through a ring of four stages filled by
//     16-byte `cp.async`, two tiles ahead of the products, with one barrier
//     per tile, up to the last key the block's rows can see;
//   * S = Q K^T is a `wgmma` of bf16 tiles in shared memory, from the
//     unscaled q; S is scaled in fp32 in registers (exactly the JAX
//     kernels' arithmetic where sm_scale is a power of two, as at head dim
//     64), and the exponentials are `ex2.approx.ftz` with log2(e) folded
//     into the scale (a P below 2^-126 becomes 0, nothing beside l >= 1);
//   * the online softmax runs on the accumulator fragment: row max and sum
//     over the four threads that share a row, masks only on tiles at the
//     ragged edge or on the causal diagonal.  P = exp(S - m) stays in
//     registers and is rounded once to bf16, after l has summed it in fp32,
//     to be the A operand of O += P V, whose B operand is the row-major v
//     tile read MN-major through the descriptor.  One rounding keeps the
//     output within a bf16 ulp or two of the plain version, at head dim 128
//     too (unlike the backward's dS, P is never a difference of near-equal
//     terms; tests/test_torch_flash_attention.py models it);
//   * a warpgroup waits for the P V product of tile t only together with
//     S of tile t + 1, so that product overlaps the barrier and the loads
//     of the next iteration; the fourth stage keeps its v tile in place.
// Tried and dropped on the card (PERF.md): 128-key tiles at one
// block per SM, and a grid that runs the q tiles of one head together.
//
// fp32 keeps the JAX kernels' arithmetic on the CUDA cores, for the fidelity
// checks, where TF32's ~3 digits would not do: one block of 256 threads per
// (batch*head, 64-row q tile).  The q tile sits transposed in shared memory,
// scaled; k and v are staged 64 rows at a time; each thread owns a 4x4
// patch of the 64x64 score tile and 4 rows by D/16 columns of the output
// accumulator, all in fp32 registers, and the 16 threads that share rows
// reduce the row max and sum with shuffles.  It is bound by fp32 FMA issue
// (67 TFLOP/s peak, fewer in practice because every FMA pair needs a
// shared-memory load).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

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

template <int D>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < rows) x = q[(int64_t)(q0 + r) * p.q_ss + d] * p.scale;
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
        kx = k[(int64_t)(k0 + c) * p.k_ss + d];
        vx = v[(int64_t)(k0 + c) * p.v_ss + d];
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

  float* out = static_cast<float*>(p.out);
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
        out[row * D + half * 64 + tx * 4 + j] = acc[i][half * 4 + j] / lc;
    if (tx == 0) p.lse[(int64_t)bh * p.Sq + q0 + r] = m[i] + logf(lc);
  }
}

// k/v stages of the bf16 kernel: loads run two tiles ahead, as in the
// backward, and a fourth stage keeps tile t - 1's v in place while its P V
// product still runs during iteration t
constexpr int KV_STAGES = 4;

template <int D>
constexpr int bf16_smem_bytes() {  // the q tile; stages of k and v
  return 1024 + BM * D * 2 + KV_STAGES * 2 * BN * D * 2;
}

// s = Q K^T for one warpgroup: its 64 rows of the BM-row q tile against a
// 64-row k tile, both K-major over D
template <int D>
__device__ __forceinline__ void mma_qk(float (&s)[32], uint32_t q, uint32_t k,
                                       int wg) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  sm90::fence_regs(s);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qo = (kk / 4) * (BM * 128) + wg * (64 * 128) + (kk % 4) * 32;
    const uint32_t ko = (kk / 4) * (BN * 128) + (kk % 4) * 32;
    sm90::wgmma_ss_n64(s, sm90::kmajor_desc(q + qo), sm90::kmajor_desc(k + ko),
                       kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, D == 64 ? 2 : 1)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr uint32_t Q_TILE = BM * D * 2;  // bytes of the q tile
  constexpr uint32_t K_TILE = BN * D * 2;  // bytes of one k or v stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t q_s = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + Q_TILE;              // KV_STAGES k tiles
  const uint32_t v_s = k_s + KV_STAGES * K_TILE;  // KV_STAGES v tiles

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

  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + rows + p.q_offset);
  const int n_tiles = (k_end + BN - 1) / BN;
  auto load_kv = [&](int t) {
    const uint32_t stage = (t % KV_STAGES) * K_TILE;
    load_tile<BN, D>(k_s + stage, k, p.k_ss, t * BN, p.Sk - t * BN);
    load_tile<BN, D>(v_s + stage, v, p.v_ss, t * BN, p.Sk - t * BN);
  };
  load_tile<BM, D>(q_s, q, p.q_ss, q0, rows);
  load_kv(0);
  sm90::cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  sm90::cp_async_commit();

  // this thread's accumulator rows: r0 and r0 + 8.  m is the running row
  // max of the unscaled scores; l sums this thread's share of the row
  const int r0 = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const float scale_log2 = p.scale * LOG2E;
  const float masked = MASKED / p.scale;  // a masked score, unscaled
  float m[2] = {masked, masked}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int wg_last = min(rows, wg * 64 + 64) - 1;  // last row that exists
  // P in bf16, the A operand of P V: it outlives the iteration, since the
  // product of tile t runs on until the wait for S of tile t + 1
  uint32_t pf[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) pf[i / 4][i % 4] = 0u;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    const uint32_t ks = k_s + (t % KV_STAGES) * K_TILE;
    const uint32_t vs = v_s + (t % KV_STAGES) * K_TILE;
    ring_wait();
    if (t + 2 < n_tiles) load_kv(t + 2);  // overlaps the next two tiles
    sm90::cp_async_commit();
    // a warpgroup whose rows are all padding or all masked skips the tile
    if (wg_last < wg * 64 || (p.causal && q0 + wg_last + p.q_offset < k0))
      continue;
    float s[32];
    mma_qk<D>(s, q_s, ks, wg);  // its wait also ends the last P V product
    sm90::fence_regs(acc);
    sm90::fence_regs(pf);
    auto softmax = [&](auto masked_tile) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i / 2) % 2;
        if constexpr (decltype(masked_tile)::value) {
          const int key = k0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
          if (key >= p.Sk)
            s[i] = -INFINITY;  // ragged edge: no key at all
          else if (p.causal && q0 + r0 + 8 * e + p.q_offset < key)
            s[i] = masked;
        }
        mx[e] = fmaxf(mx[e], s[i]);
      }
      float alpha[2], mb[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        alpha[e] = sm90::exp2_ftz((m[e] - mx[e]) * scale_log2);
        m[e] = mx[e];
        mb[e] = mx[e] * scale_log2;
        l[e] *= alpha[e];
      }
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int e = (i / 2) % 2;
        const float p0 = sm90::exp2_ftz(s[i] * scale_log2 - mb[e]);
        const float p1 = sm90::exp2_ftz(s[i + 1] * scale_log2 - mb[e]);
        l[e] += p0 + p1;
        const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        pf[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pb);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    };
    if (k0 + BN > p.Sk ||
        (p.causal && q0 + wg * 64 + p.q_offset < k0 + BN - 1))
      softmax(std::true_type());
    else
      softmax(std::false_type());
    sm90::wgmma_fence();
    mma_rs<D>(acc, pf, vs);
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  float lc[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // the four threads of a row hold its sum
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    lc[e] = fmaxf(l[e], 1e-20f);
    const int r = r0 + 8 * e;
    if (r < rows && lane % 4 == 0)
      p.lse[(int64_t)bh * p.Sq + q0 + r] = m[e] * p.scale + logf(lc[e]);
  }
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int e = (i / 2) % 2;
    const int r = r0 + 8 * e;
    if (r >= rows) continue;
    const int c = (i / 4) * 8 + (lane % 4) * 2;
    const int64_t row = ((int64_t)b * p.Sq + q0 + r) * p.H + h;
    *reinterpret_cast<__nv_bfloat162*>(out + row * D + c) =
        __floats2bfloat162_rn(acc[i] / lc[e], acc[i + 1] / lc[e]);
  }
}

template <int D>
cudaError_t launch_fwd(const Params& p, bool bf16_inputs, cudaStream_t s) {
  if (bf16_inputs)
    return launch(flash_fwd_bf16_kernel<D>,
                  dim3(p.B * p.H, (p.Sq + BM - 1) / BM), WG_THREADS,
                  bf16_smem_bytes<D>(), p, s);
  return launch(flash_fwd_kernel<D>, dim3(p.B * p.H, (p.Sq + BQ - 1) / BQ),
                THREADS, smem_bytes<D>(), p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Strides are in
// elements; the head dimension of q, k and v must be contiguous, and for
// bfloat16 every pointer and stride must also be a multiple of 16 bytes.
// out is a contiguous (B, Sq, H, D) tensor of q's dtype, lse a contiguous
// fp32 (B*H, Sq) tensor.  Returns the launch's cudaError_t (0 on success).
extern "C" int alpa_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int B, int H, int Sq, int Sk, int head_dim,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int causal, int q_offset, float scale, void* stream) {
  if (B * H == 0 || Sq == 0) return (int)cudaSuccess;
  if (Sk <= 0 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch_fwd<64>(p, dtype == 1, s);
  if (head_dim == 128) return (int)launch_fwd<128>(p, dtype == 1, s);
  return (int)cudaErrorInvalidValue;
}
