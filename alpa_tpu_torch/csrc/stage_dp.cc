// The inter-op stage construction dynamic program (Alpa, OSDI'22), the
// port's own copy of the JAX package's csrc/stage_dp.cc (the same C ABI,
// version 2, and the same inflight modes).  Host C++, built with g++ at
// first use by alpa_tpu_torch/ops/_build.py and loaded by
// alpa_tpu_torch/pipeline_parallel/stage_dp.py through ctypes.
//
// Problem: split L contiguous layers into stages; give stage t a submesh
// from the choice list (n_m devices each) so submesh sizes sum to exactly D;
// minimize  sum_t cost_t + (B - 1) * max_t cost_t
// where cost_t = C[i][j][m] for layers i..j on submesh m and B = number of
// microbatches.  Solved by iterating candidate values of max_t cost_t
// (t_max) and, for each, a DP over (first uncovered layer, devices left,
// stages in the suffix) minimizing the total sum subject to every stage
// cost <= t_max.
//
// Memory feasibility is position-aware: the s-th stage from the END holds
// some number of in-flight microbatches of activations that depends on the
// schedule, so the budget check for a candidate stage is
//   mem_param + inflight(s) * mem_act <= mem_budget
// which requires the suffix-stage count s as a DP dimension.  inflight_mode
// selects the schedule's in-flight profile:
//   0 = 1F1B:             min(s, B)
//   1 = GPipe:            B        (all microbatches live before backward)
//   2 = overlap-friendly: min(2s-1, B)  (eager forwards hold ~2x)
//   3 = inference:        1        (forward-only, nothing stacks)
//
// Exported C ABI (ctypes):
//   int stage_dp_abi_version() -> kAbiVersion (the loader refuses another)
//   int stage_dp_solve(L, M, D, B, inflight_mode, C[L*L*M], n_devices[M],
//                      mem_param[L*L*M], mem_act[L*L*M], mem_budget,
//                      out_starts[L], out_meshes[L]) ->
//   number of stages (or -1 if infeasible). Stage t covers layers
//   out_starts[t] .. out_starts[t+1]-1 on submesh out_meshes[t].
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr int32_t kAbiVersion = 2;

double inflight_count(int s, int B, int32_t mode) {
  const int b = B > 0 ? B : 1;
  switch (mode) {
    case 1:  return b;                          // gpipe
    case 2:  return std::min(2 * s - 1, b);     // overlap-friendly 1f1b
    case 3:  return 1.0;                        // inference
    default: return std::min(s, b);             // 1f1b
  }
}

struct DPResult {
  double total;
  std::vector<int> starts;
  std::vector<int> meshes;
};

// DP for a fixed t_max: f[l][d][s] = min total cost covering layers l..L-1
// with exactly d devices left in exactly s stages.
bool run_dp(int L, int M, int D, int B, int32_t inflight_mode,
            const double* C, const int64_t* ndev,
            const double* mem_param, const double* mem_act,
            double mem_budget, double t_max, DPResult* out) {
  const int stride_j = M;
  const int stride_i = L * M;
  const int S = L + 1;
  std::vector<double> f(static_cast<size_t>(L + 1) * (D + 1) * S, kInf);
  std::vector<int32_t> choice_j(f.size(), -1);
  std::vector<int32_t> choice_m(f.size(), -1);
  auto idx = [D, S](int l, int d, int s) {
    return (static_cast<size_t>(l) * (D + 1) + d) * S + s;
  };
  f[idx(L, 0, 0)] = 0.0;

  for (int l = L - 1; l >= 0; --l) {
    for (int d = 1; d <= D; ++d) {
      for (int s = 1; s <= L - l; ++s) {
        double best = kInf;
        int bj = -1, bm = -1;
        // in-flight microbatches for the stage s-from-the-end
        const double inflight = inflight_count(s, B, inflight_mode);
        for (int j = l; j < L; ++j) {
          const double* row = C + l * stride_i + j * stride_j;
          const double* prow = mem_param + l * stride_i + j * stride_j;
          const double* arow = mem_act + l * stride_i + j * stride_j;
          for (int m = 0; m < M; ++m) {
            const int64_t n = ndev[m];
            if (n > d) continue;
            const double c = row[m];
            if (c > t_max || c >= kInf) continue;
            if (mem_budget > 0 &&
                prow[m] + inflight * arow[m] > mem_budget)
              continue;
            const double rest =
                f[idx(j + 1, d - static_cast<int>(n), s - 1)];
            if (rest >= kInf) continue;
            const double tot = c + rest;
            if (tot < best) {
              best = tot;
              bj = j;
              bm = m;
            }
          }
        }
        f[idx(l, d, s)] = best;
        choice_j[idx(l, d, s)] = bj;
        choice_m[idx(l, d, s)] = bm;
      }
    }
  }
  double best_total = kInf;
  int best_s = -1;
  for (int s = 1; s <= L; ++s) {
    if (f[idx(0, D, s)] < best_total) {
      best_total = f[idx(0, D, s)];
      best_s = s;
    }
  }
  if (best_s < 0) return false;

  out->total = best_total;
  out->starts.clear();
  out->meshes.clear();
  int l = 0, d = D, s = best_s;
  while (l < L) {
    const int j = choice_j[idx(l, d, s)];
    const int m = choice_m[idx(l, d, s)];
    if (j < 0 || m < 0) return false;
    out->starts.push_back(l);
    out->meshes.push_back(m);
    d -= static_cast<int>(ndev[m]);
    l = j + 1;
    s -= 1;
  }
  return d == 0 && s == 0;
}

}  // namespace

extern "C" {

int32_t stage_dp_abi_version() { return kAbiVersion; }

int stage_dp_solve(int32_t L, int32_t M, int32_t D, int32_t B,
                   int32_t inflight_mode,
                   const double* C, const int64_t* n_devices,
                   const double* mem_param, const double* mem_act,
                   double mem_budget, int32_t* out_starts,
                   int32_t* out_meshes) {
  if (L <= 0 || M <= 0 || D <= 0) return -1;
  // Candidate t_max values: every distinct finite stage cost.
  std::vector<double> candidates;
  candidates.reserve(static_cast<size_t>(L) * L * M);
  for (int i = 0; i < L; ++i)
    for (int j = i; j < L; ++j)
      for (int m = 0; m < M; ++m) {
        const double c = C[(i * L + j) * M + m];
        if (c < kInf) candidates.push_back(c);
      }
  if (candidates.empty()) return -1;
  std::sort(candidates.begin(), candidates.end());
  candidates.erase(std::unique(candidates.begin(), candidates.end()),
                   candidates.end());

  double best_obj = kInf;
  DPResult best;
  DPResult cur;
  for (double t_max : candidates) {
    if (best_obj < kInf && (B - 1) * t_max >= best_obj) break;
    if (!run_dp(L, M, D, B, inflight_mode, C, n_devices, mem_param, mem_act,
                mem_budget, t_max, &cur))
      continue;
    const double obj = cur.total + (B - 1) * t_max;
    if (obj < best_obj) {
      best_obj = obj;
      best = cur;
    }
  }
  if (best_obj >= kInf) return -1;
  const int S = static_cast<int>(best.starts.size());
  for (int t = 0; t < S; ++t) {
    out_starts[t] = best.starts[t];
    out_meshes[t] = best.meshes[t];
  }
  return S;
}

}  // extern "C"
