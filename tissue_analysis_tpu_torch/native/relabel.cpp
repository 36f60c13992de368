// Native ingest kernel: dense relabeling of a labeled voxel stack.
//
// TPU-native equivalent of the host-side densification step (SURVEY.md §7.1):
// original label ids -> contiguous segments 0..N-1, background pinned to
// segment 0. The pure-numpy path (`np.unique(..., return_inverse=True)`) is a
// full O(V log V) sort over the stack (seconds at 512^3); this is a two-pass
// O(V) table/hash scheme, OpenMP-parallel, memory-bound.
//
// Exposed C ABI (ctypes):
//   int64_t ta_relabel(const void* in, int64_t n, int dtype_code,
//                      int64_t background, int has_background,
//                      int32_t* dense_out, int64_t* ids_out, int64_t max_ids,
//                      int64_t* bg_segment_out);
// Returns the number of distinct labels N (ids_out[0..N-1] ascending except
// that the background label, when present, is swapped to position 0), or
// -N if N > max_ids (caller re-allocates and retries). dense_out[i] is the
// segment of voxel i. *bg_segment_out = 0 if background present else -1.
//
// dtype codes: 0=u8 1=u16 2=u32 3=i32 4=i64 5=u64

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------- small-domain path: direct presence table (u8/u16) ----------
template <typename T, typename OutT>
int64_t relabel_direct(const T* in, int64_t n, int64_t background,
                       bool has_background, OutT* dense, int64_t* ids,
                       int64_t max_ids, int64_t* bg_segment_out) {
  constexpr int64_t DOMAIN = int64_t(1) << (8 * sizeof(T));
  std::vector<uint8_t> present(DOMAIN, 0);

#pragma omp parallel
  {
    std::vector<uint8_t> local(DOMAIN, 0);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) local[in[i]] = 1;
#pragma omp critical
    for (int64_t v = 0; v < DOMAIN; ++v)
      if (local[v]) present[v] = 1;
  }

  // ranks: ascending label order, background swapped to 0 afterwards
  std::vector<int32_t> rank(DOMAIN, -1);
  int64_t n_ids = 0;
  for (int64_t v = 0; v < DOMAIN; ++v)
    if (present[v]) ++n_ids;
  if (n_ids > max_ids) return -n_ids;
  {
    int32_t r = 0;
    for (int64_t v = 0; v < DOMAIN; ++v)
      if (present[v]) {
        rank[v] = r;
        ids[r] = v;
        ++r;
      }
  }

  int64_t bg_segment = -1;
  if (has_background && background >= 0 && background < DOMAIN &&
      present[background]) {
    int32_t bg_rank = rank[background];
    if (bg_rank != 0) {
      // swap segment bg_rank <-> 0 in both table and rank map
      std::swap(ids[0], ids[bg_rank]);
      rank[ids[bg_rank]] = bg_rank;
      rank[background] = 0;
    }
    bg_segment = 0;
  }
  *bg_segment_out = bg_segment;

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) dense[i] = OutT(rank[in[i]]);
  return n_ids;
}

// ---------- wide-domain path: open-addressing hash ----------
struct Hash {
  // power-of-two open addressing; EMPTY = INT64_MIN sentinel
  static constexpr int64_t EMPTY = INT64_MIN;
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit Hash(int64_t capacity) {
    uint64_t size = 64;
    while (size < uint64_t(capacity) * 2) size <<= 1;
    keys.assign(size, EMPTY);
    vals.assign(size, -1);
    mask = size - 1;
  }
  static uint64_t mix(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
  }
  // insert key if absent; returns slot index
  uint64_t insert(int64_t k) {
    uint64_t h = mix(uint64_t(k)) & mask;
    while (true) {
      if (keys[h] == k) return h;
      if (keys[h] == EMPTY) {
        keys[h] = k;
        return h;
      }
      h = (h + 1) & mask;
    }
  }
  uint64_t find(int64_t k) const {
    uint64_t h = mix(uint64_t(k)) & mask;
    while (keys[h] != k) h = (h + 1) & mask;
    return h;
  }
};

template <typename T, typename OutT>
int64_t relabel_hash(const T* in, int64_t n, int64_t background,
                     bool has_background, OutT* dense, int64_t* ids,
                     int64_t max_ids, int64_t* bg_segment_out) {
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  // per-thread unique collection (hash sized for typical cell counts, grows
  // by rebuild on overflow — labels are < ~1e6 distinct in practice)
  std::vector<std::vector<int64_t>> locals(nthreads);

#pragma omp parallel num_threads(nthreads)
  {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    Hash h(1 << 12);
    std::vector<int64_t>& uniq = locals[tid];
    int64_t prev = INT64_MIN;  // labeled images are runs; cheap dedup
    bool have_prev = false;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      int64_t k = int64_t(in[i]);
      if (have_prev && k == prev) continue;
      prev = k;
      have_prev = true;
      uint64_t slot = h.insert(k);
      if (h.vals[slot] < 0) {
        h.vals[slot] = 1;
        uniq.push_back(k);
        if (uniq.size() * 2 > h.keys.size()) {
          Hash bigger(int64_t(h.keys.size()));  // capacity*2 inside ctor
          for (int64_t u : uniq) bigger.vals[bigger.insert(u)] = 1;
          h = std::move(bigger);
        }
      }
    }
  }

  // merge + sort unique labels
  std::vector<int64_t> all;
  for (auto& v : locals) all.insert(all.end(), v.begin(), v.end());
  std::sort(all.begin(), all.end());
  all.erase(std::unique(all.begin(), all.end()), all.end());
  int64_t n_ids = int64_t(all.size());
  if (n_ids > max_ids) return -n_ids;

  // global rank hash (background swapped to segment 0)
  int64_t bg_segment = -1;
  if (has_background) {
    auto it = std::lower_bound(all.begin(), all.end(), background);
    if (it != all.end() && *it == background) {
      // SWAP (not rotate): must match LabeledStack.from_array's numpy-path
      // convention exactly so both paths produce identical segment ids
      std::iter_swap(all.begin(), it);
      bg_segment = 0;
    }
  }
  *bg_segment_out = bg_segment;
  std::memcpy(ids, all.data(), size_t(n_ids) * sizeof(int64_t));

  Hash rank(n_ids);
  for (int64_t r = 0; r < n_ids; ++r) rank.vals[rank.insert(all[r])] = int32_t(r);

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    dense[i] = OutT(rank.vals[rank.find(int64_t(in[i]))]);
  return n_ids;
}

}  // namespace

template <typename OutT>
int64_t relabel_any(const void* in, int64_t n, int dtype_code,
                    int64_t background, int has_background, OutT* dense_out,
                    int64_t* ids_out, int64_t max_ids,
                    int64_t* bg_segment_out) {
  switch (dtype_code) {
    case 0:
      return relabel_direct(static_cast<const uint8_t*>(in), n, background,
                            has_background, dense_out, ids_out, max_ids,
                            bg_segment_out);
    case 1:
      return relabel_direct(static_cast<const uint16_t*>(in), n, background,
                            has_background, dense_out, ids_out, max_ids,
                            bg_segment_out);
    case 2:
      return relabel_hash(static_cast<const uint32_t*>(in), n, background,
                          has_background, dense_out, ids_out, max_ids,
                          bg_segment_out);
    case 3:
      return relabel_hash(static_cast<const int32_t*>(in), n, background,
                          has_background, dense_out, ids_out, max_ids,
                          bg_segment_out);
    case 4:
      return relabel_hash(static_cast<const int64_t*>(in), n, background,
                          has_background, dense_out, ids_out, max_ids,
                          bg_segment_out);
    case 5:
      return relabel_hash(static_cast<const uint64_t*>(in), n, background,
                          has_background, dense_out, ids_out, max_ids,
                          bg_segment_out);
    default:
      return INT64_MIN;  // unsupported dtype
  }
}

extern "C" {

int64_t ta_relabel(const void* in, int64_t n, int dtype_code,
                   int64_t background, int has_background, int32_t* dense_out,
                   int64_t* ids_out, int64_t max_ids,
                   int64_t* bg_segment_out) {
  return relabel_any(in, n, dtype_code, background, has_background, dense_out,
                     ids_out, max_ids, bg_segment_out);
}

// uint16 dense output — valid only when the label count fits (caller retries
// via ta_relabel if the returned count exceeds 0xFFFF).
int64_t ta_relabel_u16(const void* in, int64_t n, int dtype_code,
                       int64_t background, int has_background,
                       uint16_t* dense_out, int64_t* ids_out, int64_t max_ids,
                       int64_t* bg_segment_out) {
  if (max_ids > 0xFFFF) max_ids = 0xFFFF;
  return relabel_any(in, n, dtype_code, background, has_background, dense_out,
                     ids_out, max_ids, bg_segment_out);
}

// Batched symmetric 3x3 eigendecomposition — the analytic algorithm of
// features/finalize.py::_eigh3 (Cardano eigenvalues, cross-product
// eigenvectors), one scalar pass per matrix instead of ~40 whole-batch
// numpy passes (measured 2.6 ms -> ~0.1 ms for the 2k-label 512^3 graph
// export, the single largest host property cost). Ill-conditioned rows
// (near-degenerate spectrum / degenerate cross products) are only FLAGGED
// in bad_out — the Python caller recomputes them with LAPACK, exactly as
// the numpy path does. Returns the number of flagged rows.
int64_t ta_eigh3(const double* A, int64_t m, double* w_out, double* V_out,
                 uint8_t* bad_out) {
  int64_t nbad = 0;
#pragma omp parallel for schedule(static) reduction(+ : nbad)
  for (int64_t r = 0; r < m; ++r) {
    const double* a9 = A + 9 * r;
    double mag = 0.0;
    for (int i = 0; i < 9; ++i) {
      double v = std::fabs(a9[i]);
      if (v > mag) mag = v;
    }
    const double mags = mag > 0.0 ? mag : 1.0;
    double a[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) a[i][j] = a9[3 * i + j] / mags;

    const double q = (a[0][0] + a[1][1] + a[2][2]) / 3.0;
    double B[3][3];
    double ss = 0.0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        B[i][j] = a[i][j] - (i == j ? q : 0.0);
        ss += B[i][j] * B[i][j];
      }
    const double p = std::sqrt(ss / 6.0);
    const double ps = p > 0.0 ? p : 1.0;
    double Bn[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Bn[i][j] = B[i][j] / ps;
    const double det =
        Bn[0][0] * (Bn[1][1] * Bn[2][2] - Bn[1][2] * Bn[1][2]) -
        Bn[0][1] * (Bn[0][1] * Bn[2][2] - Bn[1][2] * Bn[0][2]) +
        Bn[0][2] * (Bn[0][1] * Bn[1][2] - Bn[1][1] * Bn[0][2]);
    double half = det / 2.0;
    if (half > 1.0) half = 1.0;
    if (half < -1.0) half = -1.0;
    const double phi = std::acos(half) / 3.0;
    const double TWO_PI_3 = 2.0943951023931953;  // 2*pi/3
    const double w2 = q + 2.0 * p * std::cos(phi);
    const double w0 = q + 2.0 * p * std::cos(phi + TWO_PI_3);
    const double w1 = 3.0 * q - w2 - w0;

    // eigenvector for lam: the largest cross product of two rows of
    // (a - lam I); first index wins ties, matching np.argmax
    double v0[3], v1[3], v2[3];
    double n0 = 0.0, n2 = 0.0;
    for (int which = 0; which < 2; ++which) {
      const double lam = which == 0 ? w0 : w2;
      double M[3][3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) M[i][j] = a[i][j] - (i == j ? lam : 0.0);
      double C[3][3];
      C[0][0] = M[1][1] * M[2][2] - M[1][2] * M[2][1];
      C[0][1] = M[1][2] * M[2][0] - M[1][0] * M[2][2];
      C[0][2] = M[1][0] * M[2][1] - M[1][1] * M[2][0];
      C[1][0] = M[2][1] * M[0][2] - M[2][2] * M[0][1];
      C[1][1] = M[2][2] * M[0][0] - M[2][0] * M[0][2];
      C[1][2] = M[2][0] * M[0][1] - M[2][1] * M[0][0];
      C[2][0] = M[0][1] * M[1][2] - M[0][2] * M[1][1];
      C[2][1] = M[0][2] * M[1][0] - M[0][0] * M[1][2];
      C[2][2] = M[0][0] * M[1][1] - M[0][1] * M[1][0];
      int pick = 0;
      double best = -1.0;
      for (int c = 0; c < 3; ++c) {
        const double nsq =
            C[c][0] * C[c][0] + C[c][1] * C[c][1] + C[c][2] * C[c][2];
        if (nsq > best) {
          best = nsq;
          pick = c;
        }
      }
      const double nrm = std::sqrt(best);
      const double div = nrm > 0.0 ? nrm : 1.0;
      double* v = which == 0 ? v0 : v2;
      for (int i = 0; i < 3; ++i) v[i] = C[pick][i] / div;
      if (which == 0)
        n0 = nrm;
      else
        n2 = nrm;
    }
    v1[0] = v2[1] * v0[2] - v2[2] * v0[1];
    v1[1] = v2[2] * v0[0] - v2[0] * v0[2];
    v1[2] = v2[0] * v0[1] - v2[1] * v0[0];
    const double n1 =
        std::sqrt(v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2]);
    const double d1 = n1 > 0.0 ? n1 : 1.0;
    for (int i = 0; i < 3; ++i) v1[i] /= d1;

    double wmax = std::fabs(w0);
    if (std::fabs(w1) > wmax) wmax = std::fabs(w1);
    if (std::fabs(w2) > wmax) wmax = std::fabs(w2);
    const double scale = wmax > 1e-300 ? wmax : 1e-300;
    const double gap = std::min(w1 - w0, w2 - w1);
    const bool finite =
        std::isfinite(w0) && std::isfinite(w1) && std::isfinite(w2);
    const bool bad =
        (gap <= 1e-5 * scale) || n0 == 0.0 || n2 == 0.0 || n1 < 0.5 || !finite;
    bad_out[r] = bad ? 1 : 0;
    if (bad) ++nbad;

    w_out[3 * r + 0] = w0 * mags;
    w_out[3 * r + 1] = w1 * mags;
    w_out[3 * r + 2] = w2 * mags;
    double* Vr = V_out + 9 * r;  // V[i][axis]: columns are eigenvectors
    for (int i = 0; i < 3; ++i) {
      Vr[3 * i + 0] = v0[i];
      Vr[3 * i + 1] = v1[i];
      Vr[3 * i + 2] = v2[i];
    }
  }
  return nbad;
}

// Version tag so the Python side can invalidate stale cached builds.
int64_t ta_native_abi_version() { return 3; }

}  // extern "C"
