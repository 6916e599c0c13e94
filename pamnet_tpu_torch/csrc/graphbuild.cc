// Host graph construction of the port: radius and knn neighbour search and
// the incoming-edge expansion behind the triplet and pair tables (reference:
// models.py:110,143 radius/knn; models.py:68-98 the SparseTensor expansion),
// the padded concatenations of batch collation (data/batch.py's
// CollatePlan), each batch's CSR arrays (csr_offsets over rows sorted by
// a key; csr_perm, the stable sort of the backward's keyed rows), and a
// structure's host spherical basis (sbf_radial, cbf: data/batch.py's
// attach_basis_np in one pass over the edges and triplets).
//
// A copy of the JAX package's csrc/graphbuild.cc (radius_graph, knn_graph,
// expand_incoming, concat_offset_i32, concat_rows_f32; csr_perm and
// csr_offsets are the port's own), changed so that each function gives the
// numpy path's arrays bit for bit
// (pamnet_tpu_torch/data/graphbuild.py, data/batch.py):
//   * radius_graph emits each query's sources in index order and keeps the
//     first max_nb of them, and compares the float32 squared distance with
//     the caller's float32 r2 (numpy compares at float32(r * r));
//   * knn_graph measures distances in double, as the numpy builder does,
//     and breaks distance ties by index;
//   * concat_offset_i32 adds the offsets with int32 wraparound, as numpy
//     does;
//   * csr_perm is build_perm_np's stable argsort and bincount, csr_offsets
//     _offsets' sortedness check and searchsorted;
//   * sbf_radial and cbf evaluate attach_basis_np's float64 formulas in its
//     order of operations (no contraction into fused multiply-adds:
//     -ffp-contract=off) and round each value to float32 once at the end.
//     The powers u^k of j_l's closed form are carried in double-double and
//     rounded once, so each is the correctly rounded power that numpy's
//     `**` gives; a power built by plain multiplication errs by up to k/2
//     ulps, which the closed form's cancellation at small arguments (the
//     1e-12 clamp of two coincident atoms) magnifies into other float32
//     values.  The closed form's sums run left to right, where numpy's
//     BLAS gemv adds them in lanes: at small arguments that moves a float32
//     value by an ulp now and then.
// Built with g++ at first use and loaded through ctypes
// (pamnet_tpu_torch/data/native.py).
//
// Output convention: results go into caller-supplied buffers, the first
// array at out[0..m), the second at out[cap..cap+m); the row count m is
// returned, or -1 when it would pass cap (the caller retries larger).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

// Per-graph contiguous ranges of a sorted graph-indicator vector.
std::vector<std::pair<int64_t, int64_t>> graph_ranges(const int64_t* batch,
                                                      int64_t n) {
  std::vector<std::pair<int64_t, int64_t>> ranges;
  int64_t start = 0;
  for (int64_t i = 1; i <= n; ++i) {
    if (i == n || batch[i] != batch[start]) {
      if (i > start) ranges.emplace_back(start, i);
      start = i;
    }
  }
  return ranges;
}

struct Cell {
  int32_t x, y, z;
};

uint64_t key_of(const Cell& c) {
  return ((uint64_t)(uint32_t)c.x << 42) ^ ((uint64_t)(uint32_t)c.y << 21) ^
         (uint64_t)(uint32_t)c.z;
}

// pw[0..k_max] = u^0..u^k_max, each the double-double product rounded once
// (the exact power correctly rounded but for ties within 2^-100).
void powers(double u, int64_t k_max, double* pw) {
  pw[0] = 1.0;
  if (k_max < 1) return;
  pw[1] = u;
  double hi = u, lo = 0.0;
  for (int64_t k = 2; k <= k_max; ++k) {
    const double p = hi * u;
    const double e = std::fma(hi, u, -p) + lo * u;
    hi = p + e;
    lo = e - (hi - p);
    pw[k] = hi;
  }
}

// Whether every index of idx[0..m) lies in [0, n).
bool in_range(const int32_t* idx, int64_t m, int64_t n) {
  for (int64_t i = 0; i < m; ++i)
    if (idx[i] < 0 || idx[i] >= n) return false;
  return true;
}

}  // namespace

extern "C" {

// Every (query, source) pair of one graph with squared distance <= r2
// (float32, as ((dx*dx + dy*dy) + dz*dz)), self included, query-major,
// sources in index order, at most max_nb a query.  Cells of side `cell`
// (slightly above the radius) bucket the sources: every candidate lies in
// one of the 27 cells around its query.
int64_t radius_graph(const float* pos, const int64_t* batch, int64_t n,
                     float cell, float r2, int64_t max_nb, int32_t* out,
                     int64_t cap) {
  int64_t m = 0;
  std::vector<std::pair<uint64_t, int64_t>> keyed;
  std::vector<int64_t> found;
  for (const auto& [lo, hi] : graph_ranges(batch, n)) {
    float mn[3] = {pos[lo * 3], pos[lo * 3 + 1], pos[lo * 3 + 2]};
    for (int64_t i = lo; i < hi; ++i)
      for (int d = 0; d < 3; ++d) mn[d] = std::min(mn[d], pos[i * 3 + d]);
    auto cell_of = [&](int64_t i) -> Cell {
      return Cell{(int32_t)((pos[i * 3 + 0] - mn[0]) / cell),
                  (int32_t)((pos[i * 3 + 1] - mn[1]) / cell),
                  (int32_t)((pos[i * 3 + 2] - mn[2]) / cell)};
    };
    keyed.resize(hi - lo);
    for (int64_t i = lo; i < hi; ++i) keyed[i - lo] = {key_of(cell_of(i)), i};
    std::sort(keyed.begin(), keyed.end());
    for (int64_t q = lo; q < hi; ++q) {
      const Cell c = cell_of(q);
      found.clear();
      for (int dx = -1; dx <= 1; ++dx)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dz = -1; dz <= 1; ++dz) {
            const uint64_t key = key_of(Cell{c.x + dx, c.y + dy, c.z + dz});
            auto it = std::lower_bound(keyed.begin(), keyed.end(),
                                       std::make_pair(key, (int64_t)-1));
            for (; it != keyed.end() && it->first == key; ++it) {
              const int64_t s = it->second;
              const float ddx = pos[q * 3] - pos[s * 3];
              const float ddy = pos[q * 3 + 1] - pos[s * 3 + 1];
              const float ddz = pos[q * 3 + 2] - pos[s * 3 + 2];
              const float xx = ddx * ddx;
              const float yy = ddy * ddy;
              const float zz = ddz * ddz;
              if ((xx + yy) + zz <= r2) found.push_back(s);
            }
          }
      std::sort(found.begin(), found.end());
      const int64_t take = std::min<int64_t>((int64_t)found.size(), max_nb);
      if (m + take > cap) return -1;
      for (int64_t j = 0; j < take; ++j) {
        out[m] = (int32_t)q;
        out[cap + m] = (int32_t)found[j];
        ++m;
      }
    }
  }
  return m;
}

// The k nearest sources of each query in its graph, self included, ordered
// by (double squared distance, index).
int64_t knn_graph(const float* pos, const int64_t* batch, int64_t n, int64_t k,
                  int32_t* out, int64_t cap) {
  int64_t m = 0;
  std::vector<std::pair<double, int64_t>> d;
  for (const auto& [lo, hi] : graph_ranges(batch, n)) {
    const int64_t gn = hi - lo;
    const int64_t kk = std::min<int64_t>(k, gn);
    d.resize(gn);
    for (int64_t q = lo; q < hi; ++q) {
      for (int64_t s = lo; s < hi; ++s) {
        const double dx = (double)pos[q * 3] - (double)pos[s * 3];
        const double dy = (double)pos[q * 3 + 1] - (double)pos[s * 3 + 1];
        const double dz = (double)pos[q * 3 + 2] - (double)pos[s * 3 + 2];
        const double xx = dx * dx;
        const double yy = dy * dy;
        const double zz = dz * dz;
        d[s - lo] = {(xx + yy) + zz, s};
      }
      std::partial_sort(d.begin(), d.begin() + kk, d.end());
      if (m + kk > cap) return -1;
      for (int64_t j = 0; j < kk; ++j) {
        out[m] = (int32_t)q;
        out[cap + m] = (int32_t)d[j].second;
        ++m;
      }
    }
  }
  return m;
}

// For each edge i, every edge id e with dst[e] == anchor[i], in edge-id
// order (anchor = src: two-hop triplets; anchor = dst: one-hop pairs).
// Emits (outer = i, inner = e).
int64_t expand_incoming(const int32_t* dst, const int32_t* anchor, int64_t e,
                        int64_t n_nodes, int32_t* out, int64_t cap) {
  std::vector<int64_t> offsets(n_nodes + 1, 0);
  for (int64_t i = 0; i < e; ++i) offsets[dst[i] + 1]++;
  for (int64_t v = 0; v < n_nodes; ++v) offsets[v + 1] += offsets[v];
  std::vector<int32_t> in_edges(e);
  {
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t i = 0; i < e; ++i) in_edges[cursor[dst[i]]++] = (int32_t)i;
  }
  int64_t m = 0;
  for (int64_t i = 0; i < e; ++i) {
    const int32_t a = anchor[i];
    const int64_t lo = offsets[a], hi = offsets[a + 1];
    if (m + (hi - lo) > cap) return -1;
    for (int64_t p = lo; p < hi; ++p) {
      out[m] = (int32_t)i;
      out[cap + m] = in_edges[p];
      ++m;
    }
  }
  return m;
}

// Collation: the arrays at srcs[0..n_arr) (lens[a] int32 values each, or
// lens[a] rows of row_w floats), one after another from the start of `out`,
// array a's values plus offs[a], the rest of the out_len values or out_rows
// rows zeros.  Returns the rows written, or -1 (nothing written) when they
// would pass the padded length.
int64_t concat_offset_i32(const uint64_t* srcs, const int64_t* lens,
                          const int32_t* offs, int64_t n_arr, int32_t* out,
                          int64_t out_len) {
  int64_t total = 0;
  for (int64_t a = 0; a < n_arr; ++a) total += lens[a];
  if (total > out_len) return -1;
  int64_t m = 0;
  for (int64_t a = 0; a < n_arr; ++a) {
    const int32_t* s = reinterpret_cast<const int32_t*>(srcs[a]);
    const uint32_t o = (uint32_t)offs[a];
    for (int64_t i = 0; i < lens[a]; ++i)
      out[m + i] = (int32_t)((uint32_t)s[i] + o);
    m += lens[a];
  }
  std::fill(out + m, out + out_len, 0);
  return m;
}

int64_t concat_rows_f32(const uint64_t* srcs, const int64_t* lens,
                        int64_t row_w, int64_t n_arr, float* out,
                        int64_t out_rows) {
  int64_t total = 0;
  for (int64_t a = 0; a < n_arr; ++a) total += lens[a];
  if (total > out_rows) return -1;
  int64_t m = 0;
  for (int64_t a = 0; a < n_arr; ++a) {
    const float* s = reinterpret_cast<const float*>(srcs[a]);
    std::copy(s, s + lens[a] * row_w, out + m * row_w);
    m += lens[a];
  }
  std::fill(out + m * row_w, out + out_rows * row_w, 0.0f);
  return m;
}

// The backward's CSR of rows [0, num_valid) keyed by ids, each in
// [0, num_groups): a stable counting sort.  perm (total_rows) holds the
// valid rows by id, ties in row order, then the padded rows
// num_valid..total_rows in order; poff (num_groups + 1) the first position
// of each group, poff[num_groups] == num_valid.  Returns 0, or -1 (the
// outputs undefined) when an id lies out of range.
int64_t csr_perm(const int32_t* ids, int64_t num_valid, int64_t num_groups,
                 int64_t total_rows, int32_t* perm, int32_t* poff) {
  std::fill(poff, poff + num_groups + 1, 0);
  for (int64_t i = 0; i < num_valid; ++i) {
    const int32_t g = ids[i];
    if (g < 0 || g >= num_groups) return -1;
    ++poff[g + 1];
  }
  for (int64_t g = 0; g < num_groups; ++g) poff[g + 1] += poff[g];
  std::vector<int32_t> cursor(poff, poff + num_groups);
  for (int64_t i = 0; i < num_valid; ++i) perm[cursor[ids[i]]++] = (int32_t)i;
  for (int64_t i = num_valid; i < total_rows; ++i) perm[i] = (int32_t)i;
  return 0;
}

// CSR offsets of rows [0, num_valid) sorted by ids, in one pass: off[g]
// (g in [0, num_groups]) the rows with an id below g, ids out of range
// counted as numpy's searchsorted counts them.  Returns 0, or -1 (off
// undefined) when the rows are not sorted.
int64_t csr_offsets(const int32_t* ids, int64_t num_valid, int64_t num_groups,
                    int32_t* off) {
  int64_t g = 0;  // the next offset to write
  for (int64_t i = 0; i < num_valid; ++i) {
    const int64_t id = ids[i];
    if (i > 0 && id < ids[i - 1]) return -1;
    for (; g <= num_groups && g <= id; ++g) off[g] = (int32_t)i;
  }
  for (; g <= num_groups; ++g) off[g] = (int32_t)num_valid;
  return 0;
}

// The radial part of the spherical basis of one structure's local edges
// (src[e] -> dst[e], positions pos (n, 3) in double): for each edge the
// distance d, x = d / cutoff, the polynomial envelope of exponent p
// (1/max(x, 1e-12) + a x^p + b x^(p+1) + c x^(p+2) for x < 1, else 0), and
// out[e, l*nr + n] = (norm[l,n] * j_l(max(zeros[l,n] * x, 1e-12))) * env,
// j_l(t) = sin(t) (sum_k u^k S[l,k]) + cos(t) (sum_k u^k C[l,k]), u = 1/t,
// S and C (ns, ns + 1), p >= 0.  Returns 0, or -1 (out undefined) when an
// index lies outside [0, n).
int64_t sbf_radial(const double* pos, int64_t n, const int32_t* src,
                   const int32_t* dst, int64_t e, double cutoff, int64_t p,
                   int64_t ns, int64_t nr, const double* zeros,
                   const double* norm, const double* S, const double* C,
                   float* out) {
  if (!in_range(src, e, n) || !in_range(dst, e, n)) return -1;
  const int64_t P = ns + 1;
  const double a = (double)(-(p + 1) * (p + 2)) / 2.0;
  const double b = (double)(p * (p + 2));
  const double c = (double)(-p * (p + 1)) / 2.0;
  std::vector<double> pw(std::max(ns + 1, p + 3));
  for (int64_t i = 0; i < e; ++i) {
    const double* ps = pos + 3 * (int64_t)src[i];
    const double* pd = pos + 3 * (int64_t)dst[i];
    const double dx = pd[0] - ps[0], dy = pd[1] - ps[1], dz = pd[2] - ps[2];
    const double xx = dx * dx, yy = dy * dy, zz = dz * dz;
    const double x = std::sqrt((xx + yy) + zz) / cutoff;
    double env = 0.0;
    if (x < 1.0) {
      powers(x, p + 2, pw.data());
      env = ((1.0 / std::max(x, 1e-12) + a * pw[p]) + b * pw[p + 1]) +
            c * pw[p + 2];
    }
    float* o = out + i * ns * nr;
    for (int64_t l = 0; l < ns; ++l) {
      const double* sl = S + l * P;
      const double* cl = C + l * P;
      for (int64_t r = 0; r < nr; ++r) {
        const double t = std::max(zeros[l * nr + r] * x, 1e-12);
        powers(1.0 / t, l + 1, pw.data());
        double ss = 0.0, sc = 0.0;
        for (int64_t k = 0; k <= l + 1; ++k) {
          ss = ss + pw[k] * sl[k];
          sc = sc + pw[k] * cl[k];
        }
        const double j = std::sin(t) * ss + std::cos(t) * sc;
        o[l * nr + r] = (float)((norm[l * nr + r] * j) * env);
      }
    }
  }
  return 0;
}

// The angular part of the basis over triplets or pairs (ia, ib, ic): v1 =
// pos[ib] - pos[ia], v2 = pos[ic] - pos[ib], the angle atan2(|v1 x v2|,
// v1 . v2), and out[t, l] = P_l(cos angle) * pref[l] by the Legendre
// recurrence.  Returns 0, or -1 (out undefined) when an index lies outside
// [0, n).
int64_t cbf(const double* pos, int64_t n, const int32_t* ia, const int32_t* ib,
            const int32_t* ic, int64_t m, int64_t ns, const double* pref,
            float* out) {
  if (!in_range(ia, m, n) || !in_range(ib, m, n) || !in_range(ic, m, n))
    return -1;
  std::vector<double> pl(std::max<int64_t>(ns, 2));
  for (int64_t t = 0; t < m; ++t) {
    const double* pa = pos + 3 * (int64_t)ia[t];
    const double* pb = pos + 3 * (int64_t)ib[t];
    const double* pc = pos + 3 * (int64_t)ic[t];
    double v1[3], v2[3];
    for (int d = 0; d < 3; ++d) {
      v1[d] = pb[d] - pa[d];
      v2[d] = pc[d] - pb[d];
    }
    const double d0 = v1[0] * v2[0], d1 = v1[1] * v2[1], d2 = v1[2] * v2[2];
    const double dot = (d0 + d1) + d2;
    const double c0 = v1[1] * v2[2] - v1[2] * v2[1];
    const double c1 = v1[2] * v2[0] - v1[0] * v2[2];
    const double c2 = v1[0] * v2[1] - v1[1] * v2[0];
    const double q0 = c0 * c0, q1 = c1 * c1, q2 = c2 * c2;
    const double cth = std::cos(std::atan2(std::sqrt((q0 + q1) + q2), dot));
    pl[0] = 1.0;
    pl[1] = cth;
    for (int64_t l = 2; l < ns; ++l)
      pl[l] = (((double)(2 * l - 1) * cth) * pl[l - 1] -
               (double)(l - 1) * pl[l - 2]) /
              (double)l;
    for (int64_t l = 0; l < ns; ++l) out[t * ns + l] = (float)(pl[l] * pref[l]);
  }
  return 0;
}

}  // extern "C"
