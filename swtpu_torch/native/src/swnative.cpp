// swtpu native host runtime: traceback walkers + 2-bit codec.
//
// The TPU computes forward passes (scores, endpoints, band histories); the
// host walks alignment paths — the same split as the reference's banded
// family (SIMD forward / scalar traceback, source.cpp:1978-2162). These
// are the C++ hot-path equivalents of swtpu/batch/traceback.py and
// swtpu/core/encode.py, exact to the reference semantics:
//  - traceback tie-break order diag -> up -> left (source.cpp:1558-1567,
//    2149-2158)
//  - argmax = first maximum in row-major scan order (source.cpp:1545)
//  - banded Get() reconstruction with 0 = dead cell (source.cpp:1944-1951)
//  - 2-bit codec byte/bit layout (source.cpp:1580-1583)
//
// Exposed as a C ABI for ctypes; see swtpu/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------- codec --

void sw_pack_2bit(const uint8_t* src, int64_t n, uint8_t* dst) {
  for (int64_t i = 0; i < n / 4; ++i) {
    dst[i] = (uint8_t)((src[4 * i] & 3) | ((src[4 * i + 1] & 3) << 2) |
                       ((src[4 * i + 2] & 3) << 4) |
                       ((src[4 * i + 3] & 3) << 6));
  }
}

void sw_unpack_2bit(const uint8_t* src, int64_t n_packed, uint8_t* dst) {
  for (int64_t i = 0; i < n_packed; ++i) {
    const uint8_t b = src[i];
    dst[4 * i] = b & 3;
    dst[4 * i + 1] = (b >> 2) & 3;
    dst[4 * i + 2] = (b >> 4) & 3;
    dst[4 * i + 3] = (b >> 6) & 3;
  }
}

// ---------------------------------------------- local SW with traceback --

// Full-matrix recompute + walk. matrix: [A*A] int32 row-major (q*A + t).
// path_out receives (i, j) pairs (1-based DP coords); returns path length.
// Caller provides path_out sized 2*(n+m+2).
int64_t sw_traceback(const uint8_t* q, int64_t n, const uint8_t* t,
                     int64_t m, const int32_t* matrix, int32_t A,
                     int32_t gap, int32_t* path_out, int32_t* out_score) {
  std::vector<int32_t> dp((n + 1) * (m + 1), 0);
  const int64_t stride = m + 1;
  int32_t best = 0;
  int64_t bi = 0, bj = 0;
  for (int64_t i = 1; i <= n; ++i) {
    const int32_t* srow = matrix + (int64_t)q[i - 1] * A;
    int32_t left = 0;
    for (int64_t j = 1; j <= m; ++j) {
      int32_t v = 0;
      v = std::max(v, dp[(i - 1) * stride + (j - 1)] + srow[t[j - 1]]);
      v = std::max(v, dp[(i - 1) * stride + j] - gap);
      v = std::max(v, left - gap);
      dp[i * stride + j] = v;
      left = v;
      if (v > best) {  // strict: first max in row-major scan order
        best = v;
        bi = i;
        bj = j;
      }
    }
  }
  *out_score = best;
  int64_t len = 0;
  path_out[2 * len] = (int32_t)bi;
  path_out[2 * len + 1] = (int32_t)bj;
  ++len;
  int64_t i = bi, j = bj;
  while (i || j) {
    const int32_t v = dp[i * stride + j];
    if (v == 0) break;
    if (i && j &&
        v == dp[(i - 1) * stride + (j - 1)] +
                 matrix[(int64_t)q[i - 1] * A + t[j - 1]]) {
      --i;
      --j;
    } else if (i && v == dp[(i - 1) * stride + j] - gap) {
      --i;
    } else if (j && v == dp[i * stride + (j - 1)] - gap) {
      --j;
    } else {
      return -1;  // inconsistent
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  // reverse pairs in place
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// ------------------------------------ affine local SW with traceback -----

// Full-matrix Gotoh recompute + three-state walk (swtpu/oracle/affine.py
// semantics: first row-major argmax, H-state preference diag -> F (up)
// -> E (left), path ends where H reaches 0). matrix: [A*A] int32
// row-major (q*A + t).
int64_t sw_affine_traceback(const uint8_t* q, int64_t n, const uint8_t* t,
                            int64_t m, const int32_t* matrix, int32_t A,
                            int32_t gap_open, int32_t gap_extend,
                            int32_t* path_out, int32_t* out_score) {
  const int32_t NEG = -(1 << 29);
  const int64_t stride = m + 1;
  std::vector<int32_t> H((n + 1) * stride, 0);
  std::vector<int32_t> E((n + 1) * stride, NEG);
  std::vector<int32_t> F((n + 1) * stride, NEG);
  int32_t best = 0;
  int64_t bi = 0, bj = 0;
  for (int64_t i = 1; i <= n; ++i) {
    const int32_t* srow = matrix + (int64_t)q[i - 1] * A;
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t c = i * stride + j;
      E[c] = std::max(E[c - 1] - gap_extend, H[c - 1] - gap_open);
      F[c] = std::max(F[c - stride] - gap_extend, H[c - stride] - gap_open);
      int32_t v = std::max(0, H[c - stride - 1] + srow[t[j - 1]]);
      v = std::max(v, std::max(E[c], F[c]));
      H[c] = v;
      if (v > best) {  // strict: first max in row-major scan order
        best = v;
        bi = i;
        bj = j;
      }
    }
  }
  *out_score = best;
  int64_t len = 0;
  path_out[2 * len] = (int32_t)bi;
  path_out[2 * len + 1] = (int32_t)bj;
  ++len;
  int64_t i = bi, j = bj;
  int st = 0;
  while (i || j) {
    const int64_t c = i * stride + j;
    if (st == 0) {
      const int32_t v = H[c];
      if (v == 0) break;
      if (i && j &&
          v == H[c - stride - 1] + matrix[(int64_t)q[i - 1] * A + t[j - 1]]) {
        --i;
        --j;
      } else if (v == F[c]) {
        st = 2;
        continue;
      } else if (v == E[c]) {
        st = 1;
        continue;
      } else {
        return -1;
      }
    } else if (st == 1) {
      const int32_t v = E[c];
      if (j && v == H[c - 1] - gap_open) {
        --j;
        st = 0;
      } else if (j && v == E[c - 1] - gap_extend) {
        --j;
      } else {
        return -1;
      }
    } else {
      const int32_t v = F[c];
      if (i && v == H[c - stride] - gap_open) {
        --i;
        st = 0;
      } else if (i && v == F[c - stride] - gap_extend) {
        --i;
      } else {
        return -1;
      }
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// ------------------------------- fixed-band local SW with traceback ------

// Fixed diagonal corridor |i - j| <= W (swtpu/oracle/banded_static.py
// semantics). Dense recompute over the corridor in skewed storage
// (row i, slot k = j - i + W, 2W+1 slots), then the family's walk:
// diag -> up -> left (linear, gap_open == gap_extend) or the Gotoh
// three-state diag -> F -> E (affine). matrix: [A*A] int32 row-major.
int64_t banded_static_traceback(const uint8_t* q, int64_t n,
                                const uint8_t* t, int64_t m,
                                const int32_t* matrix, int32_t A,
                                int32_t gap_open, int32_t gap_extend,
                                int32_t W, int32_t* path_out,
                                int32_t* out_score) {
  const int32_t NEG = -(1 << 29);
  const bool affine = gap_open != gap_extend;
  const int64_t KB = 2 * (int64_t)W + 1;
  std::vector<int32_t> H((n + 1) * KB, NEG);
  std::vector<int32_t> E, F;
  if (affine) {
    E.assign((n + 1) * KB, NEG);
    F.assign((n + 1) * KB, NEG);
  }
  auto slot = [&](int64_t i, int64_t j) { return i * KB + (j - i + W); };
  auto in_band = [&](int64_t i, int64_t j) {
    return j >= i - W && j <= i + W && j >= 0 && j <= m && i >= 0 && i <= n;
  };
  auto h_at = [&](int64_t i, int64_t j) {
    return in_band(i, j) ? H[slot(i, j)] : NEG;
  };
  auto e_at = [&](int64_t i, int64_t j) {
    return in_band(i, j) ? E[slot(i, j)] : NEG;
  };
  auto f_at = [&](int64_t i, int64_t j) {
    return in_band(i, j) ? F[slot(i, j)] : NEG;
  };
  for (int64_t j = 0; j <= std::min<int64_t>(W, m); ++j) H[slot(0, j)] = 0;
  for (int64_t i = 1; i <= n; ++i) {
    if (i - W <= 0) H[slot(i, 0)] = 0;
  }
  int32_t best = 0;
  int64_t bi = 0, bj = 0;
  for (int64_t i = 1; i <= n; ++i) {
    const int32_t* srow = matrix + (int64_t)q[i - 1] * A;
    const int64_t j_lo = std::max<int64_t>(1, i - W);
    const int64_t j_hi = std::min<int64_t>(m, i + W);
    for (int64_t j = j_lo; j <= j_hi; ++j) {
      const int32_t s = srow[t[j - 1]];
      int32_t v;
      if (affine) {
        const int32_t e =
            std::max(e_at(i, j - 1) - gap_extend, h_at(i, j - 1) - gap_open);
        const int32_t f =
            std::max(f_at(i - 1, j) - gap_extend, h_at(i - 1, j) - gap_open);
        E[slot(i, j)] = e;
        F[slot(i, j)] = f;
        v = std::max(0, h_at(i - 1, j - 1) + s);
        v = std::max(v, std::max(e, f));
      } else {
        v = std::max(0, h_at(i - 1, j - 1) + s);
        v = std::max(v, h_at(i - 1, j) - gap_extend);
        v = std::max(v, h_at(i, j - 1) - gap_extend);
      }
      H[slot(i, j)] = v;
      if (v > best) {
        best = v;
        bi = i;
        bj = j;
      }
    }
  }
  *out_score = best;
  int64_t len = 0;
  path_out[2 * len] = (int32_t)bi;
  path_out[2 * len + 1] = (int32_t)bj;
  ++len;
  int64_t i = bi, j = bj;
  int st = 0;
  while (i || j) {
    if (st == 0) {
      const int32_t v = h_at(i, j);
      if (v == 0) break;
      const int32_t s =
          (i && j) ? matrix[(int64_t)q[i - 1] * A + t[j - 1]] : 0;
      if (i && j && h_at(i - 1, j - 1) > NEG / 2 &&
          v == h_at(i - 1, j - 1) + s) {
        --i;
        --j;
      } else if (affine && v == f_at(i, j)) {
        st = 2;
        continue;
      } else if (affine && v == e_at(i, j)) {
        st = 1;
        continue;
      } else if (!affine && i && v == h_at(i - 1, j) - gap_extend) {
        --i;
      } else if (!affine && j && v == h_at(i, j - 1) - gap_extend) {
        --j;
      } else {
        return -1;
      }
    } else if (st == 1) {
      const int32_t v = e_at(i, j);
      if (j && v == h_at(i, j - 1) - gap_open) {
        --j;
        st = 0;
      } else if (j && v == e_at(i, j - 1) - gap_extend) {
        --j;
      } else {
        return -1;
      }
    } else {
      const int32_t v = f_at(i, j);
      if (i && v == h_at(i - 1, j) - gap_open) {
        --i;
        st = 0;
      } else if (i && v == f_at(i - 1, j) - gap_extend) {
        --i;
      } else {
        return -1;
      }
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// ------------------------------------------- semi-global with traceback --

// Full-matrix semi-global (no zero floor, start at (0,0), end at argmax).
// pin_end != 0 pins the end at the (n, m) corner instead — GLOBAL
// (Needleman-Wunsch) alignment, same origin-anchored fill.
int64_t semiglobal_traceback(const uint8_t* q, int64_t n, const uint8_t* t,
                             int64_t m, int32_t match, int32_t mismatch,
                             int32_t gap, int32_t pin_end, int32_t* path_out,
                             int32_t* out_score) {
  const int32_t MINF = INT32_MIN / 2;
  const int64_t stride = m + 1;
  std::vector<int32_t> dp((n + 1) * stride, MINF);
  dp[0] = 0;
  for (int64_t j = 1; j <= m; ++j) dp[j] = (int32_t)(-gap * j);
  for (int64_t i = 1; i <= n; ++i) dp[i * stride] = (int32_t)(-gap * i);
  int32_t best = 0;
  int64_t bi = 0, bj = 0;
  for (int64_t i = 1; i <= n; ++i) {
    for (int64_t j = 1; j <= m; ++j) {
      const int32_t s = (q[i - 1] == t[j - 1]) ? match : -mismatch;
      int32_t v = dp[(i - 1) * stride + (j - 1)] + s;
      v = std::max(v, dp[(i - 1) * stride + j] - gap);
      v = std::max(v, dp[i * stride + (j - 1)] - gap);
      dp[i * stride + j] = v;
      if (v > best) {
        best = v;
        bi = i;
        bj = j;
      }
    }
  }
  if (pin_end) {
    bi = n;
    bj = m;
    best = dp[n * stride + m];
  }
  *out_score = best;
  int64_t len = 0;
  path_out[2 * len] = (int32_t)bi;
  path_out[2 * len + 1] = (int32_t)bj;
  ++len;
  int64_t i = bi, j = bj;
  while (i || j) {
    const int32_t v = dp[i * stride + j];
    const int32_t s =
        (i && j && q[i - 1] == t[j - 1]) ? match : -mismatch;
    if (i && j && v == dp[(i - 1) * stride + (j - 1)] + s) {
      --i;
      --j;
    } else if (i && v == dp[(i - 1) * stride + j] - gap) {
      --i;
    } else if (j && v == dp[i * stride + (j - 1)] - gap) {
      --j;
    } else {
      return -1;
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// Full-matrix semi-global with a general substitution matrix
// ([A*A] int32 row-major, q*A + t) — the general-matrix/protein mode of
// swtpu/oracle/semiglobal.py semiglobal_full(matrix=...).
int64_t semiglobal_traceback_matrix(const uint8_t* q, int64_t n,
                                    const uint8_t* t, int64_t m,
                                    const int32_t* matrix, int32_t A,
                                    int32_t gap, int32_t pin_end,
                                    int32_t* path_out, int32_t* out_score) {
  const int32_t MINF = INT32_MIN / 2;
  const int64_t stride = m + 1;
  std::vector<int32_t> dp((n + 1) * stride, MINF);
  dp[0] = 0;
  for (int64_t j = 1; j <= m; ++j) dp[j] = (int32_t)(-gap * j);
  for (int64_t i = 1; i <= n; ++i) dp[i * stride] = (int32_t)(-gap * i);
  int32_t best = 0;
  int64_t bi = 0, bj = 0;
  for (int64_t i = 1; i <= n; ++i) {
    const int32_t* srow = matrix + (int64_t)q[i - 1] * A;
    for (int64_t j = 1; j <= m; ++j) {
      int32_t v = dp[(i - 1) * stride + (j - 1)] + srow[t[j - 1]];
      v = std::max(v, dp[(i - 1) * stride + j] - gap);
      v = std::max(v, dp[i * stride + (j - 1)] - gap);
      dp[i * stride + j] = v;
      if (v > best) {
        best = v;
        bi = i;
        bj = j;
      }
    }
  }
  if (pin_end) {
    bi = n;
    bj = m;
    best = dp[n * stride + m];
  }
  *out_score = best;
  int64_t len = 0;
  path_out[2 * len] = (int32_t)bi;
  path_out[2 * len + 1] = (int32_t)bj;
  ++len;
  int64_t i = bi, j = bj;
  while (i || j) {
    const int32_t v = dp[i * stride + j];
    if (i && j &&
        v == dp[(i - 1) * stride + (j - 1)] +
                 matrix[(int64_t)q[i - 1] * A + t[j - 1]]) {
      --i;
      --j;
    } else if (i && v == dp[(i - 1) * stride + j] - gap) {
      --i;
    } else if (j && v == dp[i * stride + (j - 1)] - gap) {
      --j;
    } else {
      return -1;
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// Full-matrix semi-global with AFFINE (Gotoh) gaps and a general matrix —
// the C++ twin of swtpu/oracle/semiglobal.py semiglobal_affine_full:
// origin-anchored, ends at the row-major-first argmax of H, H-state walk
// preference diag -> F (up) -> E (left).
int64_t semiglobal_affine_traceback(const uint8_t* q, int64_t n,
                                    const uint8_t* t, int64_t m,
                                    const int32_t* matrix, int32_t A,
                                    int32_t gap_open, int32_t gap_extend,
                                    int32_t pin_end, int32_t* path_out,
                                    int32_t* out_score) {
  const int32_t MINF = INT32_MIN / 2;
  const int64_t stride = m + 1;
  std::vector<int32_t> H((n + 1) * stride, MINF);
  std::vector<int32_t> E((n + 1) * stride, MINF);
  std::vector<int32_t> F((n + 1) * stride, MINF);
  H[0] = 0;
  for (int64_t j = 1; j <= m; ++j)
    H[j] = E[j] = (int32_t)(-gap_open - gap_extend * (j - 1));
  for (int64_t i = 1; i <= n; ++i)
    H[i * stride] = F[i * stride] =
        (int32_t)(-gap_open - gap_extend * (i - 1));
  int32_t best = 0;
  int64_t bi = 0, bj = 0;
  for (int64_t i = 1; i <= n; ++i) {
    const int32_t* srow = matrix + (int64_t)q[i - 1] * A;
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t c = i * stride + j;
      E[c] = std::max(E[c - 1] - gap_extend, H[c - 1] - gap_open);
      F[c] = std::max(F[c - stride] - gap_extend, H[c - stride] - gap_open);
      int32_t v = H[c - stride - 1] + srow[t[j - 1]];
      v = std::max(v, std::max(E[c], F[c]));
      H[c] = v;
      if (v > best) {
        best = v;
        bi = i;
        bj = j;
      }
    }
  }
  if (pin_end) {
    bi = n;
    bj = m;
    best = H[n * stride + m];
  }
  *out_score = best;
  int64_t len = 0;
  path_out[2 * len] = (int32_t)bi;
  path_out[2 * len + 1] = (int32_t)bj;
  ++len;
  int64_t i = bi, j = bj;
  int st = 0;
  while (i || j) {
    const int64_t c = i * stride + j;
    if (st == 0) {
      const int32_t v = H[c];
      if (i && j &&
          v == H[c - stride - 1] + matrix[(int64_t)q[i - 1] * A + t[j - 1]]) {
        --i;
        --j;
      } else if (v == F[c]) {
        st = 2;
        continue;
      } else if (v == E[c]) {
        st = 1;
        continue;
      } else {
        return -1;
      }
    } else if (st == 1) {
      const int32_t v = E[c];
      if (j && v == H[c - 1] - gap_open) {
        --j;
        st = 0;
      } else if (j && v == E[c - 1] - gap_extend) {
        --j;
      } else {
        return -1;
      }
    } else {
      const int32_t v = F[c];
      if (i && v == H[c - stride] - gap_open) {
        --i;
        st = 0;
      } else if (i && v == F[c - stride] - gap_extend) {
        --i;
      } else {
        return -1;
      }
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// --------------------------------------------------- banded traceback ----

// Walk one alignment's path from its device-computed band history.
// hist: [n_rounds, W] int32, pos_y: [n_rounds] int32.
// max_score_off = score + x_threshold (offset-inclusive).
// Substitution scores come from a general [A*A] matrix (uniform scoring
// is the dna_matrix(match, -mismatch) special case built by the Python
// wrapper); only in-sequence chars are consulted during the walk.
int64_t banded_traceback(const uint8_t* q, int64_t n, const uint8_t* t,
                         int64_t m, const int32_t* hist,
                         const int32_t* pos_y, int64_t n_rounds,
                         int64_t max_round, int32_t max_score_off,
                         const int32_t* matrix, int32_t A, int32_t gap,
                         int32_t W, int32_t* path_out) {
  const int32_t MINF = INT32_MIN / 2;
  auto get = [&](int64_t y, int64_t x) -> int32_t {
    if (y < 0 || y > n || x < 0 || x > m) return MINF;
    const int64_t r = y + x;
    if (r >= n_rounds) return MINF;
    const int64_t k = (W - 1) - (y - pos_y[r]);
    if (k < 0 || k >= W) return MINF;
    const int32_t v = hist[r * W + k];
    return v == 0 ? MINF : v;
  };
  int64_t my = pos_y[max_round];
  int64_t mx = max_round - my;
  while (get(my, mx) != max_score_off) {
    ++my;
    --mx;
    if (my > n + (int64_t)W) return -1;
  }
  int64_t len = 0;
  path_out[2 * len] = (int32_t)my;
  path_out[2 * len + 1] = (int32_t)mx;
  ++len;
  int64_t i = my, j = mx;
  while (i || j) {
    const int32_t v = get(i, j);
    const int32_t s =
        (i && j) ? matrix[(int64_t)q[i - 1] * A + t[j - 1]] : 0;
    if (i && j && v == get(i - 1, j - 1) + s) {
      --i;
      --j;
    } else if (i && v == get(i - 1, j) - gap) {
      --i;
    } else if (j && v == get(i, j - 1) - gap) {
      --j;
    } else {
      return -1;
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// ------------------------------------------ affine banded traceback ------

// Gotoh three-state walk over a device band history (affine gaps).
// The E/F bands are reconstructed from the H history alone: the E/F
// recurrences (swtpu/oracle/banded_affine.py) never touch the
// substitution score, and the per-round direction is recoverable from
// pos_y (a round moved down iff pos_y advanced). Walk preference in the
// H state: diag -> F (up) -> E (left), matching the linear family's
// diag -> up -> left order.
int64_t banded_affine_traceback(const uint8_t* q, int64_t n,
                                const uint8_t* t, int64_t m,
                                const int32_t* hist, const int32_t* pos_y,
                                int64_t n_rounds, int64_t max_round,
                                int32_t max_score_off,
                                const int32_t* matrix, int32_t A,
                                int32_t gap_open,
                                int32_t gap_extend, int32_t W,
                                int32_t* path_out) {
  const int32_t MINF = -(1 << 30);
  const int32_t EF_DEAD = -(1 << 28);
  const int32_t EF_CUT = EF_DEAD / 2;
  std::vector<int32_t> e_hist(n_rounds * W, EF_DEAD);
  std::vector<int32_t> f_hist(n_rounds * W, EF_DEAD);
  std::vector<int32_t> e_band(W, EF_DEAD), f_band(W, EF_DEAD);
  std::vector<int32_t> he(W), vf(W), horiz(W), vert(W);
  for (int64_t r = 1; r < n_rounds; ++r) {
    const int32_t* res_prev = hist + (r - 1) * W;
    const int32_t* res_now = hist + r * W;
    const bool right = pos_y[r] == pos_y[r - 1];
    for (int64_t k = 0; k < W; ++k) {
      if (right) {
        horiz[k] = res_prev[k];
        he[k] = e_band[k];
        vf[k] = (k + 1 < W) ? f_band[k + 1] : EF_DEAD;
        vert[k] = (k + 1 < W) ? res_prev[k + 1] : 0;
      } else {
        vert[k] = res_prev[k];
        vf[k] = f_band[k];
        he[k] = k ? e_band[k - 1] : EF_DEAD;
        horiz[k] = k ? res_prev[k - 1] : 0;
      }
    }
    for (int64_t k = 0; k < W; ++k) {
      const int32_t e =
          std::max(he[k] > EF_CUT ? he[k] - gap_extend : MINF,
                   horiz[k] != 0 ? horiz[k] - gap_open : MINF);
      const int32_t f =
          std::max(vf[k] > EF_CUT ? vf[k] - gap_extend : MINF,
                   vert[k] != 0 ? vert[k] - gap_open : MINF);
      e_band[k] = res_now[k] == 0 ? EF_DEAD : e;
      f_band[k] = res_now[k] == 0 ? EF_DEAD : f;
      e_hist[r * W + k] = e_band[k];
      f_hist[r * W + k] = f_band[k];
    }
  }
  auto get = [&](const int32_t* arr, int64_t y, int64_t x,
                 bool dead_zero) -> int32_t {
    if (y < 0 || y > n || x < 0 || x > m) return MINF;
    const int64_t r = y + x;
    if (r >= n_rounds) return MINF;
    const int64_t k = (W - 1) - (y - pos_y[r]);
    if (k < 0 || k >= W) return MINF;
    const int32_t v = arr[r * W + k];
    return (dead_zero && v == 0) ? MINF : v;
  };
  auto get_h = [&](int64_t y, int64_t x) { return get(hist, y, x, true); };
  auto get_e = [&](int64_t y, int64_t x) {
    return get(e_hist.data(), y, x, false);
  };
  auto get_f = [&](int64_t y, int64_t x) {
    return get(f_hist.data(), y, x, false);
  };
  int64_t my = pos_y[max_round];
  int64_t mx = max_round - my;
  while (get_h(my, mx) != max_score_off) {
    ++my;
    --mx;
    if (my > n + (int64_t)W) return -1;
  }
  int64_t len = 0;
  path_out[2 * len] = (int32_t)my;
  path_out[2 * len + 1] = (int32_t)mx;
  ++len;
  int64_t i = my, j = mx;
  int st = 0;  // 0 = H, 1 = E (left), 2 = F (up)
  while (i || j) {
    if (st == 0) {
      const int32_t v = get_h(i, j);
      const int32_t s =
          (i && j) ? matrix[(int64_t)q[i - 1] * A + t[j - 1]] : 0;
      if (i && j && v == get_h(i - 1, j - 1) + s) {
        --i;
        --j;
      } else if (v == get_f(i, j)) {
        st = 2;
        continue;
      } else if (v == get_e(i, j)) {
        st = 1;
        continue;
      } else {
        return -1;
      }
    } else if (st == 1) {
      const int32_t v = get_e(i, j);
      if (j && v == get_h(i, j - 1) - gap_open) {
        --j;
        st = 0;
      } else if (j && v == get_e(i, j - 1) - gap_extend) {
        --j;
      } else {
        return -1;
      }
    } else {
      const int32_t v = get_f(i, j);
      if (i && v == get_h(i - 1, j) - gap_open) {
        --i;
        st = 0;
      } else if (i && v == get_f(i - 1, j) - gap_extend) {
        --i;
      } else {
        return -1;
      }
    }
    path_out[2 * len] = (int32_t)i;
    path_out[2 * len + 1] = (int32_t)j;
    ++len;
  }
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}


// ------------------------------------------- checkpointed lowmem walker --
// C++ twin of swtpu/batch/lowmem.py: streaming forward pass with row
// checkpoints every row_block rows, backward walk re-filling one block at
// a time. O(m * (n/row_block + row_block)) ints of memory instead of the
// full (n+1)*(m+1) matrix. The serial recurrences run directly (no
// decoupling needed), so the affine mode is exact for ANY gap_open/
// gap_extend. Tie-breaks match the oracles: argmax = first maximum in
// row-major scan order; linear moves diag -> up -> left; affine state
// preference diag -> F -> E.
//
// end_i < 0 requests the argmax search; otherwise the pass is bounded to
// the [0..end_i, 0..end_j] prefix (device-computed endpoints).
// Returns the path length in pairs (path written start -> end), or -1 on
// an inconsistent walk.

static const int32_t LOWMEM_NEG = -(1 << 29);

int64_t sw_traceback_lowmem(const uint8_t* q, int64_t n, const uint8_t* t,
                            int64_t m, const int32_t* mat, int32_t A,
                            int32_t gap_open, int32_t gap_extend,
                            int64_t end_i, int64_t end_j,
                            int32_t row_block, int32_t* path_out,
                            int32_t* score_out) {
  const bool affine = gap_open != gap_extend;
  const int32_t gap = gap_extend;  // linear-gap value when !affine
  const bool have_ends = end_i >= 0;
  if (have_ends) {
    if (end_i == 0 || end_j == 0) {
      *score_out = 0;
      path_out[0] = 0;
      path_out[1] = 0;
      return 1;
    }
    n = end_i;
    m = end_j;
  }
  const int64_t rb = row_block > 0 ? row_block : 512;
  const int64_t w = m + 1;
  const int64_t n_ck = n / rb + 1;

  // one linear-gap row: cur from prev (row index i, 1-based)
  auto lin_row = [&](int64_t i, const int32_t* prev, int32_t* cur) {
    const int32_t* row = mat + (int64_t)q[i - 1] * A;
    cur[0] = 0;
    int32_t left = 0;
    for (int64_t j = 1; j <= m; ++j) {
      int32_t v = prev[j - 1] + row[t[j - 1]];
      v = std::max(v, prev[j] - gap);
      v = std::max(v, left - gap);
      v = std::max(v, 0);
      cur[j] = v;
      left = v;
    }
  };
  // one Gotoh row: (cur, e_row, f_cur) from (prev, f_prev)
  auto aff_row = [&](int64_t i, const int32_t* prev, const int32_t* f_prev,
                     int32_t* cur, int32_t* e_row, int32_t* f_cur) {
    const int32_t* row = mat + (int64_t)q[i - 1] * A;
    cur[0] = 0;
    e_row[0] = LOWMEM_NEG;
    f_cur[0] = LOWMEM_NEG;
    for (int64_t j = 1; j <= m; ++j) {
      int32_t e = std::max(e_row[j - 1] - gap_extend,
                           cur[j - 1] - gap_open);
      int32_t f = std::max(f_prev[j] - gap_extend, prev[j] - gap_open);
      int32_t v = prev[j - 1] + row[t[j - 1]];
      v = std::max(v, e);
      v = std::max(v, f);
      v = std::max(v, 0);
      e_row[j] = e;
      f_cur[j] = f;
      cur[j] = v;
    }
  };

  // --- streaming forward: checkpoints + (optionally) argmax ---
  std::vector<int32_t> ck((size_t)(n_ck * w), 0);
  std::vector<int32_t> ck_f;
  if (affine) ck_f.assign((size_t)(n_ck * w), LOWMEM_NEG);
  std::vector<int32_t> hp(w, 0), hc(w), fp(w, LOWMEM_NEG), fc(w), er(w);
  int32_t best = 0;
  int64_t ei = 0, ej = 0;
  for (int64_t i = 1; i <= n; ++i) {
    if (affine)
      aff_row(i, hp.data(), fp.data(), hc.data(), er.data(), fc.data());
    else
      lin_row(i, hp.data(), hc.data());
    if (!have_ends) {
      for (int64_t j = 1; j <= m; ++j)
        if (hc[j] > best) { best = hc[j]; ei = i; ej = j; }
    }
    std::swap(hp, hc);
    if (affine) std::swap(fp, fc);
    if (i % rb == 0 && i < n) {
      std::memcpy(&ck[(size_t)((i / rb) * w)], hp.data(),
                  (size_t)w * sizeof(int32_t));
      if (affine)
        std::memcpy(&ck_f[(size_t)((i / rb) * w)], fp.data(),
                    (size_t)w * sizeof(int32_t));
    }
  }
  if (have_ends) {
    ei = n;
    ej = m;
    best = hp[m];
  }
  *score_out = best;
  if (best == 0) {
    // normalize like the numpy twin: zero score walks to [(0, 0)]
    // whether or not device endpoints were supplied
    path_out[0] = 0;
    path_out[1] = 0;
    return 1;
  }

  // --- backward walk, one re-filled block at a time ---
  std::vector<int32_t> Hb((size_t)((rb + 1) * w));
  std::vector<int32_t> Eb, Fb;
  if (affine) {
    Eb.assign((size_t)((rb + 1) * w), LOWMEM_NEG);
    Fb.assign((size_t)((rb + 1) * w), LOWMEM_NEG);
  }
  int64_t i = ei, j = ej, len = 0;
  int st = 0;  // 0 = H, 1 = E, 2 = F
  path_out[0] = (int32_t)i;
  path_out[1] = (int32_t)j;
  len = 1;
  bool done = (i == 0 && j == 0);
  while (!done) {
    const int64_t b0 = (i - 1) / rb * rb;
    const int64_t rows = std::min(rb, n - b0);
    std::memcpy(Hb.data(), &ck[(size_t)((b0 / rb) * w)],
                (size_t)w * sizeof(int32_t));
    if (affine)
      std::memcpy(Fb.data(), &ck_f[(size_t)((b0 / rb) * w)],
                  (size_t)w * sizeof(int32_t));
    for (int64_t r = 1; r <= rows; ++r) {
      if (affine)
        aff_row(b0 + r, &Hb[(size_t)((r - 1) * w)],
                &Fb[(size_t)((r - 1) * w)], &Hb[(size_t)(r * w)],
                &Eb[(size_t)(r * w)], &Fb[(size_t)(r * w)]);
      else
        lin_row(b0 + r, &Hb[(size_t)((r - 1) * w)], &Hb[(size_t)(r * w)]);
    }
    auto H = [&](int64_t y, int64_t x) { return Hb[(size_t)((y - b0) * w + x)]; };
    auto E = [&](int64_t y, int64_t x) { return Eb[(size_t)((y - b0) * w + x)]; };
    auto F = [&](int64_t y, int64_t x) { return Fb[(size_t)((y - b0) * w + x)]; };
    auto S = [&](int64_t y, int64_t x) {
      return mat[(int64_t)q[y - 1] * A + t[x - 1]];
    };
    while (i > b0 || (b0 == 0 && (i || j))) {
      if (i == 0) { done = true; break; }  // top row: local walk has ended
      if (!affine) {
        int32_t v = H(i, j);
        if (v == 0) { done = true; break; }
        if (i && j && v == H(i - 1, j - 1) + S(i, j)) {
          --i; --j;
        } else if (i && v == H(i - 1, j) - gap) {
          --i;
        } else if (j && v == H(i, j - 1) - gap) {
          --j;
        } else {
          return -1;
        }
        path_out[2 * len] = (int32_t)i;
        path_out[2 * len + 1] = (int32_t)j;
        ++len;
      } else {
        if (st == 0) {
          int32_t v = H(i, j);
          if (v == 0) { done = true; break; }
          if (i && j && v == H(i - 1, j - 1) + S(i, j)) {
            --i; --j;
            path_out[2 * len] = (int32_t)i;
            path_out[2 * len + 1] = (int32_t)j;
            ++len;
          } else if (v == F(i, j)) {
            st = 2;
          } else if (v == E(i, j)) {
            st = 1;
          } else {
            return -1;
          }
        } else if (st == 1) {  // E: gap moves left
          int32_t v = E(i, j);
          if (j && v == H(i, j - 1) - gap_open) {
            --j; st = 0;
          } else if (j && v == E(i, j - 1) - gap_extend) {
            --j;
          } else {
            return -1;
          }
          path_out[2 * len] = (int32_t)i;
          path_out[2 * len + 1] = (int32_t)j;
          ++len;
        } else {  // F: gap moves up
          int32_t v = F(i, j);
          if (i && v == H(i - 1, j) - gap_open) {
            --i; st = 0;
          } else if (i && v == F(i - 1, j) - gap_extend) {
            --i;
          } else {
            return -1;
          }
          path_out[2 * len] = (int32_t)i;
          path_out[2 * len + 1] = (int32_t)j;
          ++len;
        }
      }
      if (i == 0 && j == 0) { done = true; break; }
    }
  }
  // emitted end -> start; flip to start -> end like the other walkers
  for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
    std::swap(path_out[2 * a], path_out[2 * b]);
    std::swap(path_out[2 * a + 1], path_out[2 * b + 1]);
  }
  return len;
}

// -------------------------------------------------------------- seeding --

// K-mer seeding + diagonal clustering for the read mapper — the C++ twin
// of swtpu.models.mapper.find_candidates (bit-equal outputs; the numpy
// path is the reference and the differential test anchor). Per read:
// CSR-table lookups of every k-mer, (diag bucket, packed(qpos, diag))
// seeds, bucket grouping, adjacent-bucket merge, min_seeds / top
// max_loci / best-third filters. Reads are independent, so the loop
// parallelizes with OpenMP when built with it; outputs land in fixed
// per-read strides (deterministic regardless of thread schedule).
//
// qcodes: [R * nk] base-4 k-mer codes, -1 = invalid (pad-touching).
// csr: [4^k + 1] int32 row starts into pos (direct-addressed table);
// pos: [P] int32 positions ordered by code. The loop is DRAM-latency
// bound (random accesses into csr/pos), so both tables are int32 and the
// lookups run ahead of consumption with software prefetch.
// out_anchor/out_nseeds: [R * max_loci]; out_cnt: [R] clusters per read.
// Returns the total cluster count.
int64_t seed_candidates(
    const int64_t* qcodes, int64_t R, int64_t nk, int64_t L,
    const int32_t* csr, const int32_t* pos, int64_t dw, int64_t max_occ,
    int64_t min_seeds, int64_t max_loci, int64_t* out_anchor,
    int64_t* out_nseeds, int32_t* out_cnt) {
  const int64_t PF = 16;  // prefetch distance (k-mers ahead)
  // per-bucket accumulator: count + first-arrival packed(qpos, diag).
  // Seeds are generated qpos-ascending, and within one qpos the pos
  // table is position-sorted per code (build_index argsorts stably), so
  // diag ascends too: the FIRST seed of a bucket is its min packed —
  // the numpy path's earliest-seed anchor rule without any per-seed
  // sort (the old pair sort was ~2/3 of seeding wall at k=9).
  struct Acc { int64_t bucket, pmin, count; };
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t rid = 0; rid < R; ++rid) {
    // thread-local scratch reused across reads (no per-read mallocs)
    static thread_local std::vector<Acc> accs, accs2;
    static thread_local std::vector<int32_t> htab;  // open addressing
    accs.clear();
    int64_t hbits = 12;  // 4096 slots; grown if a read overflows half
    if ((int64_t)htab.size() < (1LL << hbits))
      htab.assign(1LL << hbits, 0);
    else
      std::fill(htab.begin(), htab.begin() + (1LL << hbits), 0);
    const int64_t* qc = qcodes + rid * nk;
    for (int64_t qpos = 0; qpos < nk; ++qpos) {
      if (qpos + PF < nk && qc[qpos + PF] >= 0)
        __builtin_prefetch(&csr[qc[qpos + PF]]);
      if (qpos + PF / 2 < nk && qc[qpos + PF / 2] >= 0)
        __builtin_prefetch(&pos[csr[qc[qpos + PF / 2]]]);
      const int64_t c = qc[qpos];
      if (c < 0) continue;
      const int64_t lo = csr[c], hi = csr[c + 1];
      const int64_t occ = hi - lo;
      if (occ == 0 || occ > max_occ) continue;
      for (int64_t s = lo; s < hi; ++s) {
        const int64_t diag = (int64_t)pos[s] - qpos;
        const int64_t bucket = (diag + L) / dw;
        // multiplicative hash + linear probe
        uint64_t h =
            ((uint64_t)bucket * 0x9E3779B97F4A7C15ULL) >> (64 - hbits);
        const uint64_t mask = (1ULL << hbits) - 1;
        while (true) {
          int32_t slot = htab[h];
          if (slot == 0) {
            htab[h] = (int32_t)accs.size() + 1;
            accs.push_back({bucket, (qpos << 32) | (diag + L), 1});
            break;
          }
          if (accs[slot - 1].bucket == bucket) {
            ++accs[slot - 1].count;
            break;
          }
          h = (h + 1) & mask;
        }
        if ((int64_t)accs.size() * 2 > (1LL << hbits)) {
          // grow + rehash (rare: needs > 2048 distinct buckets/read)
          ++hbits;
          htab.assign(1LL << hbits, 0);
          const uint64_t m2 = (1ULL << hbits) - 1;
          for (int64_t a = 0; a < (int64_t)accs.size(); ++a) {
            uint64_t h2 = ((uint64_t)accs[a].bucket *
                           0x9E3779B97F4A7C15ULL) >> (64 - hbits);
            while (htab[h2] != 0) h2 = (h2 + 1) & m2;
            htab[h2] = (int32_t)a + 1;
          }
        }
      }
    }
    // order the unique buckets for the adjacent merge: LSD byte radix
    // (buckets are small non-negative ints; 2 passes for a 1 Mbp
    // reference vs the old O(n log n) pair sort over every seed)
    int64_t maxb = 0;
    for (const Acc& a : accs) maxb = std::max(maxb, a.bucket);
    accs2.resize(accs.size());
    int64_t cnt256[256];
    for (int shift = 0; (maxb >> shift) != 0; shift += 8) {
      std::fill(cnt256, cnt256 + 256, 0);
      for (const Acc& a : accs) ++cnt256[(a.bucket >> shift) & 255];
      int64_t run = 0;
      for (int b = 0; b < 256; ++b) {
        int64_t c0 = cnt256[b];
        cnt256[b] = run;
        run += c0;
      }
      for (const Acc& a : accs) accs2[cnt256[(a.bucket >> shift) & 255]++] = a;
      std::swap(accs, accs2);
    }
    // clusters: runs of equal buckets merged with runs of adjacent ones
    struct Cl { int64_t count, pmin, anchor; };
    std::vector<Cl> cls;
    int64_t i = 0;
    while (i < (int64_t)accs.size()) {
      int64_t count = 0, pmin = INT64_MAX;
      int64_t cur = accs[i].bucket;
      while (i < (int64_t)accs.size() &&
             (accs[i].bucket == cur || accs[i].bucket == cur + 1)) {
        if (accs[i].bucket == cur + 1) cur = accs[i].bucket;
        pmin = std::min(pmin, accs[i].pmin);
        count += accs[i].count;
        ++i;
      }
      if (count >= min_seeds)
        cls.push_back({count, pmin, (pmin & 0xFFFFFFFFLL) - L});
    }
    // per-read order (count desc, anchor asc), top max_loci, best/3 cut
    std::sort(cls.begin(), cls.end(), [](const Cl& a, const Cl& b) {
      if (a.count != b.count) return a.count > b.count;
      return a.anchor < b.anchor;
    });
    int32_t n_out = 0;
    const int64_t best = cls.empty() ? 0 : cls[0].count;
    const int64_t cut = std::max(min_seeds, best / 3);
    for (const Cl& c : cls) {
      if (n_out >= max_loci) break;
      if (c.count < cut) continue;
      out_anchor[rid * max_loci + n_out] = c.anchor;
      out_nseeds[rid * max_loci + n_out] = c.count;
      ++n_out;
    }
    out_cnt[rid] = n_out;
  }
  int64_t total = 0;
  for (int64_t rid = 0; rid < R; ++rid) total += out_cnt[rid];
  return total;
}

// ---------------------------------------------------- move-wire decode --

// Decode the device banded walker's wire format (the TPU-side analog of
// the reference's scalar band traceback, source.cpp:2130-2162): per pair
// 20 bytes of little-endian int32 meta (score, start_y, start_x, n_steps,
// ok) followed by 2-bit packed moves, 4 per byte, low bits first
// (0 = diag, 1 = up, 2 = left), stored end -> start. Writes each path
// FORWARD (start -> end, the host walkers' convention) as interleaved
// (y, x) int32 pairs into out_path + b * path_stride * 2 and the path
// length (n_steps + 1 points) into out_len[b]; scores into out_scores.
// Returns 0, or -(b + 1) for the first pair whose ok flag is unset.
// Pairs are independent -> OpenMP across the batch.
int64_t decode_move_wire(const uint8_t* wire, int64_t B, int64_t row_bytes,
                         int32_t* out_scores, int32_t* out_len,
                         int32_t* out_path, int64_t path_stride) {
  int64_t bad = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* row = wire + b * row_bytes;
    int32_t meta[5];
    std::memcpy(meta, row, 20);
    const int32_t score = meta[0], sy = meta[1], sx = meta[2];
    const int32_t nsteps = meta[3], ok = meta[4];
    if (!ok || nsteps + 1 > path_stride ||
        (int64_t)20 + (nsteps + 3) / 4 > row_bytes) {
#ifdef _OPENMP
#pragma omp critical
#endif
      if (bad == 0 || -(b + 1) > bad) bad = -(b + 1);
      out_scores[b] = score;
      out_len[b] = 0;
      continue;
    }
    out_scores[b] = score;
    out_len[b] = nsteps + 1;
    const uint8_t* packed = row + 20;
    int32_t* path = out_path + b * path_stride * 2;
    int64_t p = nsteps;  // fill backward: moves run end -> start
    int32_t y = sy, x = sx;
    path[2 * p] = y;
    path[2 * p + 1] = x;
    for (int32_t k = 0; k < nsteps; ++k) {
      const int32_t mv = (packed[k >> 2] >> ((k & 3) * 2)) & 3;
      y -= (mv == 0) | (mv == 1);
      x -= (mv == 0) | (mv == 2);
      --p;
      path[2 * p] = y;
      path[2 * p + 1] = x;
    }
  }
  return bad;
}

}  // extern "C"
