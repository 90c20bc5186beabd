// Native host-side runtime: flat-matrix batch assembly + feature hashing.
//
// The training engine feeds the device exactly one [rows, total_width]
// float32 matrix per batch (deepctr_tpu/models/basemodel.py::_assemble_x).
// This library provides the hot host-side pieces as C++:
//   * dctr_assemble: multi-threaded column-concatenation of per-feature
//     arrays into the flat matrix (the numpy path allocates and copies
//     through generic ufunc machinery; this is straight strided memcpy).
//   * dctr_hash_strings / dctr_hash_i64: 64-bit FNV-1a feature hashing
//     onto [0, vocab) — implements the SparseFeat(use_hash=True) contract
//     that the reference declares but does not support
//     (deepctr_torch/inputs.py:31-33 prints a notice and ignores it).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// toolchain).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

inline uint64_t fnv1a(const unsigned char* data, int64_t len, uint64_t h) {
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<uint64_t>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

template <typename Fn>
void parallel_rows(int64_t rows, Fn fn) {
  int n_threads = hw_threads();
  if (rows < 4096 || n_threads <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < rows ? lo + chunk : rows;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Concatenate n per-feature float32 arrays (each [rows, widths[i]],
// C-contiguous) into out [rows, sum(widths)].
void dctr_assemble(float* out, const float* const* srcs, const int* widths,
                   int n, int64_t rows) {
  int64_t total = 0;
  for (int i = 0; i < n; ++i) total += widths[i];
  std::vector<int64_t> offsets(n);
  int64_t off = 0;
  for (int i = 0; i < n; ++i) {
    offsets[i] = off;
    off += widths[i];
  }
  parallel_rows(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      float* dst_row = out + r * total;
      for (int f = 0; f < n; ++f) {
        std::memcpy(dst_row + offsets[f], srcs[f] + r * widths[f],
                    widths[f] * sizeof(float));
      }
    }
  });
}

// Gather rows of a [n, width] float32 matrix by int64 indices into
// out [m, width] — the host-side shuffle+batch step.
void dctr_take_rows(float* out, const float* src, const int64_t* idx,
                    int64_t m, int64_t width) {
  parallel_rows(m, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(out + r * width, src + idx[r] * width,
                  width * sizeof(float));
    }
  });
}

// Hash n length-prefixed byte strings onto [0, mod).
void dctr_hash_strings(const char* const* strs, const int64_t* lens,
                       int64_t n, int64_t mod, int64_t* out) {
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t h = fnv1a(
          reinterpret_cast<const unsigned char*>(strs[i]), lens[i],
          kFnvOffset);
      out[i] = static_cast<int64_t>(h % static_cast<uint64_t>(mod));
    }
  });
}

// Parse Criteo-format delimited text: each line is
//   label <sep> I1..I{n_dense} <sep> C1..C{n_sparse}
// (display-ads CSV/TSV; the sample sets and the full dataset share this
// layout — reference examples/run_classification_criteo.py).  Dense
// fields parse as float (empty -> 0; log_dense applies log1p(max(v,0)),
// the standard streaming normalization where a global MinMaxScaler is
// impossible).  Categorical fields FNV-1a-hash onto [0, vocabs[i])
// (empty -> 0).  Only COMPLETE lines are consumed; *consumed reports the
// byte count so callers can carry the tail of a read buffer over to the
// next chunk.  Returns rows written (<= max_rows).
int64_t dctr_parse_criteo(const char* buf, int64_t len, int64_t max_rows,
                          int n_dense, int n_sparse, const int64_t* vocabs,
                          char sep, int log_dense, float* y, float* dense,
                          float* sparse_out, int64_t* consumed) {
  // index complete lines
  std::vector<int64_t> starts, ends;
  starts.reserve(max_rows);
  ends.reserve(max_rows);
  int64_t pos = 0;
  while (pos < len && static_cast<int64_t>(starts.size()) < max_rows) {
    const char* nl = static_cast<const char*>(
        memchr(buf + pos, '\n', len - pos));
    if (nl == nullptr) break;
    int64_t e = nl - buf;
    if (e > pos) {  // skip blank lines
      starts.push_back(pos);
      ends.push_back(buf[e - 1] == '\r' ? e - 1 : e);
    }
    pos = e + 1;
  }
  *consumed = pos;
  int64_t rows = starts.size();

  parallel_rows(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const char* p = buf + starts[r];
      const char* end = buf + ends[r];
      int field = 0;
      while (p <= end && field < 1 + n_dense + n_sparse) {
        const char* f_end = p;
        while (f_end < end && *f_end != sep) ++f_end;
        int64_t flen = f_end - p;
        if (field == 0) {
          y[r] = (flen > 0 && *p == '1') ? 1.0f : 0.0f;
        } else if (field <= n_dense) {
          float v = 0.0f;
          if (flen > 0) {
            // hand-rolled float parse (fields are not NUL-terminated):
            // sign, integer part, fraction — criteo dense fields carry
            // no exponents
            const char* q = p;
            bool neg = false;
            if (*q == '-') { neg = true; ++q; }
            double acc = 0.0;
            while (q < f_end && *q >= '0' && *q <= '9')
              acc = acc * 10.0 + (*q++ - '0');
            if (q < f_end && *q == '.') {
              ++q;
              double scale = 0.1;
              while (q < f_end && *q >= '0' && *q <= '9') {
                acc += (*q++ - '0') * scale;
                scale *= 0.1;
              }
            }
            v = static_cast<float>(neg ? -acc : acc);
          }
          if (log_dense) v = std::log1p(v < 0.0f ? 0.0f : v);
          dense[r * n_dense + (field - 1)] = v;
        } else {
          int s = field - 1 - n_dense;
          int64_t id = 0;
          if (flen > 0) {
            uint64_t h = fnv1a(
                reinterpret_cast<const unsigned char*>(p), flen,
                kFnvOffset);
            id = static_cast<int64_t>(
                h % static_cast<uint64_t>(vocabs[s]));
          }
          sparse_out[r * n_sparse + s] = static_cast<float>(id);
        }
        ++field;
        p = f_end + 1;
      }
    }
  });
  return rows;
}

// Hash n int64 values onto [0, mod).
void dctr_hash_i64(const int64_t* vals, int64_t n, int64_t mod,
                   int64_t* out) {
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t h = fnv1a(reinterpret_cast<const unsigned char*>(&vals[i]),
                         sizeof(int64_t), kFnvOffset);
      out[i] = static_cast<int64_t>(h % static_cast<uint64_t>(mod));
    }
  });
}

}  // extern "C"
