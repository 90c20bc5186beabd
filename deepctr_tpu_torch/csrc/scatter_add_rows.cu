// Multi-table scatter-add of gathered-row cotangents for Hopper (sm_90a):
// the backward of gather_rows.
//
//   target_f[rows[b, f], :] += grad[b, f, :]          for every (b, f)
//
// for all the fields of one gather_rows launch (tables of one row width W),
// in one launch.  A field's target is either a table's dense [V, W]
// gradient, indexed by id, or the [n_unique, W] gradient of the rows a
// batch touches, indexed by the slot the dedup gave the id.  Several
// fields may share one target (a table read by two features).
//
// What it replaces: the backward of the TPU's gather kernel
// (deepctr_tpu/ops/pallas_gather.py:_gather_bwd and _gather_packed_bwd, an
// XLA scatter-add into the table), and the transpose of the substituted
// slice in the active-rows train step (deepctr_tpu/models/basemodel.py:
// 733-741), which sums the cotangents of each touched row.
//
// Order of the sums: every target row sums its contributions one after
// another, in increasing flat index b * F + f, starting from the value
// the target holds.  That is the order in which torch.index_add_ adds on
// the CPU, so the kernel equals that plain version bit for bit, and two
// runs give the same bits (no float atomics, whose order changes from run
// to run).  The wrapper sorts the contributions by (target, row) with a
// stable library sort; `keys` are the sorted keys, `order` the flat index
// of each sorted contribution, `ends` the end of each key's run.
//
// What bounds it: device-memory bytes.  It reads the [B, F, W] cotangent
// once (7.24 MB at B=4096, F=26, W=17), the sorted keys and indices, and
// reads and writes each target row once.  About 14 MB, some 4 us at
// 3.35 TB/s.
//
// What the design does about that: one thread per (run, column).  The
// thread at the head of a run walks it, so a row is written once, with no
// atomics; the W threads of a run read neighbouring floats of each
// cotangent row.  A run's loads are written kUnroll at a time ahead of
// their sums, so that the compiler may have them in flight together.  A
// long run (a table of 3 rows read 4096 times) is serial all the same, and
// it is the kernel's critical path: on the H100 it costs about 90 ns a
// contribution (PERF.md).  Splitting it would change the order of the
// sums.  Runs of one contribution, the common case for big tables, cost a
// load and a store.
//
// The per-field arguments come in one int64 device array `meta` whose
// first 2 * n_fields entries are the target base pointers and the target
// row counts.  A row outside [0, rows) (an id out of range) adds nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const float* __restrict__ grad,
                        const long long* __restrict__ rows,
                        const long long* __restrict__ keys,
                        const long long* __restrict__ order,
                        const long long* __restrict__ ends,
                        const long long* __restrict__ meta,
                        long long n, unsigned n_fields, unsigned width) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n * width) return;
  const long long k = i / width;
  const unsigned w = static_cast<unsigned>(i - k * width);
  if (k > 0 && __ldg(keys + k) == __ldg(keys + k - 1)) return;  // not a head
  const long long first = __ldg(order + k);
  const unsigned f = static_cast<unsigned>(first % n_fields);
  const long long row = __ldg(rows + first);
  if (row < 0 || row >= meta[n_fields + f]) return;
  float* dst = reinterpret_cast<float*>(meta[f]) + row * width + w;
  const long long end = __ldg(ends + k);
  float acc = *dst;
  long long j = k;
  for (; j + kUnroll <= end; j += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldg(grad + __ldg(order + j + u) * width + w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; j < end; ++j) {
    acc = __fadd_rn(acc, __ldg(grad + __ldg(order + j) * width + w));
  }
  *dst = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `grad` is [n / n_fields, n_fields, width] contiguous, `rows` the target
// row of each of its n rows; `keys`, `order` and `ends` have n entries.
// The caller checks shapes and types and keeps every buffer alive until
// the kernel has run.
extern "C" int scatter_add_rows_f32(const float* grad, const long long* rows,
                                    const long long* keys,
                                    const long long* order,
                                    const long long* ends,
                                    const long long* meta, long long n,
                                    int n_fields, int width, void* stream) {
  if (n <= 0 || n_fields <= 0 || width <= 0 || n % n_fields != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = n * width;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  scatter_add_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      grad, rows, keys, order, ends, meta, n,
      static_cast<unsigned>(n_fields), static_cast<unsigned>(width));
  return static_cast<int>(cudaGetLastError());
}
