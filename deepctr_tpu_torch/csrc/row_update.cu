// Fused optimizer step on the touched rows of every sparse table, for
// Hopper (sm_90a), in one launch:
//
//   for j < n_valid_t:   r = rows_t[j]
//     g' = g_t[j] + 2 * l2_t * w_t[r]                (lazy L2, per column)
//     sgd:      w_t[r] -= lr * g'
//     adagrad:  a = acc_t[r] + g'^2;             w_t[r] -= lr * g' / (sqrt(a) + eps)
//     rmsprop:  v = d1 * acc_t[r] + c1 * g'^2;   w_t[r] -= lr * g' / (sqrt(v) + eps)
//     adam:     m = d1 * m_t[r] + c1 * g';  v = d2 * v_t[r] + c2 * g'^2;
//               w_t[r] -= lr * (m / bc1_t) / (sqrt(v / bc2_t) + eps)
//
// The table and its state rows are updated IN PLACE (the JAX package
// returns new buffers through input_output_aliases; here the tensors are
// simply overwritten).  Rows past n_valid_t are never read or written, and
// a row that no batch touched keeps its bits.
//
// What it replaces: the TPU's fused read-modify-write row update
// (deepctr_tpu/ops/pallas_update.py:fused_row_update, sgd and adagrad) and
// the write-back kernels the JAX package pairs with XLA math for adagrad
// and adam (pallas_update.py:scatter_rows with L=2 and L=3, and its
// multi-table and arena variants), plus the rmsprop step
// (deepctr_tpu/models/basemodel.py:1222-1258).  On this card there is no
// per-row DMA issue cost to design around, so one kernel reads, computes
// and writes every touched element of every table.
//
// Numerics: each operation rounds once, in the order the JAX package
// writes it (IEEE sqrt and division, no contraction into FMAs: the __*_rn
// intrinsics), so the kernel equals its plain PyTorch version bit for bit.
// Adam's bias corrections 1 - beta^t come per table from the host.
//
// What bounds it: device-memory bytes.  Per touched element it reads
// w, g and the state and writes w and the state: 5 floats for adagrad and
// rmsprop, 7 for adam, 3 for sgd.  At B=4096 over the 8 big Criteo tables
// (about 33k touched rows of 17 floats) that is about 11 MB for adagrad,
// some 3.4 us at 3.35 TB/s.
//
// What the design does about that: one thread per touched element, so
// the W threads of a row read and write its W neighbouring floats
// together, and every table of the step goes in one launch.
//
// Per-table arguments come in one int64 device array `meta` of
// kMeta * n_tables entries: pointers to w, state 1, state 2, g, rows and
// the [W] l2 vector, then n_valid and W; `offsets` holds n_tables + 1
// prefix sums of n_valid * W, and `bias` two floats per table.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMeta = 8;

enum Mode { kSgd = 0, kAdagrad = 1, kRmsprop = 2, kAdam = 3 };

__global__ void __launch_bounds__(kThreads)
row_update_kernel(const long long* __restrict__ meta,
                  const long long* __restrict__ offsets,
                  const float* __restrict__ bias, int n_tables, int mode,
                  float lr, float eps, float d1, float c1, float d2,
                  float c2) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= offsets[n_tables]) return;
  int t = 0;
  while (i >= offsets[t + 1]) ++t;
  const long long* m = meta + kMeta * t;
  const long long width = m[7];
  const long long e = i - offsets[t];
  const long long j = e / width;
  const long long col = e - j * width;
  float* w = reinterpret_cast<float*>(m[0]);
  float* s1 = reinterpret_cast<float*>(m[1]);
  float* s2 = reinterpret_cast<float*>(m[2]);
  const float* g = reinterpret_cast<const float*>(m[3]);
  const long long* rows = reinterpret_cast<const long long*>(m[4]);
  const float* l2 = reinterpret_cast<const float*>(m[5]);

  const long long idx = rows[j] * width + col;
  const float wv = w[idx];
  const float gp = __fadd_rn(g[e], __fmul_rn(__fmul_rn(2.0f, l2[col]), wv));
  float step;
  if (mode == kSgd) {
    step = __fmul_rn(lr, gp);
  } else if (mode == kAdagrad || mode == kRmsprop) {
    float a = __fmul_rn(gp, gp);
    a = mode == kAdagrad ? __fadd_rn(s1[idx], a)
                         : __fadd_rn(__fmul_rn(d1, s1[idx]), __fmul_rn(c1, a));
    s1[idx] = a;
    step = __fdiv_rn(__fmul_rn(lr, gp), __fadd_rn(__fsqrt_rn(a), eps));
  } else {
    const float mv = __fadd_rn(__fmul_rn(d1, s1[idx]), __fmul_rn(c1, gp));
    const float vv = __fadd_rn(__fmul_rn(d2, s2[idx]),
                               __fmul_rn(c2, __fmul_rn(gp, gp)));
    s1[idx] = mv;
    s2[idx] = vv;
    const float m_hat = __fdiv_rn(mv, bias[2 * t]);
    const float v_hat = __fdiv_rn(vv, bias[2 * t + 1]);
    step = __fdiv_rn(__fmul_rn(lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), eps));
  }
  w[idx] = __fsub_rn(wv, step);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `total` is offsets[n_tables], the number of elements to update; the
// caller checks shapes and types, and keeps every buffer alive until the
// kernel has run.
extern "C" int row_update_f32(const long long* meta, const long long* offsets,
                              const float* bias, int n_tables,
                              long long total, int mode, float lr, float eps,
                              float d1, float c1, float d2, float c2,
                              void* stream) {
  if (n_tables <= 0 || total < 0 || mode < kSgd || mode > kAdam) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  row_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      meta, offsets, bias, n_tables, mode, lr, eps, d1, c1, d2, c2);
  return static_cast<int>(cudaGetLastError());
}
