// Multi-table embedding row gather for Hopper (sm_90a).
//
//   rows[b, f, :] = table_f[int(X[b, col_f]), :]     for every field f
//
// for all the fields whose tables share one row width W, in one launch.
// X is the flat [B, input_dim] float32 batch; the ids ride in it as floats
// and are cast to int by truncation, as deepctr_tpu/inputs.py:316-318
// does.  An id outside [0, V_f) reads nothing and writes a NaN row (the
// fill that jnp.take gives an out-of-range id).
//
// The shard-local mode (zero_fill = 1) serves a table row-sharded over a
// device mesh: field f's table holds the logical rows [base_f, base_f +
// V_f) of its table, id i reads row i - base_f there, and an id outside
// that block writes a row of zeros, which the lookup exchange's sum over
// the mesh's model axis adds to the owner's row
// (deepctr_tpu_torch/parallel/embedding.py).  That is the JAX package's
// jnp.take plus in-range mask (deepctr_tpu/parallel/embedding.py:50-55),
// with no mask pass and no [B, F] float matrix built for it.
//
// What it replaces: the TPU's row-DMA kernel
// (deepctr_tpu/ops/pallas_gather.py:_gather_kernel), and the two lookups
// that the JAX package shaped around the TPU for the same job: the bf16
// one-hot matmuls of deepctr_tpu/ops/onehot_lookup.py (small tables) and
// the 128-lane packed rows plus lane select of deepctr_tpu/inputs.py:
// 273-285 (big tables).  On this card a plain row copy serves every table,
// and the rows come back in exact float32.
//
// What bounds it: device-memory bytes, at least.  It does no arithmetic;
// it reads B*F ids and the rows they name and writes B*F*W*4 bytes.  At
// B=4096, F=26, W=17 that is about 11 MB, 3.4 us at 3.35 TB/s.  Measured
// on an H100 80GB HBM3 at 700 W (PERF.md): the earlier design, one thread
// an output float, took 0.0174 ms there, the same on ids sorted within
// each field and 0.0121 ms with a warm L2, so neither the DRAM's cost of
// random rows nor its rate bound it but the latency of each warp's few
// rows in flight.  This design takes about 0.0128 ms (0.0091 with a warm
// L2): the launch is one wave whose warps all wait out the same chain of
// dependent loads (the fields' arguments, the id, the row) before their
// stores; at the sequence models' 203-403 fields of W=32 it is within
// 1.5-1.9x of its bytes.
//
// The design: the (b, f) pairs are numbered b * F + f, and a warp takes a
// run of 32 consecutive pairs, whose outputs are one contiguous run of
// 32 W floats.  Lane j loads pair j's id once, truncates it, checks its
// range and forms its row pointer (null out of range); the per-field
// arguments come from shared memory, staged once a block where there are
// at most 256 fields (else each lane reads its field's own).  Then the warp issues all its row
// loads before any store: the run's float i (lane + 32 k, k < W) belongs
// to pair i / W, whose row pointer the lane takes from the owning lane by
// shuffle, so every lane has W loads in flight and the warp 32 rows.  The
// stores are coalesced over the run.  W is a template argument for the
// widths the paths use (17: Criteo DeepFM and xDeepFM with the fused wide
// column; 1: linear tables; 32, the sequence models', as 8 units of 16
// bytes), so i / W is a multiply; any other width takes a generic loop
// with 8 loads in flight a lane.  Where W % 4 == 0 and the tables are
// 16-byte aligned the runs move 16-byte units.
//
// The per-field arguments come in one int64 device array `meta` of
// 3 * n_fields entries: table base pointers, id column indices, vocab
// sizes (the rows each table holds), and in the shard-local mode n_fields
// more, the row bases.  The host caches it and rebuilds it when a table
// moves.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a block: 8 runs of 32 pairs
constexpr int kGeneric = 0;    // W (or W / 4) known only at run time
constexpr int kBatch = 8;      // loads in flight a lane in the generic loop
constexpr unsigned kFull = 0xffffffffu;

template <bool VEC>
struct Unit;  // what one load moves: a float, or 4 of them
template <>
struct Unit<false> {
  using T = float;
  __device__ static T load(const T* p) { return __ldg(p); }
  __device__ static T fill(bool zero) {
    return zero ? 0.0f : __int_as_float(0x7fc00000);
  }
};
template <>
struct Unit<true> {
  using T = float4;
  __device__ static T load(const T* p) { return __ldg(p); }
  __device__ static T fill(bool zero) {
    const float v = zero ? 0.0f : __int_as_float(0x7fc00000);
    return make_float4(v, v, v, v);
  }
};

// UNITS: a row's units (W, or W / 4 with VEC), kGeneric for `units`
template <int UNITS, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ x, long long ld_x,
                   const long long* __restrict__ meta, unsigned n_fields,
                   unsigned units, unsigned n_pairs, int zero_fill,
                   float* __restrict__ out) {
  using U = Unit<VEC>;
  using T = typename U::T;
  __shared__ long long s_meta[4 * kThreads];
  const unsigned row_units = UNITS != kGeneric ? UNITS : units;
  const bool staged = n_fields <= kThreads;
  const unsigned n_meta = (zero_fill ? 4 : 3) * n_fields;
  if (staged) {
    for (unsigned i = threadIdx.x; i < n_meta; i += kThreads) {
      s_meta[i] = __ldg(meta + i);
    }
    __syncthreads();
  }
  const unsigned lane = threadIdx.x & 31;
  const unsigned pair = blockIdx.x * kThreads + threadIdx.x;
  const unsigned run0 = pair - lane;
  if (run0 >= n_pairs) return;  // the whole warp: no barrier follows

  // this lane's pair: its row, or null out of range
  const T* row = nullptr;
  if (pair < n_pairs) {
    const unsigned b = pair / n_fields;
    const unsigned f = pair - b * n_fields;
    const long long table =
        staged ? s_meta[f] : __ldg(meta + f);
    const long long col =
        staged ? s_meta[n_fields + f] : __ldg(meta + n_fields + f);
    const long long vocab =
        staged ? s_meta[2 * n_fields + f] : __ldg(meta + 2 * n_fields + f);
    const long long base =
        !zero_fill ? 0
        : staged   ? s_meta[3 * n_fields + f]
                   : __ldg(meta + 3 * n_fields + f);
    // truncation toward zero, as float32 -> int32 in the JAX package
    const long long id =
        __float2int_rz(__ldg(x + static_cast<long long>(b) * ld_x + col)) -
        base;
    if (id >= 0 && id < vocab) {
      row = reinterpret_cast<const T*>(table) + id * row_units;
    }
  }
  const unsigned pairs = min(32u, n_pairs - run0);
  const unsigned n_units = pairs * row_units;  // the run's units
  T* dst = reinterpret_cast<T*>(out) +
           static_cast<long long>(run0) * row_units;
  const unsigned long long mine = reinterpret_cast<unsigned long long>(row);
  const T empty = U::fill(zero_fill != 0);

  if constexpr (UNITS != kGeneric) {
    // all UNITS loads, then all UNITS stores
    T v[UNITS];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const unsigned i = lane + 32 * k;
      const unsigned src = i / UNITS;
      const T* p = reinterpret_cast<const T*>(
          __shfl_sync(kFull, mine, src & 31));
      v[k] = p != nullptr ? U::load(p + (i - src * UNITS)) : empty;
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const unsigned i = lane + 32 * k;
      if (i < n_units) dst[i] = v[k];
    }
  } else {
    for (unsigned k0 = 0; k0 < row_units; k0 += kBatch) {
      T v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const unsigned i = lane + 32 * (k0 + k);
        if (k0 + k < row_units) {
          const unsigned src = i / row_units;
          const T* p = reinterpret_cast<const T*>(
              __shfl_sync(kFull, mine, src & 31));
          v[k] = p != nullptr ? U::load(p + (i - src * row_units)) : empty;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const unsigned i = lane + 32 * (k0 + k);
        if (k0 + k < row_units && i < n_units) dst[i] = v[k];
      }
    }
  }
}

template <int UNITS, bool VEC>
void launch(const float* x, long long ld_x, const long long* meta,
            unsigned n_fields, unsigned units, unsigned n_pairs,
            int zero_fill, float* out, cudaStream_t stream) {
  const unsigned blocks = (n_pairs + kThreads - 1) / kThreads;
  gather_rows_kernel<UNITS, VEC><<<blocks, kThreads, 0, stream>>>(
      x, ld_x, meta, n_fields, units, n_pairs, zero_fill, out);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes and types, allocates `out` [n_rows, n_fields,
// width] and keeps `meta` alive until the kernel has run; `vec` (1 or 0)
// says that width % 4 == 0 and every table is 16-byte aligned;
// `zero_fill` (1 or 0) selects the shard-local mode.
extern "C" int gather_rows_f32(const float* x, long long n_rows,
                               long long ld_x, const long long* meta,
                               int n_fields, int width, int vec,
                               int zero_fill, float* out, void* stream) {
  const long long total = n_rows * n_fields * width;
  if (n_rows <= 0 || n_fields <= 0 || width <= 0 || total >= (1LL << 31) ||
      (vec && width % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned pairs = static_cast<unsigned>(n_rows * n_fields);
  const unsigned f = static_cast<unsigned>(n_fields);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const unsigned units = static_cast<unsigned>(width / 4);
    if (units == 8) {
      launch<8, true>(x, ld_x, meta, f, units, pairs, zero_fill, out, s);
    } else {
      launch<kGeneric, true>(x, ld_x, meta, f, units, pairs, zero_fill, out,
                             s);
    }
  } else if (width == 1) {
    launch<1, false>(x, ld_x, meta, f, 1, pairs, zero_fill, out, s);
  } else if (width == 17) {
    launch<17, false>(x, ld_x, meta, f, 17, pairs, zero_fill, out, s);
  } else {
    launch<kGeneric, false>(x, ld_x, meta, f, static_cast<unsigned>(width),
                            pairs, zero_fill, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
