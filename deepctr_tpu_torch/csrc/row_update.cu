// Fused optimizer step on the touched rows of every sparse table, for
// Hopper (sm_90a):
//
//   for j < capacity_t:  r = rows_t[j], skipped unless 0 <= r < vocab_t
//     g' = g_t[j] + 2 * l2_t * w_t[r]                (lazy L2, per column)
//     sgd:      w_t[r] -= lr * g'
//     adagrad:  a = acc_t[r] + g'^2;             w_t[r] -= lr * g' / (sqrt(a) + eps)
//     rmsprop:  v = d1 * acc_t[r] + c1 * g'^2;   w_t[r] -= lr * g' / (sqrt(v) + eps)
//     adam:     m = d1 * m_t[r] + c1 * g';  v = d2 * v_t[r] + c2 * g'^2;
//               w_t[r] -= lr * (m / bc1) / (sqrt(v / bc2) + eps)
//
// Adam's (bc1, bc2) = (1 - b1^t, 1 - b2^t) come one pair a table (the
// table's step count), or, in the per-row mode (t_t non-null, as
// torch.optim.SparseAdam), from the row's own count: the lane that holds
// the row's id reads n = t_t[r] + 1, writes it back and reads the pair
// from row n of a [T, 2] table of the pairs of every count (bias_t), so
// that the corrections are the JAX package's float32 pow bit for bit.
// Each row id is held by one lane and the ids are distinct: no race.
//
// The table and its state rows are updated IN PLACE (the JAX package
// returns new buffers through input_output_aliases; here the tensors are
// simply overwritten).  A table's row list has a fixed capacity: the
// caller pads it past the table (row ids at or past vocab_t), as the JAX
// package pads its dedup with out-of-bounds rows, and such a slot is never
// read or written.  So the launch depends on no count the host would have
// to read back from the device.  A row that no batch touched keeps its
// bits.  The row ids of a table are distinct (the caller's dedup), so no
// two threads touch one element.
//
// What it replaces: the TPU's fused read-modify-write row update
// (deepctr_tpu/ops/pallas_update.py:146 fused_row_update, kernel :45, call
// :190; sgd and adagrad) and the write-back kernels the JAX package pairs
// with XLA math for adagrad, rmsprop and adam: scatter_rows (:357, kernel
// :273, call :408), multi_scatter_rows (:455, kernel :419, call :480),
// arena_scatter_rows (:520, kernel :491, call :551) and
// fused_row_update_combined (:571, kernel :219, call :602), with the
// rmsprop and adam row math of deepctr_tpu/models/basemodel.py:1205-1258.
// On this card there is no per-row DMA issue cost to design around, so
// one kernel reads, computes and writes every touched element.
//
// Numerics: each operation rounds once, in the order the JAX package
// writes it (IEEE sqrt and division, no contraction into FMAs: the __*_rn
// intrinsics), so the kernel equals its plain PyTorch version bit for bit.
// Adam's bias corrections (1 - b1^t, 1 - b2^t) are read from device
// memory through a pointer in the table's arguments, so that a launch
// captured in a CUDA graph takes each replay's step; in the per-row mode
// so is the row's count.
//
// What bounds it: device-memory bytes.  Per touched element it reads w, g
// and the state and writes w and the state: 5 floats for adagrad and
// rmsprop, 7 for adam, 3 for sgd, and a row id a row; adam's per-row
// count adds 8 bytes a row (t read and written) and its pair, 8 bytes
// from a table of a few KB that stays in L2.  At B=4096 over the
// 8 big Criteo tables (about 32.6k touched rows of 17 floats) that is
// about 11.3 MB for adagrad, 3.4 us at 3.35 TB/s.  Counted in the 32-byte
// sectors the memory moves, a 68-byte row at a random 4-byte offset
// always covers three (96 bytes): about 15.0 MB, 4.5 us.  DIEN's W=32 rows
// are whole sectors.
//
// The earlier design (one thread a float, its arguments in a device array
// walked from table 0 and uploaded by the host every call) waited out a
// chain of four dependent loads before the first table byte, with two or
// three loads in flight a thread, behind two uploads.  Here:
//
// 1. Arguments by value.  Every table's pointers (adam's bias pair's
//    among them), vocabulary, capacity and W, and the first run of each
//    table, come in one
//    __grid_constant__ struct in the launch's parameter space (constant
//    bank 0): the host allocates and copies nothing.  A warp finds its
//    run's table by counting the first runs at or before it, 31 compares
//    with constant operands and no load; the table's fields are then
//    constant-cache reads.  More tables than kMaxTables of one route go
//    in further launches (ops/row_update.py:launch_plan).
// 2. Rows in flight.  A warp takes a run of kRunRows = 8 touched rows of
//    one table: lanes 0-7 load their row ids (one coalesced load), the
//    run's gradient (contiguous) is asked for at once, and then every lane
//    issues its share of all the run's table and state loads before any
//    arithmetic: unit i = lane + 32 k of the run belongs to row i / W,
//    whose id the lane takes from lane i / W by shuffle.  At W=17 a lane
//    has 4-5 floats of each array in flight; at W=32 with 16-byte aligned
//    arrays, 2 float4 units of each.  So the chain before the table bytes
//    is two loads long (the row id, then the rows).  Runs of 16 and 32
//    rows were slower (tools/row_update_parts.py): what the card needs in
//    flight is bytes an SM, not a warp, and short runs spread each run's
//    divisions and square roots over more warps.  A route (W=17, other
//    widths in floats, widths of 4k floats in 16-byte units) is a kernel
//    instance of its own, so that each holds only its own registers
//    (53-90, no spills).  Criteo's W=17 has its own: with the row's units
//    a constant, i / W is a multiply and a lane's 5 units need no batch
//    checks, 7% faster than the instance for any width in floats
//    (adagrad, cold L2; tools/row_update_parts.py).
// 3. One wave.  The grid is at most the blocks the card holds at once
//    (the occupancy calculator's count times the SMs), and warps stride
//    over the runs.  By Little's law the card needs about 3.4 MB in flight
//    (3.35 TB/s x about 1 us), 25 KB an SM: Criteo's 32.6k rows are about
//    4,100 runs, and the card holds 28-32 warps an SM, each with about
//    1.6 KB of adagrad's bytes in flight: 45-50 KB an SM.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): about 0.016 ms at
// Criteo's adagrad shape with a cold L2, against 0.0236 ms for the earlier
// design's call; an empty launch timed the same way takes about 0.005 ms,
// and with a cold L2 the stores to random rows and the reads behind them
// take most of the rest.

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRunRows = 8;     // touched rows a warp takes at a time
constexpr int kMaxTables = 32;  // tables one launch's arguments hold
constexpr int kBatch = 8;       // floats in flight a lane on generic routes
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kSgd = 0, kAdagrad = 1, kRmsprop = 2, kAdam = 3 };
// how a launch's tables move their rows: W=17 floats; any W as floats;
// W % 4 == 0 as float4 units (every array on a 16-byte boundary)
enum Route { kW17 = 0, kScalar = 1, kVec = 2 };

// one table's arguments (mirrored by ops/row_update.py:_Table)
struct Table {
  float* w;
  float* s1;  // null for sgd
  float* s2;  // adam's v; null otherwise
  const float* g;
  const long long* rows;
  const float* l2;
  const float* bias;  // adam's (1 - b1^t, 1 - b2^t): one pair, or a
                      // [T, 2] table by count with t; null otherwise
  int* t;             // adam's per-row counts [vocab]; null otherwise
  long long vocab;    // the table's rows: a row id past them is padding
  int capacity;       // row ids listed, > 0
  int width;
};

// one launch's arguments (mirrored by ops/row_update.py:_Args)
struct Args {
  int first_run[kMaxTables];  // INT_MAX past n_tables
  Table table[kMaxTables];
  int n_tables;
  int n_runs;
  int mode;
  int route;  // every table's
  float lr, eps, d1, c1, d2, c2;
};
static_assert(sizeof(Args) <= 4096,
              "the arguments must fit the classic 4 KB parameter space");

struct Consts {
  float lr, eps, d1, c1, d2, c2, bc1, bc2;
};

template <int M>
__device__ __forceinline__ float update(float w, float g, float l2,
                                        float& s1, float& s2,
                                        const Consts& k) {
  const float gp = __fadd_rn(g, __fmul_rn(__fmul_rn(2.0f, l2), w));
  float step;
  if (M == kSgd) {
    step = __fmul_rn(k.lr, gp);
  } else if (M == kAdagrad || M == kRmsprop) {
    float a = __fmul_rn(gp, gp);
    a = M == kAdagrad ? __fadd_rn(s1, a)
                      : __fadd_rn(__fmul_rn(k.d1, s1), __fmul_rn(k.c1, a));
    s1 = a;
    step = __fdiv_rn(__fmul_rn(k.lr, gp), __fadd_rn(__fsqrt_rn(a), k.eps));
  } else {
    const float mv = __fadd_rn(__fmul_rn(k.d1, s1), __fmul_rn(k.c1, gp));
    const float vv =
        __fadd_rn(__fmul_rn(k.d2, s2), __fmul_rn(k.c2, __fmul_rn(gp, gp)));
    s1 = mv;
    s2 = vv;
    const float m_hat = __fdiv_rn(mv, k.bc1);
    const float v_hat = __fdiv_rn(vv, k.bc2);
    step = __fdiv_rn(__fmul_rn(k.lr, m_hat),
                     __fadd_rn(__fsqrt_rn(v_hat), k.eps));
  }
  return __fsub_rn(w, step);
}

template <int M>
__device__ __forceinline__ float4 update(float4 w, float4 g, float4 l2,
                                         float4& s1, float4& s2,
                                         const Consts& k) {
  return make_float4(update<M>(w.x, g.x, l2.x, s1.x, s2.x, k),
                     update<M>(w.y, g.y, l2.y, s1.y, s2.y, k),
                     update<M>(w.z, g.z, l2.z, s1.z, s2.z, k),
                     update<M>(w.w, g.w, l2.w, s1.w, s2.w, k));
}

// What one access moves: a float, or 4 of them (route "vec").
template <bool VEC>
using Unit = typename std::conditional<VEC, float4, float>::type;

// A lane's units k0 .. k0 + K - 1 of the run: all loads, then the updates
// and all stores.  Unit i = lane + 32 k of the run is column i % units of
// the run's row i / units, whose id `row` holds in lane i / units; bit r
// of `live` says whether the run's row r lies in the table.  UNITS is the
// row's units where the instance fixes it, else 0 and `units` says.
template <int M, bool VEC, int UNITS, int K>
__device__ __forceinline__ void update_units(const Table& tb,
                                             const Consts& k, int units,
                                             int k0, int j0, int n,
                                             long long row, unsigned live,
                                             int lane, bool rowwise,
                                             float rbc1, float rbc2) {
  using T = Unit<VEC>;
  if (UNITS != 0) units = UNITS;  // a constant: i / units is a multiply
  const int n_units = n * units;
  T* const w = reinterpret_cast<T*>(tb.w);
  T* const s1 = reinterpret_cast<T*>(tb.s1);
  T* const s2 = reinterpret_cast<T*>(tb.s2);
  const T* const g =
      reinterpret_cast<const T*>(tb.g) + static_cast<long long>(j0) * units;
  const T* const l2 = reinterpret_cast<const T*>(tb.l2);
  // unit i's element offset in the table, from its row's id in lane
  // i / units (a shuffle: recomputed for the stores rather than held)
  const auto offset = [&](int i) {
    const int src = i / units;
    const long long r = __shfl_sync(kFull, row, src & 31);
    return r * units + (i - src * units);
  };
  // the generic routes' batches end where the run does (warp-uniform)
  const auto past = [&](int u) {
    return UNITS == 0 && 32 * (k0 + u) >= n_units;
  };
  // a unit of a row that lies in the table (a padding row is skipped)
  const auto in_table = [&](int i) {
    return i < n_units && ((live >> (i / units)) & 1u);
  };

  T gv[K], wv[K], av[K], bv[K];
  // the gradient first: contiguous over the run, it needs no row id
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int i = lane + 32 * (k0 + u);
    if (i < n_units) gv[u] = __ldg(g + i);
  }
  // then every table and state load of these units
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (past(u)) break;
    const int i = lane + 32 * (k0 + u);
    const long long at = offset(i);
    if (in_table(i)) {
      wv[u] = w[at];
      if (M != kSgd) av[u] = s1[at];
      if (M == kAdam) bv[u] = s2[at];
    }
  }
  // the updates and all stores (l2 is a few floats, in L1 after a run)
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (past(u)) break;
    const int i = lane + 32 * (k0 + u);
    const long long at = offset(i);
    Consts ku = k;
    if (M == kAdam && rowwise) {  // warp-uniform: the row's own pair
      const int src = (i / units) & 31;
      ku.bc1 = __shfl_sync(kFull, rbc1, src);
      ku.bc2 = __shfl_sync(kFull, rbc2, src);
    }
    if (in_table(i)) {
      w[at] = update<M>(wv[u], gv[u], __ldg(l2 + i % units), av[u], bv[u],
                        ku);
      if (M != kSgd) s1[at] = av[u];
      if (M == kAdam) s2[at] = bv[u];
    }
  }
}

template <int M, bool VEC, int UNITS>
__device__ __forceinline__ void update_run(const Table& tb, const Consts& k,
                                           int j0, int n, long long row,
                                           unsigned live, int lane,
                                           bool rowwise, float rbc1,
                                           float rbc2) {
  if constexpr (UNITS != 0) {
    update_units<M, VEC, UNITS, (kRunRows * UNITS + 31) / 32>(
        tb, k, UNITS, 0, j0, n, row, live, lane, rowwise, rbc1, rbc2);
  } else {
    constexpr int K = VEC ? kBatch / 4 : kBatch;
    const int units = VEC ? tb.width >> 2 : tb.width;
    for (int k0 = 0; 32 * k0 < n * units; k0 += K) {
      update_units<M, VEC, 0, K>(tb, k, units, k0, j0, n, row, live,
                                 lane, rowwise, rbc1, rbc2);
    }
  }
}

template <int M, int R>
__global__ void __launch_bounds__(kThreads)
row_update_kernel(const __grid_constant__ Args a) {
  const int n_warps = gridDim.x * kWarps;
  for (int run = blockIdx.x * kWarps + (threadIdx.x >> 5); run < a.n_runs;
       run += n_warps) {
    // opaque to the compiler, so that it does not hoist the per-unit
    // indices out of the loop and hold them all in registers
    int lane = threadIdx.x & 31;
    asm volatile("" : "+r"(lane));
    // the run's table: the last whose first run is at or before it
    int t = 0;
#pragma unroll
    for (int i = 1; i < kMaxTables; ++i) t += a.first_run[i] <= run;
    const Table& tb = a.table[t];
    const int j0 = (run - a.first_run[t]) * kRunRows;
    const int n = min(kRunRows, tb.capacity - j0);
    const long long row = lane < n ? __ldg(tb.rows + j0 + lane) : 0;
    // the run's rows that lie in the table: padding rows are dropped
    const unsigned live = __ballot_sync(
        kFull, lane < n && static_cast<unsigned long long>(row) <
                               static_cast<unsigned long long>(tb.vocab));
    if (live == 0) continue;  // warp-uniform: a run of padding only
    Consts k{a.lr, a.eps, a.d1, a.c1, a.d2, a.c2, 1.0f, 1.0f};
    // per-row counts: the lane of each live row advances it and reads
    // the row's pair (rbc1, rbc2), which the row's units take by shuffle
    const bool rowwise = M == kAdam && tb.t != nullptr;
    float rbc1 = 1.0f, rbc2 = 1.0f;
    if (rowwise) {
      if ((live >> lane) & 1u) {
        const int count = tb.t[row] + 1;
        tb.t[row] = count;
        rbc1 = __ldg(tb.bias + 2 * static_cast<long long>(count));
        rbc2 = __ldg(tb.bias + 2 * static_cast<long long>(count) + 1);
      }
    } else if (M == kAdam) {
      k.bc1 = __ldg(tb.bias);
      k.bc2 = __ldg(tb.bias + 1);
    }
    update_run<M, R == kVec, R == kW17 ? 17 : 0>(tb, k, j0, n, row, live,
                                                 lane, rowwise, rbc1, rbc2);
  }
}

// the blocks of row_update_kernel<M, R> the current device holds at once
template <int M, int R>
int resident_blocks() {
  static int cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_update_kernel<M, R>, kThreads, 0) != cudaSuccess) {
    return 0;
  }
  const int blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev] = blocks;
  return blocks;
}

template <int M, int R>
int launch(const Args& a, cudaStream_t stream) {
  const int resident = resident_blocks<M, R>();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = std::min((a.n_runs + kWarps - 1) / kWarps, resident);
  row_update_kernel<M, R><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_route(const Args& a, cudaStream_t stream) {
  switch (a.route) {
    case kW17:
      return launch<M, kW17>(a, stream);
    case kScalar:
      return launch<M, kScalar>(a, stream);
    case kVec:
      return launch<M, kVec>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The layout the host mirrors: sizeof(Args), kMaxTables and kRunRows.
extern "C" int row_update_args_bytes() { return sizeof(Args); }
extern "C" int row_update_capacity() { return kMaxTables; }
extern "C" int row_update_run_rows() { return kRunRows; }

// Launches one kernel over `args` (a host struct, copied into the launch's
// parameters) on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and alignment, plans the tables' runs
// and keeps every buffer alive until the kernel has run.
extern "C" int row_update_f32(const void* args_ptr, void* stream) {
  const Args* args = static_cast<const Args*>(args_ptr);
  if (args == nullptr || args->n_tables <= 0 ||
      args->n_tables > kMaxTables || args->n_runs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->mode) {
    case kSgd:
      return launch_route<kSgd>(*args, s);
    case kAdagrad:
      return launch_route<kAdagrad>(*args, s);
    case kRmsprop:
      return launch_route<kRmsprop>(*args, s);
    case kAdam:
      return launch_route<kAdam>(*args, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
