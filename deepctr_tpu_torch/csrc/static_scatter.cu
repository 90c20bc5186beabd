// Row-group scatter for Hopper (sm_90a): the write-back of L-row groups.
//
//   table[starts[g, j] + r, :] = vals[g, j*L + r, :]      r < L
//
// for G groups of n slots into one table (an arena of G tables laid end to
// end, or one table when G = 1), in place.  The static variant copies
// every slot j < n: padding slots name a sacrificial dump row past the
// tables, so the trip count never depends on the data.  The dynamic
// variant copies the slots j < n_valid[g], a count it reads from device
// memory.
//
// What it replaces: the TPU's static-trip-count scatter
// (tools/scatter_issue_micro.py:static_scatter, its kernel
// _make_static_kernel), an A/B variant of the row-DMA scatter
// deepctr_tpu/ops/pallas_update.py:scatter_rows / arena_scatter_rows (the
// dynamic variant here).  On the TPU each slot is one DMA issued from a
// scalar loop, and the question the tool asks is whether the issue loop's
// overhead, which unrolling amortises, is the wall.
//
// What bounds it: device-memory bytes.  It does no arithmetic: each slot
// reads L rows of vals and writes L rows of the table.  At the tool's
// shape (G = 26, n = 5120 slots, L = 2, rows of 128 float32) the static
// variant moves 2 * 26 * 5120 * 2 * 512 B = 272.6 MB, 0.0814 ms at
// 3.35 TB/s; the dynamic one, over 4097 valid slots a group, 0.0652 ms.
//
// What the design does about that: one warp a group of kSlots consecutive
// slots, a static trip count; a slot's L rows are contiguous in vals and
// in the table, so the warp copies them as one run of 16-byte vectors
// (narrower words where the row width or the pointers are not 16-byte
// aligned), neighbouring lanes on neighbouring addresses.  The slot loop
// is unrolled UNROLL times with every load issued before the stores, so
// UNROLL slots' reads are in flight at once per lane: the GPU's form of
// the TPU's unrolled DMA issue.  A slot whose start would put a row
// outside the table is skipped.  Slots that name the same rows race; the
// value left there is one of theirs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // warps a block
constexpr int kSlots = 8;     // slots a warp: the static trip count

template <typename V, int UNROLL, bool DYNAMIC>
__global__ void __launch_bounds__(kWarps * 32)
scatter_kernel(const V* __restrict__ vals, V* __restrict__ table,
               const int* __restrict__ starts,
               const int* __restrict__ n_valid, int n, int L,
               long long row_vecs, long long table_rows) {
  static_assert(kSlots % UNROLL == 0, "UNROLL must divide kSlots");
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kSlots;
  const long long limit = DYNAMIC ? min(n, max(n_valid[g], 0)) : n;
  if (base >= limit) return;
  const long long slot_vecs = row_vecs * L;
  const int* st = starts + static_cast<long long>(g) * n;
  const V* src_g = vals + static_cast<long long>(g) * n * slot_vecs;
#pragma unroll
  for (int it = 0; it < kSlots; it += UNROLL) {
    long long src[UNROLL], dst[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = base + it + u;
      ok[u] = j < limit;
      const long long s = ok[u] ? static_cast<long long>(st[j]) : -1;
      ok[u] = ok[u] && s >= 0 && s + L <= table_rows;
      src[u] = j * slot_vecs;
      dst[u] = s * row_vecs;
    }
    for (long long c = lane; c < slot_vecs; c += 32) {
      V r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (ok[u]) r[u] = src_g[src[u] + c];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (ok[u]) table[dst[u] + c] = r[u];
      }
    }
  }
}

template <typename V, bool DYNAMIC>
int launch_v(int unroll, const void* vals, void* table, const int* starts,
             const int* n_valid, int G, int n, int L, long long row_bytes,
             long long table_rows, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kWarps) * kSlots;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  G);
  const long long row_vecs = row_bytes / static_cast<long long>(sizeof(V));
  const V* v = static_cast<const V*>(vals);
  V* t = static_cast<V*>(table);
  switch (unroll) {
    case 1:
      scatter_kernel<V, 1, DYNAMIC><<<grid, kWarps * 32, 0, stream>>>(
          v, t, starts, n_valid, n, L, row_vecs, table_rows);
      break;
    case 2:
      scatter_kernel<V, 2, DYNAMIC><<<grid, kWarps * 32, 0, stream>>>(
          v, t, starts, n_valid, n, L, row_vecs, table_rows);
      break;
    case 4:
      scatter_kernel<V, 4, DYNAMIC><<<grid, kWarps * 32, 0, stream>>>(
          v, t, starts, n_valid, n, L, row_vecs, table_rows);
      break;
    case 8:
      scatter_kernel<V, 8, DYNAMIC><<<grid, kWarps * 32, 0, stream>>>(
          v, t, starts, n_valid, n, L, row_vecs, table_rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool DYNAMIC>
int launch(int unroll, const void* vals, void* table, const int* starts,
           const int* n_valid, int G, int n, int L, long long row_bytes,
           long long table_rows, cudaStream_t stream) {
  // the widest word that divides the row and both base addresses
  const unsigned long long a =
      reinterpret_cast<unsigned long long>(vals) |
      reinterpret_cast<unsigned long long>(table) |
      static_cast<unsigned long long>(row_bytes);
  if (a % 16 == 0)
    return launch_v<uint4, DYNAMIC>(unroll, vals, table, starts, n_valid, G,
                                    n, L, row_bytes, table_rows, stream);
  if (a % 4 == 0)
    return launch_v<unsigned int, DYNAMIC>(unroll, vals, table, starts,
                                           n_valid, G, n, L, row_bytes,
                                           table_rows, stream);
  if (a % 2 == 0)
    return launch_v<unsigned short, DYNAMIC>(unroll, vals, table, starts,
                                             n_valid, G, n, L, row_bytes,
                                             table_rows, stream);
  return launch_v<unsigned char, DYNAMIC>(unroll, vals, table, starts,
                                          n_valid, G, n, L, row_bytes,
                                          table_rows, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// vals [G, n*L, row_bytes] and table [table_rows, row_bytes] contiguous,
// starts [G, n] int32 (row indices into the table), n_valid [G] int32 on
// the device (read only when dynamic is 1); unroll 1, 2, 4 or 8.  The
// caller checks shapes, types and devices.
extern "C" int static_scatter(int dynamic, int unroll, const void* vals,
                              void* table, const int* starts,
                              const int* n_valid, int G, int n, int L,
                              long long row_bytes, long long table_rows,
                              void* stream) {
  if (G <= 0 || G > 65535 || n <= 0 || L <= 0 || row_bytes <= 0 ||
      table_rows <= 0 || (dynamic && n_valid == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dynamic)
    return launch<true>(unroll, vals, table, starts, n_valid, G, n, L,
                        row_bytes, table_rows, s);
  return launch<false>(unroll, vals, table, starts, n_valid, G, n, L,
                       row_bytes, table_rows, s);
}
