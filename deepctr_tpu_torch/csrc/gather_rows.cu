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
// What it replaces: the TPU's row-DMA kernel
// (deepctr_tpu/ops/pallas_gather.py:_gather_kernel), and the two lookups
// that the JAX package shaped around the TPU for the same job: the bf16
// one-hot matmuls of deepctr_tpu/ops/onehot_lookup.py (small tables) and
// the 128-lane packed rows plus lane select of deepctr_tpu/inputs.py:
// 273-285 (big tables).  On this card a plain row copy serves every table,
// and the rows come back in exact float32.
//
// What bounds it: device-memory bytes.  It does no arithmetic; it reads
// B*F ids and B*F*W*4 bytes of rows and writes the same number of bytes.
// At B=4096, F=26, W=17 that is about 15 MB, a few microseconds at
// 3.35 TB/s.
//
// What the design does about that: one thread per output float, so
// neighbouring threads write neighbouring addresses and every store is
// fully coalesced, and the threads of one row read that row's W
// consecutive floats together (one or two 32-byte sectors).  Loads are
// 4 bytes wide because a width-17 row is 68 bytes and not 16-byte aligned.
// One launch covers every field of a width, so a forward pays one launch,
// not one per table.  Wider loads from padded rows, and fetching ids once
// per row instead of once per float, are later work.
//
// The per-field arguments come in one int64 device array `meta` of
// 3 * n_fields entries: table base pointers, id column indices, vocab
// sizes.  The host caches it and rebuilds it when a table moves.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ x, long long ld_x,
                   const long long* __restrict__ meta, unsigned n_fields,
                   unsigned width, unsigned total, float* __restrict__ out) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned pair = i / width;  // b * n_fields + f
  const unsigned w = i - pair * width;
  const unsigned b = pair / n_fields;
  const unsigned f = pair - b * n_fields;
  const float* table = reinterpret_cast<const float*>(meta[f]);
  const long long col = meta[n_fields + f];
  const long long vocab = meta[2 * n_fields + f];
  // truncation toward zero, as float32 -> int32 in the JAX package
  const long long id =
      __float2int_rz(__ldg(x + static_cast<long long>(b) * ld_x + col));
  float v = __int_as_float(0x7fc00000);  // NaN row for an id out of range
  if (id >= 0 && id < vocab) v = __ldg(table + id * width + w);
  out[i] = v;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes and types, allocates `out` [n_rows, n_fields,
// width] and keeps `meta` alive until the kernel has run.
extern "C" int gather_rows_f32(const float* x, long long n_rows,
                               long long ld_x, const long long* meta,
                               int n_fields, int width, float* out,
                               void* stream) {
  const long long total = n_rows * n_fields * width;
  if (n_rows <= 0 || n_fields <= 0 || width <= 0 || total >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads);
  gather_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, ld_x, meta, static_cast<unsigned>(n_fields),
      static_cast<unsigned>(width), static_cast<unsigned>(total), out);
  return static_cast<int>(cudaGetLastError());
}
