// Multi-table scatter-add of gathered-row cotangents for Hopper (sm_90a):
// the backward of gather_rows.
//
//   target_f[rows[b, f], :] += grad[b, f, :]          for every (b, f)
//
// for all the fields of one gather_rows launch (tables of one row width W),
// in one call.  A field's target is either a table's dense [V, W]
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
// The call runs a sort of its own and a sum in two levels, all kernels of
// this file, on the caller's stream:
//
// 1. Keys.  A contribution's key is its target's base (the distinct
//    targets laid end to end) plus its row; a row outside [0, rows) gets
//    the key `total`, past every target, and adds nothing.  Keys are small
//    integers (int32), so a stable LSD radix sort of digits of at most 10
//    bits orders them: each pass is a counting sort of one digit, in two
//    kernels (block histograms; a placement by rank in the current order,
//    whose blocks each read all the histograms for their offsets, so that
//    no scan kernel runs).  In the placement each warp ranks its own
//    contiguous run of the block's tile with warp matches and counters of
//    its own; a prefix over the warps then places every contribution after
//    those of its digit in earlier warps and tiles.  So every pass is
//    stable and the sorted permutation is that of a stable sort: each
//    key's run lists its contributions in increasing flat index b * F + f.
//    No float and no order-dependent atomics take part.
// 2. Level 1.  Each run is cut into chunks: the first runs from the run's
//    start to the first multiple of kChunk at least kChunk past it, the
//    others span kChunk positions each, from a multiple of kChunk.  A warp
//    takes a segment of kChunk sorted positions, its lanes on the columns,
//    and sums every chunk whose head lies in the segment, in order: a
//    run's first chunk starting from the value the target holds, the
//    others from their first term.  A run of one chunk is written to its
//    target here.
// 3. Level 2.  A warp a run of several chunks adds the chunk sums in chunk
//    order and writes the target row.
//
// Order of the sums, and what it equals: a run of at most kChunk
// contributions (and some up to 2 kChunk - 1) is one chunk, summed one
// after another in increasing b * F + f from the target's value: the order
// of torch.index_add_ on the CPU, bit for bit.  A longer run sums in two
// levels, which is not that order: it is held to the sum of its terms'
// magnitudes.  Every sum is one fixed sequence of float32 adds, so a
// repeat gives the same bits.
//
// What bounds it: device-memory bytes.  It reads the [B, F, W] cotangent
// once (7.24 MB at B=4096, F=26, W=17), the rows, and reads and writes
// each target row once: about 15 MB, some 4.6 us at 3.35 TB/s.  The sort
// moves 16 bytes a contribution a pass (1.7 MB a pass at n = 106,496).
//
// What the design does about that: the sort's passes are short, bounded
// by launches and latency (two kernels a pass, two passes at the main
// path's key ranges), so no kernel waits at a block barrier a round, and
// every access of a single block is coalesced (one SM's uncoalesced
// stores were what made a one-block scan slow).  Level 1 walks its
// segment 32 positions at a time, their cotangent and target loads in
// flight together into shared memory, then adds them in a rolled loop
// (a fully unrolled walk was too much code), and every branch turns on
// keys alone, the same for all lanes;
// a long run's chain is at most 2 kChunk - 1 adds in level 1 and (run
// length / kChunk) in level 2, not the run's length (a table of 3 rows
// read 4096 times was a chain of ~1,365 dependent adds).
//
// The per-field arguments come in one int64 device array `meta`: target
// base pointers, target row counts and target bases, n_fields each.  The
// caller allocates the workspace (scatter_add_rows_workspace bytes).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                   // rounds of 32 a warp
constexpr int kTile = kThreads * kRounds;    // contributions a sort block
constexpr int kMaxDigitBits = 10;
constexpr int kMaxBuckets = 1 << kMaxDigitBits;
constexpr int kMaxHist = 1 << 16;            // buckets x tiles of a pass
constexpr int kChunk = 64;
constexpr int kBatch = 32;                   // positions a walk stages at once
constexpr int kSumWarps = 4;
constexpr int kMaxFields = 1024;             // meta in a sum block's smem

struct Workspace {
  int* keys[2];
  int* vals[2];
  int* hist;        // [n_tiles][buckets], tile-major
  float* first;     // [n / kChunk + 1][W]: first chunks of long runs
  float* rest;      // [n / kChunk + 1][W]: the other chunks
  int* long_start;  // [n / kChunk + 1]: a segment's long run start, or -1
};

long long align_up(long long v, long long a) { return (v + a - 1) / a * a; }

long long layout(long long n, int width, char* base, Workspace* ws) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long segs = n / kChunk + 1;
  long long off = 0;
  auto take = [&](long long bytes) {
    const long long at = off;
    off = align_up(off + bytes, 256);
    return base ? base + at : nullptr;
  };
  char* k0 = take(4 * n);
  char* k1 = take(4 * n);
  char* v0 = take(4 * n);
  char* v1 = take(4 * n);
  char* h = take(4LL * kMaxBuckets * n_tiles);
  char* f = take(4 * segs * width);
  char* r = take(4 * segs * width);
  char* l = take(4 * segs);
  if (ws) {
    ws->keys[0] = reinterpret_cast<int*>(k0);
    ws->keys[1] = reinterpret_cast<int*>(k1);
    ws->vals[0] = reinterpret_cast<int*>(v0);
    ws->vals[1] = reinterpret_cast<int*>(v1);
    ws->hist = reinterpret_cast<int*>(h);
    ws->first = reinterpret_cast<float*>(f);
    ws->rest = reinterpret_cast<float*>(r);
    ws->long_start = reinterpret_cast<int*>(l);
  }
  return off;
}

// the passes and digit width that cover keys up to `total`: as few passes
// of at most kMaxDigitBits bits as keep buckets x tiles within kMaxHist
// (each placement block reads all of a pass's histograms), the bits
// spread evenly, at least 2 (the placement reads digits in fours)
void digits_for(long long total, long long n_tiles, int* passes,
                int* digit_bits) {
  int bits = 1;
  while (bits < 31 && (total >> bits) > 0) ++bits;
  int p = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  while (p < bits && (n_tiles << ((bits + p - 1) / p)) > kMaxHist) ++p;
  *passes = p;
  *digit_bits = (bits + p - 1) / p < 2 ? 2 : (bits + p - 1) / p;
}

// ceil(2^32 / d) for d > 1 where every v < n has an exact quotient by it
// (n d < 2^32), else 0: then field_of divides
unsigned field_magic(long long n, int d) {
  if (d <= 1 || n * static_cast<long long>(d) >= (1LL << 32)) return 0;
  return static_cast<unsigned>(((1ULL << 32) + d - 1) / d);
}

// the field of flat index v = b * n_fields + f
__device__ __forceinline__ int field_of(int v, int n_fields, unsigned magic) {
  if (magic == 0) return v % n_fields;
  return v - static_cast<int>(__umulhi(static_cast<unsigned>(v), magic)) *
                 n_fields;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// the flat index of a sort block's (warp, round, lane): each warp owns a
// contiguous run of kRounds * 32 contributions, in rounds of 32
__device__ __forceinline__ long long tile_index(int warp, int r, int lane) {
  return static_cast<long long>(blockIdx.x) * kTile +
         (warp * kRounds + r) * 32 + lane;
}

// counts of the tile's digits into hist[tile * n_buckets + digit]; with
// `rows`, the keys are built first (and written with the identity order)
__global__ void __launch_bounds__(kThreads)
keys_hist_kernel(const long long* __restrict__ rows,
                 const long long* __restrict__ meta, int n_fields,
                 unsigned magic, int total, int* __restrict__ keys,
                 int* __restrict__ vals, int* __restrict__ hist, long long n,
                 int shift, int n_buckets) {
  __shared__ int counts[kMaxBuckets];
  const int tid = threadIdx.x;
  for (int d = tid; d < n_buckets; d += kThreads) counts[d] = 0;
  int key[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = tile_index(tid >> 5, r, tid & 31);
    key[r] = -1;
    if (i < n) {
      if (rows) {
        const int f = field_of(static_cast<int>(i), n_fields, magic);
        const long long row = rows[i];
        key[r] = (row >= 0 && row < meta[n_fields + f])
                     ? static_cast<int>(meta[2 * n_fields + f] + row) : total;
        keys[i] = key[r];
        vals[i] = static_cast<int>(i);
      } else {
        key[r] = keys[i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int digit = key[r] < 0 ? n_buckets
                                 : (key[r] >> shift) & (n_buckets - 1);
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (digit < n_buckets && (peers & lanemask_lt()) == 0) {
      atomicAdd(&counts[digit], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = tid; d < n_buckets; d += kThreads) {
    hist[static_cast<long long>(blockIdx.x) * n_buckets + d] = counts[d];
  }
}

// stable placement of one digit.  The block first reads every tile's
// histogram (coalesced over digits): a digit's offset for this tile is
// the count of all smaller digits plus its count in earlier tiles, so no
// separate scan runs.  Each warp then ranks its own contiguous run of the
// tile in rounds of 32 (warp matches and counters of its own, no block
// barrier), and one prefix over the warps a digit turns the counts into
// each warp's start: a contribution lands at its digit's offset + its
// warp's start + its rank in the warp, the order of the flat index within
// a digit.
__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
             int* __restrict__ keys_out, int* __restrict__ vals_out,
             const int* __restrict__ hist, long long n, int n_tiles,
             int shift, int n_buckets) {
  __shared__ int base[kMaxBuckets];
  __shared__ int totals[kMaxBuckets];
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned short cnt[kWarps][kMaxBuckets];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int key[kRounds], val[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = tile_index(warp, r, lane);
    key[r] = i < n ? keys_in[i] : -1;
    val[r] = i < n ? vals_in[i] : 0;
  }
  // each digit's count in earlier tiles and in all: a thread reads four
  // digits (int4) of a share of the tiles, the shares added in shared
  // memory (integer sums: any order gives the same counts)
  for (int d = tid; d < n_buckets; d += kThreads) {
    base[d] = 0;
    totals[d] = 0;
  }
  __syncthreads();
  {
    const int quads = n_buckets / 4;
    const int groups = kThreads / quads;         // n_buckets <= 4 kThreads
    const int grp = tid / quads, q = tid % quads;
    if (grp < groups) {
      const int per = (n_tiles + groups - 1) / groups;
      const int t0 = grp * per;
      const int t1 = t0 + per < n_tiles ? t0 + per : n_tiles;
      int4 pre = make_int4(0, 0, 0, 0), all = make_int4(0, 0, 0, 0);
#pragma unroll 16
      for (int t = t0; t < t1; ++t) {
        const int4 c = reinterpret_cast<const int4*>(
            hist + static_cast<long long>(t) * n_buckets)[q];
        all.x += c.x; all.y += c.y; all.z += c.z; all.w += c.w;
        if (t < static_cast<int>(blockIdx.x)) {
          pre.x += c.x; pre.y += c.y; pre.z += c.z; pre.w += c.w;
        }
      }
      atomicAdd(&totals[4 * q], all.x);
      atomicAdd(&totals[4 * q + 1], all.y);
      atomicAdd(&totals[4 * q + 2], all.z);
      atomicAdd(&totals[4 * q + 3], all.w);
      atomicAdd(&base[4 * q], pre.x);
      atomicAdd(&base[4 * q + 1], pre.y);
      atomicAdd(&base[4 * q + 2], pre.z);
      atomicAdd(&base[4 * q + 3], pre.w);
    }
  }
  __syncthreads();
  // exclusive scan of the totals over digits: a thread a run of digits
  {
    const int per = (n_buckets + kThreads - 1) / kThreads;
    const int lo = tid * per;
    int sum = 0;
    for (int d = lo; d < lo + per && d < n_buckets; ++d) sum += totals[d];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += warp_sums[w];
    for (int d = lo; d < lo + per && d < n_buckets; ++d) {
      base[d] += run;
      run += totals[d];
    }
  }
  for (int d = lane; d < n_buckets; d += 32) cnt[warp][d] = 0;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int digit = key[r] < 0 ? n_buckets
                                 : (key[r] >> shift) & (n_buckets - 1);
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int before = digit < n_buckets ? cnt[warp][digit] : 0;
    rank[r] = before + __popc(peers & lanemask_lt());
    __syncwarp();
    if (digit < n_buckets && (peers & lanemask_lt()) == 0) {
      cnt[warp][digit] = static_cast<unsigned short>(before + __popc(peers));
    }
    __syncwarp();
  }
  __syncthreads();
  for (int d = tid; d < n_buckets; d += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][d];
      cnt[w][d] = static_cast<unsigned short>(run);
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (key[r] < 0) continue;
    const int digit = (key[r] >> shift) & (n_buckets - 1);
    const int pos = base[digit] + cnt[warp][digit] + rank[r];
    keys_out[pos] = key[r];
    vals_out[pos] = val[r];
  }
}

// the first multiple of kChunk at least kChunk past a run's start: where
// its second chunk begins
__device__ __forceinline__ long long second_chunk(long long start) {
  return (start + 2 * kChunk - 1) / kChunk * kChunk;
}

// a field's target pointers and bases, from meta into shared memory
__device__ __forceinline__ void load_fields(const long long* meta,
                                            int n_fields, long long* fm) {
  for (int i = threadIdx.x; i < n_fields; i += blockDim.x) {
    fm[i] = meta[i];
    fm[n_fields + i] = meta[2 * n_fields + i];
  }
  __syncthreads();
}

// the target element of key k, read through contribution v's field
__device__ __forceinline__ float* target_at(const long long* fm, int n_fields,
                                            unsigned magic, int k, int v,
                                            int width, int w) {
  const int f = field_of(v, n_fields, magic);
  return reinterpret_cast<float*>(fm[f]) +
         (static_cast<long long>(k) - fm[n_fields + f]) * width + w;
}

// Level 1.  A warp a segment [P0, P0 + kChunk) of the sorted positions,
// its lanes on the columns.  It sums every chunk whose head lies in the
// segment: a rest chunk at P0 (a run that began kChunk or more before),
// and the first chunk of each run starting in the segment, which may run
// on into the next segment up to second_chunk(start).  It walks the
// positions in order, kBatch at a time: the batch's terms, and the
// targets' values where a first chunk opens, are staged in shared memory
// with cp.async, all in flight together; then one rolled loop adds them
// in order.  Every branch turns on keys alone, the same for all lanes.  A
// first chunk that ends its run is written to the target; one whose run
// goes on is left in `first`, a rest chunk in `rest`.
__global__ void __launch_bounds__(kSumWarps * 32)
chunk_sum_kernel(const float* __restrict__ grad,
                 const long long* __restrict__ meta,
                 const int* __restrict__ keys, const int* __restrict__ vals,
                 float* __restrict__ first, float* __restrict__ rest,
                 int* __restrict__ long_start, long long n, int n_fields,
                 unsigned magic, int width, int total) {
  extern __shared__ long long fm[];
  __shared__ float sg[kSumWarps][kBatch][32];   // the batch's terms
  __shared__ float st[kSumWarps][kBatch][32];   // targets where runs open
  load_fields(meta, n_fields, fm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long seg = static_cast<long long>(blockIdx.x) * kSumWarps + warp;
  const long long P0 = seg * kChunk;
  if (P0 >= n) return;
  const long long seg_end = P0 + kChunk;
  // the keys around P0 and the first batch, all loaded together
  const int k0 = keys[P0];
  const int before = P0 > 0 ? keys[P0 - 1] : -1;
  const int back = P0 >= kChunk ? keys[P0 - kChunk] : -1;
  const int kl0 = P0 + lane < n ? keys[P0 + lane] : -1;
  const int vl0 = P0 + lane < n ? vals[P0 + lane] : 0;
  if (k0 == total) {                  // rows out of range, sorted last
    if (lane == 0) long_start[seg] = -1;
    return;
  }
  const bool carried = before == k0;
  const bool rest_at_p0 = carried && back == k0;
  long long long_run = -1;
  for (int w0 = 0; w0 < width; w0 += 32) {
    const int w = w0 + lane;
    const bool col = w < width;
    // the open chunk: kind 1 a first chunk, 2 a rest chunk, 0 none;
    // skip: P0 continues a first chunk that the previous segment sums
    int kind = rest_at_p0 ? 2 : 0;
    bool skip = carried && !rest_at_p0;
    bool fresh = true;
    long long limit = seg_end, start = -1;
    float acc = 0.f;
    float* dst = nullptr;
    int prev = before;
    bool done = false;
    int kl = kl0, vl = vl0;
    for (long long q = P0; !done; q += kBatch) {
      int kp = __shfl_up_sync(0xffffffffu, kl, 1);
      if (lane == 0) kp = prev;
      // bit u: position q + u starts a run
      const unsigned starts = __ballot_sync(0xffffffffu, kl != kp);
      // the walk stops at the first run past the segment, or past the
      // contributions that add: no loads from there on
      const unsigned ends = __ballot_sync(
          0xffffffffu, (kl != kp && q + lane >= seg_end) || kl < 0 ||
                           kl == total);
      const int used = ends ? __ffs(ends) - 1 : kBatch;
      // each lane finds its position's target row (column 0)
      float* row = nullptr;
      if (kl >= 0 && kl != total) row = target_at(fm, n_fields, magic, kl, vl,
                                                   width, 0);
#pragma unroll 8
      for (int u = 0; u < used; ++u) {
        const int v = __shfl_sync(0xffffffffu, vl, u);
        float* const r = reinterpret_cast<float*>(__shfl_sync(
            0xffffffffu, reinterpret_cast<unsigned long long>(row), u));
        if (col) {
          cp_async_4(&sg[warp][u][lane],
                     grad + static_cast<long long>(v) * width + w);
          if (((starts >> u) & 1) && q + u < seg_end) {
            cp_async_4(&st[warp][u][lane], r + w);
          }
        }
      }
      // the next batch's keys, in flight during this batch's sums
      const long long i = q + kBatch + lane;
      const int kl_next = i < n ? keys[i] : -1;
      const int vl_next = i < n ? vals[i] : 0;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      for (int u = 0; u <= used && u < kBatch; ++u) {
        const long long pos = q + u;
        const float g = sg[warp][u][lane];
        if ((starts >> u) & 1) {
          // a run ends: close its open chunk
          if (kind == 1) {
            if (col) *dst = acc;
          } else if (kind == 2) {
            if (col) rest[seg * width + w] = acc;
          }
          kind = 0;
          skip = false;
          const int k = __shfl_sync(0xffffffffu, kl, u);
          if (pos >= seg_end || k < 0 || k == total) {
            done = true;
            break;
          }
          float* const r = reinterpret_cast<float*>(__shfl_sync(
              0xffffffffu, reinterpret_cast<unsigned long long>(row), u));
          kind = 1;
          start = pos;
          limit = second_chunk(pos);
          dst = r + w;
          acc = __fadd_rn(st[warp][u][lane], g);
        } else if (skip) {
          if (pos >= seg_end) {
            done = true;
            break;
          }
        } else if (kind != 0) {
          if (pos == limit) {
            // the run goes on past this chunk: level 2 finishes it
            if (kind == 1) {
              if (col) first[seg * width + w] = acc;
              long_run = start;
            } else if (col) {
              rest[seg * width + w] = acc;
            }
            done = true;
            break;
          }
          acc = fresh && kind == 2 ? g : __fadd_rn(acc, g);
          fresh = false;
        }
      }
      prev = __shfl_sync(0xffffffffu, kl, kBatch - 1);
      kl = kl_next;
      vl = vl_next;
      __syncwarp();
    }
  }
  if (lane == 0) long_start[seg] = static_cast<int>(long_run);
}

// Level 2.  A warp a segment whose long run level 1 left in `first`: the
// run's chunk sums added in chunk order, kBatch heads loaded at once, and
// the target row written.
__global__ void __launch_bounds__(kThreads)
run_sum_kernel(const long long* __restrict__ meta,
               const int* __restrict__ keys, const int* __restrict__ vals,
               const float* __restrict__ first,
               const float* __restrict__ rest,
               const int* __restrict__ long_start, long long n,
               int n_fields, unsigned magic, int width) {
  extern __shared__ long long fm[];
  load_fields(meta, n_fields, fm);
  const int lane = threadIdx.x & 31;
  const long long seg =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (seg * kChunk >= n) return;
  const int s = long_start[seg];
  if (s < 0) return;
  const int k = keys[s];
  const int v = vals[s];
  for (int w0 = 0; w0 < width; w0 += 32) {
    const int w = w0 + lane;
    const bool col = w < width;
    float acc = col ? first[seg * width + w] : 0.f;
    for (long long h = second_chunk(s);; h += kBatch * kChunk) {
      const long long at = h + static_cast<long long>(lane) * kChunk;
      const int kk = at < n ? keys[at] : -1;
      // the heads still in the run: a prefix of the lanes
      const int count = __popc(__ballot_sync(0xffffffffu, kk == k));
      float c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        c[u] = col && u < count
                   ? rest[(h / kChunk + u) * width + w] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < count) acc = __fadd_rn(acc, c[u]);
      }
      if (count < kBatch) break;
    }
    if (col) *target_at(fm, n_fields, magic, k, v, width, w) = acc;
  }
}

struct Args {
  const float* grad;
  const long long* rows;
  const long long* meta;
  long long n;
  int n_fields, width, total;
  unsigned magic;
  Workspace ws;
  int n_tiles;
  cudaStream_t stream;
};

bool prepare(Args* a, const float* grad, const long long* rows,
             const long long* meta, long long n, int n_fields, int width,
             long long total, void* workspace, long long workspace_bytes,
             void* stream) {
  if (n <= 0 || n_fields <= 0 || n_fields > kMaxFields || width <= 0 ||
      n % n_fields != 0 ||
      n >= (1LL << 31) / 2 || total < 0 || total >= (1LL << 31) - 1 ||
      workspace == nullptr ||
      workspace_bytes < layout(n, width, nullptr, nullptr)) {
    return false;
  }
  a->grad = grad;
  a->rows = rows;
  a->meta = meta;
  a->n = n;
  a->n_fields = n_fields;
  a->width = width;
  a->total = static_cast<int>(total);
  a->magic = field_magic(n, n_fields);
  layout(n, width, static_cast<char*>(workspace), &a->ws);
  a->n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  a->stream = static_cast<cudaStream_t>(stream);
  return true;
}

int passes_for(long long total, long long n) {
  int passes, digit_bits;
  digits_for(total, (n + kTile - 1) / kTile, &passes, &digit_bits);
  return passes;
}

// the sort; returns which of the two buffers holds the sorted keys
int sort(const Args& a) {
  int passes, digit_bits;
  digits_for(a.total, a.n_tiles, &passes, &digit_bits);
  const int n_buckets = 1 << digit_bits;
  int cur = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = digit_bits * pass;
    keys_hist_kernel<<<a.n_tiles, kThreads, 0, a.stream>>>(
        pass == 0 ? a.rows : nullptr, a.meta, a.n_fields, a.magic, a.total,
        a.ws.keys[cur], a.ws.vals[cur], a.ws.hist, a.n, shift, n_buckets);
    place_kernel<<<a.n_tiles, kThreads, 0, a.stream>>>(
        a.ws.keys[cur], a.ws.vals[cur], a.ws.keys[1 - cur],
        a.ws.vals[1 - cur], a.ws.hist, a.n, a.n_tiles, shift, n_buckets);
    cur = 1 - cur;
  }
  return cur;
}

int sorted_buffer(long long total, long long n) {
  return passes_for(total, n) % 2;
}

void sum(const Args& a, int cur) {
  const long long segs = (a.n + kChunk - 1) / kChunk;
  const size_t smem = 2 * sizeof(long long) * a.n_fields;
  chunk_sum_kernel<<<static_cast<unsigned>((segs + kSumWarps - 1) / kSumWarps),
                     kSumWarps * 32, smem, a.stream>>>(
      a.grad, a.meta, a.ws.keys[cur], a.ws.vals[cur], a.ws.first,
      a.ws.rest, a.ws.long_start, a.n, a.n_fields, a.magic, a.width,
      a.total);
  run_sum_kernel<<<static_cast<unsigned>((segs + kWarps - 1) / kWarps),
                   kThreads, smem, a.stream>>>(
      a.meta, a.ws.keys[cur], a.ws.vals[cur], a.ws.first, a.ws.rest,
      a.ws.long_start, a.n, a.n_fields, a.magic, a.width);
}

}  // namespace

// Bytes of workspace a call of n contributions of `width` floats needs.
extern "C" long long scatter_add_rows_workspace(long long n, int width) {
  return layout(n, width, nullptr, nullptr);
}

// The chunk length of the two-level sum.
extern "C" int scatter_add_rows_chunk() { return kChunk; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `grad` is [n / n_fields, n_fields, width] contiguous float32, `rows` the
// target row of each of its n rows, `meta` the per-field arguments,
// `total` the rows of the distinct targets together.  part: 0 = the
// whole call, 1 = the sort alone, 2 = the sums alone (on the sort of an
// earlier part-1 call into the same workspace).  The caller checks
// shapes and types and keeps every buffer alive until the kernels have
// run.
extern "C" int scatter_add_rows_f32(const float* grad, const long long* rows,
                                    const long long* meta, long long n,
                                    int n_fields, int width, long long total,
                                    void* workspace,
                                    long long workspace_bytes, int part,
                                    void* stream) {
  Args a;
  if (part < 0 || part > 2 ||
      !prepare(&a, grad, rows, meta, n, n_fields, width, total, workspace,
               workspace_bytes, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cur = sorted_buffer(a.total, a.n);
  if (part != 2) cur = sort(a);
  if (part != 1) sum(a, cur);
  return static_cast<int>(cudaGetLastError());
}

// The sorted keys and order of the last sort into `workspace` (for a
// check on the card): copies n int32 of each into keys_out and vals_out.
extern "C" int scatter_add_rows_sorted(void* workspace, long long n,
                                       int width, long long total,
                                       int* keys_out, int* vals_out,
                                       void* stream) {
  Workspace ws;
  layout(n, width, static_cast<char*>(workspace), &ws);
  const int cur = sorted_buffer(total, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemcpyAsync(keys_out, ws.keys[cur], 4 * n, cudaMemcpyDeviceToDevice,
                  s);
  cudaMemcpyAsync(vals_out, ws.vals[cur], 4 * n, cudaMemcpyDeviceToDevice,
                  s);
  return static_cast<int>(cudaGetLastError());
}
