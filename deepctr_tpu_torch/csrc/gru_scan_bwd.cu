// Backward of the masked GRU / AGRU / AUGRU recurrence (csrc/gru_scan.cu),
// for Hopper (sm_90a).
//
// Time runs in reverse from dh = dh_last.  At each step t, from the saved
// carry h = h_{t-1} and the gates gi_t:
//
//   gh = h @ W_hh^T + b_hh;  r, z, n as in the forward (float32)
//   g  = m * (dh + douts_t)
//   gru    dn = g (1 - z),  dz = g (h - n),  dh_direct = g z
//   agru   dn = g a,  du = g (n - h),  dh_direct = g (1 - a),  da = sum du
//   augru  u = a z;  dn = g u,  du = g (n - h),  dh_direct = g (1 - u),
//          da = sum du z,  dz = du a
//   d_pre_n = dn (1 - n^2),  d_pre_z = dz z (1 - z),
//   d_pre_r = d_pre_n h_n r (1 - r)
//   dgi_t = [d_pre_r, d_pre_z, d_pre_n]            (storage type)
//   d_gh  = [d_pre_r, d_pre_z, d_pre_n r]          (float32)
//   dh    = (1 - m) dh + dh_direct + d_gh @ W_hh^T^T
//   dW_hh += h^T d_gh,  db_hh += sum over rows of d_gh  (float32)
//
// and d(att)[b, t] = da, in the type of att.
//
// What it replaces: the TPU kernel deepctr_tpu/ops/pallas_gru.py:_bwd_call
// (_make_bwd_kernel), one pallas_call whose grid walks batch blocks and,
// inside each, time chunks in reverse, all in order on one core, so that
// its dW_hh / db_hh scratch accumulates across batch blocks.  Blocks on
// this card run in parallel, so the work is split in two:
//
// 1. The reverse scan: each block owns a tile of batch rows and walks t
//    from its rows' last valid step down to 0 (a step with m = 0 passes
//    dh on unchanged and has zero dgi, so the steps after every row's
//    history only write zeros), and writes d_gh [T, B, 3H] in float32 to
//    a scratch buffer.  For H <= 64 (gru_scan_bwd_rows_kernel, on DIEN's
//    path) both products of a step, the gate recompute h @ W_hh^T and dh
//    = d_gh @ W_hh, run on the tensor cores: mma.sync m16n8k8 with TF32
//    operands split hi + lo and multiplied three times, which keeps
//    float32 accuracy, over tiles of the block's 8 rows.  W_hh^T's
//    fragments are split once into shared memory (registers could not hold
//    both products' beside the elementwise phase's without spilling) and
//    each one read serves all 8 rows.  The gate recompute of step t - 1
//    runs beside dh of step t, as it does not wait on dh.  A step's
//    inputs are loaded ahead, kept as they lie in memory and converted
//    where they are used; the L2 is asked for them kPrefetch steps ahead.
//    Above H=64 the wide design (gru_scan_bwd_kernel, the earlier one) runs:
//    a thread a (row, unit), W_hh^T in shared memory with rows padded to
//    3H + 1 floats (read through L2 above H=136).
// 2. The dW product: dW_hh = carry^T d_gh and db_hh = ones^T d_gh over the
//    B*T rows, in fixed chunks of rows (float32 partials), then summed over
//    the chunks in order (dw_reduce_kernel).  For H <= 64
//    dw_rows_partial_kernel: a block holds all of [H, 3H], 8 x 6 outputs
//    a thread, and skips the padded steps' rows; above, dw_partial_kernel's
//    64 x 64 tiles.  dw_reduce_kernel keeps 16 loads in flight a thread
//    rather than waiting out each split's load in turn.  No atomics: two
//    launches on the same inputs give the same bits.
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W; PERF.md).  The
// earlier scan was bound, as its forward, by the SM's shared-memory load
// rate (every multiply-add of both products loaded its operands from
// shared memory), and its dW product by its loads from device memory.
// Now a step of the scan costs about 2,650 clocks for its two products on
// the tensor pipe (576 m16n8k8 TF32 products a block a step: a build
// without both runs 0.134 ms faster than the scan's 0.239,
// tools/gru_parts.py) and about 2,100 for the elementwise phase, its
// loads and stores and two barriers.  The dW product (0.113 ms) stays far
// above its multiply-adds' time: staging its rows by cp.async several
// stages ahead was no faster, and skipping the padded rows' sums did not
// move it, so neither its loads' latency nor its multiply-adds bound it;
// what does is not measured (no stall profiler runs on that machine).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;   // threads of a block of several rows
constexpr int kMaxUnits = 1024;    // the most threads a block may have
// the shared memory a block may take on Hopper
constexpr int kMaxSharedBytes = 232448;
// returned for a hidden size a block does not take
constexpr int kDoesNotFit = -2;
// the row-blocked design: kRows batch rows a block of kRowThreads, for
// H <= kRowMaxH: the gate recompute in kKSteps k steps of 8, dh in
// kSplits quarters of the 3H columns, kCSteps column steps of 8 each
constexpr int kRows = 8;
constexpr int kRowThreads = 512;
constexpr int kRowMaxH = 64;
constexpr int kKSteps = kRowMaxH / 8;
constexpr int kSplits = 4;
constexpr int kCSteps = 3 * kRowMaxH / 8 / kSplits;

// the dW product: a block computes a kTile x kTile tile of [H, 3H] over
// one chunk of rows, kDepth rows a shared-memory stage, each of its 256
// threads a 4 x 4 block of outputs (kTile == 16 * 4, kDepth == 16)
constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kProductThreads = 256;
// blocks the split over rows aims for: eight a streaming multiprocessor,
// so that their loads hide each other's latency
constexpr int kTargetBlocks = 1056;
constexpr int kReduceThreads = 256;
constexpr int kReduceBatch = 16;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float load_att(const void* att, int bf16,
                                          long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(att)[i])
              : __ldg(static_cast<const float*>(att) + i);
}

__device__ __forceinline__ void store_att(void* att, int bf16, long long i,
                                          float v) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(att)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(att)[i] = v;
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

int rows_per_block(int H) {
  int rows = kMaxThreads / H;
  return rows < 1 ? 1 : rows;
}

// the h tile [rows][H], the d_gh tile [rows][3H] and the d(att) partials
// [rows * H]
size_t tile_bytes(int H) {
  return sizeof(float) * static_cast<size_t>(rows_per_block(H)) * 5 * H;
}

size_t w_bytes(int H) {
  return sizeof(float) * static_cast<size_t>(H) * (3 * H + 1);
}

bool w_fits(int H) {
  return tile_bytes(H) + w_bytes(H) <= static_cast<size_t>(kMaxSharedBytes);
}

// chunks of rows the dW product is split into (a function of the shapes
// alone, so that the sum's order is fixed)
// the dW product for H <= kRowMaxH: a block of kDwThreads sums the whole
// [H, 3H] over its chunk of rows, kDwRows rows a stage; kDwBlocks blocks,
// two a streaming multiprocessor
constexpr int kDwRows = 16;
constexpr int kDwThreads = 256;
constexpr int kDwBlocks = 264;

long long dw_splits(long long n_rows, int H) {
  if (H <= kRowMaxH) {
    const long long most = (n_rows + kDwRows - 1) / kDwRows;
    return most < kDwBlocks ? (most < 1 ? 1 : most) : kDwBlocks;
  }
  const long long tiles = static_cast<long long>((H + kTile - 1) / kTile) *
                          ((3 * H + kTile - 1) / kTile);
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (n_rows + kDepth - 1) / kDepth;
  if (splits > most) splits = most;
  return splits < 1 ? 1 : splits;
}

long long dw_chunk(long long n_rows, long long splits, int H) {
  const long long chunk = (n_rows + splits - 1) / splits;
  const int step = H <= kRowMaxH ? kDwRows : kDepth;
  return (chunk + step - 1) / step * step;
}

// MODE: 0 gru, 1 agru, 2 augru; W_SHARED: W_hh^T copied into shared memory
// (else W_hh^T and its transpose W_hh read from device memory).  gi is
// addressed as gi[t * gi_st + b * gi_sb + c], dgi the same way with its
// own strides, douts as douts[t * do_st + b * do_sb + j], dh_last as
// dh_last[b * dhl_sb + j]; carry is [T, B, H] and dgh [T, B, 3H]
// contiguous; mask is [B, T] bytes (0 or 1); att and datt are [B, T],
// float32 or bfloat16 (att_bf16).  douts and dh_last may be null (zero).
template <typename S, int MODE, bool W_SHARED>
__global__ void __launch_bounds__(kMaxUnits)
gru_scan_bwd_kernel(const S* __restrict__ gi, long long gi_st,
                    long long gi_sb, const S* __restrict__ carry,
                    const float* __restrict__ whh_t,
                    const float* __restrict__ whh,
                    const float* __restrict__ bhh,
                    const unsigned char* __restrict__ mask,
                    const void* __restrict__ att, int att_bf16,
                    const S* __restrict__ douts, long long do_st,
                    long long do_sb, const S* __restrict__ dh_last,
                    long long dhl_sb, int B, int T, int H,
                    S* __restrict__ dgi, long long dgi_st, long long dgi_sb,
                    float* __restrict__ dgh, void* __restrict__ datt) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int WS = H3 + 1;            // the padded row of W_hh^T
  const int rows = blockDim.x / H;  // blockDim.x == rows * H
  float* hs = smem;                 // [rows][H]
  float* dgs = hs + blockDim.x;     // [rows][3H]
  float* red = dgs + 3 * blockDim.x;  // [rows * H]
  float* ws = red + blockDim.x;     // [H][3H + 1] when W_SHARED
  const int tid = threadIdx.x;
  if (W_SHARED) {
    for (int i = tid; i < H * H3; i += blockDim.x) {
      const int k = i / H3;
      ws[k * WS + (i - k * H3)] = __ldg(whh_t + i);
    }
  }
  const float* w = W_SHARED ? ws : whh_t;
  const int w_st = W_SHARED ? WS : H3;
  const int lr = tid / H;
  const int j = tid - lr * H;
  const long long b = static_cast<long long>(blockIdx.x) * rows + lr;
  const bool active = b < B;
  const long long c_st = static_cast<long long>(B) * H;
  float br = 0.0f, bz = 0.0f, bn = 0.0f, dh = 0.0f;
  if (active) {
    br = __ldg(bhh + j);
    bz = __ldg(bhh + H + j);
    bn = __ldg(bhh + 2 * H + j);
    if (dh_last != nullptr) dh = load_f(dh_last + b * dhl_sb + j);
  }
  const S* g = gi + b * gi_sb + j;
  const S* cr = carry + b * H + j;
  const unsigned char* m_row = mask + b * T;
  const long long a_row = b * T;  // att is read only when MODE != 0

  // the next (earlier) step's gates, carry, mask, attention and output
  // cotangent, loaded a step ahead; nothing but the mask on a padded step
  float nr = 0.0f, nz = 0.0f, nn = 0.0f, nh = 0.0f, nm = 0.0f, na = 0.0f,
        nd = 0.0f;
  if (active) {
    const int t = T - 1;
    nm = static_cast<float>(m_row[t]);
    if (nm != 0.0f) {
      const S* gn = g + t * gi_st;
      nr = load_f(gn);
      nz = load_f(gn + H);
      nn = load_f(gn + 2 * H);
      nh = load_f(cr + t * c_st);
      if (MODE != 0) na = load_att(att, att_bf16, a_row + t);
      if (douts != nullptr) nd = load_f(douts + t * do_st + b * do_sb + j);
    }
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const float ir = nr, iz = nz, in = nn, h = nh, m = nm, a = na, d = nd;
    if (active && t > 0) {
      const int tn = t - 1;
      nm = static_cast<float>(m_row[tn]);
      if (nm != 0.0f) {
        const S* gn = g + tn * gi_st;
        nr = load_f(gn);
        nz = load_f(gn + H);
        nn = load_f(gn + 2 * H);
        nh = load_f(cr + tn * c_st);
        if (MODE != 0) na = load_att(att, att_bf16, a_row + tn);
        if (douts != nullptr) {
          nd = load_f(douts + tn * do_st + b * do_sb + j);
        }
      }
    }
    const bool live = active && m != 0.0f;
    if (live) hs[tid] = h;
    __syncthreads();  // the h tile is complete
    float d_r = 0.0f, d_z = 0.0f, d_n = 0.0f, d_hn = 0.0f, da = 0.0f,
          dh_direct = 0.0f;
    if (live) {
      float hr = 0.0f, hz = 0.0f, hn = 0.0f;
      const float* hrow = hs + lr * H;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hrow[k];
        const float* wk = w + k * w_st;
        hr = fmaf(hk, wk[j], hr);
        hz = fmaf(hk, wk[H + j], hz);
        hn = fmaf(hk, wk[2 * H + j], hn);
      }
      hr += br;
      hz += bz;
      hn += bn;
      const float r = sigmoid_f(ir + hr);
      const float z = sigmoid_f(iz + hz);
      const float n = tanhf(in + r * hn);
      const float g_new = m * (dh + d);
      float dn, dz;
      if (MODE == 0) {
        dn = g_new * (1.0f - z);
        dz = g_new * (h - n);
        dh_direct = g_new * z;
      } else {
        const float u = MODE == 2 ? a * z : a;
        dn = g_new * u;
        const float du = g_new * (n - h);
        dh_direct = g_new * (1.0f - u);
        if (MODE == 2) {
          da = du * z;
          dz = du * a;
        } else {
          da = du;
          dz = 0.0f;
        }
      }
      d_n = dn * (1.0f - n * n);
      d_z = dz * z * (1.0f - z);
      d_r = d_n * hn * r * (1.0f - r);
      d_hn = d_n * r;
      float* dq = dgs + lr * H3 + j;
      dq[0] = d_r;
      dq[H] = d_z;
      dq[2 * H] = d_hn;
    }
    if (active) {
      S* dg = dgi + t * dgi_st + b * dgi_sb + j;
      store_f(dg, d_r);
      store_f(dg + H, d_z);
      store_f(dg + 2 * H, d_n);
      float* dq = dgh + (static_cast<long long>(t) * B + b) * H3 + j;
      dq[0] = d_r;
      dq[H] = d_z;
      dq[2 * H] = d_hn;
    }
    if (MODE != 0) {
      // d(att) of the row: its H units' terms summed in a fixed order
      if (H % 32 == 0) {
        float v = da;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, o);
        }
        if ((tid & 31) == 0) red[tid >> 5] = v;
      } else {
        red[tid] = da;
      }
    }
    __syncthreads();  // the d_gh tile and the d(att) partials are complete
    if (MODE != 0 && active && j == 0) {
      float s = 0.0f;
      if (H % 32 == 0) {
        const float* q = red + ((lr * H) >> 5);
        for (int i = 0; i < (H >> 5); ++i) s += q[i];
      } else {
        const float* q = red + lr * H;
        for (int i = 0; i < H; ++i) s += q[i];
      }
      store_att(datt, att_bf16, a_row + t, m == 0.0f ? 0.0f : s);
    }
    if (live) {
      // (1 - m) dh vanishes: m is 1 here
      float acc = 0.0f;
      const float* drow = dgs + lr * H3;
      if (W_SHARED) {
        const float* wj = ws + j * WS;
#pragma unroll 8
        for (int c = 0; c < H3; ++c) acc = fmaf(drow[c], wj[c], acc);
      } else {
#pragma unroll 8
        for (int c = 0; c < H3; ++c) {
          acc = fmaf(drow[c], __ldg(whh + c * H + j), acc);
        }
      }
      dh = dh_direct + acc;
    }
  }
}

// part[z] = [carry^T dgh; ones^T dgh] over the rows [z * chunk, (z + 1) *
// chunk) of the N = T * B rows (chunk z is blockIdx.z): a [H + 1, 3H]
// float32 block of partials for each chunk, its row H the column sums
// that make db_hh.  A block computes a kTile x kTile tile of carry^T dgh,
// each thread 4 x 4 outputs whose operands are 4 consecutive floats of
// each shared-memory row (one 16-byte load each); the blocks of the first
// tile of k also sum their stage's rows of dgh for db_hh, each thread one
// row a stage, and reduce the 16 row sums of a column in order at the
// end.
template <typename S>
__global__ void __launch_bounds__(kProductThreads)
dw_partial_kernel(const S* __restrict__ carry, const float* __restrict__ dgh,
                  long long N, int H, long long chunk,
                  float* __restrict__ part) {
  __shared__ __align__(16) float cs[kDepth][kTile];  // carry rows [n][k]
  __shared__ __align__(16) float gs[kDepth][kTile];  // d_gh rows [n][c]
  const int H3 = 3 * H;
  const int k0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;
  const bool with_db = blockIdx.x == 0;
  const long long n0 = static_cast<long long>(blockIdx.z) * chunk;
  const long long n_end = n0 + chunk < N ? n0 + chunk : N;
  const int tx = threadIdx.x % 16;  // outputs c0 + 4 tx + q
  const int ty = threadIdx.x / 16;  // outputs k0 + 4 ty + i
  float acc[4][4];
  float db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  }
  // a thread's share of a stage: 4 values of each tile, loaded into
  // registers one stage ahead so that the loads overlap the products
  constexpr int kPer = kDepth * kTile / kProductThreads;
  float pc[kPer], pg[kPer];
  auto load_stage = [&](long long nb) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kProductThreads;
      const int r = i / kTile;
      const int col = i - r * kTile;
      const long long n = nb + r;
      const int k = k0 + col;
      const int c = c0 + col;
      float cv = 0.0f, gv = 0.0f;
      if (n < n_end) {
        if (k < H) cv = load_f(carry + n * H + k);
        if (c < H3) gv = __ldg(dgh + n * H3 + c);
      }
      pc[u] = cv;
      pg[u] = gv;
    }
  };
  if (n0 < n_end) load_stage(n0);
  for (long long nb = n0; nb < n_end; nb += kDepth) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kProductThreads;
      cs[i / kTile][i % kTile] = pc[u];
      gs[i / kTile][i % kTile] = pg[u];
    }
    __syncthreads();
    if (nb + kDepth < n_end) load_stage(nb + kDepth);
#pragma unroll 4
    for (int r = 0; r < kDepth; ++r) {
      const float4 cv = *reinterpret_cast<const float4*>(&cs[r][4 * ty]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[r][4 * tx]);
      const float a[4] = {cv.x, cv.y, cv.z, cv.w};
      const float g[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], g[q], acc[i][q]);
      }
    }
    if (with_db) {
      const float4 gv = *reinterpret_cast<const float4*>(&gs[ty][4 * tx]);
      db[0] += gv.x;
      db[1] += gv.y;
      db[2] += gv.z;
      db[3] += gv.w;
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * (H + 1) * H3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= H) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * tx + q;
      if (c < H3) out[k * H3 + c] = acc[i][q];
    }
  }
  if (with_db) {
    // every thread is past the loop's last barrier: cs is free
#pragma unroll
    for (int q = 0; q < 4; ++q) cs[ty][4 * tx + q] = db[q];
    __syncthreads();
    if (ty == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float sum = 0.0f;
        for (int y = 0; y < kDepth; ++y) sum += cs[y][4 * tx + q];
        const int c = c0 + 4 * tx + q;
        if (c < H3) out[static_cast<long long>(H) * H3 + c] = sum;
      }
    }
  }
}

// part[z] = [carry^T dgh; ones^T dgh] over the rows [z * chunk, (z + 1) *
// chunk) of the N = T * B rows (chunk z is blockIdx.x), for H <= kRowMaxH:
// a [H + 1, 3H] block of float32 partials, its row H the column sums that
// make db_hh.  The block holds all of [H, 3H]: thread (kt = tid / 32, ct =
// tid % 32) owns the 8 x 6 outputs k = 8 kt .., c = 6 ct .. in registers,
// so that each carry value it reads (a broadcast across the warp) serves 6
// columns and each d_gh value 8 units.  A stage of kDwRows rows of both
// operands goes through shared memory (zero past H and 3H), loaded into
// registers one stage ahead while the stage before is summed.  Warp 0 also
// sums the d_gh rows for db_hh.  The rows are summed in order; a row whose
// step is padded (mask 0: its d_gh row is zero) is skipped.  mask is
// [B, T]; row n is step n / B of batch row n % B.
template <typename S>
__global__ void __launch_bounds__(kDwThreads, 2)
dw_rows_partial_kernel(const S* __restrict__ carry,
                       const float* __restrict__ dgh,
                       const unsigned char* __restrict__ mask, int B, int T,
                       long long N, int H, long long chunk,
                       float* __restrict__ part) {
  constexpr int kC = 3 * kRowMaxH;
  constexpr int kPerC = kDwRows * kRowMaxH / kDwThreads;
  constexpr int kPerG = kDwRows * kC / kDwThreads;
  __shared__ __align__(16) float cs[kDwRows][kRowMaxH];
  __shared__ __align__(16) float gs[kDwRows][kC];
  __shared__ unsigned char live[kDwRows];
  const int H3 = 3 * H;
  const int tid = threadIdx.x;
  const int k0 = 8 * (tid >> 5);
  const int c0 = 6 * (tid & 31);
  const long long n0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long n_end = n0 + chunk < N ? n0 + chunk : N;
  float acc[8][6];
  float db[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    db[f] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e][f] = 0.0f;
  }
  float pc[kPerC], pg[kPerG];
  auto load_stage = [&](long long nb) {
#pragma unroll
    for (int u = 0; u < kPerC; ++u) {
      const int i = tid + u * kDwThreads;
      const int r = i / kRowMaxH;
      const int k = i - r * kRowMaxH;
      const long long n = nb + r;
      pc[u] = (n < n_end && k < H) ? load_f(carry + n * H + k) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPerG; ++u) {
      const int i = tid + u * kDwThreads;
      const int r = i / kC;
      const int c = i - r * kC;
      const long long n = nb + r;
      pg[u] = (n < n_end && c < H3) ? __ldg(dgh + n * H3 + c) : 0.0f;
    }
  };
  if (n0 < n_end) load_stage(n0);
  for (long long nb = n0; nb < n_end; nb += kDwRows) {
#pragma unroll
    for (int u = 0; u < kPerC; ++u) {
      const int i = tid + u * kDwThreads;
      cs[i / kRowMaxH][i % kRowMaxH] = pc[u];
    }
#pragma unroll
    for (int u = 0; u < kPerG; ++u) {
      const int i = tid + u * kDwThreads;
      gs[i / kC][i % kC] = pg[u];
    }
    if (tid < kDwRows) {
      const long long n = nb + tid;
      live[tid] = n < n_end ? mask[(n % B) * T + n / B] : 0;
    }
    __syncthreads();
    if (nb + kDwRows < n_end) load_stage(nb + kDwRows);
#pragma unroll 4
    for (int r = 0; r < kDwRows; ++r) {
      if (live[r] == 0) continue;
      const float4 h0 = *reinterpret_cast<const float4*>(&cs[r][k0]);
      const float4 h1 = *reinterpret_cast<const float4*>(&cs[r][k0 + 4]);
      const float2 g0 = *reinterpret_cast<const float2*>(&gs[r][c0]);
      const float2 g1 = *reinterpret_cast<const float2*>(&gs[r][c0 + 2]);
      const float2 g2 = *reinterpret_cast<const float2*>(&gs[r][c0 + 4]);
      const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const float gv[6] = {g0.x, g0.y, g1.x, g1.y, g2.x, g2.y};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int f = 0; f < 6; ++f) acc[e][f] = fmaf(hv[e], gv[f], acc[e][f]);
      }
      if (tid < 32) {
#pragma unroll
        for (int f = 0; f < 6; ++f) db[f] += gv[f];
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.x) * (H + 1) * H3;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (k0 + e >= H) continue;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      if (c0 + f < H3) out[(k0 + e) * H3 + c0 + f] = acc[e][f];
    }
  }
  if (tid < 32) {
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      if (c0 + f < H3) out[static_cast<long long>(H) * H3 + c0 + f] = db[f];
    }
  }
}

// dwhh [H, 3H] and dbhh [3H]: the partials summed over the chunks in order
__global__ void __launch_bounds__(kReduceThreads)
dw_reduce_kernel(const float* __restrict__ part, int splits, int H,
                 float* __restrict__ dwhh, float* __restrict__ dbhh) {
  const int H3 = 3 * H;
  const long long n_out = static_cast<long long>(H + 1) * H3;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_out) return;
  // in order, kReduceBatch loads in flight at a time: one load after
  // another would wait out the latency of each of the splits
  float s = 0.0f;
  int z = 0;
  for (; z + kReduceBatch <= splits; z += kReduceBatch) {
    float v[kReduceBatch];
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      v[u] = __ldg(part + (z + u) * n_out + i);
    }
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) s += v[u];
  }
  for (; z < splits; ++z) s += __ldg(part + z * n_out + i);
  if (i < static_cast<long long>(H) * H3) {
    dwhh[i] = s;
  } else {
    dbhh[i - static_cast<long long>(H) * H3] = s;
  }
}

// ---------------------------------------------------------------------------
// The row-blocked design (H <= kRowMaxH): both products of a step on the
// tensor cores, every W_hh value read serving the kRows rows of its block.
// ---------------------------------------------------------------------------

// h tiles [2][kRows][kHs], alternating by step (step t's elementwise phase
// writes the carry of step t - 1 for the gate recompute that follows it),
// the gate and d_gh tiles [kRows][kGs], the dh partials
// [kSplits][kRows][kHs].  kHs = 68 and kGs = 196 (4 mod 32 floats) keep
// the fragment loads and stores free of bank conflicts.
constexpr int kHs = 68;
constexpr int kGs = 196;

// A step's inputs are loaded ahead into registers as they lie in memory
// and converted only where a later step uses them, so that no warp waits on
// a load inside the step that issued it; the L2 is asked for them
// kPrefetch steps ahead, so that the load itself finds them there.
constexpr int kPrefetch = 8;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ float load_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load_raw(const __nv_bfloat16* p) {
  return *p;
}

// a score as it lies in memory: float32 bits, or bfloat16 bits in the top
// half
__device__ __forceinline__ unsigned load_att_raw(const void* att, int bf16,
                                                 long long i) {
  return bf16 ? static_cast<unsigned>(
                    static_cast<const unsigned short*>(att)[i])
              : __float_as_uint(__ldg(static_cast<const float*>(att) + i));
}
__device__ __forceinline__ float att_f(unsigned v, int bf16) {
  return __uint_as_float(bf16 ? v << 16 : v);
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x, in two integer instructions (sm_90
// emulates that cvt in about seven)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (hi rounded to nearest; lo the rest, rounded)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: a 16 x 8 (row-major), b 8 x 8 (column-
// major), TF32 operands, float32 accumulators; lane (g = lane / 4, q =
// lane % 4) holds a[g][q], a[g + 8][q], a[g][q + 4], a[g + 8][q + 4],
// b[q][g], b[q + 4][g] and d[g][2q], d[g][2q + 1], d[g + 8][2q],
// d[g + 8][2q + 1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 (hi*hi into main, hi*lo and lo*hi into their own
// sums: three chains a third as deep), a's and b's TF32 halves given.  The
// dropped lo*lo term is below 2^-22 of each product.
__device__ __forceinline__ void mma_3xtf32(float (&main)[4],
                                           float (&corr_a)[4],
                                           float (&corr_b)[4], uint4 ah,
                                           uint4 al, unsigned b0_hi,
                                           unsigned b0_lo, unsigned b1_hi,
                                           unsigned b1_lo) {
  const unsigned a_hi[4] = {ah.x, ah.y, ah.z, ah.w};
  const unsigned a_lo[4] = {al.x, al.y, al.z, al.w};
  mma_tf32(main, a_hi, b0_hi, b1_hi);
  mma_tf32(corr_a, a_hi, b0_lo, b1_lo);
  mma_tf32(corr_b, a_lo, b0_hi, b1_hi);
}

// The W_hh^T fragments of both products, split hi + lo once at the start
// and read from shared memory each step (registers cannot hold them beside
// the elementwise phase's): the gate recompute's [warp < 12][k step]
// [hi, lo][lane], then dh's [warp][column step][hi, lo][lane].
constexpr int kW1Slots = 12 * kKSteps * 2 * 32;
constexpr int kW2Slots = (kRowThreads / 32) * kCSteps * 2 * 32;

__device__ __forceinline__ int w1_slot(int w, int ks, int part, int lane) {
  return ((w * kKSteps + ks) * 2 + part) * 32 + lane;
}
__device__ __forceinline__ int w2_slot(int w, int cs, int part, int lane) {
  return kW1Slots + ((w * kCSteps + cs) * 2 + part) * 32 + lane;
}

// One block of kRowThreads threads owns kRows batch rows.  Roles:
//  - (row, unit), (lr = tid / H, j = tid % H), tid < 8H: the elementwise
//    backward of its pair; it writes dgi, the d_gh row for the dW product
//    and the d_gh tile, and takes dh = dh_direct + the products' partials;
//  - the gate recompute of step t - 1: warp w < ceil(3H / 16) computes
//    the 16 gate columns 16w .. of h_{t-2} @ W_hh^T for the 8 rows as one
//    m16n8 tile, k in steps of 8;
//  - dh: warp w computes units 16 (w % 4) .. of d_gh @ W_hh (the units'
//    rows of W_hh^T against the 8 rows' d_gh) over its quarter w / 4 of
//    the 3H columns; the quarters' partials meet in a fixed order in the
//    (row, unit) threads.
// The products run in 3xTF32 on the tensor cores, their W_hh^T fragments
// split once into shared memory.  Two barriers a step:
// the elementwise phase, then both products.  The block starts at its
// rows' last valid step t0; the steps t0 + 1 .. T-1 only write zero dgi,
// d_gh and d(att) (m = 0 there, so dh passes unchanged).
template <typename S, int MODE>
__global__ void __launch_bounds__(kRowThreads, 1)
gru_scan_bwd_rows_kernel(const S* __restrict__ gi, long long gi_st,
                         long long gi_sb, const S* __restrict__ carry,
                         const float* __restrict__ whh_t,
                         const float* __restrict__ bhh,
                         const unsigned char* __restrict__ mask,
                         const void* __restrict__ att, int att_bf16,
                         const S* __restrict__ douts, long long do_st,
                         long long do_sb, const S* __restrict__ dh_last,
                         long long dhl_sb, int B, int T, int H,
                         S* __restrict__ dgi, long long dgi_st,
                         long long dgi_sb, float* __restrict__ dgh,
                         void* __restrict__ datt) {
  extern __shared__ uint4 ws[];  // kW1Slots + kW2Slots fragments
  __shared__ __align__(16) float hs[2 * kRows * kHs];
  __shared__ __align__(16) float ghs[kRows * kGs];
  __shared__ __align__(16) float dgs[kRows * kGs];
  __shared__ __align__(16) float dps[kSplits * kRows * kHs];
  __shared__ float red[kRowThreads];
  __shared__ int t0_s;
  const int H3 = 3 * H;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int q = tid & 3;

  // the gate recompute: columns 16w .. of W_hh^T, kKSteps k steps of 8
  // (zero past H)
  const int lane = tid & 31;
  const bool gates_warp = 16 * w < H3;
  if (gates_warp) {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 8 * ks + q + (i >= 2 ? 4 : 0);
        const int c = 16 * w + g + (i & 1 ? 8 : 0);
        split_tf32((k < H && c < H3) ? __ldg(whh_t + k * H3 + c) : 0.0f,
                   hi[i], lo[i]);
      }
      ws[w1_slot(w, ks, 0, lane)] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      ws[w1_slot(w, ks, 1, lane)] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  // dh: units 16 * u0 .., the column steps c_step0 .. of this quarter
  const int u0 = 16 * (w % 4);
  const int split = w / 4;
  const bool dh_warp = u0 < H;
  const int c_step0 = split * kCSteps;
#pragma unroll
  for (int cs = 0; cs < kCSteps; ++cs) {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = u0 + g + (i & 1 ? 8 : 0);
      const int c = 8 * (c_step0 + cs) + q + (i >= 2 ? 4 : 0);
      split_tf32((dh_warp && k < H && c < H3) ? __ldg(whh_t + k * H3 + c)
                                              : 0.0f,
                 hi[i], lo[i]);
    }
    ws[w2_slot(w, cs, 0, lane)] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    ws[w2_slot(w, cs, 1, lane)] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  // (row, unit)
  const int lr = tid / H;
  const int j = tid - lr * H;
  const bool pair = tid < kRows * H;
  const long long b = static_cast<long long>(blockIdx.x) * kRows + lr;
  const bool active = pair && b < B;
  for (int i = tid; i < 2 * kRows * kHs; i += kRowThreads) hs[i] = 0.0f;
  for (int i = tid; i < kRows * kGs; i += kRowThreads) dgs[i] = 0.0f;
  if (tid == 0) t0_s = -1;
  float br = 0.0f, bz = 0.0f, bn = 0.0f, dh = 0.0f;
  if (active) {
    br = __ldg(bhh + j);
    bz = __ldg(bhh + H + j);
    bn = __ldg(bhh + 2 * H + j);
    if (dh_last != nullptr) dh = load_f(dh_last + b * dhl_sb + j);
  }
  const S* gp = gi + b * gi_sb + j;
  const long long c_st = static_cast<long long>(B) * H;
  const S* cr = carry + b * H + j;
  const unsigned char* m_row = mask + b * T;
  const long long a_row = b * T;  // att is read only when MODE != 0
  __syncthreads();
  // t0: the last valid step of the block's rows (-1: none)
  int last = -1;
  if (active) {
    for (int t = j; t < T; t += H) {
      if (m_row[t] != 0) last = t;
      if (MODE != 0) {
        prefetch_l2(static_cast<const char*>(att) +
                    (a_row + t) * (att_bf16 ? 2 : 4));
      }
    }
  }
  if (last >= 0) atomicMax(&t0_s, last);
  __syncthreads();
  const int t0 = t0_s;
  // two lanes a warp ask the L2 for a step's gates, carry and output
  // cotangent (their rows' segments start and end in their lines)
  const bool fetcher = active && ((tid & 31) == 0 || (tid & 31) == 31);
  auto prefetch_step = [&](int t) {
    const S* gt = gp + t * gi_st;
    prefetch_l2(gt);
    prefetch_l2(gt + H);
    prefetch_l2(gt + 2 * H);
    prefetch_l2(cr + t * c_st);
    if (douts != nullptr) prefetch_l2(douts + t * do_st + b * do_sb + j);
  };
  if (fetcher) {
    for (int t = t0; t >= 0 && t > t0 - kPrefetch; --t) prefetch_step(t);
  }

  // the steps past every row's history: zero dgi, d_gh and d(att)
  if (active) {
    for (int t = T - 1; t > t0; --t) {
      S* dg = dgi + t * dgi_st + b * dgi_sb + j;
      store_f(dg, 0.0f);
      store_f(dg + H, 0.0f);
      store_f(dg + 2 * H, 0.0f);
      float* dq = dgh + (static_cast<long long>(t) * B + b) * H3 + j;
      dq[0] = 0.0f;
      dq[H] = 0.0f;
      dq[2 * H] = 0.0f;
      if (MODE != 0 && j == 0) store_att(datt, att_bf16, a_row + t, 0.0f);
    }
  }

  // the inputs of a step as they lie in memory: gates, mask, score and
  // output cotangent
  auto load_step = [&](int t, S& xr, S& xz, S& xn, unsigned char& xm,
                       unsigned& xa, S& xd) {
    const S* gt = gp + t * gi_st;
    xr = load_raw(gt);
    xz = load_raw(gt + H);
    xn = load_raw(gt + 2 * H);
    xm = m_row[t];
    if (MODE != 0) xa = load_att_raw(att, att_bf16, a_row + t);
    if (douts != nullptr) xd = load_raw(douts + t * do_st + b * do_sb + j);
  };
  // the gate recompute of step t from the h tile hs[t & 1]
  auto gates = [&](int t) {
    if (!gates_warp) return;
    const float* hb = hs + (t & 1) * kRows * kHs + g * kHs + q;
    float main[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float corr_a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float corr_b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    // all kKSteps steps: past H the h tile and W_hh^T are zero
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      unsigned b0_hi, b0_lo, b1_hi, b1_lo;
      split_tf32(hb[8 * ks], b0_hi, b0_lo);
      split_tf32(hb[8 * ks + 4], b1_hi, b1_lo);
      mma_3xtf32(main, corr_a, corr_b, ws[w1_slot(w, ks, 0, lane)],
                 ws[w1_slot(w, ks, 1, lane)], b0_hi, b0_lo, b1_hi, b1_lo);
    }
    const int c = 16 * w + g;
    float* gq = ghs + (2 * q) * kGs + c;
    gq[0] = main[0] + (corr_a[0] + corr_b[0]);
    gq[kGs] = main[1] + (corr_a[1] + corr_b[1]);
    gq[8] = main[2] + (corr_a[2] + corr_b[2]);
    gq[kGs + 8] = main[3] + (corr_a[3] + corr_b[3]);
  };

  // pipelined inputs: cur (step t), nxt (step t - 1), nh / h2 the carries
  // of steps t - 1 and t - 2 (the h tile of step t - 1 is written during
  // step t, so its carry is loaded two steps ahead)
  S ir{}, iz{}, in{}, d{}, h{}, nr{}, nz{}, nn{}, nd{}, nh{}, h2{};
  unsigned char m = 0, nm = 0;
  unsigned a = 0, na = 0;
  if (t0 >= 0) {
    if (active) {
      load_step(t0, ir, iz, in, m, a, d);
      h = load_raw(cr + t0 * c_st);
      if (t0 >= 1) {
        load_step(t0 - 1, nr, nz, nn, nm, na, nd);
        nh = load_raw(cr + (t0 - 1) * c_st);
      }
      if (t0 >= 2) h2 = load_raw(cr + (t0 - 2) * c_st);
    }
    if (pair) hs[(t0 & 1) * kRows * kHs + lr * kHs + j] = to_f(h);
    __syncthreads();
    gates(t0);
    __syncthreads();
  }
  bool live_next = false;  // the step after this one (t + 1) was live
  float dh_direct = 0.0f;
  for (int t = t0; t >= 0; --t) {
    // dh of step t + 1: (1 - m) dh vanishes on a live step
    if (live_next) {
      const float* dp = dps + lr * kHs + j;
      const int st = kRows * kHs;
      dh = dh_direct + ((dp[0] + dp[st]) + (dp[2 * st] + dp[3 * st]));
    }
    // the elementwise backward of (row lr, unit j) at step t
    float d_r = 0.0f, d_z = 0.0f, d_n = 0.0f, d_hn = 0.0f, da = 0.0f;
    dh_direct = 0.0f;
    const bool live = active && m != 0;
    if (live) {
      // m is 1 here
      const float hf = to_f(h);
      const float* gq = ghs + lr * kGs + j;
      const float hr = gq[0] + br;
      const float hz = gq[H] + bz;
      const float hn = gq[2 * H] + bn;
      const float rg = sigmoid_f(to_f(ir) + hr);
      const float z = sigmoid_f(to_f(iz) + hz);
      const float n = tanhf(to_f(in) + rg * hn);
      const float g_new = dh + to_f(d);
      const float af = MODE != 0 ? att_f(a, att_bf16) : 0.0f;
      float dn, dz;
      if (MODE == 0) {
        dn = g_new * (1.0f - z);
        dz = g_new * (hf - n);
        dh_direct = g_new * z;
      } else {
        const float u = MODE == 2 ? af * z : af;
        dn = g_new * u;
        const float du = g_new * (n - hf);
        dh_direct = g_new * (1.0f - u);
        if (MODE == 2) {
          da = du * z;
          dz = du * af;
        } else {
          da = du;
          dz = 0.0f;
        }
      }
      d_n = dn * (1.0f - n * n);
      d_z = dz * z * (1.0f - z);
      d_r = d_n * hn * rg * (1.0f - rg);
      d_hn = d_n * rg;
    }
    live_next = live;
    if (pair) {
      float* dq = dgs + lr * kGs + j;
      dq[0] = d_r;
      dq[H] = d_z;
      dq[2 * H] = d_hn;
      if (t > 0) hs[((t - 1) & 1) * kRows * kHs + lr * kHs + j] = to_f(nh);
    }
    if (active) {
      S* dg = dgi + t * dgi_st + b * dgi_sb + j;
      store_f(dg, d_r);
      store_f(dg + H, d_z);
      store_f(dg + 2 * H, d_n);
      float* dq = dgh + (static_cast<long long>(t) * B + b) * H3 + j;
      dq[0] = d_r;
      dq[H] = d_z;
      dq[2 * H] = d_hn;
    }
    if (MODE != 0) {
      // d(att) of the row: its H units' terms summed in a fixed order
      if (H % 32 == 0) {
        float v = da;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, o);
        }
        if ((tid & 31) == 0) red[w] = v;
      } else {
        red[tid] = da;
      }
    }
    __syncthreads();  // the d_gh and h tiles and d(att) partials

    if (t > 0) {
      // dh partials of step t: d_gh @ W_hh over this warp's quarter of
      // the columns, units u0 ..
      if (dh_warp) {
        const float* db = dgs + g * kGs + q;
        float main[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float corr_a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float corr_b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // all kCSteps steps: past 3H the d_gh tile and W_hh^T are zero
#pragma unroll
        for (int cs = 0; cs < kCSteps; ++cs) {
          const int c = 8 * (c_step0 + cs);
          unsigned b0_hi, b0_lo, b1_hi, b1_lo;
          split_tf32(db[c], b0_hi, b0_lo);
          split_tf32(db[c + 4], b1_hi, b1_lo);
          mma_3xtf32(main, corr_a, corr_b, ws[w2_slot(w, cs, 0, lane)],
                     ws[w2_slot(w, cs, 1, lane)], b0_hi, b0_lo, b1_hi,
                     b1_lo);
        }
        float* dp = dps + split * kRows * kHs + (2 * q) * kHs + u0 + g;
        dp[0] = main[0] + (corr_a[0] + corr_b[0]);
        dp[kHs] = main[1] + (corr_a[1] + corr_b[1]);
        dp[8] = main[2] + (corr_a[2] + corr_b[2]);
        dp[kHs + 8] = main[3] + (corr_a[3] + corr_b[3]);
      }
      gates(t - 1);
    }
    if (MODE != 0 && active && j == 0) {
      float sum = 0.0f;
      if (H % 32 == 0) {
        const float* rq = red + ((lr * H) >> 5);
        for (int i = 0; i < (H >> 5); ++i) sum += rq[i];
      } else {
        const float* rq = red + lr * H;
        for (int i = 0; i < H; ++i) sum += rq[i];
      }
      store_att(datt, att_bf16, a_row + t, m == 0 ? 0.0f : sum);
    }
    // the next step's inputs; the carry two steps ahead
    ir = nr;
    iz = nz;
    in = nn;
    m = nm;
    a = na;
    d = nd;
    h = nh;
    nh = h2;
    if (active && t >= 2) load_step(t - 2, nr, nz, nn, nm, na, nd);
    if (active && t >= 3) h2 = load_raw(cr + (t - 3) * c_st);
    if (fetcher && t >= kPrefetch) prefetch_step(t - kPrefetch);
    __syncthreads();  // the products are complete; the tiles are read
  }
}

template <typename S, int MODE>
int launch_rows(const void* gi, long long gi_st, long long gi_sb,
                const void* carry, const float* whh_t, const float* bhh,
                const unsigned char* mask, const void* att, int att_bf16,
                const void* douts, long long do_st, long long do_sb,
                const void* dh_last, long long dhl_sb, int B, int T, int H,
                void* dgi, long long dgi_st, long long dgi_sb, float* dgh,
                void* datt, cudaStream_t stream) {
  auto kernel = gru_scan_bwd_rows_kernel<S, MODE>;
  const size_t smem = sizeof(uint4) * (kW1Slots + kW2Slots);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  kernel<<<blocks, kRowThreads, smem, stream>>>(
      static_cast<const S*>(gi), gi_st, gi_sb, static_cast<const S*>(carry),
      whh_t, bhh, mask, att, att_bf16, static_cast<const S*>(douts), do_st,
      do_sb, static_cast<const S*>(dh_last), dhl_sb, B, T, H,
      static_cast<S*>(dgi), dgi_st, dgi_sb, dgh, datt);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int MODE, bool W_SHARED>
int launch_scan(const void* gi, long long gi_st, long long gi_sb,
                const void* carry, const float* whh_t, const float* whh,
                const float* bhh, const unsigned char* mask, const void* att,
                int att_bf16, const void* douts, long long do_st,
                long long do_sb, const void* dh_last, long long dhl_sb, int B,
                int T, int H, void* dgi, long long dgi_st, long long dgi_sb,
                float* dgh, void* datt, cudaStream_t stream) {
  const int rows = rows_per_block(H);
  const size_t smem = tile_bytes(H) + (W_SHARED ? w_bytes(H) : 0);
  auto kernel = gru_scan_bwd_kernel<S, MODE, W_SHARED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + rows - 1) / rows);
  kernel<<<blocks, rows * H, smem, stream>>>(
      static_cast<const S*>(gi), gi_st, gi_sb, static_cast<const S*>(carry),
      whh_t, whh, bhh, mask, att, att_bf16, static_cast<const S*>(douts),
      do_st, do_sb, static_cast<const S*>(dh_last), dhl_sb, B, T, H,
      static_cast<S*>(dgi), dgi_st, dgi_sb, dgh, datt);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int MODE>
int dispatch_w(const void* gi, long long gi_st, long long gi_sb,
               const void* carry, const float* whh_t, const float* whh,
               const float* bhh, const unsigned char* mask, const void* att,
               int att_bf16, const void* douts, long long do_st,
               long long do_sb, const void* dh_last, long long dhl_sb, int B,
               int T, int H, void* dgi, long long dgi_st, long long dgi_sb,
               float* dgh, void* datt, cudaStream_t stream) {
  if (w_fits(H)) {
    return launch_scan<S, MODE, true>(
        gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask, att, att_bf16, douts,
        do_st, do_sb, dh_last, dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh,
        datt, stream);
  }
  return launch_scan<S, MODE, false>(
      gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask, att, att_bf16, douts,
      do_st, do_sb, dh_last, dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh, datt,
      stream);
}

// The reverse scan of the row-blocked design, for mode 0, 1 or 2.
template <typename S>
int scan_rows(int mode, const void* gi, long long gi_st, long long gi_sb,
              const void* carry, const float* whh_t, const float* bhh,
              const unsigned char* mask, const void* att, int att_bf16,
              const void* douts, long long do_st, long long do_sb,
              const void* dh_last, long long dhl_sb, int B, int T, int H,
              void* dgi, long long dgi_st, long long dgi_sb, float* dgh,
              void* datt, cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch_rows<S, 0>(gi, gi_st, gi_sb, carry, whh_t, bhh, mask,
                               att, att_bf16, douts, do_st, do_sb, dh_last,
                               dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh,
                               datt, stream);
    case 1:
      return launch_rows<S, 1>(gi, gi_st, gi_sb, carry, whh_t, bhh, mask,
                               att, att_bf16, douts, do_st, do_sb, dh_last,
                               dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh,
                               datt, stream);
    case 2:
      return launch_rows<S, 2>(gi, gi_st, gi_sb, carry, whh_t, bhh, mask,
                               att, att_bf16, douts, do_st, do_sb, dh_last,
                               dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh,
                               datt, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The reverse scan of the wide design (H > kRowMaxH), for mode 0, 1 or 2.
template <typename S>
int scan_wide(int mode, const void* gi, long long gi_st, long long gi_sb,
              const void* carry, const float* whh_t, const float* whh,
              const float* bhh, const unsigned char* mask, const void* att,
              int att_bf16, const void* douts, long long do_st,
              long long do_sb, const void* dh_last, long long dhl_sb, int B,
              int T, int H, void* dgi, long long dgi_st, long long dgi_sb,
              float* dgh, void* datt, cudaStream_t stream) {
  switch (mode) {
    case 0:
      return dispatch_w<S, 0>(gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask,
                              att, att_bf16, douts, do_st, do_sb, dh_last,
                              dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh, datt,
                              stream);
    case 1:
      return dispatch_w<S, 1>(gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask,
                              att, att_bf16, douts, do_st, do_sb, dh_last,
                              dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh, datt,
                              stream);
    case 2:
      return dispatch_w<S, 2>(gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask,
                              att, att_bf16, douts, do_st, do_sb, dh_last,
                              dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh, datt,
                              stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int reduce_dw(const float* part, long long splits, int H, float* dwhh,
              float* dbhh, cudaStream_t stream) {
  const long long n_out = static_cast<long long>(H + 1) * 3 * H;
  dw_reduce_kernel<<<static_cast<unsigned>((n_out + kReduceThreads - 1) /
                                           kReduceThreads),
                     kReduceThreads, 0, stream>>>(
      part, static_cast<int>(splits), H, dwhh, dbhh);
  return static_cast<int>(cudaGetLastError());
}

// parts: 1 the reverse scan, 2 the dW_hh product (see gru_scan_bwd).
template <typename S>
int launch_all(int parts, int mode, const void* gi, long long gi_st,
               long long gi_sb, const void* carry, const float* whh_t,
               const float* whh, const float* bhh, const unsigned char* mask,
               const void* att, int att_bf16, const void* douts,
               long long do_st, long long do_sb, const void* dh_last,
               long long dhl_sb, int B, int T, int H, void* dgi,
               long long dgi_st, long long dgi_sb, float* dwhh, float* dbhh,
               void* datt, float* scratch, cudaStream_t stream) {
  float* dgh = scratch;
  const long long n_rows = static_cast<long long>(T) * B;
  float* part = scratch + n_rows * 3 * H;
  int rc = 0;
  if (parts & 1) {
    if (H <= kRowMaxH) {
      rc = scan_rows<S>(mode, gi, gi_st, gi_sb, carry, whh_t, bhh, mask, att,
                        att_bf16, douts, do_st, do_sb, dh_last, dhl_sb, B, T,
                        H, dgi, dgi_st, dgi_sb, dgh, datt, stream);
    } else {
      rc = scan_wide<S>(mode, gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask,
                        att, att_bf16, douts, do_st, do_sb, dh_last, dhl_sb,
                        B, T, H, dgi, dgi_st, dgi_sb, dgh, datt, stream);
    }
  }
  if (rc != 0 || !(parts & 2)) return rc;
  const long long splits = dw_splits(n_rows, H);
  const long long chunk = dw_chunk(n_rows, splits, H);
  if (H <= kRowMaxH) {
    dw_rows_partial_kernel<S><<<static_cast<unsigned>(splits), kDwThreads,
                                0, stream>>>(
        static_cast<const S*>(carry), dgh, mask, B, T, n_rows, H, chunk,
        part);
  } else {
    const dim3 grid((H + kTile - 1) / kTile, (3 * H + kTile - 1) / kTile,
                    static_cast<unsigned>(splits));
    dw_partial_kernel<S><<<grid, kProductThreads, 0, stream>>>(
        static_cast<const S*>(carry), dgh, n_rows, H, chunk, part);
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return reduce_dw(part, splits, H, dwhh, dbhh, stream);
}

}  // namespace

// The float32 scratch gru_scan_bwd needs, in elements: d_gh [T, B, 3H] and
// the dW product's partials.
extern "C" long long gru_scan_bwd_scratch(int B, int T, int H) {
  const long long n_rows = static_cast<long long>(T) * B;
  return n_rows * 3 * H +
         dw_splits(n_rows, H) * static_cast<long long>(H + 1) * 3 * H;
}

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success), or -2 for H > 1024.  parts: 1 the reverse scan (dgi, d(att)
// and d_gh in the scratch), 2 the dW_hh / db_hh product from that d_gh, 3
// both (the backward); a part alone serves timing.  dtype: 0
// float32, 1 bfloat16 (gi, carry, douts, dh_last, dgi); mode: 0 gru, 1
// agru, 2 augru (att and datt, float32 or bfloat16 as att_bf16 says, are
// used only for 1 and 2).  whh_t is W_hh^T [H, 3H] and whh its transpose
// [3H, H], both float32 and contiguous, as bhh [3H]; mask is [B, T] bytes
// (0 or 1).  douts and dh_last may be null.  Strides are in elements.  The
// caller checks shapes, types and contiguity of the last dimension, and
// allocates dgi, dwhh [H, 3H], dbhh [3H], datt [B, T] (contiguous) and
// gru_scan_bwd_scratch(B, T, H) floats of scratch.
extern "C" int gru_scan_bwd(int parts, int dtype, int mode, const void* gi,
                            long long gi_st, long long gi_sb,
                            const void* carry, const float* whh_t,
                            const float* whh, const float* bhh,
                            const unsigned char* mask, const void* att,
                            int att_bf16, const void* douts, long long do_st,
                            long long do_sb, const void* dh_last,
                            long long dhl_sb, int B, int T, int H, void* dgi,
                            long long dgi_st, long long dgi_sb, float* dwhh,
                            float* dbhh, void* datt, float* scratch,
                            void* stream) {
  if (H > kMaxUnits) return kDoesNotFit;
  if (B <= 0 || T <= 0 || H <= 0 || parts < 1 || parts > 3 ||
      mode < 0 || mode > 2 ||
      (mode != 0 && (att == nullptr || datt == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_all<float>(parts, mode, gi, gi_st, gi_sb, carry, whh_t,
                             whh, bhh, mask, att, att_bf16, douts, do_st,
                             do_sb, dh_last, dhl_sb, B, T, H, dgi, dgi_st,
                             dgi_sb, dwhh, dbhh, datt, scratch, s);
  }
  if (dtype == 1) {
    return launch_all<__nv_bfloat16>(
        parts, mode, gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask, att,
        att_bf16, douts, do_st, do_sb, dh_last, dhl_sb, B, T, H, dgi, dgi_st,
        dgi_sb, dwhh, dbhh, datt, scratch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
