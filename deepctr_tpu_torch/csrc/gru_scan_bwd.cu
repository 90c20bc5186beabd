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
// 1. gru_scan_bwd_kernel: each block owns a tile of batch rows (a thread a
//    (row, unit), as the forward) and walks t = T-1 .. 0.  W_hh^T stays in
//    shared memory for the whole scan, its rows padded from 3H to 3H + 1
//    floats, so that the transposed product d_gh @ W_hh^T, where thread j
//    reads row j of W_hh^T, hits 32 banks and not one (3H = 192 is 0 mod
//    32).  Above H=136 W_hh^T does not fit and is read through L2, the
//    transposed product then from a [3H, H] copy whose reads coalesce.  A
//    step's gates, carry and cotangent are loaded one step ahead.  A row
//    whose step is padded (m = 0) only passes dh on: it computes nothing
//    and writes zero dgi / d_gh rows.  The block writes d_gh [T, B, 3H] in
//    float32 to a scratch buffer.
// 2. dw_partial_kernel + dw_reduce_kernel: dW_hh = carry^T d_gh and db_hh =
//    ones^T d_gh over the B*T rows, one hand-written tiled product split
//    into fixed chunks of rows (float32 partials; eight blocks a
//    streaming multiprocessor, each loading its next stage while it
//    computes one), then summed over the chunks in order.  No atomics:
//    two launches on the same inputs give the same bits.
//
// What bounds it: as the forward, the serial chain of T dependent steps.
// A step inside a history costs the forward's gate product and the
// transposed product (2 * H * 3H multiply-adds a row, both from shared
// memory), then two barriers; the dW product is off that chain, a
// B*T x (H+1) x 3H product whose operations (at 67 TFLOP/s, the float32
// rate outside the tensor cores) and bytes (the carry and d_gh once each)
// take tens of microseconds.  Putting either product on the tensor cores
// (mma.sync in a 3xTF32 split that keeps float32 accuracy) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;   // threads of a block of several rows
constexpr int kMaxUnits = 1024;    // the most threads a block may have
// the shared memory a block may take on Hopper
constexpr int kMaxSharedBytes = 232448;
// returned for a hidden size a block does not take
constexpr int kDoesNotFit = -2;

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

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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
long long dw_splits(long long n_rows, int H) {
  const long long tiles = static_cast<long long>((H + kTile - 1) / kTile) *
                          ((3 * H + kTile - 1) / kTile);
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (n_rows + kDepth - 1) / kDepth;
  if (splits > most) splits = most;
  return splits < 1 ? 1 : splits;
}

long long dw_chunk(long long n_rows, long long splits) {
  const long long chunk = (n_rows + splits - 1) / splits;
  return (chunk + kDepth - 1) / kDepth * kDepth;
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

// dwhh [H, 3H] and dbhh [3H]: the partials summed over the chunks in order
__global__ void __launch_bounds__(kReduceThreads)
dw_reduce_kernel(const float* __restrict__ part, int splits, int H,
                 float* __restrict__ dwhh, float* __restrict__ dbhh) {
  const int H3 = 3 * H;
  const long long n_out = static_cast<long long>(H + 1) * H3;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_out) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[z * n_out + i];
  if (i < static_cast<long long>(H) * H3) {
    dwhh[i] = s;
  } else {
    dbhh[i - static_cast<long long>(H) * H3] = s;
  }
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

template <typename S>
int launch_all(int mode, const void* gi, long long gi_st, long long gi_sb,
               const void* carry, const float* whh_t, const float* whh,
               const float* bhh, const unsigned char* mask, const void* att,
               int att_bf16, const void* douts, long long do_st,
               long long do_sb, const void* dh_last, long long dhl_sb, int B,
               int T, int H, void* dgi, long long dgi_st, long long dgi_sb,
               float* dwhh, float* dbhh, void* datt, float* scratch,
               cudaStream_t stream) {
  float* dgh = scratch;
  const long long n_rows = static_cast<long long>(T) * B;
  float* part = scratch + n_rows * 3 * H;
  int rc;
  switch (mode) {
    case 0:
      rc = dispatch_w<S, 0>(gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask,
                            att, att_bf16, douts, do_st, do_sb, dh_last,
                            dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh, datt,
                            stream);
      break;
    case 1:
      rc = dispatch_w<S, 1>(gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask,
                            att, att_bf16, douts, do_st, do_sb, dh_last,
                            dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh, datt,
                            stream);
      break;
    case 2:
      rc = dispatch_w<S, 2>(gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask,
                            att, att_bf16, douts, do_st, do_sb, dh_last,
                            dhl_sb, B, T, H, dgi, dgi_st, dgi_sb, dgh, datt,
                            stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const long long splits = dw_splits(n_rows, H);
  const long long chunk = dw_chunk(n_rows, splits);
  const dim3 grid((H + kTile - 1) / kTile, (3 * H + kTile - 1) / kTile,
                  static_cast<unsigned>(splits));
  dw_partial_kernel<S><<<grid, kProductThreads, 0, stream>>>(
      static_cast<const S*>(carry), dgh, n_rows, H, chunk, part);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long n_out = static_cast<long long>(H + 1) * 3 * H;
  dw_reduce_kernel<<<static_cast<unsigned>((n_out + kReduceThreads - 1) /
                                           kReduceThreads),
                     kReduceThreads, 0, stream>>>(
      part, static_cast<int>(splits), H, dwhh, dbhh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 scratch gru_scan_bwd needs, in elements: d_gh [T, B, 3H] and
// the dW product's partials.
extern "C" long long gru_scan_bwd_scratch(int B, int T, int H) {
  const long long n_rows = static_cast<long long>(T) * B;
  return n_rows * 3 * H +
         dw_splits(n_rows, H) * static_cast<long long>(H + 1) * 3 * H;
}

// Launches the scan, the dW product and its reduction on `stream` and
// returns cudaGetLastError() (0 on success), or -2 for H > 1024.  dtype: 0
// float32, 1 bfloat16 (gi, carry, douts, dh_last, dgi); mode: 0 gru, 1
// agru, 2 augru (att and datt, float32 or bfloat16 as att_bf16 says, are
// used only for 1 and 2).  whh_t is W_hh^T [H, 3H] and whh its transpose
// [3H, H], both float32 and contiguous, as bhh [3H]; mask is [B, T] bytes
// (0 or 1).  douts and dh_last may be null.  Strides are in elements.  The
// caller checks shapes, types and contiguity of the last dimension, and
// allocates dgi, dwhh [H, 3H], dbhh [3H], datt [B, T] (contiguous) and
// gru_scan_bwd_scratch(B, T, H) floats of scratch.
extern "C" int gru_scan_bwd(int dtype, int mode, const void* gi,
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
  if (B <= 0 || T <= 0 || H <= 0 ||
      (mode != 0 && (att == nullptr || datt == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_all<float>(mode, gi, gi_st, gi_sb, carry, whh_t, whh, bhh,
                             mask, att, att_bf16, douts, do_st, do_sb,
                             dh_last, dhl_sb, B, T, H, dgi, dgi_st, dgi_sb,
                             dwhh, dbhh, datt, scratch, s);
  }
  if (dtype == 1) {
    return launch_all<__nv_bfloat16>(
        mode, gi, gi_st, gi_sb, carry, whh_t, whh, bhh, mask, att, att_bf16,
        douts, do_st, do_sb, dh_last, dhl_sb, B, T, H, dgi, dgi_st, dgi_sb,
        dwhh, dbhh, datt, scratch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
