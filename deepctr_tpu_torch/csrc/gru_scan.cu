// Masked GRU / AGRU / AUGRU recurrence over hoisted input gates, for
// Hopper (sm_90a).  The forward; its backward is csrc/gru_scan_bwd.cu.
//
//   gh = h @ W_hh^T + b_hh                        (torch gate order r|z|n)
//   r = sigmoid(i_r + h_r), z = sigmoid(i_z + h_z), n = tanh(i_n + r * h_n)
//   gru    h' = (1 - z) * n + z * h
//   agru   h' = (1 - a) * h + a * n
//   augru  u = a * z;  h' = (1 - u) * h + u * n
//   h_next = h + m * (h' - h),   out_t = m * h'          (m: 0/1 mask)
//
// for t = 0 .. T-1 and every batch row, with h_0 = 0.  The gate math and
// the carry h are float32; only `outs` and `h_last` are rounded to the
// storage type (float32 or bfloat16), as the TPU kernel does.  For
// training, the forward also writes the carries `carry[t] = h_{t-1}`
// ([T, B, H], rounded to the storage type, as `_make_fwd_kernel` writes
// them with save_carry), the one residual the backward cannot recompute;
// at inference the caller passes no carry buffer and that store is
// compiled out.
//
// What it replaces: the TPU kernel deepctr_tpu/ops/pallas_gru.py:_fwd_call
// (_make_fwd_kernel), the whole recurrence in one pallas_call whose grid
// walks time as its sequential minor axis with h in a VMEM scratch.  On
// this card blocks run in parallel and share nothing, so each block owns
// a tile of batch rows and walks t = 0 .. T-1 in a loop inside the block;
// there is no time grid and no padding of T or B to a tile.
//
// Two designs, chosen by H.
//
// H <= 64, the row-blocked design (gru_scan_rows_kernel), on DIEN's path.
// A block owns 8 batch rows.  The step's product h @ W_hh^T runs on the
// tensor cores: mma.sync m16n8k8 with TF32 operands, each split hi + lo
// and multiplied three times (hi*hi + hi*lo + lo*hi), which keeps float32
// accuracy.  A warp's tile is 16 gate columns by the block's 8 rows; each
// lane holds its W_hh^T fragments, split, in registers for the whole scan,
// so every W value it holds serves all 8 rows, and it reads the h tile as
// 16 scalar loads a step.  Then one thread a (row, unit) applies the
// gates; two barriers a step.  A step's gates are loaded a step ahead,
// kept as they lie in memory and converted only where the next step uses
// them, and the L2 is asked for them kPrefetch steps ahead.  A block walks
// t only up to the last valid step of its rows, holes in the mask
// included; the steps after it write zero outputs and unchanged carries.
// Rows are not reordered by history length: a launch lasts as long as its
// longest block, about T steps at uniform lengths whatever the order, and
// sorting would only lower the total work, which the card does not wait
// on at one block an SM.
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W; PERF.md).  The
// earlier design, one thread a (row, unit) with W_hh^T in shared memory,
// was bound by the SM's shared-memory load rate: its SASS loads one h and
// three W values for every three multiply-adds, 4,096 warp-wide loads a
// step an SM at one a clock, most of the 5,400-6,100 clocks a step took.
// Now a step takes about 2,300 clocks: the tensor pipe's rate for the 288
// m16n8k8 TF32 products a block issues (about 1,200 clocks: a build
// without the product runs that much faster, tools/gru_parts.py), then the
// gate phase's dependent chain, its loads and stores and the two barriers
// (about 1,100 clocks).  A conversion placed right after its load had made
// every warp wait out that load inside the step, hence the deferral.
//
// H > 64, the wide design (gru_scan_kernel), the earlier one: one thread owns
// one (row, unit) pair and computes its three gate dot products from
// shared memory (h broadcast across the warp, W_hh^T rows contiguous
// across it), rows_per_block(H) rows a block; above H=138 W_hh^T does not
// fit in shared memory and is read through the cache (the same for every
// block, it stays in L2); a block takes H <= 1024 units.

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
// H <= kRowMaxH (kKSteps k steps of 8)
constexpr int kRows = 8;
constexpr int kRowThreads = 512;
constexpr int kRowMaxH = 64;
constexpr int kKSteps = kRowMaxH / 8;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <bool SHARED>
__device__ __forceinline__ float load_w(const float* p) {
  if constexpr (SHARED) {
    return *p;
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ float load_att(const void* att, int bf16,
                                          long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(att)[i])
              : __ldg(static_cast<const float*>(att) + i);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

int rows_per_block(int H) {
  int rows = kMaxThreads / H;
  return rows < 1 ? 1 : rows;
}

size_t tile_bytes(int H) {
  return sizeof(float) * static_cast<size_t>(rows_per_block(H)) * H;
}

bool w_fits(int H) {
  return tile_bytes(H) + sizeof(float) * static_cast<size_t>(3) * H * H <=
         static_cast<size_t>(kMaxSharedBytes);
}

// MODE: 0 gru, 1 agru, 2 augru; W_SHARED: W_hh^T copied into shared
// memory (else read from device memory); CARRY: write carry [T, B, H].
// gi is addressed as gi[t * gi_st + b * gi_sb + c], outs as
// outs[t * out_st + b * out_sb + j]; mask is [B, T] bytes (0 or 1), att
// [B, T] float32 or bfloat16 (att_bf16), W_hh^T [H, 3H] and b_hh [3H]
// float32.
template <typename S, int MODE, bool W_SHARED, bool CARRY>
__global__ void __launch_bounds__(kMaxUnits)
gru_scan_kernel(const S* __restrict__ gi, long long gi_st, long long gi_sb,
                const float* __restrict__ whh_t,
                const float* __restrict__ bhh,
                const unsigned char* __restrict__ mask,
                const void* __restrict__ att, int att_bf16, int B, int T,
                int H, S* __restrict__ outs, long long out_st,
                long long out_sb, S* __restrict__ h_last,
                S* __restrict__ carry) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* hs = smem;                 // [rows][H]
  float* ws = smem + blockDim.x;    // [H][3H] when W_SHARED
  const int rows = blockDim.x / H;  // blockDim.x == rows * H
  const int tid = threadIdx.x;
  if (W_SHARED) {
    for (int i = tid; i < H * H3; i += blockDim.x) ws[i] = __ldg(whh_t + i);
  }
  const float* w = W_SHARED ? ws : whh_t;
  const int lr = tid / H;
  const int j = tid - lr * H;
  const long long b = static_cast<long long>(blockIdx.x) * rows + lr;
  const bool active = b < B;
  hs[tid] = 0.0f;
  float br = 0.0f, bz = 0.0f, bn = 0.0f;
  if (active) {
    br = __ldg(bhh + j);
    bz = __ldg(bhh + H + j);
    bn = __ldg(bhh + 2 * H + j);
  }
  const S* g = gi + b * gi_sb + j;
  const unsigned char* m_row = mask + b * T;
  const long long a_row = b * T;  // att is read only when MODE != 0

  // the next step's gates, mask and attention, loaded a step ahead
  float nr = 0.0f, nz = 0.0f, nn = 0.0f, nm = 0.0f, na = 0.0f;
  if (active) {
    nr = load_f(g);
    nz = load_f(g + H);
    nn = load_f(g + 2 * H);
    nm = static_cast<float>(m_row[0]);
    if (MODE != 0) na = load_att(att, att_bf16, a_row);
  }
  float h = 0.0f;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float ir = nr, iz = nz, in = nn, m = nm, a = na;
    if (CARRY && active) {
      store_f(carry + (static_cast<long long>(t) * B + b) * H + j, h);
    }
    if (active && t + 1 < T) {
      const S* gn = g + (t + 1) * gi_st;
      nr = load_f(gn);
      nz = load_f(gn + H);
      nn = load_f(gn + 2 * H);
      nm = static_cast<float>(m_row[t + 1]);
      if (MODE != 0) na = load_att(att, att_bf16, a_row + t + 1);
    }
    float hr = 0.0f, hz = 0.0f, hn = 0.0f;
    const float* hrow = hs + lr * H;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = hrow[k];
      const float* wk = w + k * H3;
      hr = fmaf(hk, load_w<W_SHARED>(wk + j), hr);
      hz = fmaf(hk, load_w<W_SHARED>(wk + H + j), hz);
      hn = fmaf(hk, load_w<W_SHARED>(wk + 2 * H + j), hn);
    }
    hr += br;
    hz += bz;
    hn += bn;
    const float r = sigmoid_f(ir + hr);
    const float z = sigmoid_f(iz + hz);
    const float n = tanhf(in + r * hn);
    float h_new;
    if (MODE == 0) {
      h_new = (1.0f - z) * n + z * h;
    } else if (MODE == 1) {
      h_new = (1.0f - a) * h + a * n;
    } else {
      const float u = a * z;
      h_new = (1.0f - u) * h + u * n;
    }
    if (active) store_f(outs + t * out_st + b * out_sb + j, m * h_new);
    h = h + m * (h_new - h);
    __syncthreads();  // every thread has read the old h tile
    hs[tid] = h;
    __syncthreads();  // the new h tile is complete
  }
  if (active) store_f(h_last + b * H + j, h);
}

// ---------------------------------------------------------------------------
// The row-blocked design (H <= kRowMaxH): the step's product on the tensor
// cores, every W_hh value held in registers for the scan and serving the
// kRows rows of its block.
// ---------------------------------------------------------------------------

// The h tile [kRows][kHs] and the gate tile [kRows][kGs].  kHs = 68 and
// kGs = 196 (4 mod 32 floats) keep the fragment loads and stores free of
// bank conflicts: lane (g, q) reads h[g][8ks + q] and writes gh[2q][c + g].
constexpr int kHs = 68;
constexpr int kGs = 196;

// A step's inputs are loaded one step ahead into registers as they lie in
// memory and converted only where the next step uses them, so that no
// warp waits on a load inside the step that issued it; the L2 is asked for
// them kPrefetch steps ahead, so that the load itself finds them there.
constexpr int kPrefetch = 8;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ float load_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load_raw(const __nv_bfloat16* p) {
  return *p;
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// One block of kRowThreads threads owns kRows batch rows.  Two roles:
//  - the product: warp w < ceil(3H / 16) computes the 16 gate columns c =
//    16w .. 16w + 15 of gh = h @ W_hh^T for the block's 8 rows as one
//    m16n8 tile (rows of the tile: columns of W_hh^T; its 8 columns: the
//    batch rows), k in steps of 8.  Each lane holds its fragments of
//    W_hh^T's 16 columns, split hi + lo in TF32, in registers for the
//    scan; the h tile is split the same way each step.  hi*hi, hi*lo and
//    lo*hi (3xTF32) keep float32 accuracy: the dropped lo*lo term is
//    below 2^-22 of each product.  The lanes store their tile to the gate
//    tile;
//  - the gates: thread (lr = tid / H, j = tid % H), tid < 8H, applies the
//    nonlinearity of its (row, unit), writes outs (and the carry) and
//    puts its new h into the h tile.
// Two barriers a step.  The block walks t only up to its rows' last
// valid step t_end - 1 (found from the mask, holes allowed); past it
// every row keeps h, so the steps t_end .. T-1 only write zero outputs
// (and the unchanged carries).
template <typename S, int MODE, bool CARRY>
__global__ void __launch_bounds__(kRowThreads, 1)
gru_scan_rows_kernel(const S* __restrict__ gi, long long gi_st,
                     long long gi_sb, const float* __restrict__ whh_t,
                     const float* __restrict__ bhh,
                     const unsigned char* __restrict__ mask,
                     const void* __restrict__ att, int att_bf16, int B,
                     int T, int H, S* __restrict__ outs, long long out_st,
                     long long out_sb, S* __restrict__ h_last,
                     S* __restrict__ carry) {
  __shared__ __align__(16) float hs[kRows * kHs];
  __shared__ __align__(16) float ghs[kRows * kGs];
  __shared__ int t_end_s;
  const int H3 = 3 * H;
  const int tid = threadIdx.x;

  // the product role: warp w's 16 columns, kKSteps k steps of 8 (zero
  // past H)
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int q = tid & 3;
  const bool product_warp = 16 * w < H3;
  unsigned a_hi[kKSteps][4], a_lo[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * ks + q + (i >= 2 ? 4 : 0);
      const int c = 16 * w + g + (i & 1 ? 8 : 0);
      const float v =
          (product_warp && k < H && c < H3) ? __ldg(whh_t + k * H3 + c) : 0.0f;
      split_tf32(v, a_hi[ks][i], a_lo[ks][i]);
    }
  }

  // the gate role
  const int lr = tid / H;
  const int j = tid - lr * H;
  const long long b = static_cast<long long>(blockIdx.x) * kRows + lr;
  const bool active = tid < kRows * H && b < B;
  for (int i = tid; i < kRows * kHs; i += kRowThreads) hs[i] = 0.0f;
  if (tid == 0) t_end_s = 0;
  float br = 0.0f, bz = 0.0f, bn = 0.0f;
  if (active) {
    br = __ldg(bhh + j);
    bz = __ldg(bhh + H + j);
    bn = __ldg(bhh + 2 * H + j);
  }
  const S* gp = gi + b * gi_sb + j;
  const unsigned char* m_row = mask + b * T;
  const long long a_row = b * T;  // att is read only when MODE != 0
  __syncthreads();
  // t_end: one past the last valid step of the block's rows
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
  if (last >= 0) atomicMax(&t_end_s, last + 1);
  // two lanes a warp ask the L2 for the first steps' gates (their rows'
  // segments of gi start and end in their lines)
  const bool fetcher = active && ((tid & 31) == 0 || (tid & 31) == 31);
  if (fetcher) {
    for (int t = 0; t < kPrefetch && t < T; ++t) {
      const S* gt = gp + t * gi_st;
      prefetch_l2(gt);
      prefetch_l2(gt + H);
      prefetch_l2(gt + 2 * H);
    }
  }

  // the first step's gates, mask and attention
  S nr{}, nz{}, nn{};
  unsigned char nm = 0;
  unsigned na = 0;
  if (active) {
    nr = load_raw(gp);
    nz = load_raw(gp + H);
    nn = load_raw(gp + 2 * H);
    nm = m_row[0];
    if (MODE != 0) na = load_att_raw(att, att_bf16, a_row);
  }
  float h = 0.0f;
  __syncthreads();
  const int t_end = t_end_s;
  for (int t = 0; t < t_end; ++t) {
    const S ir = nr, iz = nz, in = nn;
    const unsigned char m8 = nm;
    const unsigned a_raw = na;
    if (CARRY && active) {
      store_f(carry + (static_cast<long long>(t) * B + b) * H + j, h);
    }
    // the next step's inputs, loaded while this step computes
    if (active && t + 1 < t_end) {
      const S* gn = gp + (t + 1) * gi_st;
      nr = load_raw(gn);
      nz = load_raw(gn + H);
      nn = load_raw(gn + 2 * H);
      nm = m_row[t + 1];
      if (MODE != 0) na = load_att_raw(att, att_bf16, a_row + t + 1);
      if (fetcher && t + kPrefetch < t_end) {
        const S* gt = gp + (t + kPrefetch) * gi_st;
        prefetch_l2(gt);
        prefetch_l2(gt + H);
        prefetch_l2(gt + 2 * H);
      }
    }
    if (product_warp) {
      // hi*hi, hi*lo and lo*hi summed apart, each over the even and the
      // odd k steps: six chains of four; the small sums are added first.
      // All kKSteps steps run: past H the h tile and W_hh^T are zero.
      float acc[6][4];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      }
      const float* hrow = hs + g * kHs + q;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        unsigned b0_hi, b0_lo, b1_hi, b1_lo;
        split_tf32(hrow[8 * ks], b0_hi, b0_lo);
        split_tf32(hrow[8 * ks + 4], b1_hi, b1_lo);
        mma_tf32(acc[ks & 1], a_hi[ks], b0_hi, b1_hi);
        mma_tf32(acc[2 + (ks & 1)], a_hi[ks], b0_lo, b1_lo);
        mma_tf32(acc[4 + (ks & 1)], a_lo[ks], b0_hi, b1_hi);
      }
      float* gq = ghs + (2 * q) * kGs + 16 * w + g;
      const int at[4] = {0, kGs, 8, kGs + 8};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gq[at[e]] = (acc[0][e] + acc[1][e]) +
                    ((acc[2][e] + acc[3][e]) + (acc[4][e] + acc[5][e]));
      }
    }
    __syncthreads();  // the gate tile is complete; the h tile is read
    if (tid < kRows * H) {
      const float m = static_cast<float>(m8);
      const float a = MODE != 0 ? att_f(a_raw, att_bf16) : 0.0f;
      const float* gq = ghs + lr * kGs + j;
      const float hr = gq[0] + br;
      const float hz = gq[H] + bz;
      const float hn = gq[2 * H] + bn;
      const float r = sigmoid_f(to_f(ir) + hr);
      const float z = sigmoid_f(to_f(iz) + hz);
      const float n = tanhf(to_f(in) + r * hn);
      float h_new;
      if (MODE == 0) {
        h_new = (1.0f - z) * n + z * h;
      } else if (MODE == 1) {
        h_new = (1.0f - a) * h + a * n;
      } else {
        const float u = a * z;
        h_new = (1.0f - u) * h + u * n;
      }
      if (active) store_f(outs + t * out_st + b * out_sb + j, m * h_new);
      h = h + m * (h_new - h);
      hs[lr * kHs + j] = h;
    }
    __syncthreads();  // the new h tile is complete
  }
  if (active) {
    // past every row's last valid step: zero outputs, unchanged carries
    for (int t = t_end; t < T; ++t) {
      store_f(outs + t * out_st + b * out_sb + j, 0.0f);
      if (CARRY) {
        store_f(carry + (static_cast<long long>(t) * B + b) * H + j, h);
      }
    }
    store_f(h_last + b * H + j, h);
  }
}

template <typename S, int MODE, bool CARRY>
int launch_rows(const void* gi, long long gi_st, long long gi_sb,
                const float* whh_t, const float* bhh,
                const unsigned char* mask, const void* att, int att_bf16,
                int B, int T, int H, void* outs, long long out_st,
                long long out_sb, void* h_last, void* carry,
                cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  gru_scan_rows_kernel<S, MODE, CARRY><<<blocks, kRowThreads, 0, stream>>>(
      static_cast<const S*>(gi), gi_st, gi_sb, whh_t, bhh, mask, att,
      att_bf16, B, T, H, static_cast<S*>(outs), out_st, out_sb,
      static_cast<S*>(h_last), static_cast<S*>(carry));
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int MODE, bool W_SHARED, bool CARRY>
int launch(const void* gi, long long gi_st, long long gi_sb,
           const float* whh_t, const float* bhh, const unsigned char* mask,
           const void* att, int att_bf16, int B, int T, int H, void* outs,
           long long out_st, long long out_sb, void* h_last, void* carry,
           cudaStream_t stream) {
  const int rows = rows_per_block(H);
  const size_t smem =
      tile_bytes(H) + (W_SHARED ? sizeof(float) * 3 * H * H : 0);
  auto kernel = gru_scan_kernel<S, MODE, W_SHARED, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + rows - 1) / rows);
  kernel<<<blocks, rows * H, smem, stream>>>(
      static_cast<const S*>(gi), gi_st, gi_sb, whh_t, bhh, mask, att,
      att_bf16, B, T, H, static_cast<S*>(outs), out_st, out_sb,
      static_cast<S*>(h_last), static_cast<S*>(carry));
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int MODE, bool CARRY>
int dispatch_w(const void* gi, long long gi_st, long long gi_sb,
               const float* whh_t, const float* bhh,
               const unsigned char* mask, const void* att, int att_bf16,
               int B, int T, int H, void* outs, long long out_st,
               long long out_sb, void* h_last, void* carry,
               cudaStream_t stream) {
  if (H <= kRowMaxH) {
    return launch_rows<S, MODE, CARRY>(gi, gi_st, gi_sb, whh_t, bhh, mask,
                                       att, att_bf16, B, T, H, outs, out_st,
                                       out_sb, h_last, carry, stream);
  }
  if (w_fits(H)) {
    return launch<S, MODE, true, CARRY>(gi, gi_st, gi_sb, whh_t, bhh, mask,
                                        att, att_bf16, B, T, H, outs, out_st,
                                        out_sb, h_last, carry, stream);
  }
  return launch<S, MODE, false, CARRY>(gi, gi_st, gi_sb, whh_t, bhh, mask,
                                       att, att_bf16, B, T, H, outs, out_st,
                                       out_sb, h_last, carry, stream);
}

template <typename S, int MODE>
int dispatch_carry(const void* gi, long long gi_st, long long gi_sb,
                   const float* whh_t, const float* bhh,
                   const unsigned char* mask, const void* att, int att_bf16,
                   int B, int T, int H, void* outs, long long out_st,
                   long long out_sb, void* h_last, void* carry,
                   cudaStream_t stream) {
  if (carry != nullptr) {
    return dispatch_w<S, MODE, true>(gi, gi_st, gi_sb, whh_t, bhh, mask, att,
                                     att_bf16, B, T, H, outs, out_st, out_sb,
                                     h_last, carry, stream);
  }
  return dispatch_w<S, MODE, false>(gi, gi_st, gi_sb, whh_t, bhh, mask, att,
                                    att_bf16, B, T, H, outs, out_st, out_sb,
                                    h_last, carry, stream);
}

template <typename S>
int dispatch_mode(int mode, const void* gi, long long gi_st, long long gi_sb,
                  const float* whh_t, const float* bhh,
                  const unsigned char* mask, const void* att, int att_bf16,
                  int B, int T, int H, void* outs, long long out_st,
                  long long out_sb, void* h_last, void* carry,
                  cudaStream_t stream) {
  switch (mode) {
    case 0:
      return dispatch_carry<S, 0>(gi, gi_st, gi_sb, whh_t, bhh, mask, att,
                                  att_bf16, B, T, H, outs, out_st, out_sb,
                                  h_last, carry, stream);
    case 1:
      return dispatch_carry<S, 1>(gi, gi_st, gi_sb, whh_t, bhh, mask, att,
                                  att_bf16, B, T, H, outs, out_st, out_sb,
                                  h_last, carry, stream);
    case 2:
      return dispatch_carry<S, 2>(gi, gi_st, gi_sb, whh_t, bhh, mask, att,
                                  att_bf16, B, T, H, outs, out_st, out_sb,
                                  h_last, carry, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// -2 for H > 1024.  dtype: 0 float32, 1 bfloat16 (gi, outs, h_last,
// carry); mode: 0 gru, 1 agru, 2 augru (att, float32 or bfloat16 as
// att_bf16 says, is read only for 1 and 2).  mask is [B, T] bytes (0 or
// 1).  Strides are in elements.  The caller checks shapes, types and
// contiguity of the last dimension, and allocates outs, h_last [B, H]
// (contiguous) and, for training, carry [T, B, H] (contiguous; null at
// inference).
extern "C" int gru_scan_fwd(int dtype, int mode, const void* gi,
                            long long gi_st, long long gi_sb,
                            const float* whh_t, const float* bhh,
                            const unsigned char* mask, const void* att,
                            int att_bf16, int B, int T, int H, void* outs,
                            long long out_st, long long out_sb, void* h_last,
                            void* carry, void* stream) {
  if (H > kMaxUnits) return kDoesNotFit;
  if (B <= 0 || T <= 0 || H <= 0 || (mode != 0 && att == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_mode<float>(mode, gi, gi_st, gi_sb, whh_t, bhh, mask, att,
                                att_bf16, B, T, H, outs, out_st, out_sb,
                                h_last, carry, s);
  }
  if (dtype == 1) {
    return dispatch_mode<__nv_bfloat16>(mode, gi, gi_st, gi_sb, whh_t, bhh,
                                        mask, att, att_bf16, B, T, H, outs,
                                        out_st, out_sb, h_last, carry, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
