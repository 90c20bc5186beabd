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
// What bounds it: the serial chain of T dependent steps.  The bytes
// (the [T, B, 3H] gates read once, the [T, B, H] outputs written once)
// and the 2*B*T*H*3H multiply-adds would each take tens of microseconds
// at T=100, B=1024, H=64 at the card's peak rates (for the operations, 67
// TFLOP/s, the float32 rate outside the tensor cores); each step, though,
// needs the h of the step before, so a block does its T steps one after
// the other and the time is T times the latency of one step.
//
// What the design does about that: W_hh^T (H x 3H floats, 48 KB at H=64)
// and the block's h tile stay in shared memory for the whole scan, so a
// step reads nothing from device memory but its own gates, and those are
// loaded one step ahead, while the step before is computed.  One thread
// owns one (row, unit) pair and computes its three gate dot products from
// shared memory (h broadcast across the warp, W_hh^T rows contiguous
// across it); two barriers a step hand the new h tile to the block.  A
// tile of 8 rows at H=64 gives 512 threads and, at B=1024, 128 blocks:
// about one per SM.  Above H=138 W_hh^T does not fit in shared memory and
// is read through the cache instead (the same for every block, it stays
// in L2); a block takes H <= 1024 units.  Putting the h @ W_hh^T product
// on the tensor cores (several rows per warp with mma.sync) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;   // threads of a block of several rows
constexpr int kMaxUnits = 1024;    // the most threads a block may have
// the shared memory a block may take on Hopper
constexpr int kMaxSharedBytes = 232448;
// returned for a hidden size a block does not take
constexpr int kDoesNotFit = -2;

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
