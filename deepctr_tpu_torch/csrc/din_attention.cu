// Fused DIN attention pooling over a behaviour history, for Hopper
// (sm_90a).  Inference only.  For every sample b:
//
//   x_t   = [q, k_t, q - k_t, q * k_t]                    (4E floats)
//   s_t   = MLP(x_t): hidden layers act(x W_i + b_i), then x W_o + b_o
//   s_t   = s_t * m_t + (1 - m_t) * (-2^32 + 1); s = softmax_t(s)
//                                           (weight normalisation on)
//   s_t   = s_t * m_t                       (weight normalisation off)
//   out   = sum_t s_t * k_t                                [E]
//
// act is sigmoid, relu or linear; the MLP, the softmax and the sum run in
// float32 whatever the storage type of the query and keys (float32 or
// bfloat16), and only `out` is rounded to the keys' type.  The mask is 0/1.
//
// The first layer comes folded (ops/attention.py:pack_params).  With its
// weight W_0 = [A; B; C; D] by quarters of E rows,
//
//   x_t W_0 = q (A + C) + k_t (B - C + diag(q) D) = c0 + k_t B_s,
//
// so the query's part c0 is computed once a sample, and a time step costs
// E x n1 multiply-adds of the first layer instead of 4E x n1.
//
// What it replaces: the TPU kernel deepctr_tpu/ops/pallas_attention.py:
// din_attention_fused (_kernel), one grid step a sample, which keeps the
// [B, T, 4E] MLP input and the [B, T, H] activations out of device memory.
//
// What the function needs: per sample, c0 and the fold B_s (2 E n1
// multiply-adds); per step inside the history, E n1 for the first layer,
// the later layers (64 x 16 + 16 at the bench's 64-16 attention) and E for
// the weighted sum; a step past the history needs no MLP (its score is
// the mask constant, or 0).
//
// Two designs, chosen by shape (din_attention_route).
//
// The tensor-core design (din_attention_mma_kernel), for every shape whose
// weights and a window of key rows fit in a block's shared memory and
// whose hidden layers are at most 128 wide (the bench's E=64, 64-16;
// E=13, 36-10; E=256, 32-8 in smaller windows; not E=512, 80-40, whose
// B_s alone is 320 KB), in two instances: up to 8 n tiles (hidden widths
// up to 64) and up to 16 (up to 128; DIN's default 80-40 at E=64).  A
// block of 4 warps walks samples b = blockIdx.x,
// blockIdx.x + gridDim.x, ..., with a grid of as many blocks as the SMs
// hold at once (2 at the bench's shape: 255 registers a thread and 110 KB
// of shared memory a block), so that one block's per-sample work runs
// while the other's products do.
//  - Once a block, from ops/attention.py:pack_params's buffer, with
//    cp.async (4-byte copies straight to each value's fragment slot, all
//    in flight at once): the first layer's W_q, its W_k and W_qk in
//    mma.sync's B-fragment order, and the later layers' weights in that
//    order, then split hi + lo in TF32 in place; the later biases and the
//    output weight, zero-padded.  They serve every sample.
//  - Once a sample, c0 = q W_q + b_0 and B_s = W_k + diag(q) W_qk ([E,
//    n1], E padded to 16 and n1 to 8 with zeros) are formed in shared
//    memory from there, B_s split hi + lo in fragment order (a thread
//    forms four values from two 16-byte loads).  The query and the first
//    window of the mask are loaded while the sample before runs its
//    tiles, and that window's key rows are asked of the L2.
//  - The sample's valid steps are compacted a window of up to 128 steps
//    at a time (a ballot a warp; any mask, holes included); the thread
//    that found a valid step copies its key row into the window's stage
//    in shared memory with cp.async while c0 and B_s are formed.  The
//    staged rows form 16-row M tiles, a tile a warp.  Layer 0 of a tile
//    is c0 + k_t B_s on mma.sync m16n8k8 TF32 with float32 accumulators:
//    bfloat16 keys are exact in TF32, so k B_hi + k B_lo (two products);
//    float32 keys are split too, so k_hi B_hi + k_hi B_lo + k_lo B_hi
//    (3xTF32).  A lane reads its A fragments from the stage four
//    consecutive values a load: the k order inside each 16-column slab is
//    permuted to match, in A and B_s alike.  The stage's rows are padded
//    so that the 8 rows of a fragment load fall in distinct banks.
//  - The activation is applied in registers, and the accumulators of a
//    layer are the A fragments of the next (each 8-column k step takes
//    the permutation that puts a lane's columns 2q, 2q + 1 at q, q + 4):
//    the hidden layers never leave registers.  They run in 3xTF32.  The
//    small products sum apart from hi * hi (at hidden widths up to 64),
//    so that a warp has more independent mma.sync chains in flight.
//    Where a layer's tile counts are the bench's (the 8-tile instance;
//    layer 0: 8 tiles; the next: 8 in, 2 out) the compiler knows them,
//    and no guard splits a layer's products.
//  - The output layer (n_last -> 1) is a dot product reduced over the
//    four lanes of a row with shuffles.  Each warp keeps its own online
//    softmax (running maximum and sum, its key sum rescaled when the
//    maximum rises) and adds its tiles' weighted keys, a lane two columns
//    in 64; the warps' states are merged when the sample ends.  An empty
//    history under the softmax reads the mean of its T keys, staged a
//    window at a time.
// Padded rows, columns and k steps multiply zeros; a tile's rows past the
// window's valid steps hold stale values, which stay in their own rows of
// the products and get no weight.  Dropping the lo*lo term leaves each
// product within about 2^-21 of float32's.
//
// The FMA design (din_attention_fma_kernel), for the other shapes: one
// block a sample.  The block walks T in windows of 32 steps; one warp
// compacts the window's valid steps (a ballot of the mask), their keys
// are copied into shared memory in rows of up to 32, and the MLP runs
// over those rows with the activations in shared memory, on float32
// FMAs; each thread computes 4 rows of one output unit of the first
// layer.  The rows' scores fold into the same online softmax.  The
// weights are read through the L1 cache, so the shared memory a block
// needs does not grow with them: at E <= 512, 32 rows in work fit for
// hidden widths up to about 600, and the launch takes fewer rows a pass
// for wider layers (one row fits up to about 28,000).
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W, bf16 keys,
// relu, B=1024, T=100, E=64, 64-16; PERF.md).  The FMA design issued
// about 7 load instructions for every 4 multiply-adds of layer 0 (its
// SASS: 441 LDS and 255 LDG against 371 FFMA) and took 0.1447 ms at
// uniform lengths, 0.0246 at lengths 0 and 0.1996 at lengths 100: the
// load issue, not the arithmetic (8 us at the float32 rate).  The
// tensor-core design takes about 0.057 ms at uniform lengths, and
// tools/attention_parts.py splits it: about half a sample's fixed work
// (the query and mask loads, c0 and the fold, the barriers, the merge:
// 0.027 ms at every length 0 without the softmax, the block's weight
// copy about 0.002 of it) and half its tiles; of the tiles, the
// weighted keys and the later layer take about a quarter each.  With
// two blocks of 4 warps an SM, latency (of mma.sync chains, shared-memory
// loads and barriers) and not the tensor pipe's rate bounds it: its TF32
// products at 2-3 a multiply-add take about 0.003 ms at the card's TF32
// rate.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {


constexpr int kThreads = 256;  // the FMA design's block
constexpr int kWindow = 32;    // time steps one warp's ballot compacts
constexpr int kRows = 4;       // time steps a thread computes in layer 0
// partial sums a dot product keeps (the terms k, k + kParts, ... in each),
// which shortens its chain of float32 roundings; added pairwise at the end
constexpr int kParts = 4;
constexpr int kMaxLayers = 8;  // hidden layers + the output layer
// the shared memory a block may take on Hopper, less this kernel's static
// arrays
constexpr int kMaxSharedBytes = 232448 - 256;
// returned when even one row of work does not fit in shared memory
constexpr int kDoesNotFit = -2;

struct Layout {
  int n_layers;                // hidden layers + 1
  int n[kMaxLayers + 1];       // widths: n[0] = 4E, n[n_layers] = 1
  int w[kMaxLayers];           // offset of layer i's weight
  int b[kMaxLayers];           // offset of layer i's bias
  int max_hidden;              // widest hidden layer
};

// The packed buffer: W_q = A + C, W_k = B - C, W_qk = D (each [E, n1]),
// b_0 [n1], then every later layer's [n_i, n_i+1] weight and its bias.
bool make_layout(int n_layers, const int* widths, int E, Layout* lay) {
  if (n_layers < 2 || n_layers > kMaxLayers) return false;
  lay->n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] <= 0) return false;
    lay->n[i] = widths[i];
  }
  if (lay->n[0] != 4 * E || lay->n[n_layers] != 1) return false;
  int off = 3 * E * lay->n[1], widest = 0;
  lay->w[0] = 0;
  lay->b[0] = off;
  off += lay->n[1];
  for (int i = 1; i < n_layers; ++i) {
    lay->w[i] = off;
    off += lay->n[i] * lay->n[i + 1];
    lay->b[i] = off;
    off += lay->n[i + 1];
  }
  for (int i = 1; i < n_layers; ++i) {
    if (lay->n[i] > widest) widest = lay->n[i];
  }
  lay->max_hidden = widest;
  return true;
}

size_t shared_bytes(const Layout& lay, int E, int rows) {
  return sizeof(float) *
         (2 * static_cast<size_t>(E) + lay.n[1] +
          static_cast<size_t>(rows) * (E + 2 * lay.max_hidden + 2));
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sum_parts(const float (&a)[kParts]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// sum_k x[k * sx] * w[k * sw] over k < n (x in shared memory, w read
// through the cache), in kParts partial sums
__device__ __forceinline__ float dot_parts(const float* x, int sx,
                                           const float* w, int sw, int n) {
  float a[kParts] = {};
  int k = 0;
  for (; k + kParts <= n; k += kParts) {
#pragma unroll
    for (int u = 0; u < kParts; ++u) {
      a[u] = fmaf(x[(k + u) * sx], __ldg(w + (k + u) * sw), a[u]);
    }
  }
  for (; k < n; ++k) a[0] = fmaf(x[k * sx], __ldg(w + k * sw), a[0]);
  return sum_parts(a);
}

template <int ACT>
__device__ __forceinline__ float act_f(float x) {
  if (ACT == 0) return 1.0f / (1.0f + expf(-x));
  if (ACT == 1) return x > 0.0f ? x : 0.0f;
  return x;
}

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

template <typename S, int ACT>
__global__ void __launch_bounds__(kThreads)
din_attention_fma_kernel(const void* __restrict__ q, int q_bf16,
                     const S* __restrict__ keys, long long k_sb,
                     long long k_st, const unsigned char* __restrict__ mask,
                     const float* __restrict__ prm, Layout lay, int T, int E,
                     int chunk, int wnorm, S* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int vi[kWindow];  // the window's valid steps
  __shared__ int nv_s;         // how many
  const int n1 = lay.n[1];
  float* qs = smem;                          // [E] the query
  float* acc = qs + E;                       // [E] the running sum
  float* c0 = acc + E;                       // [n1] query part of layer 0
  float* kc = c0 + n1;                       // [chunk, E] keys in work
  float* buf0 = kc + chunk * E;              // [chunk, max_hidden]
  float* buf1 = buf0 + chunk * lay.max_hidden;
  float* sc = buf1 + chunk * lay.max_hidden;  // [chunk] scores
  float* pc = sc + chunk;                    // [chunk] their weights
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const S* kb = keys + b * k_sb;
  const unsigned char* mb = mask + b * T;

  for (int i = tid; i < E; i += kThreads) {
    qs[i] = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[b * E + i])
                   : static_cast<const float*>(q)[b * E + i];
    acc[i] = 0.0f;
  }
  __syncthreads();
  const float* wq = prm + lay.w[0];
  const float* wk = wq + E * n1;
  const float* wqk = wk + E * n1;
  const float* b0 = prm + lay.b[0];
  for (int o = tid; o < n1; o += kThreads) {
    c0[o] = __ldg(b0 + o) + dot_parts(qs, 1, wq + o, n1, E);
  }

  // the online softmax's running maximum and sum, the same in every thread
  float run_max = minus_inf(), run_sum = 0.0f;
  int valid = 0;
  const int last = lay.n_layers - 1;
  for (int t0 = 0; t0 < T; t0 += kWindow) {
    if (tid < 32) {
      const int t = t0 + lane;
      const bool on = t < T && mb[t] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) vi[__popc(bal & ((1u << lane) - 1u))] = t;
      if (lane == 0) nv_s = __popc(bal);
    }
    __syncthreads();  // also publishes c0 before the first rows
    const int nv = nv_s;
    valid += nv;
    for (int r0 = 0; r0 < nv; r0 += chunk) {
      const int rows = min(chunk, nv - r0);
      for (int i = tid; i < rows * E; i += kThreads) {
        const int r = i / E, e = i - r * E;
        kc[i] = load_f(kb + static_cast<long long>(vi[r0 + r]) * k_st + e);
      }
      __syncthreads();
      // layer 0: c0 + k_t (W_k + diag(q) W_qk)
      const int groups = (rows + kRows - 1) / kRows;
      for (int idx = tid; idx < groups * n1; idx += kThreads) {
        const int g = idx / n1, o = idx - g * n1;
        float a[kRows][kParts] = {};
        const float* krow[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          krow[r] = kc + min(g * kRows + r, rows - 1) * E;
        }
        int e = 0;
        for (; e + kParts <= E; e += kParts) {
#pragma unroll
          for (int u = 0; u < kParts; ++u) {
            const float w = fmaf(qs[e + u], __ldg(wqk + (e + u) * n1 + o),
                                 __ldg(wk + (e + u) * n1 + o));
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              a[r][u] = fmaf(krow[r][e + u], w, a[r][u]);
            }
          }
        }
        for (; e < E; ++e) {
          const float w = fmaf(qs[e], __ldg(wqk + e * n1 + o),
                               __ldg(wk + e * n1 + o));
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            a[r][0] = fmaf(krow[r][e], w, a[r][0]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = g * kRows + r;
          if (row < rows) {
            buf0[row * n1 + o] = act_f<ACT>(c0[o] + sum_parts(a[r]));
          }
        }
      }
      __syncthreads();
      // the other hidden layers, ping-ponging between buf0 and buf1
      float* in = buf0;
      float* nxt = buf1;
      for (int l = 1; l < last; ++l) {
        const int ni = lay.n[l], no = lay.n[l + 1];
        const float* wl = prm + lay.w[l];
        const float* bl = prm + lay.b[l];
        for (int idx = tid; idx < rows * no; idx += kThreads) {
          const int r = idx / no, o = idx - r * no;
          nxt[r * no + o] = act_f<ACT>(
              __ldg(bl + o) + dot_parts(in + r * ni, 1, wl + o, no, ni));
        }
        __syncthreads();
        float* tmp = in;
        in = nxt;
        nxt = tmp;
      }
      // the output layer: one score a row
      const int nl = lay.n[last];
      const float* wo = prm + lay.w[last];
      for (int r = tid; r < rows; r += kThreads) {
        sc[r] = __ldg(prm + lay.b[last]) +
                dot_parts(in + r * nl, 1, wo, 1, nl);
      }
      __syncthreads();
      // fold the rows into the weighted sum
      if (wnorm) {
        float mx = run_max;
        for (int r = 0; r < rows; ++r) mx = fmaxf(mx, sc[r]);
        const float scale = expf(run_max - mx);  // 0 for the first rows
        if (tid < rows) pc[tid] = expf(sc[tid] - mx);
        __syncthreads();
        float s = 0.0f;
        for (int r = 0; r < rows; ++r) s += pc[r];
        run_sum = run_sum * scale + s;
        run_max = mx;
        for (int e = tid; e < E; e += kThreads) {
          float v = acc[e] * scale;
          for (int r = 0; r < rows; ++r) v = fmaf(pc[r], kc[r * E + e], v);
          acc[e] = v;
        }
      } else {
        for (int e = tid; e < E; e += kThreads) {
          float v = acc[e];
          for (int r = 0; r < rows; ++r) v = fmaf(sc[r], kc[r * E + e], v);
          acc[e] = v;
        }
      }
      __syncthreads();  // kc, sc and pc take the next rows
    }
    __syncthreads();  // every thread has read nv_s and vi
  }

  // A step past the history scores -2^32 + 1 under the softmax, and its
  // weight exp(-2^32 + 1 - max) is exactly 0 beside any valid step's.  With
  // no valid step every score is that constant and the softmax is uniform.
  if (wnorm && valid == 0) {
    for (int e = tid; e < E; e += kThreads) {
      float v = 0.0f;
      for (int t = 0; t < T; ++t) v += load_f(kb + t * k_st + e);
      store_f(out + b * E + e, v / static_cast<float>(T));
    }
  } else {
    for (int e = tid; e < E; e += kThreads) {
      store_f(out + b * E + e, wnorm ? acc[e] / run_sum : acc[e]);
    }
  }
}

template <typename S, int ACT>
int launch_fma(const void* q, int q_bf16, const void* keys, long long k_sb,
           long long k_st, const unsigned char* mask, const float* params,
           const Layout& lay, int B, int T, int E, int chunk, int wnorm,
           void* out, cudaStream_t stream) {
  const size_t smem = shared_bytes(lay, E, chunk);
  auto kernel = din_attention_fma_kernel<S, ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, stream>>>(
      q, q_bf16, static_cast<const S*>(keys), k_sb, k_st, mask, params, lay,
      T, E, chunk, wnorm, static_cast<S*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int dispatch_fma(int act, const void* q, int q_bf16, const void* keys,
                 long long k_sb, long long k_st, const unsigned char* mask,
                 const float* params, const Layout& lay, int B, int T, int E,
                 int chunk, int wnorm, void* out, cudaStream_t stream) {
  switch (act) {
    case 0:
      return launch_fma<S, 0>(q, q_bf16, keys, k_sb, k_st, mask, params, lay, B,
                          T, E, chunk, wnorm, out, stream);
    case 1:
      return launch_fma<S, 1>(q, q_bf16, keys, k_sb, k_st, mask, params, lay, B,
                          T, E, chunk, wnorm, out, stream);
    case 2:
      return launch_fma<S, 2>(q, q_bf16, keys, k_sb, k_st, mask, params, lay, B,
                          T, E, chunk, wnorm, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// the tensor-core design
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxWindow = 32 * kMmaWarps;  // steps one compaction covers
constexpr int kMaxChunks = 8;  // a lane's columns of the key sum: 2 in 64
constexpr int kQPer = 4;       // query values a thread prefetches (E <= 512)
// the shared memory a block may take for two to share an SM (228 KB less
// 1 KB reserved for each block, halved), less this design's static arrays
constexpr int kTwoBlockBytes = (233472 - 2 * 1024) / 2 - 256;
constexpr unsigned kFull = 0xffffffffu;

struct MmaLayout {
  int ep;                 // E rounded up to 16
  int np[kMaxLayers];     // hidden widths rounded up to 8
  int frag[kMaxLayers];   // offset of layer l >= 1's fragments in wl
  int weight[kMaxLayers]; // offset of hidden layer l's weight in params
  int wl_floats;          // floats of the later layers' fragments
  int wq_floats;          // floats of W_q's copy (E n1, rounded up to 4)
  int n_hidden;           // hidden layers
  int n1, n_last;         // the first and the last hidden width
  int w_out, b_out;       // offsets of the output layer's weight and bias
  int bias[kMaxLayers];   // offset of hidden layer l's bias
  int width[kMaxLayers];  // hidden layer l's width
  int hb[kMaxLayers];     // offset of layer l >= 1's padded bias in hbs
  int hb_out;             // offset of the padded output weight in hbs
  int hb_floats;          // floats of hbs
  int c0_parts;           // threads that sum one output of q W_q
  int nt;                 // 8 or 16: the instance's most n tiles
  int win;                // steps a window compacts (32, 64 or 128)
  int kstride;            // bytes between staged key rows
  size_t smem;            // dynamic shared bytes
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t mma_shared_bytes(const MmaLayout& ml) {
  return sizeof(float) * (static_cast<size_t>(4) * ml.ep * ml.np[0] +
                          ml.wl_floats + ml.wq_floats + ml.np[0] + ml.ep +
                          kMmaWarps * ml.ep + 2 * kMmaWarps + ml.hb_floats) +
         static_cast<size_t>(ml.win) * ml.kstride +
         sizeof(int) * (ml.win + kMmaWarps);
}

// The weights in shared memory, in mma.sync's B-fragment order: W_k then
// W_qk, each [ep / 16][np[0] / 8][32 lanes][4] with lane (g, q)'s four
// values the rows 16 j + 4 q .. + 3 of column 8 nt + g; then every later
// hidden layer l (wl) as [np[l-1] / 8][np[l] / 8][32][4], lane (g, q)'s
// four values hi(W[8 ks + 2 q][8 nt + g]), hi(W[8 ks + 2 q + 1][..]) and
// their lo.
// Keys of `size` bytes are staged a window at a time, in rows padded so
// that the 8 rows of a fragment load fall in distinct banks.
bool make_mma_layout(const Layout& lay, int E, int size, MmaLayout* ml) {
  const int hidden = lay.n_layers - 1;
  ml->ep = round_up(E, 16);
  int widest = 0;
  for (int l = 0; l < hidden; ++l) {
    ml->np[l] = round_up(lay.n[l + 1], 8);
    if (ml->np[l] > widest) widest = ml->np[l];
  }
  if (widest <= 64) {
    ml->nt = 8;
  } else if (widest <= 128) {
    ml->nt = 16;
  } else {
    return false;
  }
  const int np0 = ml->np[0];
  int wl = 0;
  ml->frag[0] = 0;
  for (int l = 1; l < hidden; ++l) {
    ml->frag[l] = wl;
    wl += 2 * ml->np[l - 1] * ml->np[l];
  }
  ml->wl_floats = wl;
  ml->wq_floats = round_up(E * lay.n[1], 4);
  ml->n_hidden = hidden;
  ml->n1 = lay.n[1];
  ml->n_last = lay.n[hidden];
  ml->w_out = lay.w[hidden];
  ml->b_out = lay.b[hidden];
  int hb = 0;
  for (int l = 0; l < hidden; ++l) {
    ml->weight[l] = lay.w[l];
    ml->bias[l] = lay.b[l];
    ml->width[l] = lay.n[l + 1];
    ml->hb[l] = hb;
    if (l > 0) hb += ml->np[l];
  }
  ml->hb_out = hb;
  ml->hb_floats = hb + ml->np[hidden - 1];
  int parts = 1;
  while (parts < 32 && 2 * parts * np0 <= kMmaThreads) parts *= 2;
  ml->c0_parts = parts;
  const int row = ml->ep * size;  // a multiple of 32 bytes
  const int want = size == 2 ? 32 : 64;
  ml->kstride = row + (want - row % 128 + 128) % 128;
  // the widest window with which two blocks share an SM, else the widest
  // that fits at all
  int fits = 0;
  for (ml->win = kMaxWindow; ml->win >= 32; ml->win /= 2) {
    const size_t bytes = mma_shared_bytes(*ml);
    if (bytes <= static_cast<size_t>(kTwoBlockBytes)) {
      fits = ml->win;
      break;
    }
    if (fits == 0 && bytes <= static_cast<size_t>(kMaxSharedBytes)) {
      fits = ml->win;
    }
  }
  if (fits == 0) return false;
  ml->win = fits;
  ml->smem = mma_shared_bytes(*ml);
  return true;
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero,
// for finite x, in two integer instructions (sm_90 emulates cvt.rna.tf32)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  unsigned h, l;
  split_tf32(v.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  split_tf32(v.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  split_tf32(v.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  split_tf32(v.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

// d += a b on the tensor cores: a 16 x 8 (row-major), b 8 x 8 (column-
// major), TF32 operands, float32 accumulators; lane (g = lane / 4, q =
// lane % 4) holds a[g][q], a[g + 8][q], a[g][q + 4], a[g + 8][q + 4],
// b[q][g], b[q + 4][g] and d[g][2q], d[g][2q + 1], d[g + 8][2q],
// d[g + 8][2q + 1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
// 4 bytes from src, or zeros where !in
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src,
                                          bool in) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// key row `src` (E values) into the stage row `dst` (ep values, zeros
// past E): 16-byte copies in flight (`vec`: E % 16 == 0 and the rows
// 16-byte aligned), else one value at a time
template <typename S>
__device__ __forceinline__ void stage_row(S* dst, const S* src, int E,
                                          int ep, bool vec) {
  if (vec) {
    for (int c = 0; c < E * static_cast<int>(sizeof(S)) / 16; ++c) {
      cp_async16(reinterpret_cast<char*>(dst) + 16 * c,
                 reinterpret_cast<const char*>(src) + 16 * c);
    }
  } else {
    for (int e = 0; e < ep; ++e) dst[e] = e < E ? src[e] : S{};
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the staged values e0 .. e0 + 3 of a row, as float
__device__ __forceinline__ void lds4(const float* row, int e0,
                                     float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(row + e0);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* row, int e0,
                                     float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(row + e0);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

// the staged values e0 and e0 + 1 (e0 even) of a row, as float
__device__ __forceinline__ void lds2(const float* row, int e0, float& v0,
                                     float& v1) {
  const float2 x = *reinterpret_cast<const float2*>(row + e0);
  v0 = x.x;
  v1 = x.y;
}
__device__ __forceinline__ void lds2(const __nv_bfloat16* row, int e0,
                                     float& v0, float& v1) {
  const unsigned x = *reinterpret_cast<const unsigned*>(row + e0);
  v0 = __uint_as_float(x << 16);
  v1 = __uint_as_float(x & 0xffff0000u);
}

// n tile nt's sum of a small product: its own (SEP), or acc's
template <int NT, bool SEP>
__device__ __forceinline__ auto pick(float (&acc)[NT][4],
                                     float (&sep)[SEP ? NT : 1][4], int nt)
    -> float (&)[4] {
  if constexpr (SEP) {
    return sep[nt];
  } else {
    return acc[nt];
  }
}

// acc += ac2 + ac3 over the first `tiles` n tiles, where they are apart
template <int NT, bool SEP>
__device__ __forceinline__ void gather_sums(
    int tiles, float (&acc)[NT][4], const float (&ac2)[SEP ? NT : 1][4],
    const float (&ac3)[SEP ? NT : 1][4]) {
  if constexpr (SEP) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (nt < tiles) acc[nt][i] += ac2[nt][i] + ac3[nt][i];
      }
    }
  }
}

// h = act(acc) over the first `tiles` n tiles
template <int NT>
__device__ __forceinline__ void activate(int act, int tiles,
                                         const float (&acc)[NT][4],
                                         float (&h)[NT][4]) {
  if (act == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (nt < tiles) h[nt][i] = 1.0f / (1.0f + expf(-acc[nt][i]));
      }
    }
  } else if (act == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (nt < tiles) h[nt][i] = acc[nt][i] > 0.0f ? acc[nt][i] : 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (nt < tiles) h[nt][i] = acc[nt][i];
      }
    }
  }
}

// Layer 0 of a tile, k B_s over k slabs of 16, added to acc (and the
// small products to ac2 with SEP); FULL: every one of the NT n tiles is
// B_s's (no guard, so no branch between a tile's products)
template <typename S, int NT, bool SEP, bool FULL>
__device__ __forceinline__ void layer0(const float4* bs4, const S* row0,
                                       const S* row1, int ep, int nt0,
                                       int lane, float (&acc)[NT][4],
                                       float (&ac2)[SEP ? NT : 1][4],
                                       float (&ac3)[SEP ? NT : 1][4]) {
  constexpr bool kBf16 = sizeof(S) == 2;
  for (int j = 0; j < ep / 16; ++j) {
    float x0[4], x1[4];
    lds4(row0, 16 * j, x0);
    lds4(row1, 16 * j, x1);
    // k step s of the slab holds this lane's columns 4q + 2s (as q) and
    // 4q + 2s + 1 (as q + 4)
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float av[4] = {x0[2 * s], x1[2 * s], x0[2 * s + 1],
                           x1[2 * s + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kBf16) {
          ah[s][i] = __float_as_uint(av[i]);  // exact in TF32
        } else {
          split_tf32(av[i], ah[s][i], al[s][i]);
        }
      }
    }
    const float4* bp = bs4 + 2 * j * nt0 * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (FULL || nt < nt0) {
        const float4 bh = bp[2 * nt * 32], bl = bp[(2 * nt + 1) * 32];
        float(&s2)[4] = pick<NT, SEP>(acc, ac2, nt);
        float(&s3)[4] = pick<NT, SEP>(acc, ac3, nt);
        if constexpr (!kBf16) mma_tf32(s3, al[0], bh.x, bh.y);
        mma_tf32(s2, ah[0], bl.x, bl.y);
        mma_tf32(acc[nt], ah[0], bh.x, bh.y);
        if constexpr (!kBf16) mma_tf32(s3, al[1], bh.z, bh.w);
        mma_tf32(s2, ah[1], bl.z, bl.w);
        mma_tf32(acc[nt], ah[1], bh.z, bh.w);
      }
    }
  }
}

// A later hidden layer of a tile in 3xTF32, from h (the last layer's
// activations, tiles_in n tiles) to h (tiles_out): KT and NTO, where not
// 0, are tiles_in and tiles_out known to the compiler (no guards)
template <int NT, bool SEP, int KT, int NTO>
__device__ __forceinline__ void later_layer(
    int act, int tiles_in, int tiles_out, const float* bl, const float4* wp,
    int qd, float (&acc)[NT][4], float (&ac2)[SEP ? NT : 1][4],
    float (&ac3)[SEP ? NT : 1][4], float (&h)[NT][4]) {
  const int n_in = KT ? KT : tiles_in, n_out = NTO ? NTO : tiles_out;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < n_out) {
      const float2 c = *reinterpret_cast<const float2*>(bl + 8 * nt + 2 * qd);
      acc[nt][0] = c.x;
      acc[nt][1] = c.y;
      acc[nt][2] = c.x;
      acc[nt][3] = c.y;
      if constexpr (SEP) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ac2[nt][i] = ac3[nt][i] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    if (ks < n_in) {
      unsigned ah[4], al[4];
      split_tf32(h[ks][0], ah[0], al[0]);
      split_tf32(h[ks][2], ah[1], al[1]);
      split_tf32(h[ks][1], ah[2], al[2]);
      split_tf32(h[ks][3], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < n_out) {
          const float4 w = wp[(ks * n_out + nt) * 32];
          float(&s2)[4] = pick<NT, SEP>(acc, ac2, nt);
          float(&s3)[4] = pick<NT, SEP>(acc, ac3, nt);
          mma_tf32(s3, al, w.x, w.y);
          mma_tf32(s2, ah, w.z, w.w);
          mma_tf32(acc[nt], ah, w.x, w.y);
        }
      }
    }
  }
  gather_sums<NT, SEP>(n_out, acc, ac2, ac3);
  activate<NT>(act, n_out, acc, h);
}

// One block of kMmaThreads walks samples blockIdx.x, + gridDim.x, ...
// Shared memory: B_s [ep / 16][np0 / 8][hi, lo][32 lanes] float4; the
// later layers' fragments; the window's key rows; c0 [np0]; q [ep]; the
// warps' key sums [warps][ep], maxima and sums; the window's valid steps
// and the warps' counts.  A sample takes three barriers and a window two
// more: (1) q and the first window's ballot; (2) its valid steps, their
// key rows (cp.async, each by the thread that found the step), c0 and
// B_s; then the tiles, during which the next sample's query and mask are
// loaded; (3) the warps' states merged.
template <typename S, int NT>
__global__ void __launch_bounds__(kMmaThreads, 2)
din_attention_mma_kernel(const void* __restrict__ q, int q_bf16,
                         const S* __restrict__ keys, long long k_sb,
                         long long k_st, int vec,
                         const unsigned char* __restrict__ mask,
                         const float* __restrict__ prm, MmaLayout ml,
                         int B, int T, int E, int act,
                         int wnorm, S* __restrict__ out) {
  constexpr bool kSep = NT <= 8;  // the products' sums apart (registers)
  extern __shared__ __align__(16) float smem[];
  // each hidden layer's padded width, offsets of its padded bias and its
  // fragments, its width, and the offsets of its weight and bias
  __shared__ int s_np[kMaxLayers], s_hb[kMaxLayers], s_frag[kMaxLayers];
  __shared__ int s_n[kMaxLayers], s_w[kMaxLayers], s_b[kMaxLayers];
  const int ep = ml.ep, np0 = ml.np[0], nt0 = np0 / 8, win = ml.win;
  const int kstride = ml.kstride / static_cast<int>(sizeof(S));
  float4* bs4 = reinterpret_cast<float4*>(smem);
  float4* wkq4 = bs4 + ep * np0 / 2;   // W_k's fragments, then W_qk's
  float* wl = smem + 4 * ep * np0;
  float* wqs = wl + ml.wl_floats;      // W_q [E, n1]
  S* stage = reinterpret_cast<S*>(wqs + ml.wq_floats);
  float* c0s = reinterpret_cast<float*>(
      reinterpret_cast<char*>(stage) + static_cast<size_t>(win) * ml.kstride);
  float* qs = c0s + np0;
  float* part = qs + ep;
  float* wmax = part + kMmaWarps * ep;
  float* wsum = wmax + kMmaWarps;
  float* hbs = wsum + kMmaWarps;  // the later biases, the output weight
  int* vi = reinterpret_cast<int*>(hbs + ml.hb_floats);
  int* cnt = vi + win;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int hidden = ml.n_hidden;
  const int n1 = ml.n1;
  const int parts = ml.c0_parts;
  const int e_chunks = (E + 63) / 64;
  const float* b0 = prm + ml.bias[0];
  const float bo = __ldg(prm + ml.b_out);

  // once a block, from the packed buffer, with copies all in flight at
  // once: W_q as it lies there, W_k and W_qk each value to its fragment
  // slot, the later layers' likewise (split below); and each hidden
  // layer's shape and offsets, read from the parameter space at fixed
  // indices only, into shared memory (so that one loop walks the layers)
  {
    // 16-byte copies (W_q's rounded-up tail reads into the packed
    // buffer's next part, which it holds)
    for (int i = tid; i < ml.wq_floats / 4; i += kMmaThreads) {
      cp_async16(wqs + 4 * i, prm + 4 * i);
    }
    // W_k [E, n1] and W_qk [E, n1] follow W_q: value (e, o) to lane (o %
    // 8, e % 16 / 4), slot e % 4, of slab e / 16 and n tile o / 8, zeros
    // past [E, n1].  A slot's bank is 16 (o % 2) + e % 16, so a warp takes
    // 16 rows by 32 columns, lane (column) o at step k the row (k + o / 2)
    // % 16: a step's slots fall in distinct banks.
    float* wkq = reinterpret_cast<float*>(wkq4);
    const float* wk = prm + E * n1;
    const int ocols = (np0 + 31) / 32;
#pragma unroll 1
    for (int u = warp; u < (ep / 16) * ocols; u += kMmaWarps) {
      const int o = 32 * (u % ocols) + lane;
#pragma unroll 1
      for (int k = 0; k < 16; ++k) {
        const int e = 16 * (u / ocols) + ((k + (lane >> 1)) & 15);
        const bool in = e < E && o < n1;
        const int at = (((e >> 4) * nt0 + (o >> 3)) * 32 + 4 * (o & 7) +
                        ((e >> 2) & 3)) * 4 + (e & 3);
        if (o < np0) {
          const float* src = in ? wk + e * n1 + o : wk;
          cp_async4(wkq + at, src, in);
          cp_async4(wkq + ep * np0 + at, src + E * n1, in);
        }
      }
    }
    // the output weight, zero-padded
    for (int c = tid; c < ml.hb_floats - ml.hb_out; c += kMmaThreads) {
      hbs[ml.hb_out + c] = c < ml.n_last ? __ldg(prm + ml.w_out + c) : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (tid == l && l < hidden) {
        s_np[l] = ml.np[l];
        s_hb[l] = ml.hb[l];
        s_frag[l] = ml.frag[l];
        s_n[l] = ml.width[l];
        s_w[l] = ml.weight[l];
        s_b[l] = ml.bias[l];
      }
    }
    __syncthreads();
    // the later layers: W [ni, no], value (r, c) to lane (c % 8, r % 8 /
    // 2), slot r % 2, of k step r / 8 and n tile c / 8 (its lo goes to
    // slot 2 + r % 2 below), 8 rows by 32 columns a warp, rotated as
    // above (a slot's bank is 16 (c % 2) + 4 (r % 8 / 2) + r % 2); their
    // biases, zero-padded
    for (int l = 1; l < hidden; ++l) {
      const int ni = s_n[l - 1], no = s_n[l];
      const int nk = s_np[l - 1], nn = s_np[l];
      const float* w = prm + s_w[l];
      float* dst = wl + s_frag[l];
      const int ccols = (nn + 31) / 32;
#pragma unroll 1
      for (int u = warp; u < (nk / 8) * ccols; u += kMmaWarps) {
        const int c = 32 * (u % ccols) + lane;
#pragma unroll 1
        for (int k = 0; k < 8; ++k) {
          const int r = 8 * (u / ccols) + ((k + (lane >> 1)) & 7);
          const bool in = r < ni && c < no;
          const int at = (((r >> 3) * (nn >> 3) + (c >> 3)) * 32 +
                          4 * (c & 7) + ((r >> 1) & 3)) * 4 + (r & 1);
          if (c < nn) cp_async4(dst + at, in ? w + r * no + c : w, in);
        }
      }
      for (int c = tid; c < nn; c += kMmaThreads) {
        hbs[s_hb[l] + c] = c < no ? __ldg(prm + s_b[l] + c) : 0.0f;
      }
    }
  }
  const float4* wk4 = wkq4;
  const float4* wqk4 = wkq4 + ep * np0 / 4;

  // the first sample's query and first window of its mask
  float qn[kQPer];
  unsigned char mn = 0;
  {
    const int b = blockIdx.x;
#pragma unroll
    for (int k = 0; k < kQPer; ++k) {
      const int i = tid + k * kMmaThreads;
      qn[k] = 0.0f;
      if (i < E && b < B) {
        const long long at = static_cast<long long>(b) * E + i;
        qn[k] = q_bf16 ? __bfloat162float(
                             static_cast<const __nv_bfloat16*>(q)[at])
                       : __ldg(static_cast<const float*>(q) + at);
      }
    }
    if (tid < win && tid < T && b < B) {
      mn = mask[static_cast<long long>(b) * T + tid];
    }
  }
  cp_async_wait_all();  // the weights' copies
  __syncthreads();
  // the later layers' values split hi + lo in TF32 in place: a lane's
  // (v0, v1, -, -) becomes (hi0, hi1, lo0, lo1); read after the first
  // sample's barrier
  for (int i = tid; i < ml.wl_floats / 4; i += kMmaThreads) {
    float4* f = reinterpret_cast<float4*>(wl) + i;
    unsigned h0, l0, h1, l1;
    split_tf32(f->x, h0, l0);
    split_tf32(f->y, h1, l1);
    *f = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
  }

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const S* kb = keys + static_cast<long long>(b) * k_sb;
    const unsigned char* mb = mask + static_cast<long long>(b) * T;
    // (1) the query, and the first window's ballot
#pragma unroll
    for (int k = 0; k < kQPer; ++k) {
      const int i = tid + k * kMmaThreads;
      if (i < ep) qs[i] = qn[k];
    }
    int t = tid;
    bool on = tid < win && mn != 0;
    unsigned bal = __ballot_sync(kFull, on);
    if (lane == 0 && 32 * warp < win) cnt[warp] = __popc(bal);
    __syncthreads();

    // (2) the window's valid steps and their keys; c0 = q W_q + b_0; B_s
    int nv = 0, before = 0;
    for (int w = 0; w < win / 32; ++w) {
      const int c = cnt[w];
      before += w < warp ? c : 0;
      nv += c;
    }
    if (on) {
      const int r = before + __popc(bal & ((1u << lane) - 1u));
      vi[r] = t;
      stage_row(stage + r * kstride, kb + static_cast<long long>(t) * k_st, E,
                ep, vec);
    }
    for (int o0 = 0; o0 < np0; o0 += kMmaThreads / parts) {
      const int o = o0 + tid / parts;
      float a = 0.0f;
      if (o < n1) {
#pragma unroll 8
        for (int e = tid % parts; e < E; e += parts) {
          a = fmaf(qs[e], wqs[e * n1 + o], a);
        }
      }
      for (int m = 1; m < parts; m <<= 1) a += __shfl_xor_sync(kFull, a, m);
      if (tid % parts == 0 && o < np0) {
        c0s[o] = o < n1 ? a + __ldg(b0 + o) : 0.0f;
      }
    }
    const float4* qs4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
    for (int i = tid; i < (ep / 16) * nt0 * 32; i += kMmaThreads) {
      const int jn = i >> 5, l = i & 31;
      const float4 wk = wk4[i], wqk = wqk4[i];
      const float4 qv = qs4[4 * (jn / nt0) + (l & 3)];
      float4 hi, lo;
      split4(make_float4(fmaf(qv.x, wqk.x, wk.x), fmaf(qv.y, wqk.y, wk.y),
                         fmaf(qv.z, wqk.z, wk.z), fmaf(qv.w, wqk.w, wk.w)),
             hi, lo);
      bs4[2 * jn * 32 + l] = hi;
      bs4[(2 * jn + 1) * 32 + l] = lo;
    }
    cp_async_wait_all();
    __syncthreads();

    // the next sample's query and first window, loaded while the tiles run
    {
      const int bn = b + gridDim.x;
#pragma unroll
      for (int k = 0; k < kQPer; ++k) {
        const int i = tid + k * kMmaThreads;
        if (i < E && bn < B) {
          const long long at = static_cast<long long>(bn) * E + i;
          qn[k] = q_bf16 ? __bfloat162float(
                               static_cast<const __nv_bfloat16*>(q)[at])
                         : __ldg(static_cast<const float*>(q) + at);
        }
      }
      if (tid < win && tid < T && bn < B) {
        mn = mask[static_cast<long long>(bn) * T + tid];
      }
    }

    float run_max = minus_inf(), run_sum = 0.0f;
    float ksum[2 * kMaxChunks];
#pragma unroll
    for (int i = 0; i < 2 * kMaxChunks; ++i) ksum[i] = 0.0f;
    int valid = 0;
    for (int t0 = 0; t0 < T; t0 += win) {
      if (t0 > 0) {
        __syncthreads();  // every warp is done with vi, cnt and the stage
        t = t0 + tid;
        on = tid < win && t < T && mb[t] != 0;
        bal = __ballot_sync(kFull, on);
        if (lane == 0 && 32 * warp < win) cnt[warp] = __popc(bal);
        __syncthreads();
        nv = 0;
        before = 0;
        for (int w = 0; w < win / 32; ++w) {
          const int c = cnt[w];
          before += w < warp ? c : 0;
          nv += c;
        }
        if (on) {
          const int r = before + __popc(bal & ((1u << lane) - 1u));
          vi[r] = t;
          stage_row(stage + r * kstride,
                    kb + static_cast<long long>(t) * k_st, E, ep, vec);
        }
        cp_async_wait_all();
        __syncthreads();
      }
      valid += nv;
      const int tiles = (nv + 15) / 16;
      for (int ti = warp; ti < tiles; ti += kMmaWarps) {
        const int base = 16 * ti;
        const bool v0 = base + g < nv, v1 = base + g + 8 < nv;
        // rows past nv hold stale values: they stay in their own rows of
        // the products and get no weight
        const S* row0 = stage + (base + g) * kstride + 4 * qd;
        const S* row1 = row0 + 8 * kstride;
        // the products' sums: acc (hi * hi), and with kSep apart ac2 and
        // ac3 (the small products), so that more of a warp's mma.sync
        // chains run at once; added together, small ones first, before
        // each activation
        float acc[NT][4], ac2[kSep ? NT : 1][4], ac3[kSep ? NT : 1][4];
        float h[NT][4];

        // layer 0: c0 + k B_s over k slabs of 16
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nt0) {
            const float2 c =
                *reinterpret_cast<const float2*>(c0s + 8 * nt + 2 * qd);
            acc[nt][0] = c.x;
            acc[nt][1] = c.y;
            acc[nt][2] = c.x;
            acc[nt][3] = c.y;
            if constexpr (kSep) {
#pragma unroll
              for (int i = 0; i < 4; ++i) ac2[nt][i] = ac3[nt][i] = 0.0f;
            }
          }
        }
        // at the bench's shape (64-16: NT = 8) every n tile is B_s's, and
        // the compiler knows it
        bool full = false;
        if constexpr (NT == 8) {
          full = nt0 == NT;
          if (full) {
            layer0<S, NT, kSep, true>(bs4, row0, row1, ep, nt0, lane, acc,
                                      ac2, ac3);
          }
        }
        if (!full) {
          layer0<S, NT, kSep, false>(bs4, row0, row1, ep, nt0, lane, acc, ac2,
                                     ac3);
        }
        gather_sums<NT, kSep>(nt0, acc, ac2, ac3);
        activate<NT>(act, nt0, acc, h);

        // the later hidden layers, 3xTF32; a layer's accumulators are
        // the next one's A fragments
        int tiles_in = nt0;
        for (int l = 1; l < hidden; ++l) {
          const int tiles_out = s_np[l] / 8;
          const float* bl = hbs + s_hb[l];
          const float4* wp =
              reinterpret_cast<const float4*>(wl + s_frag[l]) + lane;
          // the bench's second layer (8 tiles in, 2 out), whose tile
          // counts the compiler knows
          bool bench = false;
          if constexpr (NT == 8) {
            bench = tiles_in == NT && tiles_out == 2;
            if (bench) {
              later_layer<NT, kSep, NT, 2>(act, tiles_in, tiles_out, bl, wp,
                                           qd, acc, ac2, ac3, h);
            }
          }
          if (!bench) {
            later_layer<NT, kSep, 0, 0>(act, tiles_in, tiles_out, bl, wp, qd,
                                        acc, ac2, ac3, h);
          }
          tiles_in = tiles_out;
        }

        // the output layer: rows g and g + 8, summed over the row's lanes
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < tiles_in) {
            const float2 w = *reinterpret_cast<const float2*>(
                hbs + ml.hb_out + 8 * nt + 2 * qd);
            s0 = fmaf(h[nt][1], w.y, fmaf(h[nt][0], w.x, s0));
            s1 = fmaf(h[nt][3], w.y, fmaf(h[nt][2], w.x, s1));
          }
        }
        s0 += __shfl_xor_sync(kFull, s0, 1);
        s0 += __shfl_xor_sync(kFull, s0, 2);
        s1 += __shfl_xor_sync(kFull, s1, 1);
        s1 += __shfl_xor_sync(kFull, s1, 2);
        s0 += bo;
        s1 += bo;

        // the tile's weights: the online softmax, or the masked scores
        float p0, p1;
        if (wnorm) {
          float m = fmaxf(v0 ? s0 : minus_inf(), v1 ? s1 : minus_inf());
          m = fmaxf(m, __shfl_xor_sync(kFull, m, 4));
          m = fmaxf(m, __shfl_xor_sync(kFull, m, 8));
          m = fmaxf(m, __shfl_xor_sync(kFull, m, 16));
          const float mx = fmaxf(run_max, m);
          const float scale = expf(run_max - mx);  // 0 for the first rows
          p0 = v0 ? expf(s0 - mx) : 0.0f;
          p1 = v1 ? expf(s1 - mx) : 0.0f;
          float ps = p0 + p1;
          ps += __shfl_xor_sync(kFull, ps, 4);
          ps += __shfl_xor_sync(kFull, ps, 8);
          ps += __shfl_xor_sync(kFull, ps, 16);
          run_sum = run_sum * scale + ps;
          run_max = mx;
#pragma unroll
          for (int i = 0; i < 2 * kMaxChunks; ++i) ksum[i] *= scale;
        } else {
          p0 = v0 ? s0 : 0.0f;
          p1 = v1 ? s1 : 0.0f;
        }
        // the weighted keys: lane owns columns 64 c + 2 lane, + 1
        const int rows = min(16, nv - base);
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const float pr = __shfl_sync(kFull, r < 8 ? p0 : p1, 4 * (r & 7));
          const S* kr = stage + (base + r) * kstride;
#pragma unroll
          for (int c = 0; c < kMaxChunks; ++c) {
            const int e = 64 * c + 2 * lane;
            if (c < e_chunks && e < ep) {
              float k0, k1;
              lds2(kr, e, k0, k1);
              ksum[2 * c] = fmaf(pr, k0, ksum[2 * c]);
              ksum[2 * c + 1] = fmaf(pr, k1, ksum[2 * c + 1]);
            }
          }
        }
      }
    }

    // the next sample's first window of key rows, asked of the L2 while
    // this sample's states merge (its mask has arrived by now)
    if (mn != 0 && b + gridDim.x < B) {
      const char* row = reinterpret_cast<const char*>(
          keys + static_cast<long long>(b + gridDim.x) * k_sb +
          static_cast<long long>(tid) * k_st);
      const int bytes = E * static_cast<int>(sizeof(S));
      for (int off = 0; off < bytes; off += 128) prefetch_l2(row + off);
      prefetch_l2(row + bytes - 1);
    }

    // (3) merge the warps' states
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int e = 64 * c + 2 * lane;
      if (c < e_chunks) {
        if (e < E) part[warp * ep + e] = ksum[2 * c];
        if (e + 1 < E) part[warp * ep + e + 1] = ksum[2 * c + 1];
      }
    }
    if (lane == 0) {
      wmax[warp] = run_max;
      wsum[warp] = run_sum;
    }
    if (wnorm && valid == 0) {
      // A step past the history scores -2^32 + 1 under the softmax, and
      // its weight exp(-2^32 + 1 - max) is exactly 0 beside any valid
      // step's.  With no valid step every score is that constant and the
      // softmax is uniform: the mean of the T keys, staged a window at a
      // time.
      float colsum[kQPer];
#pragma unroll
      for (int k = 0; k < kQPer; ++k) colsum[k] = 0.0f;
      for (int t0 = 0; t0 < T; t0 += win) {
        const int rows = min(win, T - t0);
        __syncthreads();  // the stage is free
        if (tid < rows) {
          stage_row(stage + tid * kstride,
                    kb + static_cast<long long>(t0 + tid) * k_st, E, ep, vec);
        }
        cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kQPer; ++k) {
          const int e = tid + k * kMmaThreads;
          if (e < E) {
            for (int r = 0; r < rows; ++r) {
              colsum[k] += to_float(stage[r * kstride + e]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kQPer; ++k) {
        const int e = tid + k * kMmaThreads;
        if (e < E) {
          store_f(out + static_cast<long long>(b) * E + e,
                  colsum[k] / static_cast<float>(T));
        }
      }
    } else {
      __syncthreads();
      if (wnorm) {
        float mx = wmax[0];
        for (int w = 1; w < kMmaWarps; ++w) mx = fmaxf(mx, wmax[w]);
        float f[kMmaWarps], tot = 0.0f;
        for (int w = 0; w < kMmaWarps; ++w) {
          f[w] = expf(wmax[w] - mx);  // 0 for a warp without rows
          tot += wsum[w] * f[w];
        }
        for (int e = tid; e < E; e += kMmaThreads) {
          float v = 0.0f;
          for (int w = 0; w < kMmaWarps; ++w) {
            v = fmaf(part[w * ep + e], f[w], v);
          }
          store_f(out + static_cast<long long>(b) * E + e, v / tot);
        }
      } else {
        for (int e = tid; e < E; e += kMmaThreads) {
          float v = 0.0f;
          for (int w = 0; w < kMmaWarps; ++w) v += part[w * ep + e];
          store_f(out + static_cast<long long>(b) * E + e, v);
        }
      }
    }
  }
}

template <typename S, int NT>
int launch_mma(const void* q, int q_bf16, const void* keys, long long k_sb,
               long long k_st, int vec, const unsigned char* mask,
               const float* params, const MmaLayout& ml, int B, int T, int E,
               int act, int wnorm, void* out, cudaStream_t stream) {
  auto kernel = din_attention_mma_kernel<S, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ml.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kMmaThreads, ml.smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return kDoesNotFit;
  const int grid = B < per_sm * sms ? B : per_sm * sms;
  kernel<<<grid, kMmaThreads, ml.smem, stream>>>(
      q, q_bf16, static_cast<const S*>(keys), k_sb, k_st, vec, mask, params,
      ml, B, T, E, act, wnorm, static_cast<S*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int dispatch_mma(const void* q, int q_bf16, const void* keys, long long k_sb,
                 long long k_st, int vec, const unsigned char* mask,
                 const float* params, const MmaLayout& ml, int B, int T,
                 int E, int act, int wnorm, void* out, cudaStream_t stream) {
  if (act < 0 || act > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (ml.nt == 8) {
    return launch_mma<S, 8>(q, q_bf16, keys, k_sb, k_st, vec, mask, params,
                            ml, B, T, E, act, wnorm, out, stream);
  }
  return launch_mma<S, 16>(q, q_bf16, keys, k_sb, k_st, vec, mask, params,
                           ml, B, T, E, act, wnorm, out, stream);
}

// the tensor-core design's instance (8 or 16: its most n tiles) or 0 for
// the FMA design (with its rows a pass in *chunk), kDoesNotFit where
// neither takes the shape
int route_of(const Layout& lay, int E, int size, MmaLayout* ml, int* chunk) {
  if (make_mma_layout(lay, E, size, ml)) return ml->nt;
  int c = kWindow;
  while (c > 0 &&
         shared_bytes(lay, E, c) > static_cast<size_t>(kMaxSharedBytes)) {
    c /= 2;
  }
  *chunk = c;
  return c > 0 ? 0 : kDoesNotFit;
}

}  // namespace

// The design din_attention_fwd takes for dtype (0 float32, 1 bfloat16
// keys), E and the n_layers + 1 widths (4E, the hidden widths, 1): 8 or 16
// the tensor cores' instance with at most that many n tiles (hidden
// widths up to 64, up to 128), 0 float32 FMAs, -2 neither (one row of work
// does not fit in shared memory), or cudaErrorInvalidValue for widths
// that do not chain.
extern "C" int din_attention_route(int dtype, int n_layers, const int* widths,
                                   int E) {
  Layout lay;
  MmaLayout ml;
  int chunk = 0;
  if (E <= 0 || dtype < 0 || dtype > 1 ||
      !make_layout(n_layers, widths, E, &lay)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return route_of(lay, E, dtype == 0 ? 4 : 2, &ml, &chunk);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// -2 when one row of work does not fit in a block's shared memory.
// dtype: 0 float32, 1 bfloat16 (keys and out); q_bf16: 0 float32, 1
// bfloat16 query; act: 0 sigmoid, 1 relu, 2 linear.  q [B, E], keys
// addressed as keys[b * k_sb + t * k_st + e], mask [B, T] bytes (0 or 1),
// params the float32 buffer of ops/attention.py:pack_params (from a 16-byte
// boundary), widths the n_layers + 1 widths (4E, the hidden widths, 1) as
// a host array; out [B, E].
extern "C" int din_attention_fwd(int dtype, int act, int wnorm,
                                 const void* q, int q_bf16, const void* keys,
                                 long long k_sb, long long k_st,
                                 const unsigned char* mask,
                                 const float* params, int n_layers,
                                 const int* widths, int B,
                                 int T, int E, void* out, void* stream) {
  Layout lay;
  MmaLayout ml;
  int chunk = 0;
  if (B <= 0 || T <= 0 || E <= 0 || dtype < 0 || dtype > 1 ||
      !make_layout(n_layers, widths, E, &lay)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int size = dtype == 0 ? 4 : 2;
  const int route = route_of(lay, E, size, &ml, &chunk);
  if (route < 0) return route;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route > 0) {
    const int vec = E % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                    (k_st * size) % 16 == 0 && (k_sb * size) % 16 == 0;
    if (dtype == 0) {
      return dispatch_mma<float>(q, q_bf16, keys, k_sb, k_st, vec, mask,
                                 params, ml, B, T, E, act, wnorm, out, s);
    }
    return dispatch_mma<__nv_bfloat16>(q, q_bf16, keys, k_sb, k_st, vec, mask,
                                       params, ml, B, T, E, act, wnorm, out,
                                       s);
  }
  if (dtype == 0) {
    return dispatch_fma<float>(act, q, q_bf16, keys, k_sb, k_st, mask, params,
                               lay, B, T, E, chunk, wnorm, out, s);
  }
  return dispatch_fma<__nv_bfloat16>(act, q, q_bf16, keys, k_sb, k_st, mask,
                                     params, lay, B, T, E, chunk, wnorm, out,
                                     s);
}
