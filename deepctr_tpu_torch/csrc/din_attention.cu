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
//   x_t W_0 = q (A + C) + k_t (B - C + diag(q) D),
//
// so the query's part is computed once a sample, and a time step costs
// E x n1 multiply-adds of the first layer instead of 4E x n1.
//
// What it replaces: the TPU kernel deepctr_tpu/ops/pallas_attention.py:
// din_attention_fused (_kernel), one grid step a sample, which keeps the
// [B, T, 4E] MLP input and the [B, T, H] activations out of device memory.
//
// What bounds it: float32 arithmetic.  What the function needs is, per
// sample, the query's part of the first layer and the fold (2 E n1
// multiply-adds); per step inside the history, E n1 for the first layer,
// the later layers (64 x 16 + 16 at the bench's 64-16 attention) and E for
// the weighted sum; a step past the history needs no MLP (its score is the
// mask constant, or 0).  At E=64, T=100, B=1024 and histories of 50 steps
// on average that is about 0.56 GFLOP against 6.7 MB of bf16 keys: 8 us at
// 67 TFLOP/s, the float32 rate outside the tensor cores, which is the rate
// the bound assumes, against 2 us for the bytes.  (A 3xTF32 split on the
// tensor cores keeps float32 accuracy at up to a third of their 495
// TFLOP/s; its bound would be 0.41 of this one.)
//
// What the design does about that: one block a sample, as on the TPU,
// and only the steps inside the history go through the MLP.  The block
// walks T in windows of 32 steps; one warp compacts the window's valid
// steps (a ballot of the mask), their keys are copied into shared memory
// in rows of up to 32, and the MLP runs over those rows with the
// activations in shared memory; each thread computes 4 rows of one output
// unit of the first layer, so that a folded weight serves four
// multiply-adds.  The rows' scores fold into an online softmax (a running
// maximum and sum, the weighted sum of keys rescaled when the maximum
// rises), so the block holds no [T] or [T, E] array and takes any T.  The
// weights are read through the L1 cache (they are the same for every
// block), so the shared memory a block needs does not grow with them: at
// E <= 512, 32 rows in work fit for hidden widths up to about 600, and
// the launch takes fewer rows a pass for wider layers (one row fits up to
// about 28,000).  Several samples a block and the tensor cores are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;    // time steps one warp's ballot compacts
constexpr int kRows = 4;       // time steps a thread computes in layer 0
constexpr int kMaxLayers = 8;  // hidden layers + the output layer
// the shared memory a block may take on Hopper, less this kernel's static
// arrays
constexpr int kMaxSharedBytes = 232448 - 256;
// returned when even one row of work does not fit in shared memory
constexpr int kDoesNotFit = -2;
constexpr float kNeg = -4294967295.0f;  // -2^32 + 1, as float32

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
din_attention_kernel(const void* __restrict__ q, int q_bf16,
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
    float a = __ldg(b0 + o);
    for (int e = 0; e < E; ++e) a = fmaf(qs[e], __ldg(wq + e * n1 + o), a);
    c0[o] = a;
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
        float a[kRows];
        const float* krow[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          a[r] = c0[o];
          krow[r] = kc + min(g * kRows + r, rows - 1) * E;
        }
        for (int e = 0; e < E; ++e) {
          const float w = fmaf(qs[e], __ldg(wqk + e * n1 + o),
                               __ldg(wk + e * n1 + o));
#pragma unroll
          for (int r = 0; r < kRows; ++r) a[r] = fmaf(krow[r][e], w, a[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = g * kRows + r;
          if (row < rows) buf0[row * n1 + o] = act_f<ACT>(a[r]);
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
          float a = __ldg(bl + o);
          for (int k = 0; k < ni; ++k) {
            a = fmaf(in[r * ni + k], __ldg(wl + k * no + o), a);
          }
          nxt[r * no + o] = act_f<ACT>(a);
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
        float a = __ldg(prm + lay.b[last]);
        for (int k = 0; k < nl; ++k) a = fmaf(in[r * nl + k], __ldg(wo + k), a);
        sc[r] = a;
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
int launch(const void* q, int q_bf16, const void* keys, long long k_sb,
           long long k_st, const unsigned char* mask, const float* params,
           const Layout& lay, int B, int T, int E, int chunk, int wnorm,
           void* out, cudaStream_t stream) {
  const size_t smem = shared_bytes(lay, E, chunk);
  auto kernel = din_attention_kernel<S, ACT>;
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
int dispatch_act(int act, const void* q, int q_bf16, const void* keys,
                 long long k_sb, long long k_st, const unsigned char* mask,
                 const float* params, const Layout& lay, int B, int T, int E,
                 int chunk, int wnorm, void* out, cudaStream_t stream) {
  switch (act) {
    case 0:
      return launch<S, 0>(q, q_bf16, keys, k_sb, k_st, mask, params, lay, B,
                          T, E, chunk, wnorm, out, stream);
    case 1:
      return launch<S, 1>(q, q_bf16, keys, k_sb, k_st, mask, params, lay, B,
                          T, E, chunk, wnorm, out, stream);
    case 2:
      return launch<S, 2>(q, q_bf16, keys, k_sb, k_st, mask, params, lay, B,
                          T, E, chunk, wnorm, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// -2 when one row of work does not fit in a block's shared memory.
// dtype: 0 float32, 1 bfloat16 (keys and out); q_bf16: 0 float32, 1
// bfloat16 query; act: 0 sigmoid, 1 relu, 2 linear.  q [B, E], keys
// addressed as keys[b * k_sb + t * k_st + e], mask [B, T] bytes (0 or 1),
// params the buffer of ops/attention.py:pack_params (float32), widths its
// n_layers + 1 widths (4E, the hidden widths, 1) as a host array; out
// [B, E].
extern "C" int din_attention_fwd(int dtype, int act, int wnorm,
                                 const void* q, int q_bf16, const void* keys,
                                 long long k_sb, long long k_st,
                                 const unsigned char* mask,
                                 const float* params, int n_layers,
                                 const int* widths, int B, int T, int E,
                                 void* out, void* stream) {
  Layout lay;
  if (B <= 0 || T <= 0 || E <= 0 || !make_layout(n_layers, widths, E, &lay)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int chunk = kWindow;
  while (chunk > 0 &&
         shared_bytes(lay, E, chunk) > static_cast<size_t>(kMaxSharedBytes)) {
    chunk /= 2;
  }
  if (chunk == 0) return kDoesNotFit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_act<float>(act, q, q_bf16, keys, k_sb, k_st, mask, params,
                               lay, B, T, E, chunk, wnorm, out, s);
  }
  if (dtype == 1) {
    return dispatch_act<__nv_bfloat16>(act, q, q_bf16, keys, k_sb, k_st, mask,
                                       params, lay, B, T, E, chunk, wnorm, out,
                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
