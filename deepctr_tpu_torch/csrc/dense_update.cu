// The optimizer step of every dense parameter in one launch, for Hopper
// (sm_90a): a multi-tensor apply.  For each element of parameter p with
// gradient g (a null g is a zero gradient, as optax steps every leaf),
// first the L2 penalty's gradient where the parameter carries an L2
// vector l2 of `period` floats (a table's columns, or one float):
//
//   g = g + (2 * l2[i % period]) * p        (2 * l2 * p alone for a null g)
//
// rounded as the row update K2 adds it (csrc/row_update.cu: update), then:
//
//   sgd:      p += -lr * g
//   adagrad:  a = a + g*g;                  p += (-lr * g) / (sqrt(a) + eps)
//   rmsprop:  v = d1 * v + c1 * (g*g);      p += (-lr * g) / (sqrt(v) + eps)
//   adam:     m = c1 * g + d1 * m;  v = c2 * (g*g) + d2 * v;
//             p += -lr * ((m / bc1) / (sqrt(v / bc2) + eps))
//
// with the state (a, v or m and v) updated in place.  Adam's bias
// corrections (bc1, bc2) = (1 - b1^t, 1 - b2^t) are a float32 [2] on the
// device, read through a pointer, so that a launch captured in a CUDA
// graph takes each replay's step.
//
// A second entry point, dense_penalty_f32, sums the penalty's value
// sum_p sum_i l2[i % period] * p_i^2 over the same argument struct into one
// float on the device, deterministically: each block's partial sum in a
// fixed order into a buffer, and the last block to finish (a counter it
// resets) adds the partials in block order.  No float atomics, so two runs
// give the same bits.  The train step reads the loss's penalty from it and
// keeps the penalty out of autograd (models/basemodel.py: _train_step).
//
// What it replaces: no TPU kernel.  The JAX package leaves the dense
// update to optax under XLA, which fuses it into a few loops; the port
// ran it as PyTorch operations, one parameter at a time, 16 kernels of a
// few microseconds a parameter for adam (ops/dense_update.py:
// dense_update_ref, which stays as the plain version), and the L2 penalty
// as an autograd chain, about 11 kernels a (parameter, rule) for the value
// and its gradient (dense_penalty_ref is the value's plain version).
//
// Numerics: each operation rounds once, in the order and with the float32
// constants of those PyTorch operations (IEEE sqrt and division, no
// contraction into FMAs: the __*_rn intrinsics), so the kernel equals its
// plain version bit for bit.  p += -lr * x is p - lr * x bit for bit.  The
// penalty's sum is taken in another order than its plain version's, within
// float32 rounding of a sum of ~1M terms.
//
// What bounds it: device-memory bytes, 28 a float for adam (p, g, m, v
// read; p, m, v written), 20 for adagrad and rmsprop, 12 for sgd; the L2
// term reads p, which the step reads anyway, and l2, at most a table's
// width of floats, which stays in L1.  The penalty reads 4 bytes a float.
// The benchmark's DeepFM holds about 1.02M dense floats (28.6 MB under
// adam, 8.5 us at 3.35 TB/s; its penalty 4.2 MB, 1.2 us), DIEN 78k (2.2 MB,
// under a microsecond: one launch's latency whatever the split; no L2).
//
// Design:
//
// 1. Arguments by value.  Up to kMaxTensors parameters' pointers and
//    sizes, and the first block of each, come in one __grid_constant__
//    struct in the launch's parameter space: the host allocates and
//    copies nothing, and a captured graph holds the launch as it is.  A
//    block finds its parameter by counting the first blocks at or before
//    it (compares with constant operands, no load).  More parameters take
//    further launches (ops/dense_update.py:launch_plan).
// 2. Chunks.  A block takes kChunk = 2048 consecutive floats of one
//    parameter (its last chunk shorter), all loads of a thread issued
//    before any arithmetic: 8 floats of each array a thread, as two
//    16-byte units where every array of the parameter starts on a
//    16-byte boundary (the chunk's start keeps that), else as floats; a
//    16-byte route ends in a scalar tail of numel % 4 floats.  DeepFM's
//    1.02M floats are about 530 blocks, under one wave at 8 blocks an SM,
//    each thread with 128 bytes in flight: about 256 KB an SM, ten times
//    what 3.35 TB/s at about 1 us of latency asks (25 KB an SM).
// 3. The L2 term.  A parameter's L2 vector is read through L1 (__ldg) at
//    element i's column i % period, the chunk's offset taken once a block;
//    a parameter without one skips the term (a block-uniform branch), so
//    its step is the one before the term existed, bit for bit.
// 4. The penalty's sum.  The same chunks and units, 4 bytes a float read;
//    a block sums its threads in a fixed tree (shuffles, then the 8 warps
//    in turn), the last block the blocks' partials by block index.  The
//    partials and the count live in a workspace the caller keeps, so a
//    captured graph replays the launch with nothing to set up.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                    // floats of each array
constexpr int kChunk = kThreads * kPerThread;    // floats a block takes
constexpr int kMaxTensors = 64;  // parameters one launch's arguments hold

enum Mode { kSgd = 0, kAdagrad = 1, kRmsprop = 2, kAdam = 3 };

// one parameter's arguments (mirrored by ops/dense_update.py:_Tensor)
struct Tensor {
  float* p;
  const float* g;   // null: a zero gradient
  float* s1;        // adagrad's and rmsprop's sum, adam's m; null for sgd
  float* s2;        // adam's v; null otherwise
  const float* l2;  // `period` floats, element i's at i % period; null: none
  long long numel;
  int period;
};

// one launch's arguments (mirrored by ops/dense_update.py:_Args)
struct Args {
  int first_block[kMaxTensors];  // INT_MAX past n_tensors
  Tensor tensor[kMaxTensors];
  const float* bias;  // adam's (1 - b1^t, 1 - b2^t); null otherwise
  int n_tensors;
  int n_blocks;
  int mode;
  float neg_lr, eps, d1, c1, d2, c2;
};
static_assert(sizeof(Args) <= 4096,
              "the arguments must fit the classic 4 KB parameter space");

struct Consts {
  float neg_lr, eps, d1, c1, d2, c2, bc1, bc2;
};

// a chunk's L2 vector: element e of the chunk takes v[(c0 + e) % period]
struct L2 {
  const float* v;  // null: no L2
  int period;
  int c0;  // the chunk's first element, modulo period
};

__device__ __forceinline__ L2 chunk_l2(const Tensor& x, long long base) {
  return L2{x.l2, x.period,
            x.l2 == nullptr ? 0 : static_cast<int>(base % x.period)};
}

__device__ __forceinline__ L2 shifted(const L2& l, int e) {
  return L2{l.v, l.period, l.v == nullptr ? 0 : (l.c0 + e) % l.period};
}

__device__ __forceinline__ float l2_at(const L2& l, int e) {
  return __ldg(l.v + (l.c0 + e) % l.period);
}

// the penalty's gradient (2 l2) p, rounded as K2's update rounds it
__device__ __forceinline__ float l2_grad(float p, float l2) {
  return __fmul_rn(__fmul_rn(2.0f, l2), p);
}

// element e's gradient with the L2 term: g + (2 l2) p, or (2 l2) p alone
// for a null g
__device__ __forceinline__ float with_l2(float g, bool has_g, float p,
                                         const L2& l, int e) {
  const float r = l2_grad(p, l2_at(l, e));
  return has_g ? __fadd_rn(g, r) : r;
}

__device__ __forceinline__ float4 with_l2(float4 g, bool has_g, float4 p,
                                          const L2& l, int e) {
  return make_float4(with_l2(g.x, has_g, p.x, l, e),
                     with_l2(g.y, has_g, p.y, l, e + 1),
                     with_l2(g.z, has_g, p.z, l, e + 2),
                     with_l2(g.w, has_g, p.w, l, e + 3));
}

// element e's penalty term l2 * p^2
__device__ __forceinline__ float l2_term(float p, const L2& l, int e) {
  return __fmul_rn(l2_at(l, e), __fmul_rn(p, p));
}

__device__ __forceinline__ float l2_term(float4 p, const L2& l, int e) {
  float s = l2_term(p.x, l, e);
  s = __fadd_rn(s, l2_term(p.y, l, e + 1));
  s = __fadd_rn(s, l2_term(p.z, l, e + 2));
  return __fadd_rn(s, l2_term(p.w, l, e + 3));
}

template <int M>
__device__ __forceinline__ float step(float p, float g, float& s1,
                                      float& s2, const Consts& k) {
  float u;
  if (M == kSgd) {
    u = __fmul_rn(k.neg_lr, g);
  } else if (M == kAdagrad || M == kRmsprop) {
    const float gg = __fmul_rn(g, g);
    s1 = M == kAdagrad ? __fadd_rn(s1, gg)
                       : __fadd_rn(__fmul_rn(k.d1, s1), __fmul_rn(k.c1, gg));
    u = __fdiv_rn(__fmul_rn(k.neg_lr, g), __fadd_rn(__fsqrt_rn(s1), k.eps));
  } else {
    s1 = __fadd_rn(__fmul_rn(k.c1, g), __fmul_rn(k.d1, s1));
    s2 = __fadd_rn(__fmul_rn(k.c2, __fmul_rn(g, g)), __fmul_rn(k.d2, s2));
    const float x = __fdiv_rn(__fdiv_rn(s1, k.bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(s2, k.bc2)),
                                        k.eps));
    u = __fmul_rn(k.neg_lr, x);
  }
  return __fadd_rn(p, u);
}

template <int M>
__device__ __forceinline__ float4 step(float4 p, float4 g, float4& s1,
                                       float4& s2, const Consts& k) {
  return make_float4(step<M>(p.x, g.x, s1.x, s2.x, k),
                     step<M>(p.y, g.y, s1.y, s2.y, k),
                     step<M>(p.z, g.z, s1.z, s2.z, k),
                     step<M>(p.w, g.w, s1.w, s2.w, k));
}

// Units u = threadIdx.x + kThreads * j (j < K) of a chunk of `n` units
// (floats, or float4s): every load first, then the arithmetic and stores.
template <int M, int K, typename T>
__device__ __forceinline__ void update_units(T* p, const T* g, T* s1, T* s2,
                                             int n, const L2& l,
                                             const Consts& k) {
  constexpr int kFloats = sizeof(T) / sizeof(float);
  T pv[K], gv[K], av[K], bv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = threadIdx.x + kThreads * j;
    if (u < n) {
      pv[j] = p[u];
      if (g != nullptr) {
        gv[j] = __ldg(g + u);
      } else {
        gv[j] = T{};
      }
      if (M != kSgd) av[j] = s1[u];
      if (M == kAdam) bv[j] = s2[u];
    }
  }
  if (l.v != nullptr) {  // block-uniform
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = threadIdx.x + kThreads * j;
      if (u < n) gv[j] = with_l2(gv[j], g != nullptr, pv[j], l, kFloats * u);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = threadIdx.x + kThreads * j;
    if (u < n) {
      p[u] = step<M>(pv[j], gv[j], av[j], bv[j], k);
      if (M != kSgd) s1[u] = av[j];
      if (M == kAdam) s2[u] = bv[j];
    }
  }
}

__device__ __forceinline__ std::uintptr_t addr(const void* q) {
  return reinterpret_cast<std::uintptr_t>(q);
}

// a block's chunk: its parameter (the last whose first block is at or
// before the block), the chunk's first element and its floats
struct Chunk {
  const Tensor* x;
  long long base;
  int n;
};

__device__ __forceinline__ Chunk block_chunk(const Args& a) {
  const int block = blockIdx.x;
  int t = 0;
#pragma unroll
  for (int i = 1; i < kMaxTensors; ++i) t += a.first_block[i] <= block;
  const Tensor& x = a.tensor[t];
  const long long base =
      static_cast<long long>(block - a.first_block[t]) * kChunk;
  return Chunk{&x, base, static_cast<int>(
      x.numel - base < kChunk ? x.numel - base : kChunk)};
}

template <int M>
__global__ void __launch_bounds__(kThreads)
dense_update_kernel(const __grid_constant__ Args a) {
  const Chunk c = block_chunk(a);
  const Tensor& x = *c.x;
  const long long base = c.base;
  const int n = c.n;
  Consts k{a.neg_lr, a.eps, a.d1, a.c1, a.d2, a.c2, 1.0f, 1.0f};
  if (M == kAdam) {
    k.bc1 = __ldg(a.bias);
    k.bc2 = __ldg(a.bias + 1);
  }
  float* const p = x.p + base;
  const float* const g = x.g == nullptr ? nullptr : x.g + base;
  float* const s1 = M == kSgd ? nullptr : x.s1 + base;
  float* const s2 = M == kAdam ? x.s2 + base : nullptr;
  const L2 l = chunk_l2(x, base);
  // block-uniform: 16-byte units where every array allows them
  if (((addr(p) | addr(g) | addr(s1) | addr(s2)) & 15u) == 0) {
    const int units = n >> 2;
    update_units<M, kPerThread / 4>(
        reinterpret_cast<float4*>(p), reinterpret_cast<const float4*>(g),
        reinterpret_cast<float4*>(s1), reinterpret_cast<float4*>(s2), units,
        l, k);
    const int tail = 4 * units;  // the last numel % 4 floats, as floats
    if (tail < n) {
      update_units<M, 1>(p + tail, g == nullptr ? nullptr : g + tail,
                         s1 == nullptr ? nullptr : s1 + tail,
                         s2 == nullptr ? nullptr : s2 + tail, n - tail,
                         shifted(l, tail), k);
    }
  } else {
    update_units<M, kPerThread>(p, g, s1, s2, n, l, k);
  }
}

template <int M>
int launch(const Args& a, cudaStream_t stream) {
  dense_update_kernel<M><<<a.n_blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A thread's share of a chunk's penalty: units u = threadIdx.x +
// kThreads * j (j < K) of `n`, all loads first, then summed in j's order.
template <int K, typename T>
__device__ __forceinline__ float penalty_units(const T* p, int n,
                                               const L2& l) {
  constexpr int kFloats = sizeof(T) / sizeof(float);
  T pv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = threadIdx.x + kThreads * j;
    if (u < n) pv[j] = __ldg(p + u);
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = threadIdx.x + kThreads * j;
    if (u < n) s = __fadd_rn(s, l2_term(pv[j], l, kFloats * u));
  }
  return s;
}

// The block's sum of each thread's v, in a fixed order (the warps' shuffle
// trees, then the warps in turn), in thread 0.  Every thread calls it.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  __syncthreads();  // warp_sums is free from an earlier call
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
  }
  return s;
}

// The penalty sum_i l2[i % period] * p_i^2 of every parameter of `a` into
// *out (added to it with `accumulate`, the launches after a plan's first):
// each block's sum into partials[block], then the last block to count
// itself done adds them in block order and sets the count back to 0.
__global__ void __launch_bounds__(kThreads)
dense_penalty_kernel(const __grid_constant__ Args a, float* partials,
                     unsigned int* done, float* out, int accumulate) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ bool last;
  const Chunk c = block_chunk(a);
  const float* const p = c.x->p + c.base;
  const L2 l = chunk_l2(*c.x, c.base);
  float s;
  if ((addr(p) & 15u) == 0) {
    const int units = c.n >> 2;
    s = penalty_units<kPerThread / 4>(reinterpret_cast<const float4*>(p),
                                      units, l);
    const int tail = 4 * units;
    if (tail < c.n) {
      s = __fadd_rn(s, penalty_units<1>(p + tail, c.n - tail,
                                        shifted(l, tail)));
    }
  } else {
    s = penalty_units<kPerThread>(p, c.n, l);
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();  // the partial is seen before the count
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v = 0.0f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    v = __fadd_rn(v, __ldcg(partials + b));  // from L2: other SMs wrote them
  }
  v = block_sum(v, warp_sums);
  if (threadIdx.x == 0) {
    *out = accumulate ? __fadd_rn(*out, v) : v;
    *done = 0u;
  }
}

// the struct's sizes in range, and a period for every L2 vector
bool valid(const Args* args) {
  if (args == nullptr || args->n_tensors <= 0 ||
      args->n_tensors > kMaxTensors || args->n_blocks <= 0) {
    return false;
  }
  for (int i = 0; i < args->n_tensors; ++i) {
    if (args->tensor[i].l2 != nullptr && args->tensor[i].period <= 0) {
      return false;
    }
  }
  return true;
}

}  // namespace

// The layout the host mirrors: sizeof(Args), kMaxTensors and kChunk.
extern "C" int dense_update_args_bytes() { return sizeof(Args); }
extern "C" int dense_update_capacity() { return kMaxTensors; }
extern "C" int dense_update_chunk() { return kChunk; }

// Launches one kernel over `args` (a host struct, copied into the launch's
// parameters) on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks types, shapes and contiguity, plans the blocks and
// keeps every buffer alive until the kernel has run.
extern "C" int dense_update_f32(const void* args_ptr, void* stream) {
  const Args* args = static_cast<const Args*>(args_ptr);
  if (!valid(args)) return static_cast<int>(cudaErrorInvalidValue);
  if (args->mode == kAdam && args->bias == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->mode) {
    case kSgd:
      return launch<kSgd>(*args, s);
    case kAdagrad:
      return launch<kAdagrad>(*args, s);
    case kRmsprop:
      return launch<kRmsprop>(*args, s);
    case kAdam:
      return launch<kAdam>(*args, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the penalty's kernel over `args` (every parameter with an L2
// vector; the optimizer's fields unread) on `stream`: `partials` holds a
// float for each of its blocks, `done` an unsigned count that is 0 before
// the launch and after it, `out` the float the sum goes to (or is added to,
// with `accumulate`).  Returns cudaGetLastError() (0 on success).
extern "C" int dense_penalty_f32(const void* args_ptr, void* partials,
                                 void* done, void* out, int accumulate,
                                 void* stream) {
  const Args* args = static_cast<const Args*>(args_ptr);
  if (!valid(args) || partials == nullptr || done == nullptr ||
      out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < args->n_tensors; ++i) {
    if (args->tensor[i].l2 == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  dense_penalty_kernel<<<args->n_blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      *args, static_cast<float*>(partials),
      static_cast<unsigned int*>(done), static_cast<float*>(out),
      accumulate);
  return static_cast<int>(cudaGetLastError());
}
