// Fused CIN layer of xDeepFM for Hopper (sm_90a), forward.
//
//   out[m, o] = sum_{f,h} wt[f*H + h, o] * z[m, f*H + h]
//   z[m, f*H + h] = round_s(x[m, f] * hid[m, h])
//
// over the M = B*D rows m = (b, d) of the D-major layer: hid [M, H] (the
// layer's hidden maps), x [M, F] (the embedded fields), wt [F*H, O] (the
// 1x1 convolution's weight, K-major).  The storage type s is float32 or
// bfloat16 for all four arrays.  z is rounded to s before the product, as
// the JAX einsum forms it at the operands' dtype; the sum over K = F*H is
// float32 and is rounded once to s.
//
// What it replaces: the TPU's fused CIN kernel
// (deepctr_tpu/ops/pallas.py:_fwd_kernel, called by _cin_pallas_fwd).  Its
// point is that the [M, K] interaction z never goes to device memory: it
// is formed tile by tile on chip and fed straight into the channel-mix
// product.  This kernel keeps that and nothing else of the TPU blocking.
//
// What bounds it: operations.  xDeepFM at the Criteo bench width (B=4096,
// D=16, F=26, layers 256-128 with split_half) runs two layers, K = 676,
// O = 256 and K = 3328, O = 128, over M = 65536 rows: 2*M*K*O = 22.7 and
// 55.8 GFLOP, 78.5 GFLOP a forward, 0.079 ms at the card's 989 TFLOP/s
// bf16 tensor-core rate (1.2 ms at 67 TFLOP/s of float32 FMAs).  The bytes
// are few beside that: layer 1 reads 16.8 MB of hid and x and writes
// 16.8 MB at bf16, 0.011 ms at 3.35 TB/s.
//
// What the design does about that: two register-tiled products, each a
// block owning a 128-row by 128-column output tile and building its z
// tiles in shared memory from the hid and x rows it owns, beside a staged
// wt tile.  bfloat16 storage runs on the tensor cores (cin_mix_mma_kernel,
// below: mma.sync m16n8k16, float32 accumulate), which is what the bound
// asks for; float32 storage, which the tensor cores would round (TF32),
// and bfloat16 rows too wide for shared memory run float32 FMAs on the
// CUDA cores (cin_mix_kernel: an 8 x 8 micro-tile a thread, the next K
// step's loads in flight during the current step's FMAs).  Every output
// element is one fixed sequence of sums over K, with no atomics, so a
// repeat launch gives the same bits.  Ragged M, K and O are masked with
// zeros.  wgmma fed by TMA, and a pipeline of z tiles, are the later work
// that approaches the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // output rows of a block
constexpr int kBN = 128;       // output columns of a block
constexpr int kBK = 8;         // K step
constexpr int kZPad = 4;       // row pad of the z tile: conflict-free stores
constexpr int kZLoads = kBM * kBK / kThreads;   // 4 z elements a thread
constexpr int kWLoads = kBK * kBN / kThreads;   // 4 wt elements a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the product rounded to the storage type, held as float32
__device__ __forceinline__ float round_s(float v, const float*) { return v; }
__device__ __forceinline__ float round_s(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_s(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_s(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
cin_mix_kernel(const S* __restrict__ hid, long long ld_h,
               const S* __restrict__ x, long long ld_x,
               const S* __restrict__ wt, S* __restrict__ out, long long M,
               int H, int F, int O) {
  __shared__ __align__(16) float zs[kBK][kBM + kZPad];
  __shared__ __align__(16) float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = H * F;
  // the thread's micro-tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3} (float4 shared-memory
  // reads without bank conflicts)
  const int tx = tid % 16;
  const int ty = tid / 16;

  // the z elements this thread forms: (row mm, k kk) with kk fastest, so
  // neighbouring threads read neighbouring hid values of a row
  float zr[kZLoads];
  float wr[kWLoads];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kZLoads; ++i) {
      const int e = tid + i * kThreads;
      const int mm = e / kBK;
      const int k = k0 + e % kBK;
      const long long m = m0 + mm;
      float v = 0.f;
      if (m < M && k < K) {
        const int f = k / H;
        const int h = k - f * H;
        v = round_s(to_f(x[m * ld_x + f]) * to_f(hid[m * ld_h + h]), hid);
      }
      zr[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / kBN;
      const int n = n0 + e % kBN;
      wr[i] = (k < K && n < O)
                  ? to_f(wt[static_cast<long long>(k) * O + n]) : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kZLoads; ++i) {
      const int e = tid + i * kThreads;
      zs[e % kBK][e / kBK] = zr[i];
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int e = tid + i * kThreads;
      ws[e / kBN][e % kBN] = wr[i];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tile(k0 + kBK);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&zs[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&zs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < O) store_s(out + m * O + n, acc[i][j]);
    }
  }
}

template <typename S>
int launch(const void* hid, long long ld_h, const void* x, long long ld_x,
           const void* wt, void* out, long long M, int H, int F, int O,
           cudaStream_t stream) {
  const long long row_blocks = (M + kBM - 1) / kBM;
  const dim3 grid(static_cast<unsigned>(row_blocks), (O + kBN - 1) / kBN);
  cin_mix_kernel<S><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(hid), ld_h, static_cast<const S*>(x), ld_x,
      static_cast<const S*>(wt), static_cast<S*>(out), M, H, F, O);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 storage: the same tiling on the tensor cores
// ---------------------------------------------------------------------------
//
// A block of 256 threads (8 warps, 2 x 4) owns a 128 x 128 output tile and
// walks K in steps of 32.  It first copies its 128 rows of hid and x into
// shared memory; for each step it forms the [128, 32] bfloat16 z tile from
// them (each thread 2 runs of 8 products, rounded to bfloat16 in pairs)
// and stages the [32, 128] wt tile, then each warp runs its 64 x 32 part
// as 4 x 4 mma.sync m16n8k16 (bfloat16 in, float32 accumulate) per 16 of
// K, fed by ldmatrix (the wt tile transposed on the way).  The products of
// two bfloat16 values are exact in float32, so this computes the same sum
// as the float32 path, in another order; the sum of each output element is
// still one fixed sequence of mma steps.  It takes shapes whose rows fit
// in shared memory beside the tiles (H + F <= kMaxMmaRowElems); others run
// the float32-FMA kernel above.

constexpr int kMBM = 128;
constexpr int kMBN = 128;
constexpr int kMBK = 32;
constexpr int kAStride = kMBK + 8;    // z tile row, bf16: conflict-free
constexpr int kBStride = kMBN + 8;    // wt tile row, bf16: conflict-free
constexpr int kTileBytes = (kMBM * kAStride + kMBK * kBStride) * 2;
constexpr int kMaxMmaRowElems = 360;  // two blocks an SM fit

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__global__ void __launch_bounds__(kThreads, 2)
cin_mix_mma_kernel(const __nv_bfloat16* __restrict__ hid, long long ld_h,
                   const __nv_bfloat16* __restrict__ x, long long ld_x,
                   const __nv_bfloat16* __restrict__ wt,
                   __nv_bfloat16* __restrict__ out, long long M, int H, int F,
                   int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kMBM * kAStride;
  __nv_bfloat16* hs = Bs + kMBK * kBStride;
  __nv_bfloat16* xs = hs + kMBM * H;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;    // rows wm*64 .. +63 of the tile
  const int wn = warp >> 1;   // columns wn*32 .. +31
  const long long m0 = static_cast<long long>(blockIdx.x) * kMBM;
  const int n0 = blockIdx.y * kMBN;
  const int K = H * F;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // 16-byte rows of wt where O and the base allow
  const bool wt_vectors =
      (O & 7) == 0 && (reinterpret_cast<unsigned long long>(wt) & 15) == 0;

  for (int e = tid; e < kMBM * H; e += kThreads) {
    const int mm = e / H;
    const long long m = m0 + mm;
    hs[e] = m < M ? hid[m * ld_h + (e - mm * H)] : zero;
  }
  for (int e = tid; e < kMBM * F; e += kThreads) {
    const int mm = e / F;
    const long long m = m0 + mm;
    xs[e] = m < M ? x[m * ld_x + (e - mm * F)] : zero;
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += kMBK) {
    __syncthreads();   // the rows are staged; the last tiles are consumed
    // the z tile: runs of 8 consecutive k of one row
#pragma unroll
    for (int c = tid; c < kMBM * (kMBK / 8); c += kThreads) {
      const int mm = c >> 2;
      const int kc = (c & 3) * 8;
      int k = k0 + kc;
      int f = k / H;
      int h = k - f * H;
      const __nv_bfloat16* hrow = hs + mm * H;
      const __nv_bfloat16* xrow = xs + mm * F;
      float v[8];
      if (k + 8 <= K && h + 8 <= H) {   // one field: x is constant
        const float xv = __bfloat162float(xrow[f]);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = xv * __bfloat162float(hrow[h + i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = k < K ? __bfloat162float(xrow[f]) * __bfloat162float(hrow[h])
                       : 0.f;
          ++k;
          if (++h == H) {
            h = 0;
            ++f;
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[mm * kAStride + kc]) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
    // the wt tile, rows of kMBN columns
    if (wt_vectors) {
#pragma unroll
      for (int c = tid; c < kMBK * (kMBN / 8); c += kThreads) {
        const int kk = c >> 4;
        const int nn = (c & 15) * 8;
        const int k = k0 + kk;
        const int n = n0 + nn;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < K && n < O) {
          v = *reinterpret_cast<const uint4*>(
              wt + static_cast<long long>(k) * O + n);
        }
        *reinterpret_cast<uint4*>(&Bs[kk * kBStride + nn]) = v;
      }
    } else {
      for (int c = tid; c < kMBK * kMBN; c += kThreads) {
        const int kk = c / kMBN;
        const int nn = c - kk * kMBN;
        const int k = k0 + kk;
        const int n = n0 + nn;
        Bs[kk * kBStride + nn] =
            (k < K && n < O) ? wt[static_cast<long long>(k) * O + n] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kMBK; ks += 16) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldmatrix_x4(a[mt], &As[(wm * 64 + mt * 16 + (lane & 15)) * kAStride +
                               ks + (lane >> 4) * 8]);
      }
      unsigned b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, &Bs[(ks + (lane & 15)) * kBStride + wn * 32 +
                                 np * 16 + (lane >> 4) * 8]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
        }
      }
    }
  }

  // c0, c1 at (row g, columns 2t, 2t+1), c2, c3 at row g + 8
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + t2;
        const float lo = acc[mt][nt][2 * half];
        const float hi = acc[mt][nt][2 * half + 1];
        __nv_bfloat16* p = out + m * O + n;
        if (pairs && n + 1 < O) {
          *reinterpret_cast<unsigned*>(p) = pack_bf16(lo, hi);
        } else {
          if (n < O) *p = __float2bfloat16_rn(lo);
          if (n + 1 < O) p[1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

int launch_mma(const void* hid, long long ld_h, const void* x, long long ld_x,
               const void* wt, void* out, long long M, int H, int F, int O,
               cudaStream_t stream) {
  const int smem = kTileBytes + 2 * kMBM * (H + F);
  const cudaError_t err = cudaFuncSetAttribute(
      cin_mix_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((M + kMBM - 1) / kMBM),
                  (O + kMBN - 1) / kMBN);
  cin_mix_mma_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hid), ld_h,
      static_cast<const __nv_bfloat16*>(x), ld_x,
      static_cast<const __nv_bfloat16*>(wt),
      static_cast<__nv_bfloat16*>(out), M, H, F, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype 0 = float32, 1 = bfloat16 for hid, x, wt and out alike.  hid is
// [M, H] with row stride ld_h, x [M, F] with row stride ld_x (each row
// contiguous), wt [F*H, O] and out [M, O] contiguous.  The caller checks
// shapes, types and devices and allocates `out`.
extern "C" int cin_mix_fwd(int dtype, const void* hid, long long ld_h,
                           const void* x, long long ld_x, const void* wt,
                           void* out, long long M, int H, int F, int O,
                           void* stream) {
  if (M <= 0 || H <= 0 || F <= 0 || O <= 0 ||
      static_cast<long long>(H) * F >= (1LL << 31) ||
      (M + kBM - 1) / kBM >= (1LL << 31) || (O + kBN - 1) / kBN > 65535 ||
      ld_h < H || ld_x < F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(hid, ld_h, x, ld_x, wt, out, M, H, F,
                                       O, s);
  if (dtype == 1 && H + F <= kMaxMmaRowElems)
    return launch_mma(hid, ld_h, x, ld_x, wt, out, M, H, F, O, s);
  if (dtype == 1) return launch<__nv_bfloat16>(hid, ld_h, x, ld_x, wt, out,
                                               M, H, F, O, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
