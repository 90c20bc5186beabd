// Fused CIN layer of xDeepFM for Hopper (sm_90a), forward.
//
//   out[m, o] = sum_{f,h} wt[f*H + h, o] * z[m, f*H + h]
//   z[m, f*H + h] = round_s(x[m, f] * hid[m, h])
//
// over the M = B*D rows m = (b, d) of the D-major layer: hid [M, H] (the
// layer's hidden maps), x [M, F] (the embedded fields), wt [F*H, O] (the
// 1x1 convolution's weight, K-major).  The storage type s is float32 or
// bfloat16 for the three inputs.  z is rounded to s before the product, as
// the JAX einsum forms it at the operands' dtype; the sum over K = F*H is
// float32 and is rounded once to the output's type t: s, or float32 from
// bfloat16 operands (the JAX CIN's "carry" mode, whose einsum asks for
// preferred_element_type=float32: the float32 sum is written unrounded).
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
// What the design does about that: z is formed on chip from the rows of
// hid and x a block owns and fed straight into the product.  bfloat16
// storage runs on the tensor cores with Hopper's wgmma (cin_mix_wgmma_
// kernel, below: z in registers as wgmma's A operand, the weight's K
// tiles by TMA into a ring of shared-memory stages under mbarriers, one
// product in flight while the next fragment is formed), which is what the
// bound asks for.  float32 storage, which the tensor cores would round
// (TF32), and bfloat16 rows too wide for shared memory beside the ring run
// float32 FMAs on the CUDA cores (cin_mix_kernel: a block owns a 128 x 128
// output tile and builds its z tiles in shared memory, an 8 x 8
// micro-tile a thread, the next K step's loads in flight during the
// current step's FMAs).  That is a routing by dtype and shape
// (cin_mix_route), not a fallback.  Every output element is one fixed
// sequence of sums over K, with no atomics, so a repeat launch gives the
// same bits.  Ragged M, K and O are masked with zeros.

#include <cuda.h>
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

template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
cin_mix_kernel(const S* __restrict__ hid, long long ld_h,
               const S* __restrict__ x, long long ld_x,
               const S* __restrict__ wt, T* __restrict__ out, long long M,
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

template <typename S, typename T>
int launch(const void* hid, long long ld_h, const void* x, long long ld_x,
           const void* wt, void* out, long long M, int H, int F, int O,
           cudaStream_t stream) {
  const long long row_blocks = (M + kBM - 1) / kBM;
  const dim3 grid(static_cast<unsigned>(row_blocks), (O + kBN - 1) / kBN);
  cin_mix_kernel<S, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(hid), ld_h, static_cast<const S*>(x), ld_x,
      static_cast<const S*>(wt), static_cast<T*>(out), M, H, F, O);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 storage: wgmma with z formed in registers
// ---------------------------------------------------------------------------
//
// A block owns 128 rows across BN = 128 or 256 columns of the output (one
// column block for O <= 256: each row's z is formed once) and has 9 warps:
// two consumer warpgroups of 64 rows each and one producer warp.
//
// - The weight comes in the layout ops/cin.py:mma_weight gives it: wm
//   [Op, F*Hp], K-major, each field's H rows padded with zeros to Hp (a
//   multiple of 16) and O to Op (a multiple of 8).  So every k16 step lies
//   in one field: x is one value a row for the whole step, and the TMA
//   descriptor's strides are multiples of 16 bytes.  The padding multiplies
//   zeros and is cut from the result.
// - The producer warp's lane 0 loads [BN, 64] tiles of wm (128-byte rows,
//   128-byte swizzle) with TMA into a ring of 3 or 4 stages, each behind a
//   "full" mbarrier (TMA completes its bytes) and an "empty" one (every
//   consumer warpgroup releases it).  K past Kp and rows past Op arrive as
//   TMA's zeros.  The descriptor holds wm's address, so the host encodes
//   it at every launch (cuTensorMapEncodeTiled, reached through the
//   runtime's driver entry point: the library links no -lcuda) and passes
//   it as a __grid_constant__ argument.
// - Each consumer warpgroup stages its 64 rows of hid once with cp.async
//   (4-byte granules: a split-half view of hid strides 512 bytes and x
//   rows of F=26 bf16 are 52 bytes, neither fit for TMA), and its rows of
//   x as float32; rows past M and hid's padding are zeros.  Then for each
//   k16 step every thread forms its own A fragment of z, rows g and g + 8
//   of its warp's 16, columns 2t, 2t+1, 2t+8, 2t+9: four 32-bit
//   shared-memory loads of hid pairs, two products each by the row's x,
//   rounded to bfloat16 in pairs (cvt.rn), as the JAX einsum rounds z.  z
//   is never written to shared memory.
// - The fragment feeds wgmma.mma_async m64n128k16 (bf16 in, float32
//   accumulate), one or two a step for BN = 128 or 256, with one wgmma
//   group kept in flight: the next step's fragment is formed while the
//   last product runs, into the other of two register sets (the one in
//   flight is not touched until wgmma.wait_group 1 says it is done).
//   ptxas keeps it so at BN = 256; at BN = 128 it waits after every
//   product (C7513).  The ways measured to keep BN = 128's group in
//   flight (two m64n64 products a fragment, one block an SM) were slower
//   on the card than two blocks an SM, serialised.
// - Every output is one fixed sequence of wgmma steps over K, with no
//   atomics, so a repeat launch gives the same bits; the products of two
//   bfloat16 values are exact in float32, so the sum is the float32 path's
//   in another order, rounded once to bfloat16, or written as it is where
//   the output is float32 (the instances of T = float).
// - BN = 256 runs one block an SM: 288 threads leave each thread up to
//   224 registers, which its 128 accumulators need (no setmaxnreg).  BN =
//   128 (64 accumulators) runs two, so that one block's row staging and
//   stores overlap the other's products.  Blocks of 256 rows, which halve
//   the L2 bytes of wm, measured no faster: L2 does not bound it.
// It takes shapes whose staged rows fit in shared memory beside the ring
// (cin_mix_route); others run the float32-FMA kernel above.

constexpr int kStageK = 64;             // bf16 of a 128-byte swizzled row
constexpr int kMmaThreads = 288;        // 2 consumer warpgroups + 1 warp
constexpr int kMmaRows = 128;
// stages of the ring, and blocks an SM, by BN = 128 NCH
template <int NCH>
struct Ring {
  static constexpr int stages = NCH == 1 ? 3 : 4;
  static constexpr int blocks = NCH == 1 ? 2 : 1;
};
constexpr int kMaxSmem = 232448;        // a block's dynamic shared memory

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct MmaShape {
  int Hp, Op, Kp, BN, HS, XF, smem;
};

MmaShape mma_shape(int H, int F, int O) {
  MmaShape s;
  s.Hp = round_up(H, 16);
  s.Op = round_up(O, 8);
  s.Kp = F * s.Hp;
  s.BN = s.Op <= 128 ? 128 : 256;
  s.HS = s.Hp + 8;          // row stride of hid, bf16: conflict-free pairs
  s.XF = F | 1;             // row stride of x, float32: conflict-free
  const int stages = s.BN == 128 ? Ring<1>::stages : Ring<2>::stages;
  s.smem = 1024 + stages * s.BN * 128 + 2 * stages * 8 + 16 +
           kMmaRows * (s.HS * 2 + s.XF * 4);
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// waits for the phase of `parity` to complete; a wait that never ends is a
// fault of the pipeline, and traps (a launch error) rather than hang
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<unsigned long long>(map)),
         "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving or reusing a register across this point:
// a wgmma in flight still reads its A fragment and writes its accumulators
__device__ __forceinline__ void hold(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void hold(unsigned& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// K-major B tile, 128-byte rows with 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO), the leading offset unused
__device__ __forceinline__ unsigned long long b_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// two neighbouring outputs, p 4-byte (bfloat16) or 8-byte (float) aligned
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float lo,
                                           float hi) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// two bf16 of hid (a 32-bit pair) times the row's x, rounded to a bf16 pair
__device__ __forceinline__ unsigned mul_pack(unsigned pair, float xv) {
  const float lo = __uint_as_float(pair << 16);
  const float hi = __uint_as_float(pair & 0xffff0000u);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo * xv, hi * xv);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int B>
struct Buf {
  static constexpr int value = B;
};

template <int NCH, typename T>
__global__ void __launch_bounds__(kMmaThreads, Ring<NCH>::blocks)
cin_mix_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ hid, long long ld_h,
                     const __nv_bfloat16* __restrict__ x, long long ld_x,
                     T* __restrict__ out, long long M, int H,
                     int F, int O, int Hp, int HS, int XF, int hid_pairs) {
  constexpr int BN = 128 * NCH;
  constexpr unsigned kStageBytes = BN * 128;
  constexpr int kStages = Ring<NCH>::stages;
  // the ring at a 1024-byte boundary (128-byte swizzle), found as an
  // offset into the shared array so that every pointer below stays a
  // shared-memory one (ld.shared, not generic loads)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem + kStages * kStageBytes);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(
      smem + kStages * kStageBytes + 2 * kStages * 8 + 16);
  float* xs = reinterpret_cast<float*>(hs + kMmaRows * HS);
  const unsigned ring = smem_u32(smem);
  const unsigned full0 = smem_u32(bars);
  const unsigned empty0 = full0 + kStages * 8;

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kMmaRows;
  const int n0 = blockIdx.y * BN;
  const int Kp = F * Hp;
  const int n_steps = Kp / 16;
  const int n_loads = (Kp + kStageK - 1) / kStageK;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer warp: wm tiles into the ring
    if (tid == 256) {
      for (int j = 0; j < n_loads; ++j) {
        const int slot = j % kStages;
        if (j >= kStages) mbar_wait(empty0 + 8 * slot, ((j / kStages) - 1) & 1);
        mbar_expect_tx(full0 + 8 * slot, kStageBytes);
        tma_load_2d(ring + slot * kStageBytes, &wmap, j * kStageK, n0,
                    full0 + 8 * slot);
      }
    }
    return;
  }

  // a consumer warpgroup: its 64 rows of hid and x, then the products
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = wg * 64;
  {
    const int pairs = HS / 2;
    for (int c = wtid; c < 64 * pairs; c += 128) {
      const int r = wg_row0 + c / pairs;
      const int h = 2 * (c % pairs);
      const long long m = m0 + r;
      __nv_bfloat16* dst = hs + r * HS + h;
      if (m < M && h < H && hid_pairs) {
        cp_async_4(smem_u32(dst), hid + m * ld_h + h);
      } else {
        __nv_bfloat162 v;
        v.x = (m < M && h < H) ? hid[m * ld_h + h] : __float2bfloat16_rn(0.f);
        v.y = (m < M && h + 1 < H) ? hid[m * ld_h + h + 1]
                                   : __float2bfloat16_rn(0.f);
        *reinterpret_cast<__nv_bfloat162*>(dst) = v;
      }
    }
    for (int c = wtid; c < 64 * XF; c += 128) {
      const int r = wg_row0 + c / XF;
      const int f = c % XF;
      const long long m = m0 + r;
      xs[r * XF + f] =
          (m < M && f < F) ? __bfloat162float(x[m * ld_x + f]) : 0.f;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }

  // the thread's rows: r0 and r0 + 8
  const int r0 = wg_row0 + ((wtid >> 5) << 4) + g;
  const int r1 = r0 + 8;
  float acc[NCH][64];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[c][i] = 0.f;
  }
  unsigned a[2][4] = {};
  const unsigned* hs32 = reinterpret_cast<const unsigned*>(hs);
  const int p0 = r0 * (HS / 2) + t, p1 = r1 * (HS / 2) + t;
  int f = 0, h0 = 0;

  auto step = [&](auto buf, int s) {
    constexpr int b = decltype(buf)::value;
    const int j = s >> 2;
    if ((s & 3) == 0) mbar_wait(full0 + 8 * (j % kStages), (j / kStages) & 1);
    const float xv0 = xs[r0 * XF + f];
    const float xv1 = xs[r1 * XF + f];
    const int hc = h0 >> 1;
    a[b][0] = mul_pack(hs32[p0 + hc], xv0);
    a[b][1] = mul_pack(hs32[p1 + hc], xv1);
    a[b][2] = mul_pack(hs32[p0 + hc + 4], xv0);
    a[b][3] = mul_pack(hs32[p1 + hc + 4], xv1);
    wgmma_fence();
    const unsigned long long desc =
        b_desc(ring + (j % kStages) * kStageBytes) + (s & 3) * 2;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      wgmma_n128(acc[c], a[b], desc + c * ((128 * 128) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 4; ++i) hold(a[1 - b][i]);
    // step s - 1 is done: the last of its stage releases the stage
    if (s >= 1 && ((s - 1) & 3) == 3 && wtid == 0) {
      mbar_arrive(empty0 + 8 * (((s - 1) >> 2) % kStages));
    }
    h0 += 16;
    if (h0 == Hp) {
      h0 = 0;
      ++f;
    }
  };

#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 64; ++i) hold(acc[c][i]);
  }
  for (int s = 0; s < n_steps; s += 2) {
    step(Buf<0>(), s);
    if (s + 1 < n_steps) step(Buf<1>(), s + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hold(a[0][i]);
    hold(a[1][i]);
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 64; ++i) hold(acc[c][i]);
  }

  // d[4j + {0,1}] at (row g, columns 8j + 2t, +1), d[4j + {2,3}] at row g+8
  const bool pairs_ok = (O & 1) == 0;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int n = n0 + c * 128 + jj * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + (half ? r1 : r0);
        if (m >= M) continue;
        const float lo = acc[c][4 * jj + 2 * half];
        const float hi = acc[c][4 * jj + 2 * half + 1];
        T* p = out + m * O + n;
        if (pairs_ok && n + 1 < O) {
          store_pair(p, lo, hi);
        } else {
          if (n < O) store_s(p, lo);
          if (n + 1 < O) store_s(p + 1, hi);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, so that the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

template <int NCH, typename T>
int launch_wgmma(const MmaShape& s, const void* hid, long long ld_h,
                 const void* x, long long ld_x, const void* wm, void* out,
                 long long M, int H, int F, int O, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // wm [Op, Kp] bf16, K contiguous: dims innermost first
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(s.Kp),
                              static_cast<cuuint64_t>(s.Op)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(s.Kp) * 2};
  const cuuint32_t box[2] = {kStageK, static_cast<cuuint32_t>(128 * NCH)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(wm), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        cin_mix_wgmma_kernel<NCH, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const bool hid_pairs =
      (H % 2) == 0 && (ld_h % 2) == 0 &&
      (reinterpret_cast<unsigned long long>(hid) & 3) == 0;
  const dim3 grid(static_cast<unsigned>((M + kMmaRows - 1) / kMmaRows),
                  (s.Op + 128 * NCH - 1) / (128 * NCH));
  cin_mix_wgmma_kernel<NCH, T><<<grid, kMmaThreads, s.smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(hid), ld_h,
      static_cast<const __nv_bfloat16*>(x), ld_x,
      static_cast<T*>(out), M, H, F, O, s.Hp, s.HS, s.XF,
      hid_pairs ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 where bfloat16 storage of these shapes takes the wgmma kernel
// (cin_mix_mma_fwd, with the weight in mma_weight's layout), else 0: the
// float32-FMA kernel (cin_mix_fwd).
extern "C" int cin_mix_route(int dtype, int H, int F, int O) {
  if (dtype != 1 || H <= 0 || F <= 0 || O <= 0) return 0;
  return mma_shape(H, F, O).smem <= kMaxSmem ? 1 : 0;
}

// The float32-FMA kernel.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  dtype 0 = float32, 1 = bfloat16 for
// hid, x and wt alike; out_dtype the same codes for out: dtype's, or 0
// (float32) from bfloat16 operands.  hid is [M, H] with row stride ld_h,
// x [M, F] with row stride ld_x (each row contiguous), wt [F*H, O] and out
// [M, O] contiguous.  The caller checks shapes, types and devices and
// allocates `out`.
extern "C" int cin_mix_fwd(int dtype, int out_dtype, const void* hid,
                           long long ld_h, const void* x, long long ld_x,
                           const void* wt, void* out, long long M, int H,
                           int F, int O, void* stream) {
  if (M <= 0 || H <= 0 || F <= 0 || O <= 0 ||
      static_cast<long long>(H) * F >= (1LL << 31) ||
      (M + kBM - 1) / kBM >= (1LL << 31) || (O + kBN - 1) / kBN > 65535 ||
      ld_h < H || ld_x < F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0) {
    return launch<float, float>(hid, ld_h, x, ld_x, wt, out, M, H, F, O, s);
  }
  if (dtype == 1 && out_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(hid, ld_h, x, ld_x, wt, out,
                                                M, H, F, O, s);
  }
  if (dtype == 1 && out_dtype == 0) {
    return launch<__nv_bfloat16, float>(hid, ld_h, x, ld_x, wt, out, M, H,
                                        F, O, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma kernel, bfloat16 operands only, for shapes cin_mix_route
// takes; out_dtype 1 writes bfloat16, 0 float32.  wm is [Op, F*Hp]
// contiguous and 16-byte aligned (ops/cin.py:mma_weight); the rest as for
// cin_mix_fwd.
extern "C" int cin_mix_mma_fwd(int out_dtype, const void* hid,
                               long long ld_h, const void* x, long long ld_x,
                               const void* wm, void* out, long long M, int H,
                               int F, int O, void* stream) {
  if (M <= 0 || !cin_mix_route(1, H, F, O) || ld_h < H || ld_x < F ||
      (out_dtype != 0 && out_dtype != 1) ||
      (M + kMmaRows - 1) / kMmaRows >= (1LL << 31) ||
      (reinterpret_cast<unsigned long long>(wm) & 15) != 0 ||
      static_cast<long long>(F) * round_up(H, 16) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MmaShape s = mma_shape(H, F, O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) {
    if (s.BN == 128) {
      return launch_wgmma<1, float>(s, hid, ld_h, x, ld_x, wm, out, M, H, F,
                                    O, st);
    }
    return launch_wgmma<2, float>(s, hid, ld_h, x, ld_x, wm, out, M, H, F, O,
                                  st);
  }
  if (s.BN == 128) {
    return launch_wgmma<1, __nv_bfloat16>(s, hid, ld_h, x, ld_x, wm, out, M,
                                          H, F, O, st);
  }
  return launch_wgmma<2, __nv_bfloat16>(s, hid, ld_h, x, ld_x, wm, out, M, H,
                                        F, O, st);
}
