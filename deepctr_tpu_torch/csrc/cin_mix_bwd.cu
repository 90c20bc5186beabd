// Backward of the fused CIN layer of xDeepFM (csrc/cin_mix.cu) for Hopper
// (sm_90a), bfloat16 storage:
//
//   dz[m, f*H + h] = round_s(sum_o g[m, o] * wt[f*H + h, o])
//   dh[m, h]       = sum_f dz[m, f*H + h] * x[m, f]
//   dx[m, f]       = sum_h dz[m, f*H + h] * hid[m, h]
//   dwt[f*H + h, o] = sum_m z[m, f*H + h] * g[m, o]
//   z[m, f*H + h]  = round_s(x[m, f] * hid[m, h])
//
// over the M = B*D rows m = (b, d) of the D-major layer: g [M, O] the
// cotangent of the layer's output, hid [M, H] and x [M, F] the forward's
// operands at their row strides, wt [F*H, O] its weight.  Every sum is
// float32 and is rounded once to bfloat16; dz is rounded to bfloat16 before
// it is reduced, as ops/cin.py:cin_mix_bwd's einsums round it.
//
// What it replaces: no TPU kernel.  The JAX package differentiates its CIN
// kernel with XLA einsums (deepctr_tpu/ops/pallas.py:_cin_mix_bwd), and so
// did the port (cin_mix_bwd): they write dz [M, F*H] and form z anew, both
// to device memory, and run the dh and dx contractions as batched
// matrix-vector products.
//
// What bounds it: operations.  xDeepFM at the paper's Criteo widths (B =
// 4096, D = 10, F = 26, three layers of 200 maps) makes two products of 2 *
// M * F*H * O a layer, 363 GFLOP a step over its three layers: 0.367 ms at
// the card's 989 TFLOP/s.  The bytes that must move (g, hid, x and wt read
// once, dh, dx and dwt written once) are about 150 MB, 0.045 ms at 3.35
// TB/s; dz and z would add 426 MB each a layer.
//
// What the design does about that: neither dz nor z reaches device memory.
// Four kernels; the products on wgmma (bfloat16 in, float32 sums):
//
// - cin_bwd_tile_kernel lays g and wt out as the products' shared-memory
//   tiles ([rows, 64] bfloat16 with TMA's 128-byte swizzle, zeros past the
//   edges), so that every tile is one contiguous TMA bulk copy: 2-D TMA
//   boxes of 128-byte rows at g's and wt's 400-byte strides fed the
//   products about half as fast on the card.
// - cin_bwd_data_wgmma_kernel: a block owns 128 rows, one consumer
//   warpgroup 64 of them, and a producer warpgroup (registers handed to
//   the consumers with setmaxnreg) whose one thread brings the block's
//   rows of g once, the A operand of every product, then walks wt's tiles
//   through a ring of stages.  A pair (an H chunk of NT maps, FG fields) is
//   one m64n(FG*NT)k16 product over K = O; its epilogue rounds dz to
//   bfloat16 and reduces it at once, dh in registers (the fields in order)
//   and dx over the quad's lanes (the chunks through shared memory).  The
//   two warpgroups take turns on the tensor cores (named barriers), so
//   that one reduces while the other's product runs: the epilogue's
//   arithmetic is most of the product's time.  H = 26 takes four fields of
//   32 maps a product, H = 200 two fields of one of its two 104-map chunks.
// - cin_bwd_weight_wgmma_kernel: a block owns 128 rows of dwt (4 fields by
//   32 maps at H = 26 and 200: 128 / HB fields by HB maps) across NO
//   columns, over one split of the rows m.  For each 64-row chunk the
//   consumers form z in shared memory (one 16-byte load of hid and one of
//   x for 8 values) as the MN-major A operand, from rows of hid and x
//   staged three chunks ahead with cp.async, while the last chunk's
//   products run; g's chunk tiles come by TMA as the MN-major B operand.
//   Each split writes its float32 sums to a partial [splits, F*H, O].
// - cin_bwd_weight_reduce_kernel sums the partials in split order and
//   rounds once to bfloat16, in wt's layout.
//
// The weight kernels run on a second stream beside the data kernel
// (ops/cin.py:bwd_launch), so that each fills the other's last wave.
// Every output is one fixed sequence of float32 sums, with no atomics, so
// a repeat launch gives the same bits.  cin_mix_bwd_plan chooses the
// tiling of a shape; shapes whose tiles do not fit shared memory are not
// taken (ops/cin.py:bwd_route) and keep the einsums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 288;       // weight kernel: 2 warpgroups and a warp
constexpr int kDataThreads = 384;   // data kernel: 3 warpgroups, 1 the producer
constexpr int kRows = 128;              // rows a block: data (m), weight (k)
constexpr int kStageK = 64;             // bf16 of a 128-byte swizzled row
constexpr int kTile = 64 * 128;         // bytes of a [64, 64] bf16 tile
constexpr int kMaxSmem = 232448;        // a block's dynamic shared memory
constexpr int kMaxStages = 12;
constexpr int kXTile = 64 * 8 * 2;      // bytes of a chunk's x tile

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// the data kernel's fields a wt tile (FG): a product of FG * NT maps
__host__ __device__ constexpr int fields_a_tile(int NT) {
  return NT == 32 ? 4 : 2;
}

// the shared memory of each kernel
__host__ __device__ inline int data_smem(int NB, int nch, int XF, int nkc,
                                         int stages) {
  return 1024 + 2 * nkc * kTile + stages * NB * 128 +
         round_up(8 * (2 * stages + 1), 16) +
         kRows * XF * 4 * (nch > 1 ? 2 : 1);
}

__host__ __device__ inline int weight_smem(int NO, int hb_log2, int stages) {
  return 1024 +
         stages * (((NO + 63) / 64) * kTile + 64 * (1 << hb_log2) * 2 +
                   kXTile) +
         2 * kRows * 128 + round_up(8 * 2 * stages, 16);
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

// a contiguous run of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory by the TMA unit, completing on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
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
// a wgmma in flight still writes its accumulators
__device__ __forceinline__ void hold(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// a K-major tile of 128-byte rows with 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO), the leading offset unused (csrc/cin_mix.cu's b_desc)
__device__ __forceinline__ unsigned long long k_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// an MN-major B tile with 128-byte swizzle: rows are K (128 bytes = 64
// columns of N each), 8-row K groups 1024 bytes apart (SBO), [64, 64]
// tiles of N 8192 bytes apart (LBO)
__device__ __forceinline__ unsigned long long mn_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (512ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float lo_bf16(unsigned pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned pair) {
  return __uint_as_float(pair & 0xffff0000u);
}
__device__ __forceinline__ float bf16_bits(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// wgmma.mma_async m64nNk16 from shared memory, bfloat16 in, float32 sums
// (scale_d 0 starts the sum).  wgmma_ss: A and B K-major tiles;
// wgmma_ss_mn: A and B MN-major tiles.  Overloaded on d's length, N / 2.

__device__ __forceinline__ void wgmma_ss(float (&d)[64],
                                        unsigned long long da,
                                        unsigned long long db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[104],
                                        unsigned long long da,
                                        unsigned long long db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[52],
                                        unsigned long long da,
                                        unsigned long long db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32],
                                          unsigned long long da,
                                          unsigned long long db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64],
                                          unsigned long long da,
                                          unsigned long long db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[104],
                                          unsigned long long da,
                                          unsigned long long db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[128],
                                          unsigned long long da,
                                          unsigned long long db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


// ---------------------------------------------------------------------------
// dz -> dh, dx
// ---------------------------------------------------------------------------
//
// A block owns 128 rows: consumer warpgroups 0 and 1 (64 rows each) and a
// producer warpgroup 2.  KR is the k16 steps of O's last 64-wide tile.
template <int N>
struct Steps {
  static constexpr int value = N;
};

template <int NT, int FG, int KR>
__global__ void __launch_bounds__(kDataThreads, 1)
cin_bwd_data_wgmma_kernel(const __nv_bfloat16* __restrict__ gt, int gcols,
                          const __nv_bfloat16* __restrict__ wtl,
                          const __nv_bfloat16* __restrict__ hid, long long ld_h,
                          const __nv_bfloat16* __restrict__ x, long long ld_x,
                          __nv_bfloat16* __restrict__ dh,
                          __nv_bfloat16* __restrict__ dx, long long M, int H,
                          int F, int O, int nch, int XF, int nkc, int stages,
                          int hid_pairs) {
  constexpr int NB = NT * FG;              // wgmma N: FG fields of NT maps
  constexpr int NA = NB / 2;               // accumulators a thread
  constexpr int NJ = NT / 8;               // 8-map groups of a field
  constexpr unsigned kStageBytes = NB * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* gsm = smem;
  unsigned char* ring = gsm + 2 * nkc * kTile;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(ring + stages * kStageBytes);
  float* xs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(bars) +
      round_up(8 * (2 * stages + 1), 16));
  float* dxs = xs + kRows * XF;
  const unsigned ring0 = smem_u32(ring);
  const unsigned full0 = smem_u32(bars);
  const unsigned empty0 = full0 + 8 * stages;
  const unsigned gbar = full0 + 16 * stages;

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nfg = (F + FG - 1) / FG;       // groups of FG fields
  const int npairs = nch * nfg;
  const int total = npairs * nkc;          // K tiles of wt, in pair order
  // K tile n of the walk (pair n / nkc's c-th: pair p is H chunk p / nfg
  // and fields FG * (p % nfg) on) into its stage: wtl holds
  // cin_bwd_tile_kernel's [FG * NT, 64] tiles in that order
  auto load_w = [&](int n) {
    const int slot = n % stages;
    mbar_expect_tx(full0 + 8 * slot, kStageBytes);
    bulk_load(ring0 + slot * kStageBytes,
              wtl + static_cast<long long>(n) * (kStageBytes / 2), kStageBytes,
              full0 + 8 * slot);
  };
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 8);        // a release from each consumer warp
    }
    mbar_init(gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread loads the block's rows of g once (its two 64-row tiles' first
    // nkc column tiles), then every K tile of wt as its stage frees
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const int g_tiles = min(2, static_cast<int>((M + 63) / 64) -
                                     2 * static_cast<int>(blockIdx.x));
      mbar_expect_tx(gbar, g_tiles * nkc * kTile);
      for (int w = 0; w < g_tiles; ++w) {
        bulk_load(smem_u32(gsm + w * nkc * kTile),
                  gt + (2LL * blockIdx.x + w) * gcols * (kTile / 2),
                  nkc * kTile, gbar);
      }
      for (int n = 0; n < total; ++n) {
        if (n >= stages) {
          mbar_wait(empty0 + 8 * (n % stages), ((n / stages) - 1) & 1);
        }
        load_w(n);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // each consumer warpgroup stages its 64 rows of x, a warp a row at a time
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = wg * 64;
  for (int r = wg_row0 + (wtid >> 5); r < wg_row0 + 64; r += 4) {
    const long long m = m0 + r;
    for (int f = lane; f < XF; f += 32) {
      xs[r * XF + f] =
          (m < M && f < F) ? __bfloat162float(x[m * ld_x + f]) : 0.f;
    }
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

  // the thread's rows: r0 and r0 + 8
  const int r0 = wg_row0 + ((wtid >> 5) << 4) + g;
  const int r1 = r0 + 8;
  float d[NA], dha[NT / 2];
#pragma unroll
  for (int i = 0; i < NA; ++i) d[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) dha[i] = 0.f;
  const unsigned gtile = smem_u32(gsm) + wg * nkc * kTile;
  const bool h_even = (H & 1) == 0;
  // the thread's hid pairs of H chunk j: rows r0 and r0 + 8, maps j*NT +
  // 8*jj + 2t and + 1, zeros past H and M
  unsigned hp[2][NJ];
  auto load_hid = [&](int j) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int h = j * NT + jj * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + (half ? r1 : r0);
        const unsigned short* row =
            reinterpret_cast<const unsigned short*>(hid + m * ld_h);
        unsigned v = 0;
        if (m < M && hid_pairs && h + 1 < H) {
          v = __ldg(reinterpret_cast<const unsigned*>(row + h));
        } else if (m < M) {
          v = (h < H ? row[h] : 0u) | ((h + 1 < H ? row[h + 1] : 0u) << 16);
        }
        hp[half][jj] = v;
      }
    }
  };
  mbar_wait(gbar, 0);

  // K tile n (the pair's c-th) of the product into d, one commit group
  auto k_tile = [&](int n, int c, auto steps) {
    constexpr int kSteps = decltype(steps)::value;
    const int slot = n % stages;
    mbar_wait(full0 + 8 * slot, (n / stages) & 1);
    wgmma_fence();
    const unsigned long long da = k_desc(gtile + c * kTile);
    const unsigned long long db = k_desc(ring0 + slot * kStageBytes);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      wgmma_ss(d, da + 2 * s, db + 2 * s, (c | s) != 0 ? 1 : 0);
    }
    wgmma_commit();
  };

  // pair p's dz (in d, complete): rounded to bfloat16 in pairs, into dh
  // (registers) and the rows' dx sums s[field][row] of its FG fields
  float s[FG][2];
  auto reduce = [&](int p) {
    const int j = p / nfg;
    const int f0 = (p - j * nfg) * FG;
    if (f0 == 0) load_hid(j);
    float xv[FG][2];
#pragma unroll
    for (int fi = 0; fi < FG; ++fi) {
      const bool ok = f0 + fi < F;
      xv[fi][0] = ok ? xs[r0 * XF + f0 + fi] : 0.f;
      xv[fi][1] = ok ? xs[r1 * XF + f0 + fi] : 0.f;
      s[fi][0] = 0.f;
      s[fi][1] = 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < NB / 8; ++jj) {
      const int fi = jj / NJ, hj = jj % NJ;
      const unsigned hp0 = hp[0][hj];
      const unsigned hp1 = hp[1][hj];
      const unsigned z0 = pack_bf16(d[4 * jj], d[4 * jj + 1]);
      const unsigned z1 = pack_bf16(d[4 * jj + 2], d[4 * jj + 3]);
      const float z00 = lo_bf16(z0), z01 = hi_bf16(z0);
      const float z10 = lo_bf16(z1), z11 = hi_bf16(z1);
      dha[4 * hj] = fmaf(z00, xv[fi][0], dha[4 * hj]);
      dha[4 * hj + 1] = fmaf(z01, xv[fi][0], dha[4 * hj + 1]);
      dha[4 * hj + 2] = fmaf(z10, xv[fi][1], dha[4 * hj + 2]);
      dha[4 * hj + 3] = fmaf(z11, xv[fi][1], dha[4 * hj + 3]);
      s[fi][0] = fmaf(z00, lo_bf16(hp0), s[fi][0]);
      s[fi][0] = fmaf(z01, hi_bf16(hp0), s[fi][0]);
      s[fi][1] = fmaf(z10, lo_bf16(hp1), s[fi][1]);
      s[fi][1] = fmaf(z11, hi_bf16(hp1), s[fi][1]);
    }
#pragma unroll
    for (int fi = 0; fi < FG; ++fi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[fi][half] += __shfl_xor_sync(0xffffffffu, s[fi][half], 1);
        s[fi][half] += __shfl_xor_sync(0xffffffffu, s[fi][half], 2);
      }
    }
  };
  // pair p's stores: its fields' dx (or the H chunk's part of them), and
  // dh where the pair ends an H chunk
  auto store = [&](int p) {
    const int j = p / nfg;
    const int f0 = (p - j * nfg) * FG;
    if (t == 0) {
#pragma unroll
      for (int fi = 0; fi < FG; ++fi) {
        const int f = f0 + fi;
        if (f >= F) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          float v = s[fi][half];
          if (j > 0) v += dxs[r * XF + f];
          if (j < nch - 1) {
            dxs[r * XF + f] = v;
          } else if (m0 + r < M) {
            dx[(m0 + r) * F + f] = __float2bfloat16_rn(v);
          }
        }
      }
    }
    if (f0 + FG >= F) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int h = j * NT + jj * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long m = m0 + (half ? r1 : r0);
          const float lo = dha[4 * jj + 2 * half];
          const float hi = dha[4 * jj + 2 * half + 1];
          if (m < M) {
            __nv_bfloat16* q = dh + m * H + h;
            if (h_even && h + 1 < H) {
              *reinterpret_cast<unsigned*>(q) = pack_bf16(lo, hi);
            } else {
              if (h < H) *q = __float2bfloat16_rn(lo);
              if (h + 1 < H) q[1] = __float2bfloat16_rn(hi);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) dha[i] = 0.f;
    }
  };

  // the two warpgroups take turns on the tensor cores: warpgroup 0 issues
  // pair p's product once warpgroup 1 has issued pair p - 1's, and
  // warpgroup 1 pair p's once warpgroup 0 has; so one reduces while the
  // other's product runs (named barriers 3 and 4)
#pragma unroll
  for (int i = 0; i < NA; ++i) hold(d[i]);
  for (int p = 0; p < npairs; ++p) {
    const int n0 = p * nkc;
    if (wg == 1) {
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
    } else if (p >= 1) {
      asm volatile("bar.sync 4, 256;\n" ::: "memory");
    }
    for (int c = 0; c < nkc - 1; ++c) k_tile(n0 + c, c, Steps<4>());
    k_tile(n0 + nkc - 1, nkc - 1, Steps<KR>());
    if (wg == 0) {
      asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    } else if (p + 1 < npairs) {
      asm volatile("bar.arrive 4, 256;\n" ::: "memory");
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NA; ++i) hold(d[i]);
    // this pair's K tiles are read: the producer may refill their stages
    if (lane == 0) {
      for (int c = 0; c < nkc; ++c) {
        mbar_arrive(empty0 + 8 * ((n0 + c) % stages));
      }
    }
    reduce(p);
    store(p);
  }
}


// ---------------------------------------------------------------------------
// z^T g -> float32 partials of dwt over splits of the rows
// ---------------------------------------------------------------------------
//
// A block owns FB = 128 / HB fields by HB maps of dwt's rows (the tile's
// row kl = fl * HB + hl is k = (f0 + fl) * H + h0 + hl) across NO columns,
// over one split of the rows m, 64 rows a chunk.  A chunk's stage holds
// g's tile (the B operand, MN-major) and the block's columns of hid and x
// (cin_bwd_tile_kernel's plain [64, HB] and [64, 8] tiles), all three
// brought by the producer warp's TMA.  Each warpgroup forms its 64 rows of
// z for the chunk in shared memory, the MN-major A operand, while the last
// chunk's products run.
template <int NO>
__global__ void __launch_bounds__(kThreads, 1)
cin_bwd_weight_wgmma_kernel(const __nv_bfloat16* __restrict__ gt, int gcols,
                            const __nv_bfloat16* __restrict__ ht,
                            const __nv_bfloat16* __restrict__ xt,
                            float* __restrict__ part, long long M, int H,
                            int F, int O, long long rows_per_split,
                            int hb_log2, int stages) {
  constexpr int NA = NO / 2;
  constexpr int kBoxes = (NO + 63) / 64;
  constexpr unsigned kGBytes = kBoxes * kTile;
  constexpr int kZBytes = kRows * 128;     // a chunk's z tile
  const int HB = 1 << hb_log2;
  const int FB = kRows >> hb_log2;
  const unsigned hbytes = 64 * HB * 2;      // a chunk's hid tile
  const unsigned stage_bytes = kGBytes + hbytes + kXTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* zs = smem + stages * stage_bytes;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(zs + 2 * kZBytes);
  const unsigned ring0 = smem_u32(smem);
  const unsigned zs0 = smem_u32(zs);
  const unsigned full0 = smem_u32(bars);
  const unsigned empty0 = full0 + 8 * stages;

  const int tid = threadIdx.x;
  const int nhb = (H + HB - 1) >> hb_log2;
  const int nfb = (F + FB - 1) / FB;
  const int fb = blockIdx.x / nhb, hb = blockIdx.x % nhb;
  const int f0 = fb * FB, h0 = hb * HB;
  const long long row_lo = blockIdx.y * rows_per_split;
  const long long row_hi = min(M, row_lo + rows_per_split);
  const int o0 = blockIdx.z * NO;
  const int nq = static_cast<int>((row_hi - row_lo + 63) / 64);

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer warp: the split's chunk tiles of g, hid and x
    if (tid == 256) {
      for (int q = 0; q < nq; ++q) {
        const int slot = q % stages;
        const long long tr = row_lo / 64 + q;
        const unsigned dst = ring0 + slot * stage_bytes;
        if (q >= stages) mbar_wait(empty0 + 8 * slot, ((q / stages) - 1) & 1);
        mbar_expect_tx(full0 + 8 * slot, stage_bytes);
        bulk_load(dst, gt + (tr * gcols + blockIdx.z * kBoxes) * (kTile / 2),
                  kGBytes, full0 + 8 * slot);
        bulk_load(dst + kGBytes, ht + (tr * nhb + hb) * (hbytes / 2), hbytes,
                  full0 + 8 * slot);
        bulk_load(dst + kGBytes + hbytes, xt + (tr * nfb + fb) * (kXTile / 2),
                  kXTile, full0 + 8 * slot);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // z of a chunk in shared memory as its warpgroup's A operand, MN-major
  // (rows are the chunk's 64 rows m, 128 bytes of 64 tile rows kl each,
  // 16-byte units swizzled as TMA's 128-byte swizzle lays them): the thread
  // forms 8 tile rows (octet `oc`) of rows rr, rr + 16, rr + 32, rr + 48,
  // each from one 16-byte load of hid and one value of x
  const int oc = wtid & 7;
  const int rr = wtid >> 3;
  const int kl0 = wg * 64 + 8 * oc;
  const int fl = kl0 >> hb_log2, hl = kl0 & (HB - 1);
  auto form_z = [&](const unsigned char* stage, int zb) {
    const unsigned short* hc =
        reinterpret_cast<const unsigned short*>(stage + kGBytes) + hl;
    const unsigned short* xc =
        reinterpret_cast<const unsigned short*>(stage + kGBytes + hbytes) +
        fl;
    unsigned char* zt = zs + zb * kZBytes + wg * (kZBytes / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rr + 16 * i;
      const uint4 hv = *reinterpret_cast<const uint4*>(hc + r * HB);
      const float xv = bf16_bits(xc[r * 8]);
      const uint4 z = make_uint4(
          pack_bf16(xv * lo_bf16(hv.x), xv * hi_bf16(hv.x)),
          pack_bf16(xv * lo_bf16(hv.y), xv * hi_bf16(hv.y)),
          pack_bf16(xv * lo_bf16(hv.z), xv * hi_bf16(hv.z)),
          pack_bf16(xv * lo_bf16(hv.w), xv * hi_bf16(hv.w)));
      *reinterpret_cast<uint4*>(zt + r * 128 + ((oc ^ (r & 7)) << 4)) = z;
    }
  };

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NA; ++i) hold(acc[i]);
  for (int q = 0; q < nq; ++q) {
    const int slot = q % stages;
    mbar_wait(full0 + 8 * slot, (q / stages) & 1);
    // z of chunk q - 2 in this buffer was read by this warpgroup's
    // products, done since the wait after chunk q - 1's
    form_z(smem + slot * stage_bytes, q & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    wgmma_fence();
    const unsigned long long da =
        mn_desc(zs0 + (q & 1) * kZBytes + wg * (kZBytes / 2));
    const unsigned long long db = mn_desc(ring0 + slot * stage_bytes);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_ss_mn(acc, da + s * (2048 >> 4), db + s * (2048 >> 4), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < NA; ++i) hold(acc[i]);
    // chunk q - 1's products are done, and this warpgroup formed its z: its
    // stage is free
    if (q >= 1 && wtid == 0) mbar_arrive(empty0 + 8 * ((q - 1) % stages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NA; ++i) hold(acc[i]);

  // acc[4j + {0,1}] at (tile row ra, columns 8j + 2t, +1), acc[4j + {2,3}]
  // at row ra + 8
  const int K = F * H;
  float* out = part + static_cast<long long>(blockIdx.y) * K * O;
  const bool pairs_ok = (O & 1) == 0;
  const int ra = wg * 64 + ((wtid >> 5) << 4) + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    const int f = f0 + (r >> hb_log2), h = h0 + (r & (HB - 1));
    if (f >= F || h >= H) continue;
    float* row = out + static_cast<long long>(f * H + h) * O;
#pragma unroll
    for (int jj = 0; jj < NO / 8; ++jj) {
      const int o = o0 + jj * 8 + 2 * t;
      const float lo = acc[4 * jj + 2 * half];
      const float hi = acc[4 * jj + 2 * half + 1];
      if (pairs_ok && o + 1 < O) {
        *reinterpret_cast<float2*>(row + o) = make_float2(lo, hi);
      } else {
        if (o < O) row[o] = lo;
        if (o + 1 < O) row[o + 1] = hi;
      }
    }
  }
}

// dwt = the partials summed in split order, rounded once to bfloat16
__global__ void cin_bwd_weight_reduce_kernel(const float* __restrict__ part,
                                             __nv_bfloat16* __restrict__ dwt,
                                             long long n, int splits) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i + 4 <= n && (n & 3) == 0) {
    float4 s = *reinterpret_cast<const float4*>(part + i);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = *reinterpret_cast<const float4*>(part + sp * n + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    unsigned* o = reinterpret_cast<unsigned*>(dwt + i);
    o[0] = pack_bf16(s.x, s.y);
    o[1] = pack_bf16(s.z, s.w);
    return;
  }
  for (long long e = i; e < i + 4 && e < n; ++e) {
    float s = part[e];
    for (int sp = 1; sp < splits; ++sp) s += part[sp * n + e];
    dwt[e] = __float2bfloat16_rn(s);
  }
}

// dst tile t, column tile ct: rows r < TR by CW columns, the tile's SCW
// (<= CW) columns of src and zeros past them.  With swz (CW = SCW = 64)
// the 16-byte chunks are swizzled as TMA's 128-byte swizzle lays them
// (chunk c of row r at c ^ (r % 8)), so that a tile copied whole is a wgmma
// operand; else the rows are plain.  Row r of tile t is src row t*TR + r
// (rows < rows), or, with field_rows > 0, wt's rows of TR / chunk fields a
// tile: tile t = j * ceil(fields / fg) + g holds fields g*fg on, chunk rows
// each, row r being field f = g*fg + r / chunk's src row f*field_rows +
// j*chunk + r % chunk (f < fields, j*chunk + r % chunk < field_rows);
// columns past cols and rows past those are zeros.
__global__ void cin_bwd_tile_kernel(const __nv_bfloat16* __restrict__ src,
                                    long long ld, long long rows, int cols,
                                    __nv_bfloat16* __restrict__ dst, int TR,
                                    int CW, int SCW, int swz,
                                    long long n_chunks, int col_tiles,
                                    int field_rows, int fields, int chunk,
                                    int vec) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_chunks) return;
  const int cpr = CW >> 3;                       // 16-byte chunks a row
  const int pc = static_cast<int>(i % cpr);      // the chunk in dst
  const long long row_id = i / cpr;              // (t, ct, r)
  const int r = static_cast<int>(row_id % TR);
  const long long tc = row_id / TR;
  const int ct = static_cast<int>(tc % col_tiles);
  const long long t = tc / col_tiles;
  long long srow;
  bool valid;
  if (field_rows > 0) {
    // tile t: H chunk j, fields g * fg on (fg = TR / chunk a tile)
    const int fg = TR / chunk;
    const long long groups = (fields + fg - 1) / fg;
    const long long j = t / groups;
    const long long f = (t - j * groups) * fg + r / chunk;
    const long long hr = j * chunk + r % chunk;
    srow = f * field_rows + hr;
    valid = f < fields && hr < field_rows;
  } else {
    srow = t * TR + r;
    valid = srow < rows;
  }
  const int lc = (swz ? (pc ^ (r & 7)) : pc) << 3;   // in the tile
  const int c0 = ct * SCW + lc;
  const int n = min(8, min(SCW - lc, cols - c0));    // source columns
  uint4 v = make_uint4(0, 0, 0, 0);
  if (valid && n > 0) {
    const __nv_bfloat16* p = src + srow * ld + c0;
    if (vec && n == 8) {
      v = *reinterpret_cast<const uint4*>(p);
    } else {
      unsigned short e[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        e[k] = k < n ? reinterpret_cast<const unsigned short*>(p)[k] : 0;
      }
      v = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                     e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    }
  }
  reinterpret_cast<uint4*>(dst)[i] = v;
}

template <typename Kernel>
int allow_smem(Kernel kernel, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <int NT, int KR>
int launch_data(const void* gt, int gcols, const void* wtl, const void* hid,
                long long ld_h, const void* x, long long ld_x, void* dh,
                void* dx, long long M, int H, int F, int O, int nch, int XF,
                int nkc, int stages, cudaStream_t stream) {
  static bool attr = false;
  constexpr int FG = fields_a_tile(NT);
  const int rc = allow_smem(cin_bwd_data_wgmma_kernel<NT, FG, KR>, &attr);
  if (rc != 0) return rc;
  const bool hid_pairs =
      (H % 2) == 0 && (ld_h % 2) == 0 &&
      (reinterpret_cast<unsigned long long>(hid) & 3) == 0;
  const dim3 grid(static_cast<unsigned>((M + kRows - 1) / kRows));
  cin_bwd_data_wgmma_kernel<NT, FG, KR><<<grid, kDataThreads,
                                          data_smem(NT * FG, nch, XF, nkc,
                                                    stages),
                                          stream>>>(
      static_cast<const __nv_bfloat16*>(gt), gcols,
      static_cast<const __nv_bfloat16*>(wtl),
      static_cast<const __nv_bfloat16*>(hid), ld_h,
      static_cast<const __nv_bfloat16*>(x), ld_x,
      static_cast<__nv_bfloat16*>(dh), static_cast<__nv_bfloat16*>(dx), M, H,
      F, O, nch, XF, nkc, stages, hid_pairs ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_data_kr(int kr, const void* gt, int gcols, const void* wtl,
                   const void* hid, long long ld_h, const void* x,
                   long long ld_x, void* dh, void* dx, long long M, int H,
                   int F, int O, int nch, int XF, int nkc, int stages,
                   cudaStream_t stream) {
  switch (kr) {
    case 1:
      return launch_data<NT, 1>(gt, gcols, wtl, hid, ld_h, x, ld_x, dh, dx, M,
                                H, F, O, nch, XF, nkc, stages, stream);
    case 2:
      return launch_data<NT, 2>(gt, gcols, wtl, hid, ld_h, x, ld_x, dh, dx, M,
                                H, F, O, nch, XF, nkc, stages, stream);
    case 3:
      return launch_data<NT, 3>(gt, gcols, wtl, hid, ld_h, x, ld_x, dh, dx, M,
                                H, F, O, nch, XF, nkc, stages, stream);
    case 4:
      return launch_data<NT, 4>(gt, gcols, wtl, hid, ld_h, x, ld_x, dh, dx, M,
                                H, F, O, nch, XF, nkc, stages, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NO>
int launch_weight(const void* gt, int gcols, const void* ht, const void* xt,
                  void* part, long long M, int H, int F, int O,
                  long long rows_per_split, int splits, int hb_log2,
                  int stages, cudaStream_t stream) {
  static bool attr = false;
  const int rc = allow_smem(cin_bwd_weight_wgmma_kernel<NO>, &attr);
  if (rc != 0) return rc;
  const int HB = 1 << hb_log2, FB = kRows >> hb_log2;
  const dim3 grid(((F + FB - 1) / FB) * ((H + HB - 1) / HB), splits,
                  (O + NO - 1) / NO);
  cin_bwd_weight_wgmma_kernel<NO><<<grid, kThreads,
                                    weight_smem(NO, hb_log2, stages),
                                    stream>>>(
      static_cast<const __nv_bfloat16*>(gt), gcols,
      static_cast<const __nv_bfloat16*>(ht),
      static_cast<const __nv_bfloat16*>(xt), static_cast<float*>(part), M, H,
      F, O, rows_per_split, hb_log2, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kernels' tiling at (H, F, O), for ops/cin.py:bwd_plan: plan[0..8] =
// NT, nch, FG, XF, stages, NO, hb_log2, FB, w_stages.  The data kernel
// takes H in nch chunks of NT maps (the least padding, then the widest
// chunk), FG = fields_a_tile(NT) fields a product and x's rows at stride
// XF; the weight kernel takes O in blocks of NO columns (the least of 64,
// 128, 208 and 256 that covers O, else 256) and dwt's rows in tiles of
// 2^hb_log2 maps by FB = 128 / 2^hb_log2 fields (the least padding, then
// the widest).  stages and w_stages are as many ring stages as fit a
// block's shared memory.  Returns 1, or 0 where a tile does not fit.
extern "C" int cin_mix_bwd_plan(int H, int F, int O, int* plan) {
  if (H <= 0 || F <= 0 || O <= 0 || H > 65536 || F > 65536 || O > 65536) {
    return 0;
  }
  const int nts[] = {104, 64, 32}, nos[] = {208, 128, 64};
  int NT = 0;
  for (const int nt : nts) {
    if (NT == 0 || round_up(H, nt) < round_up(H, NT)) NT = nt;
  }
  const int nch = (H + NT - 1) / NT, FG = fields_a_tile(NT), XF = F | 1;
  const int nkc = (O + kStageK - 1) / kStageK;
  int NO = 256;
  for (const int no : nos) {
    if (no >= O) NO = no;
  }
  int hb_log2 = 4;
  for (int b = 5; b <= 6; ++b) {
    const long long pad = static_cast<long long>(round_up(H, 1 << b)) *
                          round_up(F, kRows >> b);
    if (pad <= static_cast<long long>(round_up(H, 1 << hb_log2)) *
                   round_up(F, kRows >> hb_log2)) {
      hb_log2 = b;
    }
  }
  int stages = 0, w_stages = 0;
  for (int s = kMaxStages; s >= 2 && stages == 0; --s) {
    if (data_smem(NT * FG, nch, XF, nkc, s) <= kMaxSmem) stages = s;
  }
  for (int s = kMaxStages; s >= 2 && w_stages == 0; --s) {
    if (weight_smem(NO, hb_log2, s) <= kMaxSmem) w_stages = s;
  }
  if (stages == 0 || w_stages == 0) return 0;
  const int out[9] = {NT, nch, FG, XF, stages, NO, hb_log2,
                      kRows >> hb_log2, w_stages};
  for (int i = 0; i < 9; ++i) plan[i] = out[i];
  return 1;
}

// The operand tiles (cin_bwd_tile_kernel): src [rows, cols] bfloat16 at
// row stride ld -> dst, n_tiles * col_tiles tiles of [TR, CW] from SCW
// source columns a tile (swz: TMA's 128-byte swizzle, CW = SCW = 64);
// field_rows > 0 takes wt's rows TR / chunk fields and an H chunk of
// `chunk` maps a tile (n_tiles = H chunks * field groups).  dst is 16-byte
// aligned.
extern "C" int cin_mix_bwd_tile(const void* src, long long ld, long long rows,
                                int cols, void* dst, int TR, int CW, int SCW,
                                int swz, long long n_tiles, int col_tiles,
                                int field_rows, int fields, int chunk,
                                void* stream) {
  if (rows <= 0 || cols <= 0 || ld < cols || TR <= 0 || TR % 8 != 0 ||
      CW <= 0 || CW % 8 != 0 || SCW <= 0 || SCW > CW ||
      (swz && (CW != 64 || SCW != 64)) || n_tiles <= 0 ||
      static_cast<long long>(col_tiles) * SCW < cols || !aligned16(dst) ||
      (field_rows > 0 && (fields <= 0 || chunk <= 0 || TR % chunk != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_chunks = n_tiles * col_tiles * TR * (CW / 8);
  const int block = 256;
  const long long blocks = (n_chunks + block - 1) / block;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(src) && ld % 8 == 0 && SCW % 8 == 0;
  cin_bwd_tile_kernel<<<static_cast<unsigned>(blocks), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), ld, rows, cols,
      static_cast<__nv_bfloat16*>(dst), TR, CW, SCW, swz, n_chunks,
      col_tiles, field_rows, fields, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

// The data kernel: gt g's [64, 64] tiles (cin_mix_bwd_tile, TR = 64, gcols
// column tiles a row tile) and wtl wt's [FG * NT, 64] tiles (chunk = NT, FG
// = fields_a_tile(NT) fields a tile, nkc = ceil(O / 64) column tiles), hid
// [M, H] at ld_h and x
// [M, F] at ld_x (contiguous rows) -> dh [M, H] and dx [M, F] contiguous.
// NT (32, 64 or 104), nch, XF and stages are cin_mix_bwd_plan's.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cin_mix_bwd_data(const void* gt, int gcols, const void* wtl,
                                const void* hid, long long ld_h, const void* x,
                                long long ld_x, void* dh, void* dx, long long M,
                                int H, int F, int O, int NT, int nch, int XF,
                                int stages, void* stream) {
  const int nkc = (O + kStageK - 1) / kStageK;
  if (M <= 0 || H <= 0 || F <= 0 || O <= 0 || ld_h < H || ld_x < F ||
      gcols < nkc || !aligned16(gt) || !aligned16(wtl) ||
      nch * NT < H || (nch - 1) * NT >= H || XF < F ||
      stages < 2 || stages > kMaxStages ||
      static_cast<long long>(F) * H >= (1LL << 31) ||
      M + kRows >= (1LL << 31) ||
      (NT != 32 && NT != 64 && NT != 104) ||
      data_smem(NT * fields_a_tile(NT), nch, XF, nkc, stages) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kr = (O + 15) / 16 - 4 * (nkc - 1);
  switch (NT) {
    case 32:
      return launch_data_kr<32>(kr, gt, gcols, wtl, hid, ld_h, x, ld_x, dh, dx,
                                M, H, F, O, nch, XF, nkc, stages, s);
    case 64:
      return launch_data_kr<64>(kr, gt, gcols, wtl, hid, ld_h, x, ld_x, dh, dx,
                                M, H, F, O, nch, XF, nkc, stages, s);
    case 104:
      return launch_data_kr<104>(kr, gt, gcols, wtl, hid, ld_h, x, ld_x, dh,
                                 dx, M, H, F, O, nch, XF, nkc, stages, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The weight kernel: gt as for cin_mix_bwd_data (gcols a multiple of NO's
// 64-column tiles), ht hid's plain [64, HB] tiles (cin_mix_bwd_tile, CW =
// SCW = HB, ceil(H / HB) column tiles) and xt x's [64, 8] tiles (SCW = 128
// / HB fields, ceil(F / (128 / HB)) column tiles) -> part [splits, F*H, O]
// float32, split s the sums over rows [s, s + 1) * rows_per_split (a
// multiple of 64).  NO (64, 128, 208 or 256: columns a block), hb_log2 (4,
// 5 or 6: a block's HB = 2^hb_log2 maps by 128 / HB fields) and stages are
// cin_mix_bwd_plan's.
extern "C" int cin_mix_bwd_weight(const void* gt, int gcols, const void* ht,
                                  const void* xt, void* part, long long M,
                                  int H, int F, int O, int NO,
                                  long long rows_per_split, int splits,
                                  int hb_log2, int stages, void* stream) {
  if (M <= 0 || H <= 0 || F <= 0 || O <= 0 || !aligned16(gt) ||
      !aligned16(ht) || !aligned16(xt) ||
      gcols != (O + NO - 1) / NO * ((NO + 63) / 64) ||
      rows_per_split <= 0 || rows_per_split % 64 != 0 || splits <= 0 ||
      splits > 65535 || rows_per_split * splits < M ||
      (splits - 1) * rows_per_split >= M || hb_log2 < 4 || hb_log2 > 6 ||
      stages < 2 || stages > kMaxStages ||
      static_cast<long long>(F) * H >= (1LL << 31) ||
      M + 64 >= (1LL << 31) || (O + NO - 1) / NO > 65535 ||
      weight_smem(NO, hb_log2, stages) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NO) {
    case 64:
      return launch_weight<64>(gt, gcols, ht, xt, part, M, H, F, O,
                               rows_per_split, splits, hb_log2, stages, s);
    case 128:
      return launch_weight<128>(gt, gcols, ht, xt, part, M, H, F, O,
                                rows_per_split, splits, hb_log2, stages, s);
    case 208:
      return launch_weight<208>(gt, gcols, ht, xt, part, M, H, F, O,
                                rows_per_split, splits, hb_log2, stages, s);
    case 256:
      return launch_weight<256>(gt, gcols, ht, xt, part, M, H, F, O,
                                rows_per_split, splits, hb_log2, stages, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dwt [n] bfloat16 (n = F*H*O) = the sum over s of part [splits, n], in
// order of s.
extern "C" int cin_mix_bwd_reduce(const void* part, void* dwt, long long n,
                                  int splits, void* stream) {
  if (n <= 0 || splits <= 0 ||
      (reinterpret_cast<unsigned long long>(part) & 15) != 0 ||
      (reinterpret_cast<unsigned long long>(dwt) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = (n + 3) / 4;
  const int block = 256;
  const long long blocks = (threads + block - 1) / block;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cin_bwd_weight_reduce_kernel<<<static_cast<unsigned>(blocks), block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dwt), n,
      splits);
  return static_cast<int>(cudaGetLastError());
}
