// Forward attention for bf16 on Hopper's tensor cores (sm_90a), behind a
// plain C interface loaded with ctypes (kernels/build.py, kernels/ops.py).
//
// flash_attention_bf16 replaces the TPU kernel
// src/repro/kernels/flash_attention.py (`flash_attention`) for bf16 inputs:
// for q [B, Hq, S, Dqk], k [B, Hkv, S, Dqk] and v [B, Hkv, S, Dv], Hq a
// multiple of Hkv and query head h reading kv head h / (Hq / Hkv),
// o [B, Hq, S, Dv] = softmax(q k^T / sqrt(Dqk) + mask) v in bf16, with a
// causal mask and/or a sliding window (key > query - window). Dqk = Dv for
// GQA; MLA (DeepSeek) attends with Dqk = qk_nope + qk_rope = 192 and
// Dv = 128, which the JAX package leaves to its plain oracle. The numerics are the JAX package's blockwise oracle
// (src/repro/kernels/ref.py, `attention_blockwise`) at the kernel's kv tile:
// products of bf16 values accumulated in f32, the logits scaled after the
// product, running max and denominator in f32, l summed from the unrounded
// p, p rounded to bf16 before p v, a masked logit -1e30, the output divided
// by max(l, 1e-30). Any S (the last q and kv tiles are masked at S),
// (Dqk, Dv) in {(64, 64), (128, 128), (256, 256), (192, 128)}. f32 inputs
// take the CUDA-core kernel of
// flash_attention.cu, which keeps them exact to f32 rounding.
//
// What bounds it on this card: operations. Causal attention at S = 32768,
// D = 128 does 128 multiply-adds per logit and per output element against
// 2 bytes per element read, far above the ~295 operations per byte at which
// the tensor cores (989 TFLOP/s in bf16) outrun the 3.35 TB/s of memory.
// The design puts both products on wgmma:
//   - one block per (q tile of 128 rows, query head, batch row), the q
//     tiles launched longest-first across every head; two consumer
//     warpgroups of 64 rows each and one producer warp;
//   - the producer loads the q tile once and the kv tiles (128 keys at
//     D <= 128 and at (192, 128), 64 at D = 256, so that two stages fit
//     the 227 KB of shared memory: at (192, 128) 48 KB of q, 2 x 48 KB of
//     K and 2 x 32 KB of V) by TMA into a ring of two stages, each with a full barrier
//     for K, one for V and an empty barrier the consumers release; the
//     tensor maps are 4-D over [B, H, S, D] with the caller's strides (the
//     model's transposed view of v costs no copy), 128-byte swizzled in
//     64-column panels, zero-filled past S;
//   - S = Q K^T is wgmma with both operands in shared memory (K K-major);
//     the online softmax runs on the accumulator fragment in registers,
//     in log2 units (exp2f of logits scaled by log2(e) / sqrt(Dqk)); p is
//     converted in registers into the A operand of O += P V, whose B is V
//     MN-major in shared memory, so p never touches shared memory;
//   - kv tiles that the mask rules out for the whole q tile are never
//     loaded; the elementwise mask runs only on the diagonal, window-edge
//     and ragged tiles;
//   - registers: the card sizes a block of 288 threads as three
//     warpgroups (a build capped at 224 registers a thread failed to
//     launch), so ptxas holds each thread to 168. The first k-step of
//     Q K^T writes the logits without reading them, so their registers are
//     free during O += P V: no spills at D <= 128 (some at D = 256). At
//     (192, 128) the registers are those of D = 128: the accumulator is
//     Dv wide, and Q K^T only takes 12 k-steps in place of 8.
// Not here: FA3's ping-pong of the two warpgroups, setmaxnreg, fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 128;          // query rows per block
constexpr int kConsumers = 2;     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;        // kv tiles in flight
constexpr float kMasked = -1e30f;

// Shared memory of one block: the q tile and kStages K tiles, each as
// Dqk / 64 panels of [rows][64] bf16 (128-byte rows, swizzled), kStages V
// tiles of Dv / 64 such panels, then the barriers; 1024 bytes of slack to
// align the tiles to the swizzle period (every tile is a multiple of 1024
// bytes). Bk keys per kv tile, as the caller asks (kernels/ops.py,
// ATTENTION_KV_TILE); the instantiated triples are in
// flash_attention_bf16_launch.
template <int Dqk, int Dv, int Bk>
struct Tiles {
  static constexpr int kBk = Bk;
  static constexpr int kQkPanels = Dqk / 64;
  static constexpr int kVPanels = Dv / 64;
  static constexpr int kQBytes = kBq * Dqk * 2;
  static constexpr int kKBytes = kBk * Dqk * 2;
  static constexpr int kVBytes = kBk * Dv * 2;
  static constexpr int kBarriers = kQBytes + kStages * (kKBytes + kVBytes);
  static constexpr int kSmem = kBarriers + 64 + 1024;
};

// barrier slots: the q tile, then per stage K full, V full, K and V empty
__host__ __device__ constexpr int q_full() { return 0; }
__host__ __device__ constexpr int k_full(int s) { return 1 + s; }
__host__ __device__ constexpr int v_full(int s) { return 1 + kStages + s; }
__host__ __device__ constexpr int kv_empty(int s) { return 1 + 2 * kStages + s; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of this parity has completed. A phase that
// never completes (a copy that never lands) traps after some 10 s of SM
// cycles, so a fault shows as a launch error instead of a hung card.
constexpr long long kWaitCycles = 20000000000LL;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kWaitCycles) __trap();
  } while (!done);
}

// One TMA box of the 4-D map at (c0, c1, c2, c3) into shared memory; its
// bytes count against the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory:
// start address, leading and stride byte offsets, layout SWIZZLE_128B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, wait or issue around them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma instructions the kernel issues. Accumulator layout (m64nN, f32):
// thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1) in d[4 j + 2 i + c], row + 8 i, column + c.

// d[0..32) = A B^T, m64n64k16, A and B in shared memory, both K-major;
// the first k-step of a product: d's old values are not read.
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d[0..32) += A B^T, m64n64k16, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[0..64) = A B^T, m64n128k16, A and B in shared memory, both K-major;
// the first k-step of a product: d's old values are not read.
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d[0..64) += A B^T, m64n128k16, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[0..32) += A B, m64n64k16, A in registers, B in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A B, m64n128k16, A in registers, B in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..128) += A B, m64n256k16, A in registers, B in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int Dqk, int Dv, int Bk>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, long long os_b,
                            long long os_h, long long os_s, int s_len, int hq,
                            int heads, int group, int n_qtiles,
                            float scale_log2, int causal, int window) {
  using T = Tiles<Dqk, Dv, Bk>;
  constexpr int kBk = T::kBk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t k_tiles = base + T::kQBytes;             // + stage * kKBytes
  const uint32_t v_tiles = k_tiles + kStages * T::kKBytes;  // + stage * kVBytes
  const uint32_t bars = base + T::kBarriers;              // 8 bytes per barrier

  // blocks in order of q tile, last (longest causal rows) first, then heads
  const int qi = n_qtiles - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = qi * kBq;

  // the kv tiles that hold a live key for some row of this q tile
  const int q_last = min(q0 + kBq, s_len) - 1;
  int kv_end = (s_len + kBk - 1) / kBk;
  if (causal) kv_end = min(kv_end, q_last / kBk + 1);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kBk : 0;
  const int n_tiles = kv_end - kv_begin;

  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * k_full(s), 1);
      mbar_init(bars + 8 * v_full(s), 1);
      mbar_init(bars + 8 * kv_empty(s), 4 * kConsumers);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bars + 8 * q_full(), T::kQBytes);
      for (int p = 0; p < T::kQkPanels; ++p)
        tma_load(q_tile + p * kBq * 128, &tq, bars + 8 * q_full(), 64 * p, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bars + 8 * kv_empty(s), (t / kStages - 1) & 1);
        const int k0 = (kv_begin + t) * kBk;
        mbar_expect_tx(bars + 8 * k_full(s), T::kKBytes);
        for (int p = 0; p < T::kQkPanels; ++p)
          tma_load(k_tiles + s * T::kKBytes + p * kBk * 128, &tk,
                   bars + 8 * k_full(s), 64 * p, k0, hk, b);
        mbar_expect_tx(bars + 8 * v_full(s), T::kVBytes);
        for (int p = 0; p < T::kVPanels; ++p)
          tma_load(v_tiles + s * T::kVBytes + p * kBk * 128, &tv,
                   bars + 8 * v_full(s), 64 * p, k0, hk, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg .. + 63 of the q tile
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);                         // + 8 j (+ 1)
  const int wg_first = q0 + 64 * wg;
  const int wg_last = wg_first + 63;

  float acc[Dv / 2];  // O, m64nDv
  float s[kBk / 2];   // logits, then p, m64nBk; dead during O += P V
  uint32_t pa[kBk / 16][4];  // p in bf16 as the A operand of P V
#pragma unroll
  for (int i = 0; i < Dv / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMasked, kMasked};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the denominator

  mbar_wait(bars + 8 * q_full(), 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = (kv_begin + t) * kBk;
    const uint32_t kt = k_tiles + st * T::kKBytes;
    const uint32_t vt = v_tiles + st * T::kVBytes;

    // S = Q K^T: Dqk / 16 steps of k16; a step's 32 bytes sit inside one
    // 128-byte panel row, so the descriptor moves by 32 bytes within a panel
    mbar_wait(bars + 8 * k_full(st), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dqk / 16; ++kk) {
      const uint64_t da = smem_desc(
          q_tile + (kk / 4) * (kBq * 128) + wg * (64 * 128) + (kk % 4) * 32, 16, 1024);
      const uint64_t db = smem_desc(kt + (kk / 4) * (kBk * 128) + (kk % 4) * 32, 16, 1024);
      if constexpr (kBk == 128) {
        if (kk == 0) wgmma_ss_n128_first(s, da, db); else wgmma_ss_n128(s, da, db);
      } else {
        if (kk == 0) wgmma_ss_n64_first(s, da, db); else wgmma_ss_n64(s, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBk / 2>(s);

    // logits in log2 units; the mask only where some key of the tile is
    // dead for some row of this warpgroup
    const bool edge = k0 + kBk > s_len || (causal && k0 + kBk - 1 > wg_first) ||
                      (window > 0 && k0 <= wg_last - window);
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + col + c;
            const int row = row0 + 8 * i;
            bool live = key < s_len;
            if (causal) live = live && key <= row;
            if (window > 0) live = live && key > row - window;
            x = live ? x : kMasked;
          }
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a row's values sit in the 4 lanes of one quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[4 * j + 2 * i + c] - m[i]);
          l[i] += p;
          s[4 * j + 2 * i + c] = p;
        }
#pragma unroll
    for (int j = 0; j < Dv / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }
    // the accumulator fragment of keys 16 kk .. 16 kk + 15 is the A fragment
    // of k-step kk: rows r, r + 8 at keys 2 (t % 4) (+ 1), then + 8
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V: kBk / 16 steps of k16 over keys; V is MN-major, 8-key groups
    // 1024 bytes apart (stride offset), 64-column panels kBk * 128 bytes
    // apart (leading offset)
    mbar_wait(bars + 8 * v_full(st), parity);
    fence_regs<Dv / 2>(acc);
    fence_regs<kBk / 4>(&pa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint64_t db = smem_desc(vt + kk * 2048, kBk * 128, 1024);
      if constexpr (Dv == 64) {
        wgmma_rs_n64(acc, pa[kk], db);
      } else if constexpr (Dv == 128) {
        wgmma_rs_n128(acc, pa[kk], db);
      } else {
        wgmma_rs_n256(acc, pa[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<Dv / 2>(acc);
    fence_regs<kBk / 4>(&pa[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * kv_empty(st));
  }

  __nv_bfloat16* ob = o + b * os_b + h * os_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + row * os_s + col;
#pragma unroll
    for (int j = 0; j < Dv / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
  }
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint)
// so that the library links against the CUDA runtime only.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over [batch, heads, s_len, d] bf16 with element strides
// (sb, sh, ss, 1), read in boxes of 64 columns x `rows` positions,
// 128-byte swizzled, zero-filled outside the tensor.
bool encode_map(CUtensorMap* map, const void* ptr, int d, int s_len, int heads,
                long long batch, long long sb, long long sh, long long ss,
                int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Dqk, int Dv, int Bk>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long batch, int hq, int hkv, int s_len,
                   const long long* st, int causal, int window,
                   cudaStream_t stream) {
  using T = Tiles<Dqk, Dv, Bk>;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, Dqk, s_len, hq, batch, st[0], st[1], st[2], kBq) ||
      !encode_map(&mk, k, Dqk, s_len, hkv, batch, st[3], st[4], st[5], T::kBk) ||
      !encode_map(&mv, v, Dv, s_len, hkv, batch, st[6], st[7], st[8], T::kBk))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_bf16_kernel<Dqk, Dv, Bk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const long long n_qtiles = (s_len + kBq - 1) / kBq;
  const long long blocks = n_qtiles * batch * hq;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, T::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], s_len,
      hq, static_cast<int>(batch * hq), hq / hkv, static_cast<int>(n_qtiles),
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(Dqk))),
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for bf16 q [B, Hq, S, d], k [B, Hkv, S, d],
// v [B, Hkv, S, dv], o [B, Hq, S, dv], read in kv tiles of `kv_tile` keys,
// the logits scaled by 1 / sqrt(d). `strides` holds the
// element strides (batch, head, position) of q, k, v and o in that order;
// the last axis of each is contiguous, q, k and v start 16-byte aligned and
// their strides are multiples of 8 elements (TMA's rule; kernels/ops.py
// checks it). causal: 0 or 1; window <= 0 means none. Returns the
// cudaError_t of the launch (0 = launched); a (d, dv, kv_tile) triple not
// built here (64, 64, 128; 128, 128, 128; 256, 256, 64; 192, 128, 128), a
// tensor map cuTensorMapEncodeTiled refuses, or a grid out of range returns
// cudaErrorInvalidValue.
int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                void* o, long long batch, int hq, int hkv,
                                int s_len, int d, int dv, int kv_tile,
                                const long long* strides, int causal,
                                int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || s_len <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || batch * hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dv == 64 && kv_tile == 128)
    return static_cast<int>(launch<64, 64, 128>(q, k, v, o, batch, hq, hkv, s_len,
                                                strides, causal, window, s));
  if (d == 128 && dv == 128 && kv_tile == 128)
    return static_cast<int>(launch<128, 128, 128>(q, k, v, o, batch, hq, hkv, s_len,
                                                  strides, causal, window, s));
  if (d == 256 && dv == 256 && kv_tile == 64)
    return static_cast<int>(launch<256, 256, 64>(q, k, v, o, batch, hq, hkv, s_len,
                                                 strides, causal, window, s));
  if (d == 192 && dv == 128 && kv_tile == 128)
    return static_cast<int>(launch<192, 128, 128>(q, k, v, o, batch, hq, hkv, s_len,
                                                  strides, causal, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
