// Bitset OR-aggregation kernels for Hopper (sm_90a), behind a plain C
// interface loaded with ctypes (kernels/build.py, kernels/ops.py).
//
// bitset_spmm replaces the TPU kernel src/repro/kernels/bitset_spmm.py
// (`bitset_spmm`): out[v, :] = OR over active arcs u -> v of vals[u, :],
// on packed 32-bit words. The TPU kernel walks a grid of dense
// (dst block, src block) bitmasks and contracts each, unpacked to floats, on
// the MXU. A sparse graph touches millions of such blocks at 8 KiB each, so
// here the same function is a gather along the dst-sorted arcs (dst-CSR):
// destination v walks its in-arcs dst_ptr[v] .. dst_ptr[v+1]-1, skips the
// inactive ones, ORs the source rows into registers and writes out[v, :]
// once. No atomics, no tensor cores; the result is exact and deterministic,
// and a vertex without in-arcs writes 0 (the JAX wrapper's rule for dst
// blocks no adjacency block touches).
//
// bitset_wave replaces src/repro/kernels/bitset_wave.py (`bitset_wave`):
// L hops of F_r = OR-agg(F_{r-1}) & cand[r]. Each hop depends on the whole
// previous hop, so it is L launches of the hop kernel with ping-pong frontier
// buffers. A vertex whose candidacy word is 0 writes zeros without reading a
// single arc: candidacy is sparse after LCC, so most rows cost nothing. This
// stands in for what the TPU kernel gained by keeping the frontier resident
// in VMEM.
//
// What bounds them on this card: bytes. Per call they read the arc arrays
// (4 B src + 1 B active per arc, 8 B offsets per vertex), one W-word source
// row per active arc they visit, and write n rows of W words -- about one
// bitwise OR per 4 bytes moved, far below what the card can compute per byte
// of its 3.35 TB/s. The design keeps loads coalesced:
//   W = 32 (NLCC waves)  one warp per vertex, lane = word, so each arc's
//                        source row is one 128-byte load; the warp loads 32
//                        arcs' (src, active) at once and broadcasts them
//                        with shuffles;
//   W <= 2 (LCC sweeps)  one thread per vertex, its words in registers.
// Other widths take the warp mapping, lanes striding over the words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// One thread per destination vertex, W words kept in registers.
template <int W, bool kMasked>
__global__ void __launch_bounds__(kBlock)
or_gather_thread(const uint32_t* __restrict__ vals,
                 const int32_t* __restrict__ src,
                 const int64_t* __restrict__ dst_ptr,
                 const uint8_t* __restrict__ active,
                 const uint32_t* __restrict__ cand,
                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (v >= n) return;
  const uint32_t mask = kMasked ? cand[v] : 0xFFFFFFFFu;
  uint32_t acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0u;
  if (mask != 0u) {
    const int64_t end = dst_ptr[v + 1];
    for (int64_t e = dst_ptr[v]; e < end; ++e) {
      if (!active[e]) continue;
      const uint32_t* row = vals + static_cast<int64_t>(src[e]) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] |= row[w];
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) out[v * W + w] = acc[w] & mask;
}

// One warp per destination vertex; lane l owns words l, l+32, ...
template <bool kMasked>
__global__ void __launch_bounds__(kBlock)
or_gather_warp(const uint32_t* __restrict__ vals,
               const int32_t* __restrict__ src,
               const int64_t* __restrict__ dst_ptr,
               const uint8_t* __restrict__ active,
               const uint32_t* __restrict__ cand,
               uint32_t* __restrict__ out, int64_t n, int W) {
  const int64_t v =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;  // uniform across the warp
  const uint32_t mask = kMasked ? cand[v] : 0xFFFFFFFFu;
  const int64_t beg = dst_ptr[v];
  const int64_t end = dst_ptr[v + 1];
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    uint32_t acc = 0u;
    if (mask != 0u) {
      for (int64_t base = beg; base < end; base += 32) {
        const int64_t e = base + lane;
        const int32_t s = (e < end && active[e]) ? src[e] : -1;
        const int cnt = static_cast<int>(end - base < 32 ? end - base : 32);
        for (int j = 0; j < cnt; ++j) {
          const int32_t sj = __shfl_sync(0xFFFFFFFFu, s, j);
          if (sj >= 0 && w < W) acc |= vals[static_cast<int64_t>(sj) * W + w];
        }
      }
    }
    if (w < W) out[v * W + w] = acc & mask;
  }
}

template <bool kMasked>
cudaError_t launch_gather(const uint32_t* vals, const int32_t* src,
                          const int64_t* dst_ptr, const uint8_t* active,
                          const uint32_t* cand, uint32_t* out, int64_t n,
                          int W, cudaStream_t stream) {
  if (W == 1) {
    const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    or_gather_thread<1, kMasked><<<blocks, kBlock, 0, stream>>>(
        vals, src, dst_ptr, active, cand, out, n);
  } else if (W == 2) {
    const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    or_gather_thread<2, kMasked><<<blocks, kBlock, 0, stream>>>(
        vals, src, dst_ptr, active, cand, out, n);
  } else {
    const int64_t warps_per_block = kBlock / 32;
    const unsigned blocks =
        static_cast<unsigned>((n + warps_per_block - 1) / warps_per_block);
    or_gather_warp<kMasked><<<blocks, kBlock, 0, stream>>>(
        vals, src, dst_ptr, active, cand, out, n, W);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[n, W] = OR over active in-arcs of vals[src, :]. Returns the
// cudaError_t of the launch (0 = launched).
int bitset_spmm_launch(const void* vals, const void* src, const void* dst_ptr,
                       const void* active, void* out, long long n, int W,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || W <= 0) return 0;
  return static_cast<int>(launch_gather<false>(
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(src),
      static_cast<const int64_t*>(dst_ptr),
      static_cast<const uint8_t*>(active), nullptr,
      static_cast<uint32_t*>(out), n, W, static_cast<cudaStream_t>(stream)));
}

// L hops: hop r reads the previous frontier (vals for r = 0) and writes the
// next, masked by cand[r, :] (0 or all ones per vertex). The hops alternate
// between `scratch` and `out` so that the last one lands in `out`; `scratch`
// may be null when L == 1. Returns the first failing launch's cudaError_t.
int bitset_wave_launch(const void* vals, const void* src, const void* dst_ptr,
                       const void* active, const void* cand, int L,
                       void* scratch, void* out, long long n, int W,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || W <= 0 || L <= 0) return 0;
  const uint32_t* cur = static_cast<const uint32_t*>(vals);
  for (int r = 0; r < L; ++r) {
    uint32_t* next = ((L - 1 - r) % 2 == 0) ? static_cast<uint32_t*>(out)
                                            : static_cast<uint32_t*>(scratch);
    err = launch_gather<true>(
        cur, static_cast<const int32_t*>(src),
        static_cast<const int64_t*>(dst_ptr),
        static_cast<const uint8_t*>(active),
        static_cast<const uint32_t*>(cand) + static_cast<int64_t>(r) * n, next,
        n, W, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = next;
  }
  return 0;
}

const char* bitset_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
