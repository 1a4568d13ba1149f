// Bitset OR-aggregation kernels for Hopper (sm_90a), behind a plain C
// interface loaded with ctypes (kernels/build.py, kernels/ops.py).
//
// bitset_spmm replaces the TPU kernel src/repro/kernels/bitset_spmm.py
// (`bitset_spmm`): out[v, :] = OR over active arcs u -> v of vals[u, :],
// on packed 32-bit words. The TPU kernel walks a grid of dense
// (dst block, src block) bitmasks and contracts each, unpacked to floats, on
// the MXU. A sparse graph touches millions of such blocks at 8 KiB each, so
// here the same function is a gather along the dst-sorted arcs. The result is
// exact and deterministic (OR is commutative and idempotent, so the order of
// atomics cannot change it), and a vertex without in-arcs writes 0 (the JAX
// wrapper's rule for dst blocks no adjacency block touches).
//
// bitset_wave replaces src/repro/kernels/bitset_wave.py (`bitset_wave`):
// L hops of F_r = OR-agg(F_{r-1}) & cand[r]. Each hop depends on the whole
// previous hop, so it is L launches of the hop kernel with ping-pong frontier
// buffers. A vertex whose candidacy word is 0 writes zeros without reading a
// single arc: candidacy is sparse after LCC, so most rows cost nothing. This
// stands in for what the TPU kernel gained by keeping the frontier resident
// in VMEM.
//
// What bounds them on this card: bytes. Per call they read the arc arrays,
// one W-word source row per active arc they visit, and write n rows of W
// words -- about one bitwise OR per 4 bytes moved, far below what the card
// can compute per byte of its 3.35 TB/s. The designs:
//   bitset_spmm, W <= 2 (LCC sweeps)  edge-balanced: each warp takes a chunk
//     of dst-sorted arcs (as many as the caller asks, kernels/ops.py
//     BITSET_ARC_CHUNK), 32 at a time, lanes reading dst (4 B),
//     active (1 B) and, for an active arc, src (4 B) coalesced, about 9 B
//     per arc, and gathering vals[src] (4 or 8 B, from the L2: the whole
//     [n, W] table is 4-8 MB at scale 20). A segmented OR-scan by dst across
//     the lanes (shuffles) reduces each run of equal dst; a run that
//     continues past lane 31 carries into the next 32 arcs in registers. A
//     run wholly inside the chunk is stored; the first and last runs of a
//     chunk may be shared with a neighbouring chunk and are atomicOr'ed
//     into the output, which the host zeroes first (cudaMemsetAsync). So a
//     hub with tens of thousands of in-arcs is reduced by hundreds of warps
//     and costs one atomic per chunk, where one thread walking its arcs
//     set the length of the whole launch;
//   W = 32 (NLCC waves, and bitset_spmm at W > 2)  one warp per vertex,
//     lane = word, so each arc's source row is one 128-byte load; the warp
//     loads 32 arcs' (src, active) at once and broadcasts them with
//     shuffles; other widths > 2 stride the lanes over the words;
//   the masked hop of bitset_wave at W <= 2  one thread per vertex, its
//     words in registers, so that a non-candidate reads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// Edge-balanced OR-gather for W <= 2; `out` holds zeros on entry.
template <int W>
__global__ void __launch_bounds__(kBlock)
or_gather_arcs(const uint32_t* __restrict__ vals,
               const int32_t* __restrict__ src,
               const int32_t* __restrict__ dst,
               const uint8_t* __restrict__ active,
               uint32_t* __restrict__ out, int64_t m, int64_t chunk) {
  const int64_t begin =
      ((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5) *
      chunk;
  const int lane = threadIdx.x & 31;
  if (begin >= m) return;  // uniform across the warp
  const int64_t end = begin + chunk < m ? begin + chunk : m;
  const int32_t first = dst[begin];  // this run may start in the chunk before
  int32_t carry_dst = -1;            // the run left open by the last 32 arcs
  uint32_t carry[W];
#pragma unroll
  for (int w = 0; w < W; ++w) carry[w] = 0u;
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t e = base + lane;
    const bool valid = e < end;
    const int32_t d = valid ? dst[e] : -1;
    uint32_t acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0u;
    if (valid && active[e]) {
      const uint32_t* row = vals + static_cast<int64_t>(src[e]) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = row[w];
    }
    if (lane == 0 && d == carry_dst) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] |= carry[w];
    }
    // inclusive OR-scan within runs of equal dst (runs are contiguous)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t d_up = __shfl_up_sync(0xFFFFFFFFu, d, off);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, acc[w], off);
        if (lane >= off && d_up == d) acc[w] |= up;
      }
    }
    // a run ends at e unless arc e + 1 of this chunk has the same dst
    int32_t d_next = __shfl_down_sync(0xFFFFFFFFu, d, 1);
    if (lane == 31) d_next = e + 1 < end ? dst[e + 1] : -1;
    const bool run_end = valid && (e + 1 >= end || d_next != d);
    // lane 31's open run continues into the next 32 arcs
    carry_dst = __shfl_sync(0xFFFFFFFFu, run_end ? -1 : d, 31);
#pragma unroll
    for (int w = 0; w < W; ++w) carry[w] = __shfl_sync(0xFFFFFFFFu, acc[w], 31);
    if (run_end) {
      uint32_t* o = out + static_cast<int64_t>(d) * W;
      if (d == first || e + 1 >= end) {  // may be shared with a neighbour chunk
#pragma unroll
        for (int w = 0; w < W; ++w)
          if (acc[w] != 0u) atomicOr(o + w, acc[w]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) o[w] = acc[w];
      }
    }
  }
}

// One thread per destination vertex, W words kept in registers (the masked
// hop of bitset_wave at W <= 2).
template <int W>
__global__ void __launch_bounds__(kBlock)
or_gather_thread(const uint32_t* __restrict__ vals,
                 const int32_t* __restrict__ src,
                 const int64_t* __restrict__ dst_ptr,
                 const uint8_t* __restrict__ active,
                 const uint32_t* __restrict__ cand,
                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (v >= n) return;
  const uint32_t mask = cand[v];
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
cudaError_t launch_warp(const uint32_t* vals, const int32_t* src,
                        const int64_t* dst_ptr, const uint8_t* active,
                        const uint32_t* cand, uint32_t* out, int64_t n, int W,
                        cudaStream_t stream) {
  const int64_t warps_per_block = kBlock / 32;
  const unsigned blocks =
      static_cast<unsigned>((n + warps_per_block - 1) / warps_per_block);
  or_gather_warp<kMasked><<<blocks, kBlock, 0, stream>>>(
      vals, src, dst_ptr, active, cand, out, n, W);
  return cudaGetLastError();
}

// The unmasked OR-gather: edge-balanced for W <= 2, `chunk` arcs a warp;
// warp per vertex above.
cudaError_t launch_spmm(const uint32_t* vals, const int32_t* src,
                        const int32_t* dst, const int64_t* dst_ptr,
                        const uint8_t* active, uint32_t* out, int64_t n,
                        int64_t m, int64_t chunk, int W, cudaStream_t stream) {
  if (W > 2)
    return launch_warp<false>(vals, src, dst_ptr, active, nullptr, out, n, W, stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * W * 4, stream);
  if (err != cudaSuccess || m == 0) return err;
  const int64_t chunks_per_block = kBlock / 32;
  const int64_t chunks = (m + chunk - 1) / chunk;
  const unsigned blocks =
      static_cast<unsigned>((chunks + chunks_per_block - 1) / chunks_per_block);
  if (W == 1)
    or_gather_arcs<1><<<blocks, kBlock, 0, stream>>>(vals, src, dst, active, out, m,
                                                      chunk);
  else
    or_gather_arcs<2><<<blocks, kBlock, 0, stream>>>(vals, src, dst, active, out, m,
                                                      chunk);
  return cudaGetLastError();
}

// One masked hop of bitset_wave: thread per vertex for W <= 2, warp above.
cudaError_t launch_hop(const uint32_t* vals, const int32_t* src,
                       const int64_t* dst_ptr, const uint8_t* active,
                       const uint32_t* cand, uint32_t* out, int64_t n, int W,
                       cudaStream_t stream) {
  if (W > 2)
    return launch_warp<true>(vals, src, dst_ptr, active, cand, out, n, W, stream);
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  if (W == 1)
    or_gather_thread<1><<<blocks, kBlock, 0, stream>>>(
        vals, src, dst_ptr, active, cand, out, n);
  else
    or_gather_thread<2><<<blocks, kBlock, 0, stream>>>(
        vals, src, dst_ptr, active, cand, out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[n, W] = OR over active in-arcs of vals[src, :], for the m arcs
// sorted by dst (src, dst, active) with dst-CSR offsets dst_ptr; at W <= 2
// each warp takes `chunk` arcs (> 0). Returns the cudaError_t of the first
// failing call (0 = launched).
int bitset_spmm_launch(const void* vals, const void* src, const void* dst,
                       const void* dst_ptr, const void* active, void* out,
                       long long n, long long m, long long chunk, int W,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || W <= 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_spmm(
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const int64_t*>(dst_ptr),
      static_cast<const uint8_t*>(active), static_cast<uint32_t*>(out), n, m,
      chunk, W, static_cast<cudaStream_t>(stream)));
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
    err = launch_hop(
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
