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
// L hops of F_r = OR-agg(F_{r-1}) & cand[r], any 32-bit candidacy words.
// The TPU kernel keeps the frontier resident in VMEM across the hops. After
// LCC a hop has a few hundred candidates among a million vertices, so here
// a hop's cost follows its candidates, not n:
//   - a worklist pass (a thread per vertex, one read of cand [L, n]) lists
//     each hop's candidates on the device, one item per BITSET_ARC_CHUNK
//     in-arcs, so that a live hub is split over many warps; the counts stay
//     on the device and each hop kernel has a fixed grid that strides over
//     them, so the host reads nothing back;
//   - reads are gated by the previous hop's candidacy: F_{r-1}[u] =
//     agg & cand[r-1][u] is 0 where that word is 0, so a hop reads
//     cand[r-1][u] (4 B) before row u and never reads a non-candidate row.
//     The frontiers between hops are then written only at their candidates'
//     rows, in scratch buffers that rotate over at least three (the caller
//     says how many, kernels/ops.py BITSET_WAVE_BUFFERS): a split row is
//     zeroed by the previous hop's grid in a buffer that neither that hop
//     reads nor writes, and no leftover of the caching allocator is ever
//     read;
//   - `out` is zeroed once (cudaMemsetAsync, n W 4 bytes: most of the cost
//     at scale 20) and the last hop writes only its candidates' rows. The
//     live rows (a few hundred of 128 B) stay in the L2, this card's
//     counterpart of the resident frontier.
//
// What bounds them on this card: bytes. Per call they read the arc arrays
// (bitset_wave: only its candidates' in-arcs), one W-word source row per
// active arc they visit, and write n rows of W words -- about one bitwise
// OR per 4 bytes moved, far below what the card can compute per byte of its
// 3.35 TB/s. The designs:
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
//   bitset_spmm at W > 2  one warp per vertex, lane = word, so each arc's
//     source row is one 128-byte load at W = 32; the warp loads 32 arcs'
//     (src, active) at once and broadcasts them with shuffles; other widths
//     stride the lanes over the words;
//   bitset_wave  a warp per work item; at W > 2 lanes over words as above,
//     broadcasting only the arcs that are active and pass the gate (a
//     ballot); at W <= 2 lanes over arcs and a warp OR-reduction.
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

// One warp per destination vertex; lane l owns words l, l+32, ...
// (bitset_spmm at W > 2).
__global__ void __launch_bounds__(kBlock)
or_gather_warp(const uint32_t* __restrict__ vals,
               const int32_t* __restrict__ src,
               const int64_t* __restrict__ dst_ptr,
               const uint8_t* __restrict__ active,
               uint32_t* __restrict__ out, int64_t n, int W) {
  const int64_t v =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;  // uniform across the warp
  const int64_t beg = dst_ptr[v];
  const int64_t end = dst_ptr[v + 1];
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    uint32_t acc = 0u;
    for (int64_t base = beg; base < end; base += 32) {
      const int64_t e = base + lane;
      const int32_t s = (e < end && active[e]) ? src[e] : -1;
      const int cnt = static_cast<int>(end - base < 32 ? end - base : 32);
      for (int j = 0; j < cnt; ++j) {
        const int32_t sj = __shfl_sync(0xFFFFFFFFu, s, j);
        if (sj >= 0 && w < W) acc |= vals[static_cast<int64_t>(sj) * W + w];
      }
    }
    if (w < W) out[v * W + w] = acc;
  }
}

// The unmasked OR-gather: edge-balanced for W <= 2, `chunk` arcs a warp;
// warp per vertex above.
cudaError_t launch_spmm(const uint32_t* vals, const int32_t* src,
                        const int32_t* dst, const int64_t* dst_ptr,
                        const uint8_t* active, uint32_t* out, int64_t n,
                        int64_t m, int64_t chunk, int W, cudaStream_t stream) {
  if (W > 2) {
    const int64_t warps_per_block = kBlock / 32;
    const unsigned blocks =
        static_cast<unsigned>((n + warps_per_block - 1) / warps_per_block);
    or_gather_warp<<<blocks, kBlock, 0, stream>>>(vals, src, dst_ptr, active,
                                                  out, n, W);
    return cudaGetLastError();
  }
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

// ------------------------------------------------------------ bitset_wave
// A work item of a hop: (vertex, chunk). Chunk -1 is a vertex with at most
// `chunk` in-arcs, whose row the item stores whole; chunk c >= 0 is arcs
// [c * chunk, (c + 1) * chunk) of a longer in-arc list, whose row was zeroed
// before the hop and takes the item's OR by atomicOr.
struct WaveArgs {
  const uint32_t* vals;     // [n, W] the hop-0 frontier
  const int32_t* src;       // [m] dst-sorted arcs
  const int64_t* dst_ptr;   // [n + 1]
  const uint8_t* active;    // [m]
  const uint32_t* cand;     // [L, n] candidacy words
  int2* items;              // [L, cap] work items of each hop
  int* counts;              // [L] items of each hop
  int64_t n, cap, chunk;
  int L, W;
};

// Zero row v of a frontier buffer, W words, by one thread (a split row).
__device__ __forceinline__ void zero_row(uint32_t* buf, int64_t v, int W) {
  for (int w = 0; w < W; ++w) buf[v * W + w] = 0u;
}

// Hops whose candidacy words a thread of the worklist pass loads at once.
constexpr int kHopGroup = 8;

// The worklist pass, a thread per vertex: for each hop r, every candidate
// (cand[r][v] != 0) appends its items to hop r's list, one per `chunk` of
// in-arcs (at least one), at an offset from a warp scan and one atomicAdd
// per warp with candidates and hop on counts[r]. The words of kHopGroup
// hops are loaded together, and the atomics of a group are issued together,
// so that a warp waits for memory about once per group. The first chunk of
// a split list of hop 0 zeroes its row in `hub0` (hop 0's buffer; null when
// hop 0 writes `out`, which the host zeroes).
__global__ void __launch_bounds__(kBlock)
wave_worklist(WaveArgs a, uint32_t* hub0) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(kBlock) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int64_t deg = -1;  // read at the first group where v is a candidate
  for (int r0 = 0; r0 < a.L; r0 += kHopGroup) {
    uint32_t word[kHopGroup];
#pragma unroll
    for (int j = 0; j < kHopGroup; ++j)
      word[j] = (v < a.n && r0 + j < a.L) ? a.cand[(r0 + j) * a.n + v] : 0u;
    bool any = false;
#pragma unroll
    for (int j = 0; j < kHopGroup; ++j) any |= word[j] != 0u;
    if (!__any_sync(0xFFFFFFFFu, any)) continue;  // no candidate in the warp
    if (any && deg < 0) deg = a.dst_ptr[v + 1] - a.dst_ptr[v];
    int k[kHopGroup], incl[kHopGroup], base[kHopGroup];
#pragma unroll
    for (int j = 0; j < kHopGroup; ++j) {
      k[j] = word[j] == 0u ? 0
             : deg > a.chunk ? static_cast<int>((deg + a.chunk - 1) / a.chunk)
                             : 1;
      incl[j] = k[j];  // inclusive scan of k over the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, incl[j], off);
        if (lane >= off) incl[j] += up;
      }
      base[j] = 0;
      if (lane == 31 && incl[j] > 0) base[j] = atomicAdd(a.counts + r0 + j, incl[j]);
    }
#pragma unroll
    for (int j = 0; j < kHopGroup; ++j) {
      base[j] = __shfl_sync(0xFFFFFFFFu, base[j], 31);
      if (k[j] == 0) continue;
      const int r = r0 + j;
      int2* it = a.items + r * a.cap + base[j] + incl[j] - k[j];
      if (k[j] == 1) {
        it[0] = make_int2(static_cast<int>(v), -1);
      } else {
        for (int c = 0; c < k[j]; ++c) it[c] = make_int2(static_cast<int>(v), c);
        if (r == 0 && hub0 != nullptr) zero_row(hub0, v, a.W);
      }
    }
  }
}

// Arcs a warp loads at once in a hop: 8 rounds of 32, each lane holding 8.
constexpr int kArcRounds = 8;
constexpr int kArcGroup = 32 * kArcRounds;

// The sources of arcs [g + 32 j + lane] (j < kArcRounds) below `end` that
// are active and, for hop r >= 1, whose source is a candidate of hop r - 1
// (`prev_cand`); -1 for the others. The active flags, then the sources, then
// the candidacy words of all rounds are loaded together.
__device__ __forceinline__ void gated_sources(const WaveArgs& a,
                                              const uint32_t* prev_cand,
                                              int64_t g, int64_t end, int lane,
                                              int32_t (&s)[kArcRounds]) {
  bool act[kArcRounds];
#pragma unroll
  for (int j = 0; j < kArcRounds; ++j) {
    const int64_t e = g + 32 * j + lane;
    act[j] = e < end && a.active[e] != 0;
  }
#pragma unroll
  for (int j = 0; j < kArcRounds; ++j) s[j] = act[j] ? a.src[g + 32 * j + lane] : -1;
  if (prev_cand != nullptr) {
#pragma unroll
    for (int j = 0; j < kArcRounds; ++j)
      if (s[j] >= 0 && prev_cand[s[j]] == 0u) s[j] = -1;
  }
}

// One hop: F_r = OR over active in-arcs (u -> v) of F_{r-1}[u], & cand[r][v],
// for the items of hop r, a warp per item, the grid striding over the
// device-side count. F_{r-1} is `prev` (vals at hop 0);
// for r >= 1 a source u is read only when cand[r-1][u] != 0 (`prev_cand`):
// F_{r-1}[u] is 0 otherwise, whatever `prev` holds there. A warp takes an
// item's arcs kArcGroup at a time (`gated_sources`). WS = 1 or 2: lanes
// over arcs, a warp OR-reduction; WS = 0: lanes over the W words, each
// gated arc's source row one coalesced load. Last the grid zeroes the rows
// of hop r + 1's split lists in `next_after` (null if none).
template <int WS>
__global__ void __launch_bounds__(kBlock)
wave_hop(WaveArgs a, int r, const uint32_t* __restrict__ prev,
         uint32_t* next, uint32_t* next_after) {
  const uint32_t* prev_cand = r > 0 ? a.cand + (r - 1) * a.n : nullptr;
  const uint32_t* cand = a.cand + r * a.n;
  const int2* items = a.items + r * a.cap;
  const int W = WS > 0 ? WS : a.W;
  const int lane = threadIdx.x & 31;
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int total = a.counts[r];
  for (int64_t i = tid >> 5; i < total; i += threads >> 5) {  // warp-uniform
    const int2 item = items[i];
    const int64_t v = item.x;
    int64_t beg = a.dst_ptr[v];
    int64_t end = a.dst_ptr[v + 1];
    if (item.y >= 0) {
      beg += item.y * a.chunk;
      end = beg + a.chunk < end ? beg + a.chunk : end;
    }
    const uint32_t mask = cand[v];
    uint32_t* row = next + v * W;
    if constexpr (WS > 0) {
      uint32_t acc[WS];
#pragma unroll
      for (int w = 0; w < WS; ++w) acc[w] = 0u;
      for (int64_t g = beg; g < end; g += kArcGroup) {
        int32_t s[kArcRounds];
        gated_sources(a, prev_cand, g, end, lane, s);
#pragma unroll
        for (int j = 0; j < kArcRounds; ++j) {
          if (s[j] < 0) continue;
#pragma unroll
          for (int w = 0; w < WS; ++w) acc[w] |= prev[static_cast<int64_t>(s[j]) * WS + w];
        }
      }
#pragma unroll
      for (int w = 0; w < WS; ++w) acc[w] = __reduce_or_sync(0xFFFFFFFFu, acc[w]) & mask;
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < WS; ++w) {
          if (item.y < 0) row[w] = acc[w];
          else if (acc[w] != 0u) atomicOr(row + w, acc[w]);
        }
      }
    } else {
      for (int w0 = 0; w0 < W; w0 += 32) {
        const int w = w0 + lane;
        uint32_t acc = 0u;
        for (int64_t g = beg; g < end; g += kArcGroup) {
          int32_t s[kArcRounds];
          gated_sources(a, prev_cand, g, end, lane, s);
#pragma unroll
          for (int j = 0; j < kArcRounds; ++j) {
            for (unsigned live = __ballot_sync(0xFFFFFFFFu, s[j] >= 0); live != 0u;
                 live &= live - 1u) {
              const int32_t sj = __shfl_sync(0xFFFFFFFFu, s[j], __ffs(live) - 1);
              if (w < W) acc |= prev[static_cast<int64_t>(sj) * W + w];
            }
          }
        }
        acc &= mask;
        if (w < W) {
          if (item.y < 0) row[w] = acc;
          else if (acc != 0u) atomicOr(row + w, acc);
        }
      }
    }
  }
  if (next_after != nullptr) {
    const int2* after = a.items + (r + 1) * a.cap;
    const int n_after = a.counts[r + 1];
    for (int64_t i = tid; i < n_after; i += threads) {
      const int2 item = after[i];
      if (item.y == 0) zero_row(next_after, item.x, W);
    }
  }
}

// The hop kernels' grid: as many blocks as fit on the card at once.
cudaError_t hop_grid(int device, int WS, unsigned* blocks) {
  static int cached[64][3];
  if (device >= 0 && device < 64 && cached[device][WS] > 0) {
    *blocks = static_cast<unsigned>(cached[device][WS]);
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = WS == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_hop<1>, kBlock, 0)
      : WS == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_hop<2>, kBlock, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_hop<0>, kBlock, 0);
  if (err != cudaSuccess) return err;
  const int g = sms * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < 64) cached[device][WS] = g;
  *blocks = static_cast<unsigned>(g);
  return cudaSuccess;
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

// L hops of F_r = OR-agg(F_{r-1}) & cand[r] (any 32-bit candidacy words),
// F_{-1} = vals, the last into `out`: 1 + L launches (the worklist pass,
// then a kernel per hop) after two memsets (counts, out). Hop r < L - 1
// writes scratch buffer r % buffers, each [n, W]; `buffers` >= min(3, L - 1),
// since while hop r reads buffer r - 1 and writes buffer r its grid zeroes
// split rows in buffer r + 1 (`scratch` may be null when L == 1). `items`
// holds L lists of `cap` >= n + m / chunk work items (int32 pairs) and
// `counts` L ints. The counts stay on the device: nothing is read back.
// Returns the first failing call's cudaError_t.
int bitset_wave_launch(const void* vals, const void* src, const void* dst_ptr,
                       const void* active, const void* cand, int L,
                       void* scratch, int buffers, void* items, void* counts,
                       void* out, long long n, long long cap, long long chunk,
                       int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || W <= 0 || L <= 0) return 0;
  if (chunk <= 0 || cap < n || buffers < (L - 1 < 3 ? L - 1 : 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WaveArgs a{static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(src),
             static_cast<const int64_t*>(dst_ptr), static_cast<const uint8_t*>(active),
             static_cast<const uint32_t*>(cand), static_cast<int2*>(items),
             static_cast<int*>(counts), n, cap, chunk, L, W};
  auto buffer = [&](int r) -> uint32_t* {
    return r == L - 1 ? static_cast<uint32_t*>(out)
                      : static_cast<uint32_t*>(scratch) + (r % buffers) * n * W;
  };
  err = cudaMemsetAsync(counts, 0, static_cast<size_t>(L) * sizeof(int), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * W * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned pass_blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  wave_worklist<<<pass_blocks, kBlock, 0, st>>>(a, L > 1 ? buffer(0) : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ws = W <= 2 ? W : 0;
  unsigned blocks = 0;
  err = hop_grid(device, ws, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int r = 0; r < L; ++r) {
    const uint32_t* prev = r == 0 ? a.vals : buffer(r - 1);
    uint32_t* next = buffer(r);
    uint32_t* after = r + 1 < L - 1 ? buffer(r + 1) : nullptr;
    if (ws == 1)
      wave_hop<1><<<blocks, kBlock, 0, st>>>(a, r, prev, next, after);
    else if (ws == 2)
      wave_hop<2><<<blocks, kBlock, 0, st>>>(a, r, prev, next, after);
    else
      wave_hop<0><<<blocks, kBlock, 0, st>>>(a, r, prev, next, after);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* bitset_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
