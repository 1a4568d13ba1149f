// Weighted embedding bags for Hopper (sm_90a), behind a plain C interface
// loaded with ctypes (kernels/build.py, kernels/ops.py).
//
// embedding_bag replaces the TPU kernel src/repro/kernels/embedding_bag.py
// (`embedding_bag`): for table [V, D] (f32 or bf16), ids int32[B, L] and
// weights f32[B, L], out[b] = sum over l of weights[b, l] * table[ids[b, l]],
// accumulated in f32 in slot order and written once in the table's dtype;
// mode "mean" divides by the count of nonzero weights of the bag (at least
// 1). Padding is id 0 with weight 0: the row is read and multiplied by 0, as
// in the reference. Ids follow `jnp.take`: a negative id counts from the end
// of the table, and an id outside [-V, V) reads a row of NaN. The TPU kernel
// walks one (bag, slot) per sequential grid step with the ids prefetched to
// pick the table block; here every bag runs at once.
//
// A group of G threads (a power of two, at most a warp) owns a bag: each
// thread owns V consecutive columns (loads of up to 16 bytes: V = 8 for
// bf16 when D % 8 == 0, and so on down to 1), loops over the L slots in
// registers, and stores its columns once. G is the smallest power of two
// that covers D / V columns, capped at 32 (wider rows loop over columns), so
// a bag of D = 64 bf16 is 8 threads reading one 128-byte row.
//
// What bounds it on this card: bytes. Each slot reads a 4-byte id, a 4-byte
// weight and one table row and does one multiply-add per element; each bag
// writes one row. The retrieval path's bags of one id over a [1,000,002, 64]
// bf16 table move 136 bytes per candidate. Rows are gathered at random, so
// the design only keeps each row one coalesced access.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                     const float* __restrict__ weights, T* __restrict__ out,
                     long long n_bags, int bag_len, int d, long long n_rows,
                     int group, int mean) {
  const int dv = d / V;  // vector columns per row (d % V == 0)
  const int lane = threadIdx.x % group;
  const int bags_per_block = kThreads / group;
  const long long step = static_cast<long long>(gridDim.x) * bags_per_block;
  for (long long bag = static_cast<long long>(blockIdx.x) * bags_per_block +
                       threadIdx.x / group;
       bag < n_bags; bag += step) {
    const int32_t* bid = ids + bag * bag_len;
    const float* bw = weights + bag * bag_len;
    for (int col = lane; col < dv; col += group) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      int count = 0;
      for (int j = 0; j < bag_len; ++j) {
        long long id = bid[j];
        const float w = bw[j];
        count += w != 0.f;
        if (id < 0) id += n_rows;
        if (id < 0 || id >= n_rows) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = __int_as_float(0x7fc00000);  // NaN
          continue;
        }
        const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(
            table + id * d + static_cast<long long>(col) * V);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(w, to_float(p.v[e]), acc[e]);
      }
      const float denom = mean ? fmaxf(static_cast<float>(count), 1.f) : 1.f;
      Pack<T, V> r;
#pragma unroll
      for (int e = 0; e < V; ++e) from_float(&r.v[e], mean ? acc[e] / denom : acc[e]);
      *reinterpret_cast<Pack<T, V>*>(out + bag * d + static_cast<long long>(col) * V) = r;
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* table, const void* ids, const void* weights,
                   void* out, long long n_bags, int bag_len, int d,
                   long long n_rows, int mean, cudaStream_t stream) {
  const int dv = d / V;
  int group = 1;
  while (group < dv && group < 32) group *= 2;
  const long long bags_per_block = kThreads / group;
  const long long blocks = (n_bags + bags_per_block - 1) / bags_per_block;
  embedding_bag_kernel<T, V><<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                               kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(weights), static_cast<T*>(out), n_bags,
      bag_len, d, n_rows, group, mean);
  return cudaGetLastError();
}

// The widest V (elements per load, at most 16 bytes) that divides D and
// keeps every row load aligned: rows start at multiples of D elements from
// the table's base, so the base must be aligned to V elements too.
int vector_width(const void* table, int d, int elem_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(table);
  for (int v = 16 / elem_bytes; v > 1; v /= 2) {
    if (d % v == 0 && addr % (static_cast<uintptr_t>(v) * elem_bytes) == 0) {
      return v;
    }
  }
  return 1;
}

template <typename T>
cudaError_t launch_typed(const void* table, const void* ids, const void* weights,
                         void* out, long long n_bags, int bag_len, int d,
                         long long n_rows, int mean, cudaStream_t stream) {
  const int v = vector_width(table, d, sizeof(T));
  if constexpr (sizeof(T) == 2) {  // 8 elements in 16 bytes: bf16 only
    if (v == 8)
      return launch<T, 8>(table, ids, weights, out, n_bags, bag_len, d, n_rows, mean, stream);
  }
  switch (v) {
    case 4:
      return launch<T, 4>(table, ids, weights, out, n_bags, bag_len, d, n_rows, mean, stream);
    case 2:
      return launch<T, 2>(table, ids, weights, out, n_bags, bag_len, d, n_rows, mean, stream);
    default:
      return launch<T, 1>(table, ids, weights, out, n_bags, bag_len, d, n_rows, mean, stream);
  }
}

}  // namespace

extern "C" {

// out[B, D] = the weighted bags of table[V, D] (dtype 0: f32, 1: bf16) over
// ids int32[B, L] and weights f32[B, L]; mean: 0 (sum) or 1 (mean over the
// nonzero weights). All four contiguous. Returns the cudaError_t of the
// launch (0 = launched); an unknown dtype returns cudaErrorInvalidValue.
int embedding_bag_launch(const void* table, const void* ids, const void* weights,
                         void* out, long long n_bags, int bag_len, int d,
                         long long n_rows, int mean, int dtype, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bags <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_typed<float>(
          table, ids, weights, out, n_bags, bag_len, d, n_rows, mean, s));
    case 1:
      return static_cast<int>(launch_typed<__nv_bfloat16>(
          table, ids, weights, out, n_bags, bag_len, d, n_rows, mean, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
