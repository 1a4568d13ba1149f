// Fused four-way neighbourhood aggregation for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes (kernels/build.py, kernels/ops.py).
//
// segment_agg replaces the TPU kernel src/repro/kernels/segment_agg.py
// (`segment_agg`): for feats [NT, D, F] (f32 or bf16) and a valid-neighbour
// mask [NT, D], out[NT, 4, F] (f32) holds, over the valid neighbours of each
// row, the sum, the min, the max and the sum of squares. The identities are
// 0, +3.0e38, -3.0e38 and 0 (the JAX kernel's BIG, not FLT_MAX), so a row
// without a valid neighbour writes them and the wrapper's caller cleans it.
// The TPU kernel tiles (8 rows, 128 columns) into VMEM and reduces the
// middle axis on the VPU, which is why it only takes NT % 8 == 0 and
// F % 128 == 0; this one takes any NT, D and F.
//
// What bounds it on this card: bytes. Each feature is read once and costs
// five float operations, far below the card's ~20 operations per byte of
// its 3.35 TB/s. So the mapping only keeps loads coalesced and wide:
// threads run along F, each owning V consecutive columns (V elements of up
// to 16 bytes in one load: V = 4 for f32 when F % 4 == 0, V = 2 for even F,
// V = 8 / 4 / 2 for bf16 likewise, else 1), and loop over the D neighbours
// in registers; a warp reads one contiguous stretch of a neighbour row. A
// block holds TX threads along F (F / V rounded up to a warp, at most 512)
// and TY = max(1, 256 / TX) rows. The mask is uniform across a row, so a
// masked neighbour is skipped without a load: a NaN or Inf in a masked
// slot never reaches an accumulator. min / max propagate a NaN of a valid
// neighbour, like the plain version's `amin` / `amax`. Each row's four
// outputs are written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kMaxTx = 512;
constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxTx)
segment_agg_kernel(const T* __restrict__ feats,
                   const uint8_t* __restrict__ mask,
                   float* __restrict__ out, int64_t nt, int d, int f) {
  const int fv = f / V;  // vector columns per row (f % V == 0)
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= fv) return;
  const int64_t row_step = static_cast<int64_t>(gridDim.y) * blockDim.y;
  for (int64_t row = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y;
       row < nt; row += row_step) {
    float s[V], mn[V], mx[V], sq[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = 0.f;
      mn[k] = kBig;
      mx[k] = -kBig;
      sq[k] = 0.f;
    }
    const T* base = feats + row * d * f + static_cast<int64_t>(col) * V;
    const uint8_t* mrow = mask + row * d;
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      if (!mrow[j]) continue;
      const Pack<T, V> p =
          *reinterpret_cast<const Pack<T, V>*>(base + static_cast<int64_t>(j) * f);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float x = to_float(p.v[k]);
        s[k] += x;
        sq[k] += x * x;
        mn[k] = (x < mn[k] || x != x) ? x : mn[k];
        mx[k] = (x > mx[k] || x != x) ? x : mx[k];
      }
    }
    float* o = out + row * 4 * f + static_cast<int64_t>(col) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      o[k] = s[k];
      o[f + k] = mn[k];
      o[2 * f + k] = mx[k];
      o[3 * f + k] = sq[k];
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* feats, const void* mask, void* out,
                   int64_t nt, int d, int f, cudaStream_t stream) {
  const int fv = f / V;
  int tx = ((fv + 31) / 32) * 32;
  if (tx > kMaxTx) tx = kMaxTx;
  const int ty = tx >= kThreads ? 1 : kThreads / tx;
  const int64_t row_blocks = (nt + ty - 1) / ty;
  const dim3 grid((fv + tx - 1) / tx,
                  static_cast<unsigned>(row_blocks < 65535 ? row_blocks : 65535));
  segment_agg_kernel<T, V><<<grid, dim3(tx, ty), 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), nt, d, f);
  return cudaGetLastError();
}

// The widest V (elements per load, at most 16 bytes) that divides F and
// keeps every load aligned: the row starts of feats are multiples of F
// elements from its base, so the base must be aligned to V elements too.
int vector_width(const void* feats, int f, int elem_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(feats);
  for (int v = 16 / elem_bytes; v > 1; v /= 2) {
    if (f % v == 0 && addr % (static_cast<uintptr_t>(v) * elem_bytes) == 0) {
      return v;
    }
  }
  return 1;
}

template <typename T>
cudaError_t launch_typed(const void* feats, const void* mask, void* out,
                         int64_t nt, int d, int f, cudaStream_t stream) {
  const int v = vector_width(feats, f, sizeof(T));
  if constexpr (sizeof(T) == 2) {  // 8 elements in 16 bytes: bf16 only
    if (v == 8) return launch<T, 8>(feats, mask, out, nt, d, f, stream);
  }
  switch (v) {
    case 4: return launch<T, 4>(feats, mask, out, nt, d, f, stream);
    case 2: return launch<T, 2>(feats, mask, out, nt, d, f, stream);
    default: return launch<T, 1>(feats, mask, out, nt, d, f, stream);
  }
}

}  // namespace

extern "C" {

// out[NT, 4, F] f32 = (sum, min, max, sum of squares) over the valid
// neighbours of feats[NT, D, F] (dtype 0: f32, 1: bf16) under mask
// bool[NT, D]; all three contiguous. Returns the cudaError_t of the launch
// (0 = launched); an unknown dtype returns cudaErrorInvalidValue.
int segment_agg_launch(const void* feats, const void* mask, void* out,
                       long long nt, int d, int f, int dtype, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nt <= 0 || f <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_typed<float>(feats, mask, out, nt, d, f, s));
    case 1:
      return static_cast<int>(
          launch_typed<__nv_bfloat16>(feats, mask, out, nt, d, f, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
