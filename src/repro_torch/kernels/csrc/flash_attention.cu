// Forward attention with an online softmax for f32 inputs on Hopper
// (sm_90a), behind a plain C interface loaded with ctypes (kernels/build.py,
// kernels/ops.py).
//
// flash_attention replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`) for f32 inputs: for q [B, Hq, S, Dqk], k
// [B, Hkv, S, Dqk] and v [B, Hkv, S, Dv] (Hq a multiple of Hkv, query head h
// reading kv head h / (Hq / Hkv)), o [B, Hq, S, Dv] = softmax(q k^T /
// sqrt(Dqk) + mask) v in f32, with a causal mask and/or a sliding window
// (key > query - window). As in the TPU kernel,
// q is scaled before the product, the running max, the running denominator
// and the accumulator are f32, a masked logit is -1e30, the output is divided
// by max(l, 1e-30), and a kv tile that the mask rules out for the whole q
// tile is never visited. The TPU kernel needs S % 128 == 0 and D >= 128; this
// one takes any S (the last q and kv tiles are masked at S) and (Dqk, Dv) in
// {(64, 64), (128, 128), (256, 256), (192, 128)} (MLA's pair). bf16 inputs go to the tensor-core kernel of
// flash_attention_sm90.cu; this kernel no longer has a bf16 instantiation.
//
// One block of 256 threads per (q tile of 64 rows, query head, batch row),
// the q tiles launched last-first so that the long causal rows start early.
// The block keeps its scaled q tile in shared memory and walks the live kv
// tiles of 64 keys: it stages k and v in shared memory, computes the
// 64 x 64 logits on the CUDA cores (thread (ty, tx) owns rows ty + 16 i and
// keys tx + 16 j, i, j < 4, reading float4s of padded rows, so no bank
// conflicts), reduces the row max and sum across the 16 threads of a row
// with shuffles, writes p to shared memory and adds p v into its 4 rows x
// Dv / 16 output columns (4 tx + 64 c + e) held in registers. The output is
// written once, at the end.
//
// What bounds it on this card: operations. Causal attention at S = 32768,
// D = 128 does 128 multiply-adds per logit and per output element. In f32
// that work runs on the CUDA cores (67 TFLOP/s at most, about half of that
// with two shared-memory loads per four multiply-adds); the kernel keeps f32
// inputs exact to f32 rounding, which the f32 parity of the LM path (card
// against CPU) relies on.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float component(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Element strides of a [B, H, S, D] operand whose last axis is contiguous.
struct Strides {
  long long b, h, s;
};

template <int Dqk, int Dv>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBq) * (Dqk + 4) + static_cast<size_t>(kBk) * (Dqk + 4) +
          static_cast<size_t>(kBk) * Dv + static_cast<size_t>(kBq) * (kBk + 4));
}

template <int Dqk, int Dv>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int s_len, int group, float scale, int causal,
                       int window) {
  constexpr int kRow = Dqk + 4;   // padded row of the q and k tiles
  constexpr int kProw = kBk + 4;  // padded row of the p tile
  constexpr int kCols = Dv / 64;  // float4 column groups of o per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [kBq][kRow], scaled
  float* kt = qt + kBq * kRow;    // [kBk][kRow]
  float* vt = kt + kBk * kRow;    // [kBk][Dv]
  float* pt = vt + kBk * Dv;      // [kBq][kProw]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qi * kBq;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;

  for (int idx = tid; idx < kBq * Dqk; idx += kThreads) {
    const int r = idx / Dqk, d = idx % Dqk;
    const int row = q0 + r;
    qt[r * kRow + d] =
        row < s_len ? qb[row * qs.s + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // the kv tiles that hold a live key for some row of this q tile
  const int q_last = min(q0 + kBq, s_len) - 1;
  int kv_end = (s_len + kBk - 1) / kBk;
  if (causal) kv_end = min(kv_end, q_last / kBk + 1);
  int kv_begin = 0;
  if (window > 0) {
    const int first_key = q0 - window + 1;  // row q0's first live key
    kv_begin = first_key > 0 ? first_key / kBk : 0;
  }

  for (int kti = kv_begin; kti < kv_end; ++kti) {
    const int k0 = kti * kBk;
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int idx = tid; idx < kBk * Dqk; idx += kThreads) {
      const int r = idx / Dqk, d = idx % Dqk;
      const int key = k0 + r;
      kt[r * kRow + d] = key < s_len ? kb[key * ks.s + d] : 0.f;
    }
    for (int idx = tid; idx < kBk * Dv; idx += kThreads) {
      const int r = idx / Dv, d = idx % Dv;
      const int key = k0 + r;
      vt[r * Dv + d] = key < s_len ? vb[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dqk; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qt[(ty + 16 * i) * kRow + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(&kt[(tx + 16 * j) * kRow + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        bool live = key < s_len;
        if (causal) live = live && row >= key;
        if (window > 0) live = live && key > row - window;
        s[i][j] = live ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt[(ty + 16 * i) * kProw + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBk; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&pt[(ty + 16 * i) * kProw + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &vt[(kk + e) * Dv + 64 * c + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = component(p4[i], e);
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + row * os.s;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[64 * c + 4 * tx + e] = acc[i][c][e] / denom;
  }
}

template <int Dqk, int Dv>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long batch, int hq, int hkv, int s_len,
                   const long long* st, int causal, int window,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<Dqk, Dv>;
  constexpr size_t smem = smem_bytes<Dqk, Dv>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBq - 1) / kBq, hq, static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, s_len,
      hq / hkv, static_cast<float>(1.0 / sqrt(static_cast<double>(Dqk))), causal,
      window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for f32 q [B, Hq, S, d], k [B, Hkv, S, d],
// v [B, Hkv, S, dv], o [B, Hq, S, dv], the logits scaled by 1 / sqrt(d).
// `strides` holds the element strides (batch, head, position) of q, k, v
// and o in that order; the last axis of each is contiguous. causal: 0 or 1;
// window <= 0 means none. Returns the cudaError_t of the launch (0 =
// launched); a (d, dv) pair not built here or a grid out of range returns
// cudaErrorInvalidValue.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, long long batch, int hq, int hkv,
                           int s_len, int d, int dv, const long long* strides,
                           int causal, int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || s_len <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dv == 64)
    return static_cast<int>(
        launch<64, 64>(q, k, v, o, batch, hq, hkv, s_len, strides, causal, window, s));
  if (d == 128 && dv == 128)
    return static_cast<int>(
        launch<128, 128>(q, k, v, o, batch, hq, hkv, s_len, strides, causal, window, s));
  if (d == 256 && dv == 256)
    return static_cast<int>(
        launch<256, 256>(q, k, v, o, batch, hq, hkv, s_len, strides, causal, window, s));
  if (d == 192 && dv == 128)
    return static_cast<int>(
        launch<192, 128>(q, k, v, o, batch, hq, hkv, s_len, strides, causal, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
