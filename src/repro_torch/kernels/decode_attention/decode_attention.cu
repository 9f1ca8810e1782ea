// decode_attention for Hopper (sm_90a): one query token per sequence
// against a KV cache, grouped-query layout, with a per-slot validity mask.
//
// Replaces the Pallas kernel `decode_attention_fwd` in
// src/repro/kernels/decode_attention/decode_attention.py (body `_kernel`),
// with the layout fold of its wrapper `ops.decode_attention`. For each
// (batch b, kv head hk) the G query heads h = hk * G + gi attend to the
// cache rows of kv head hk where mask[b, j] is true:
//   s_j = (q . k_j) * D^-0.5 in f32,  p_j = exp(s_j - m) on valid j only,
//   out = sum_j bf(p_j) v_j / max(sum_j p_j, 1e-30)
// with m the running max started at -1e30, so a fully masked row gives 0,
// and p cast to the input type before the PV product, as the TPU kernel
// does. The fold costs nothing here: q (B, H, D) is (B*KVH, G, D) as it
// lies, the cache is read in place in its (B, S, KVH, D) layout (row
// stride KVH * D), and the (B, S) mask is read per batch, not repeated
// per kv head.
//
// What bounds it: memory. A step must read q, the mask and the K and V
// rows of valid slots once, and write the output: at tinyllama's decode
// (B = 8, KVH = 4, G = 8, S = 2048, D = 64, bf16) about 16.8 MB, 5.0 us
// at 3.35 TB/s. The TPU kernel walks the cache in order on one core and
// carries (m, l, acc) across blocks in VMEM. Here blocks run in parallel,
// so the cache is split: grid (B*KVH, query tiles of 8, splits of S).
// Each split keeps a partial (m, l, acc) per query, and a second kernel
// merges the splits (flash-decoding). Inside a block each warp streams
// cache rows with 16-byte loads, D / VEC lanes to a row, several rows per
// warp and UNROLL rows in flight per lane; invalid slots are not read.
// Every lane group keeps its own online softmax, merged by shuffles and
// then across warps through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGq = 8;      // queries per block
constexpr int kUnroll = 4;  // cache rows in flight per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Partial state layout in the scratch buffer: for each (split, query row)
// D + 2 floats: m, l, then the D unnormalised accumulators.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, float* __restrict__ part, int kvh, int g,
    int s, int chunk, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = D / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;        // rows per warp step
  constexpr int STREAMS = kWarps * RPW;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "unsupported head dim");

  __shared__ float red[kWarps][kGq][D + 2];

  const int bkv = blockIdx.x;
  const int b = bkv / kvh;
  const int hk = bkv % kvh;
  const int g0 = blockIdx.y * kGq;
  const int ng = min(kGq, g - g0);
  const int split = blockIdx.z;
  const int lo = split * chunk;
  const int hi = min(s, lo + chunk);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane / LPR;
  const int col = (lane % LPR) * VEC;
  const int stream = warp * RPW + sub;

  float qv[kGq][VEC];
#pragma unroll
  for (int gi = 0; gi < kGq; ++gi) {
    if (gi < ng) {
      const T* qr = q + (static_cast<int64_t>(bkv) * g + g0 + gi) * D + col;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[gi][e] = to_f(qr[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[gi][e] = 0.f;
    }
  }
  float m[kGq], l[kGq], acc[kGq][VEC];
#pragma unroll
  for (int gi = 0; gi < kGq; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(kvh) * D;
  const T* kb = k + static_cast<int64_t>(b) * s * row_stride + hk * D + col;
  const T* vb = v + static_cast<int64_t>(b) * s * row_stride + hk * D + col;
  const uint8_t* mb = mask + static_cast<int64_t>(b) * s;

  // Every lane runs the same trip count, so the shuffles below see the
  // whole warp; validity only predicates the loads and the update.
  for (int base = lo; base < hi; base += STREAMS * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * STREAMS + stream;
      ok[u] = j < hi && mb[j] != 0;
      if (ok[u]) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + j * row_stride);
        vr[u] = *reinterpret_cast<const uint4*>(vb + j * row_stride);
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* kt = reinterpret_cast<const T*>(&kr[u]);
      const T* vt = reinterpret_cast<const T*>(&vr[u]);
      float kf[VEC], vf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kf[e] = to_f(kt[e]);
        vf[e] = to_f(vt[e]);
      }
#pragma unroll
      for (int gi = 0; gi < kGq; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[gi][e], kf[e], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (ok[u]) {
          const float sc = dot * scale;
          const float m_new = fmaxf(m[gi], sc);
          const float corr = expf(m[gi] - m_new);
          const float p = expf(sc - m_new);
          const float pt = to_f(from_f<T>(p));
          l[gi] = l[gi] * corr + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[gi][e] = fmaf(pt, vf[e], acc[gi][e] * corr);
          m[gi] = m_new;
        }
      }
    }
  }

  // Merge the RPW row streams of this warp (lanes LPR apart).
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int gi = 0; gi < kGq; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float m_new = fmaxf(m[gi], mo);
      const float c1 = expf(m[gi] - m_new);
      const float c2 = expf(mo - m_new);
      l[gi] = l[gi] * c1 + lo_ * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * c1 + ao * c2;
      }
      m[gi] = m_new;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int gi = 0; gi < kGq; ++gi) {
      if (col == 0) {
        red[warp][gi][0] = m[gi];
        red[warp][gi][1] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[warp][gi][2 + col + e] = acc[gi][e];
    }
  }
  __syncthreads();
  // Merge the warps: one thread per (query, element) of this block.
  const int rows = gridDim.x * g;  // B*KVH*G query rows in all
  for (int t = threadIdx.x; t < ng * (D + 2); t += kThreads) {
    const int gi = t / (D + 2);
    const int c = t % (D + 2);
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red[w][gi][0]);
    float val = 0.f;
    if (c == 0) {
      val = mm;
    } else {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) val += red[w][gi][c] * expf(red[w][gi][0] - mm);
    }
    const int64_t row = static_cast<int64_t>(bkv) * g + g0 + gi;
    part[(static_cast<int64_t>(split) * rows + row) * (D + 2) + c] = val;
  }
}

// out[row, d] = sum_i e^(m_i - M) acc_i[d] / max(sum_i e^(m_i - M) l_i, 1e-30)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int rows, int splits) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(rows) * D) return;
  const int64_t row = t / D;
  const int d = static_cast<int>(t % D);
  float mm = kNegInf;
  for (int i = 0; i < splits; ++i)
    mm = fmaxf(mm, part[(i * static_cast<int64_t>(rows) + row) * (D + 2)]);
  float ll = 0.f, aa = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float* p = part + (i * static_cast<int64_t>(rows) + row) * (D + 2);
    const float c = expf(p[0] - mm);
    ll = fmaf(p[1], c, ll);
    aa = fmaf(p[2 + d], c, aa);
  }
  out[t] = from_f<T>(aa / fmaxf(ll, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           void* part, int b, int kvh, int g, int s, int splits, cudaStream_t stream) {
  const int chunk = (s + splits - 1) / splits;
  const dim3 grid(b * kvh, (g + kGq - 1) / kGq, splits);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_partial_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(part), kvh, g, s, chunk,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = b * kvh * g;
  const int64_t n = static_cast<int64_t>(rows) * D;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  decode_combine_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), rows, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, const void* mask,
               void* out, void* part, int b, int kvh, int g, int s, int splits,
               cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, mask, out, part, b, kvh, g, s, splits, stream);
    case 64: return launch<T, 64>(q, k, v, mask, out, part, b, kvh, g, s, splits, stream);
    case 128: return launch<T, 128>(q, k, v, mask, out, part, b, kvh, g, s, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out (B, KVH*G, D); k/v (B, S, KVH, D);
// mask (B, S) bool; part (splits, B*KVH*G, D + 2) float32 scratch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, void* part, int b,
                                       int kvh, int g, int s, int d, int splits,
                                       int dtype, void* stream) {
  if (b == 0 || kvh == 0 || g == 0) return static_cast<int>(cudaSuccess);
  if (s <= 0 || splits <= 0 || splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, q, k, v, mask, out, part, b, kvh, g, s, splits, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, mask, out, part, b, kvh, g, s, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
