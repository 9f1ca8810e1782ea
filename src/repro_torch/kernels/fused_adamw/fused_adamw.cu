// The global-norm clip and AdamW with an f32 master over a whole parameter
// tree, as two launches, for Hopper (sm_90a).
//
// It replaces no TPU kernel. The reference's update is jnp code
// (src/repro/optim/optimizers.py: clip_by_global_norm, then _adamw's
// update), which XLA fuses under jit into passes that read each leaf once.
// Run op by op in PyTorch the same update is 26 passes over memory: 214
// bytes a parameter for a bf16 gradient with f32 m, v and master
// (repro_torch/optim/optimizers.py, the plain version, which CPU tensors
// still take). These two kernels compute the same numbers:
//
//   optim_norm_kernel   sum over every leaf of g^2, then on the card
//                       norm  = sqrt(sum)
//                       scale = min(1, max_norm / max(norm, 1e-9))
//   optim_adamw_kernel  per element, in the loop's order and rounding:
//                       g  = round_to_grad_dtype(g * scale)
//                       m  = m*b1 + (1-b1)*g
//                       v  = v*b2 + ((1-b2)*g)*g
//                       u  = (m/c1) / (sqrt(v/c2) + eps)  [+ wd*master, rank >= 2]
//                       master = master - lr*u;  p = round_to_param_dtype(master)
//
// What bounds them: bytes. The norm must read the gradient once (2 bytes a
// parameter in bf16), the update must read g, m, v and the master (14) and
// write m, v, the master and the parameter (14): 30 bytes a parameter, 38
// GB a step for hubert-xlarge's 1.26 B parameters, 11 ms at 3.35 TB/s. The
// arithmetic (about 20 operations an element) is far below the card's
// rate. The design does five things about that:
//
// * Two launches for the whole tree. The leaves' addresses, sizes and flags
//   (gradient and parameter dtype, decay, 16-byte alignment) travel in the
//   launch's parameters, up to kMaxLeaves leaves a launch (CUDA 12.1's
//   32 KB parameter space), as PyTorch's multi_tensor_apply carries its
//   lists: a captured graph bakes them in, and no table is copied from the
//   host. A norm gain of 2,048 elements costs no launch of its own.
// * Each block takes one contiguous range of the tree's 2,048-element
//   tiles (every leaf starts a new tile), so it streams long runs of each
//   array, and a leaf's ranges start on 16-byte boundaries.
// * 16-byte accesses: a thread takes 8 elements at a time, one int4 of
//   bf16 or two float4 of f32 for each array, all loads issued before the
//   arithmetic; a masked scalar loop takes each range's last few elements
//   and every element of a leaf whose arrays do not all start on 16 bytes.
// * A deterministic norm: a fixed grid of norm_blocks blocks, fixed ranges,
//   f64 sums of each 8-element group's f32 squares in a fixed order, and
//   the last block to finish (an atomic count that it resets to 0) sums
//   the per-block partials in index order. grad_norm repeats bit for bit.
// * The loop's rounding: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
//   __fsqrt_rn, so nvcc contracts no FMA; lr, c1, c2 and the scale are read
//   by pointer, so every replay of a graph reads the step's values.
//
// Launchers have a plain C interface (ctypes, no PyTorch headers); the
// wrapper (ops.py) allocates the workspace. They return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                        // threads a block
constexpr int kVec = 8;                              // elements a thread takes at a time
constexpr long long kTile = kThreads * kVec;         // elements a tile
constexpr int kMaxLeaves = 192;                      // leaves a launch carries

enum : int { kGradBf16 = 1, kParamBf16 = 2, kDecay = 4, kAligned = 8 };

// A launch's leaf table: 11.5 KB of kernel parameters.
struct Leaves {
  const void* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  float* w[kMaxLeaves];                              // the f32 master
  void* p[kMaxLeaves];
  long long n[kMaxLeaves];                           // elements
  long long tile0[kMaxLeaves + 1];                   // first tile of each leaf; [count] = all
  int flags[kMaxLeaves];
  int count;
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;                 // omb = 1 - b, rounded from double
};

// ---------------------------------------------------------------- helpers
// Calls f(leaf, lo, hi) for each leaf's element range in this block's
// contiguous range of tiles, in leaf order.
template <class F>
__device__ __forceinline__ void for_each_range(const Leaves& L, F&& f) {
  const long long total = L.tile0[L.count];
  const long long t0 = total * blockIdx.x / gridDim.x;
  const long long t1 = total * (blockIdx.x + 1) / gridDim.x;
  int l = 0;
  while (l < L.count && L.tile0[l + 1] <= t0) ++l;
  for (; l < L.count && L.tile0[l] < t1; ++l) {
    const long long base = L.tile0[l];
    const long long lo = (t0 > base ? t0 - base : 0) * kTile;
    const long long end = (t1 < L.tile0[l + 1] ? t1 : L.tile0[l + 1]) - base;
    const long long hi = end * kTile < L.n[l] ? end * kTile : L.n[l];
    if (lo < hi) f(l, lo, hi);
  }
}

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&x)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// Sum over the block in a fixed order (the shuffle tree, then the warps'
// sums in index order); the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += warp_sums[i];
  }
  __syncthreads();  // warp_sums may be reused by the next call
  return s;
}

// ------------------------------------------------------------- the norm
__device__ __forceinline__ float sumsq8(const float (&x)[kVec]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) s = fmaf(x[k], x[k], s);
  return s;
}

template <class G>
__device__ double sumsq_range(const G* g, long long lo, long long hi, bool aligned) {
  double acc = 0.0;
  long long i = lo + static_cast<long long>(threadIdx.x) * kVec;
  if (aligned) {
    for (; i + 3 * kTile + kVec <= hi; i += 4 * kTile) {  // four loads in flight
      float a[kVec], b[kVec], c[kVec], d[kVec];
      load8(g + i, a);
      load8(g + i + kTile, b);
      load8(g + i + 2 * kTile, c);
      load8(g + i + 3 * kTile, d);
      acc += static_cast<double>(sumsq8(a));
      acc += static_cast<double>(sumsq8(b));
      acc += static_cast<double>(sumsq8(c));
      acc += static_cast<double>(sumsq8(d));
    }
    for (; i + kVec <= hi; i += kTile) {
      float a[kVec];
      load8(g + i, a);
      acc += static_cast<double>(sumsq8(a));
    }
    lo += (hi - lo) / kVec * kVec;  // the last elements, scalar
  }
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    const float x = to_float(g[j]);
    acc += static_cast<double>(x * x);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) optim_norm_kernel(
    const Leaves L, double* partials, int offset, int total_partials, int finish,
    unsigned int* done, float max_norm, float* out) {
  double acc = 0.0;
  for_each_range(L, [&](int l, long long lo, long long hi) {
    const bool aligned = L.flags[l] & kAligned;
    if (L.flags[l] & kGradBf16)
      acc += sumsq_range(static_cast<const __nv_bfloat16*>(L.g[l]), lo, hi, aligned);
    else
      acc += sumsq_range(static_cast<const float*>(L.g[l]), lo, hi, aligned);
  });
  acc = block_sum(acc);
  if (!finish) {
    if (threadIdx.x == 0) partials[offset + blockIdx.x] = acc;
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[offset + blockIdx.x] = acc;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile double* all = partials;
  double s = 0.0;
  for (int i = threadIdx.x; i < total_partials; i += kThreads) s += all[i];
  s = block_sum(s);
  if (threadIdx.x == 0) {
    *done = 0;  // ready for the next launch, or the next replay
    const float norm = __fsqrt_rn(static_cast<float>(s));
    // torch: clamp(max_norm / clamp(norm, min=1e-9), max=1.0), where
    // float / tensor is reciprocal(tensor) * float; NaN passes through.
    const float den = norm < 1e-9f ? 1e-9f : norm;
    const float ratio = __fmul_rn(__fdiv_rn(1.0f, den), max_norm);
    out[0] = norm;
    out[1] = ratio > 1.0f ? 1.0f : ratio;
  }
}

// ------------------------------------------------------------ the update
struct Step {
  float scale, lr, c1, c2;
};

__device__ __forceinline__ void adamw(float g, float& m, float& v, float& w, bool decay,
                                      const Step& s, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, w));
  w = __fsub_rn(w, __fmul_rn(s.lr, u));
}

template <class G, class P>
__device__ void update_range(const G* g, float* m, float* v, float* w, P* p, long long lo,
                             long long hi, bool aligned, bool decay, const Step& s,
                             const Hyper& h) {
  if (aligned) {
    for (long long i = lo + static_cast<long long>(threadIdx.x) * kVec; i + kVec <= hi;
         i += kTile) {
      float gx[kVec], mx[kVec], vx[kVec], wx[kVec];
      load8(g + i, gx);
      load8(m + i, mx);
      load8(v + i, vx);
      load8(w + i, wx);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        adamw(round_to(__fmul_rn(gx[k], s.scale), g), mx[k], vx[k], wx[k], decay, s, h);
      store8(m + i, mx);
      store8(v + i, vx);
      store8(w + i, wx);
      store8(p + i, wx);
    }
    lo += (hi - lo) / kVec * kVec;  // the last elements, scalar
  }
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    float mj = m[j], vj = v[j], wj = w[j];
    adamw(round_to(__fmul_rn(to_float(g[j]), s.scale), g), mj, vj, wj, decay, s, h);
    m[j] = mj;
    v[j] = vj;
    w[j] = wj;
    put(p + j, wj);
  }
}

template <class G>
__device__ __forceinline__ void update_leaf(const Leaves& L, int l, long long lo, long long hi,
                                            const Step& s, const Hyper& h) {
  const int f = L.flags[l];
  const G* g = static_cast<const G*>(L.g[l]);
  if (f & kParamBf16)
    update_range(g, L.m[l], L.v[l], L.w[l], static_cast<__nv_bfloat16*>(L.p[l]), lo, hi,
                 f & kAligned, f & kDecay, s, h);
  else
    update_range(g, L.m[l], L.v[l], L.w[l], static_cast<float*>(L.p[l]), lo, hi,
                 f & kAligned, f & kDecay, s, h);
}

__global__ void __launch_bounds__(kThreads) optim_adamw_kernel(
    const Leaves L, const float* scale, const float* lr, const float* c1, const float* c2,
    const Hyper h) {
  const Step s{*scale, *lr, *c1, *c2};
  for_each_range(L, [&](int l, long long lo, long long hi) {
    if (L.flags[l] & kGradBf16)
      update_leaf<__nv_bfloat16>(L, l, lo, hi, s, h);
    else
      update_leaf<float>(L, l, lo, hi, s, h);
  });
}

// ------------------------------------------------------------ launchers
bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Leaves [begin, begin + count) of the host arrays into a launch's table.
// m, v, w and p may be null (the norm reads only g).
void fill(Leaves& L, int begin, int count, const void* const* g, void* const* m,
          void* const* v, void* const* w, void* const* p, const long long* n,
          const int* flags) {
  L.count = count;
  L.tile0[0] = 0;
  for (int i = 0; i < count; ++i) {
    const int k = begin + i;
    L.g[i] = g[k];
    L.m[i] = m ? static_cast<float*>(m[k]) : nullptr;
    L.v[i] = v ? static_cast<float*>(v[k]) : nullptr;
    L.w[i] = w ? static_cast<float*>(w[k]) : nullptr;
    L.p[i] = p ? p[k] : nullptr;
    L.n[i] = n[k];
    L.tile0[i + 1] = L.tile0[i] + (n[k] + kTile - 1) / kTile;
    bool al = aligned16(g[k]);
    if (m) al = al && aligned16(m[k]) && aligned16(v[k]) && aligned16(w[k]) && aligned16(p[k]);
    L.flags[i] = (flags[k] & (kGradBf16 | kParamBf16 | kDecay)) | (al ? kAligned : 0);
  }
}

int adamw_grid() {
  // Resident blocks on the whole card, read once per process and device.
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev < 0 || dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, optim_adamw_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return -static_cast<int>(e);
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

extern "C" int fused_adamw_max_leaves() { return kMaxLeaves; }

// Sum of squares of every gradient leaf into partials[0, launches *
// norm_blocks), then norm and scale into out[0] and out[1]; one launch per
// kMaxLeaves leaves. `done` is an unsigned count at 0, left at 0.
extern "C" int fused_adamw_norm_launch(int count, const void* const* g, const long long* n,
                                       const int* flags, void* partials, int norm_blocks,
                                       void* done, float max_norm, void* out, void* stream) {
  if (count <= 0 || norm_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int launches = (count + kMaxLeaves - 1) / kMaxLeaves;
  Leaves L;
  for (int k = 0; k < launches; ++k) {
    const int begin = k * kMaxLeaves;
    const int here = count - begin < kMaxLeaves ? count - begin : kMaxLeaves;
    fill(L, begin, here, g, nullptr, nullptr, nullptr, nullptr, n, flags);
    optim_norm_kernel<<<norm_blocks, kThreads, 0, s>>>(
        L, static_cast<double*>(partials), k * norm_blocks, launches * norm_blocks,
        k == launches - 1, static_cast<unsigned int*>(done), max_norm,
        static_cast<float*>(out));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// The update of every leaf by the scale at `scale` and the step's lr, c1
// and c2 (0-d f32 device tensors); one launch per kMaxLeaves leaves.
extern "C" int fused_adamw_update_launch(int count, const void* const* g, void* const* m,
                                         void* const* v, void* const* w, void* const* p,
                                         const long long* n, const int* flags,
                                         const void* scale, const void* lr, const void* c1,
                                         const void* c2, float b1, float omb1, float b2,
                                         float omb2, float eps, float wd, void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = adamw_grid();
  if (grid <= 0) return grid < 0 ? -grid : static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const int launches = (count + kMaxLeaves - 1) / kMaxLeaves;
  Leaves L;
  for (int k = 0; k < launches; ++k) {
    const int begin = k * kMaxLeaves;
    const int here = count - begin < kMaxLeaves ? count - begin : kMaxLeaves;
    fill(L, begin, here, g, m, v, w, p, n, flags);
    const long long tiles = L.tile0[here];
    const int blocks = tiles < grid ? static_cast<int>(tiles > 0 ? tiles : 1) : grid;
    optim_adamw_kernel<<<blocks, kThreads, 0, s>>>(
        L, static_cast<const float*>(scale), static_cast<const float*>(lr),
        static_cast<const float*>(c1), static_cast<const float*>(c2), h);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* fused_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
