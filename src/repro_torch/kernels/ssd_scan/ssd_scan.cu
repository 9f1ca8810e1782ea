// ssd_scan_fwd for Hopper (sm_90a): the Mamba-2 SSD scan in its chunked
// form, the (P, N) state carried across chunks inside one block.
//
// Replaces the Pallas kernel `ssd_scan_fwd` in
// src/repro/kernels/ssd_scan/ssd_scan.py (body `_kernel`). For one
// (batch, head) with decay rate a < 0, step sizes dt, inputs x (S, P) and
// B, C (S, N), it computes the recurrence
//   h_t = exp(a dt_t) h_{t-1} + dt_t x_t B_tᵀ,   y_t = h_t C_t,   h_0 = 0,
// tile by tile of T = 64 time steps. With seg the inclusive cumsum of
// dt a over the tile and total its last value:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j   (intra)
//         + exp(seg_i) C_i stateᵀ                                  (inter)
//   state = state exp(total) + sum_j exp(total - seg_j) dt_j x_j B_jᵀ.
// The exponent exp(seg_i - seg_j) is taken only where j <= i: above the
// diagonal seg_i - seg_j > 0 and its exp can overflow, and 0 * inf would
// be NaN. All arithmetic is f32 with the state in f32 (TF32 would not hold
// the registry's f32 2e-4); bf16 inputs are widened in registers, which is
// exact. The state after the last tile is written as a second output (the
// Mamba-2 decode cache); the TPU kernel keeps it in VMEM scratch and drops
// it.
//
// The tile: the TPU grid's sequential chunk axis becomes a loop inside one
// block. The kernel runs its own 64-step tile whatever the caller's chunk
// (the model's 256, or 16, 24, 1 in the tests): the chunked form computes
// the same function for any chunk length, up to f32 rounding, and a 64-step
// tile keeps x, B, C, the intra-tile weights and the state in 88 KB of
// shared memory, two blocks per SM. Tail tiles are zero-padded: padded rows
// have dt = 0, so they add nothing to the state, and they are never stored.
//
// Layouts in place: x and y in the model's (B, S, H, P), dt (B, S, H), and
// one B and C (B, S, N) shared by every head (n_groups = 1) are read
// through strides, with a head stride of 0 for B and C; x, B and C may be
// column slices of the conv output (a row stride of H*P + 2N). The
// reference kernel's (BH, S, P) layout is the same code with H = 1.
//
// What bounds it: operations. One block per (batch, head), 256 threads,
// each owning a 4 x 4 block of every product and a 4 x 4 block of the state
// in registers. The bound counts the least work of the function, the bare
// recurrence: per step and head a P x N outer product into the state and a
// P x N contraction out of it, 4 P N FLOP. At Zamba2's prefill (B = 8, 64
// heads, S = 3584, P = N = 64) that is 30.1 GFLOP, 0.45 ms at 67 TFLOP/s
// (f32 outside the tensor cores), against 0.73 GB of traffic (bf16 x, B,
// C; f32 dt, y and final state), 0.22 ms at 3.35 TB/s. The chunked form
// this kernel runs does more: per full tile (T(T+1)/2)(N + P) + 2 T N P
// multiply-adds (the causal half of the intra term, the inter term, the
// state update), 45.3 GFLOP there. C Bᵀ is recomputed for every head,
// although the heads share it, and the f32 products run on the CUDA cores
// out of shared memory: sharing C Bᵀ, and the tensor cores for bf16, are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kT = 64;          // time steps per tile
constexpr int kMax = 64;        // largest P and N
constexpr int kLd = kMax + 4;   // shared row stride: float4 reads stay conflict-free
constexpr int kSmemFloats = 4 * kT * kLd + kMax * kLd + 4 * kT;
constexpr int kSmemBytes = kSmemFloats * static_cast<int>(sizeof(float));

// Element strides of every operand; B and C have no head stride (shared).
struct Strides {
  long long x_b, x_t, x_h;
  long long dt_b, dt_t, dt_h;
  long long a_b, a_h;
  long long b_b, b_t;
  long long c_b, c_t;
  long long y_b, y_t, y_h;
};
constexpr int kNumStrides = sizeof(Strides) / sizeof(long long);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][c] += sum_q a[r].q * b[q].c, the 4-deep step of a 4 x 4 product.
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float ar[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[r][0] = fmaf(ar[q], b[q].x, acc[r][0]);
      acc[r][1] = fmaf(ar[q], b[q].y, acc[r][1]);
      acc[r][2] = fmaf(ar[q], b[q].z, acc[r][2]);
      acc[r][3] = fmaf(ar[q], b[q].w, acc[r][3]);
    }
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(
    const Tin* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const Tin* __restrict__ bmat, const Tin* __restrict__ cmat, float* __restrict__ y,
    const float* __restrict__ state0, float* __restrict__ final_state, int h, int s, int p,
    int n, Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // (T, kLd) x tile
  float* bs = xs + kT * kLd;    // (T, kLd) B tile, then w_j B_j
  float* cs = bs + kT * kLd;    // (T, kLd) C tile, then exp(seg_i) C_i
  float* att = cs + kT * kLd;   // (T, kLd) intra-tile weights, 0 where j > i
  float* stT = att + kT * kLd;  // (kMax, kLd) the state transposed: stT[n][p]
  float* seg = stT + kMax * kLd;
  float* dts = seg + kT;
  float* ev = dts + kT;         // exp(seg_i)
  float* wv = ev + kT;          // exp(total - seg_j) dt_j

  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n4 = (n + 3) / 4 * 4;

  const float av = a[bb * st.a_b + hh * st.a_h];
  const Tin* xb = x + bb * st.x_b + hh * st.x_h;
  const float* dtb = dt + bb * st.dt_b + hh * st.dt_h;
  const Tin* bb_ = bmat + bb * st.b_b;
  const Tin* cb_ = cmat + bb * st.c_b;
  float* yb = y + bb * st.y_b + hh * st.y_h;
  const int64_t sbase = (static_cast<int64_t>(bb) * h + hh) * p * n;

  // This thread's state: rows n = ty*4 + r, columns p = tx*4 + c of stT.
  float sreg[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int nn = ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pp = tx * 4 + c;
      sreg[r][c] = state0 != nullptr && nn < n && pp < p ? state0[sbase + pp * n + nn] : 0.f;
    }
    *reinterpret_cast<float4*>(stT + nn * kLd + tx * 4) =
        make_float4(sreg[r][0], sreg[r][1], sreg[r][2], sreg[r][3]);
  }

  for (int t0 = 0; t0 < s; t0 += kT) {
    const int len = min(kT, s - t0);
    __syncthreads();  // the previous tile's readers are done

    // ---- load the tile, zero-padded past len rows and past P / N columns
    for (int idx = tid; idx < kT * kMax; idx += kThreads) {
      const int i = idx / kMax;
      const int col = idx % kMax;
      const bool row = i < len;
      const int64_t t = t0 + i;
      xs[i * kLd + col] = row && col < p ? to_f32(xb[t * st.x_t + col]) : 0.f;
      bs[i * kLd + col] = row && col < n ? to_f32(bb_[t * st.b_t + col]) : 0.f;
      cs[i * kLd + col] = row && col < n ? to_f32(cb_[t * st.c_t + col]) : 0.f;
    }
    if (tid < kT) dts[tid] = tid < len ? dtb[(t0 + tid) * st.dt_t] : 0.f;
    __syncthreads();

    // ---- seg: inclusive cumsum of dt a over the tile (warp 0, two rows a lane)
    if (tid < 32) {
      const float v0 = dts[2 * tid] * av;
      const float v1 = v0 + dts[2 * tid + 1] * av;
      float incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      seg[2 * tid] = excl + v0;
      seg[2 * tid + 1] = excl + v1;
    }
    __syncthreads();
    const float total = seg[len - 1];
    if (tid < kT) {
      ev[tid] = expf(seg[tid]);
      wv[tid] = tid < len ? expf(total - seg[tid]) * dts[tid] : 0.f;
    }

    // ---- att[i][j] = (C_i . B_j) exp(seg_i - seg_j) dt_j for j <= i < len
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < n4; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ty * 4 + r) * kLd + k);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = ld4(bs + (tx + 16 * c) * kLd + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(cv[r].x, bv[c].x, fmaf(cv[r].y, bv[c].y,
                        fmaf(cv[r].z, bv[c].z, fmaf(cv[r].w, bv[c].w, acc[r][c]))));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          // Mask first: exp only where j <= i, so the exponent is <= 0.
          att[i * kLd + j] = j <= i && i < len ? acc[r][c] * expf(seg[i] - seg[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- fold the row factors in: B_j <- w_j B_j, C_i <- exp(seg_i) C_i
    for (int idx = tid; idx < kT * kMax; idx += kThreads) {
      const int i = idx / kMax;
      const int col = idx % kMax;
      bs[i * kLd + col] *= wv[i];
      cs[i * kLd + col] *= ev[i];
    }
    __syncthreads();

    // ---- y_i = sum_{j <= i} att[i][j] x_j + (exp(seg_i) C_i) stateᵀ
    {
      float yacc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[r][c] = 0.f;
      const int jend = min(ty * 4 + 4, (len + 3) / 4 * 4);  // att is 0 past row i
      for (int j = 0; j < jend; j += 4) {
        float4 av4[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av4[r] = ld4(att + (ty * 4 + r) * kLd + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = ld4(xs + (j + q) * kLd + tx * 4);
        fma4x4(yacc, av4, xv);
      }
      for (int k = 0; k < n4; k += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ty * 4 + r) * kLd + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = ld4(stT + (k + q) * kLd + tx * 4);
        fma4x4(yacc, cv, sv);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        if (i < len) {
          float* yrow = yb + (t0 + i) * st.y_t;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (tx * 4 + c < p) yrow[tx * 4 + c] = yacc[r][c];
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // ---- state <- state exp(total) + sum_j (w_j B_j) x_jᵀ, in registers
    {
      const float dec = expf(total);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sreg[r][c] *= dec;
      for (int j = 0; j < len; ++j) {
        const float4 bw = ld4(bs + j * kLd + ty * 4);
        const float4 xv = ld4(xs + j * kLd + tx * 4);
        const float bn[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sreg[r][0] = fmaf(bn[r], xv.x, sreg[r][0]);
          sreg[r][1] = fmaf(bn[r], xv.y, sreg[r][1]);
          sreg[r][2] = fmaf(bn[r], xv.z, sreg[r][2]);
          sreg[r][3] = fmaf(bn[r], xv.w, sreg[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(stT + (ty * 4 + r) * kLd + tx * 4) =
            make_float4(sreg[r][0], sreg[r][1], sreg[r][2], sreg[r][3]);
    }
  }

  if (final_state != nullptr) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int nn = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pp = tx * 4 + c;
        if (nn < n && pp < p) final_state[sbase + pp * n + nn] = sreg[r][c];
      }
    }
  }
}

template <typename Tin>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           void* y, const void* state0, void* final_state, int batch, int h, int s, int p,
           int n, const Strides& st, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<Tin>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(h, batch);
  ssd_scan_kernel<Tin><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const Tin*>(b), static_cast<const Tin*>(c),
      static_cast<float*>(y), static_cast<const float*>(state0),
      static_cast<float*>(final_state), h, s, p, n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_dtype (x, B, C): 0 = float32, 1 = bfloat16; y, dt, a, state0 and
// final_state are float32. `strides` holds the 15 element strides of
// struct Strides in order. state0 (initial state) and final_state may be
// null: zeros in, nothing out. Shapes (B, H, P, N) for both states.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, void* y, const void* state0, void* final_state,
                               int batch, int h, int s, int p, int n,
                               const long long* strides, int num_strides, int in_dtype,
                               void* stream) {
  if (num_strides != kNumStrides || p < 1 || p > kMax || n < 1 || n > kMax || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  Strides st;
  long long* dst = reinterpret_cast<long long*>(&st);
  for (int i = 0; i < kNumStrides; ++i) dst[i] = strides[i];
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return launch<float>(x, dt, a, b, c, y, state0, final_state, batch, h, s, p, n, st, str);
  if (in_dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, state0, final_state, batch, h, s, p, n,
                                 st, str);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
