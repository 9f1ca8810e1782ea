// flash_attention_fwd for Hopper (sm_90a): causal / sliding-window
// attention forward with an online softmax, grouped-query layout.
//
// Replaces the Pallas kernel `flash_attention_fwd` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`),
// with the GQA wrapper `ops.flash_attention_gqa`. For query row i and key
// row j of one (batch, head):
//   s_ij = (q_i . k_j) * D^-0.5 in f32, valid when j < S and, if causal,
//   j <= i and, with a window, j > i - window;
//   out_i = sum_j bf(p_ij) v_j / max(sum_j p_ij, 1e-30),
//   p_ij = valid ? exp(s_ij - m_i) : 0, m_i the running max from -1e30.
// The guard on p matters: with a window, a row's first key tile can be
// fully masked, and exp(-1e30 - -1e30) = 1 would pollute the sums. A row
// with no valid key gives 0. p is cast to the input type before the PV
// product, with an f32 accumulator, as the TPU kernel does.
//
// Layouts: q and out (B, S, H, D), k and v (B, S, KVH, D), read in place:
// query head h reads kv head h / (H / KVH), so the GQA expand of the
// reference wrapper never reaches device memory. A plain (BH, S, D) call
// is B = BH, H = KVH = 1.
//
// What bounds it: operations. At tinyllama's prefill (B = 8, H = 32,
// KVH = 4, S = 1920, D = 64, bf16) the unmasked causal pairs need
// 4 D sum_i (i + 1) BH = 1.21e11 FLOP, 0.122 ms at 989 TFLOP/s, against
// 142 MB of traffic, 0.042 ms at 3.35 TB/s. The TPU kernel runs its
// (bh, q block, kv block) grid in order and carries (m, l, acc) across kv
// blocks in VMEM. Here one block owns one (bh, 64-row q tile) and loops
// over 64-row kv tiles staged through shared memory, with (m, l, acc) in
// registers. Key tiles that the causal or window mask empties for the
// whole q tile are skipped (the TPU kernel computes and masks them); tail
// rows past S are zero-filled in shared memory and never stored.
//
// bf16 runs on the tensor cores: four warps of 16 q rows each, QK^T and PV
// as mma.sync m16n8k16 with f32 accumulators, operands from shared memory
// through ldmatrix (rows padded by 16 bytes so the eight row addresses of
// an 8x8 load fall in distinct banks), and the S accumulators recast in
// registers as the bf16 A operand of PV, as FlashAttention-2 does. It
// stages tiles synchronously (no cp.async or TMA pipeline, no wgmma), so
// it stays well short of the bound. f32 keeps the CUDA cores (the tensor
// cores' TF32 would not hold f32 to 2e-5): 256 threads, each owning 4 q
// rows x 4 key columns of S and 4 rows x D/16 columns of the output, all
// in f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kLdp = kBk + 4;
constexpr float kNegInf = -1e30f;

// ----------------------------------------------------------------- f32
template <int D>
constexpr int smem_bytes() {
  return (3 * (kBq * (D + 4)) + kBq * kLdp) * static_cast<int>(sizeof(float));
}

// rows [row0, row0 + 64) of one head, row stride `stride` elements, into
// a (64, D + 4) tile; rows at or past `s` become zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int64_t stride, int row0, int s) {
  constexpr int PER_ROW = D / 4;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kBq * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int h, int kvh, int s, int causal, int window, float scale) {
  constexpr int LD = D + 4;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBq * LD;
  float* vs = ks + kBk * LD;
  float* ps = vs + kBk * LD;

  const int q0 = blockIdx.x * kBq;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int hk = hh / (h / kvh);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kvh) * D;
  const float* qb = q + static_cast<int64_t>(b) * s * q_stride + hh * D;
  const float* kb = k + static_cast<int64_t>(b) * s * kv_stride + hk * D;
  const float* vb = v + static_cast<int64_t>(b) * s * kv_stride + hk * D;
  float* ob = o + static_cast<int64_t>(b) * s * q_stride + hh * D;

  load_tile<D>(qs, qb, q_stride, q0, s);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(s, q0 + kBq) : s;
  int k_begin = window ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBk) * kBk;

  for (int k0 = k_begin; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, kb, kv_stride, k0, s);
    load_tile<D>(vs, vb, kv_stride, k0, s);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc_s = sc[i][j];
          acc_s = fmaf(qa[i].x, kk[j].x, acc_s);
          acc_s = fmaf(qa[i].y, kk[j].y, acc_s);
          acc_s = fmaf(qa[i].z, kk[j].z, acc_s);
          acc_s = fmaf(qa[i].w, kk[j].w, acc_s);
          sc[i][j] = acc_s;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < s && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty * 4 + i) * kLdp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBk; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kLdp + kk];
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; c += 2) {
        const float2 t = *reinterpret_cast<const float2*>(vs + kk * LD + tx * DPT + c);
        vv[c] = t.x;
        vv[c + 1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos < s) {
      const float den = fmaxf(l[i], 1e-30f);
      float* orow = ob + qpos * q_stride + tx * DPT;
#pragma unroll
      for (int c = 0; c < DPT; ++c) orow[c] = acc[i][c] / den;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int h, int kvh,
               int s, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((s + kBq - 1) / kBq, b * h);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_attention_f32_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), h, kvh, s, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16
constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * kBq * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

// rows [row0, row0 + 64) of one head into a (64, D + 8) bf16 tile; rows at
// or past `s` become zeros.
template <int D>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int64_t stride, int row0, int s) {
  constexpr int PER_ROW = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kBq * PER_ROW; idx += kMmaThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < s) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int h, int kvh,
    int s, int causal, int window, float scale) {
  constexpr int LDS = D + 8;
  constexpr int KSTEPS = D / 16;  // k-steps of QK^T
  constexpr int NB = kBk / 8;     // 8-column blocks of S
  constexpr int DB = D / 8;       // 8-column blocks of the output
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* qs = sm;
  __nv_bfloat16* ks = qs + kBq * LDS;
  __nv_bfloat16* vs = ks + kBk * LDS;

  const int q0 = blockIdx.x * kBq;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int hk = hh / (h / kvh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int c = lane % 4;  // fragment column pair

  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kvh) * D;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * s * q_stride + hh * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * s * kv_stride + hk * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * s * kv_stride + hk * D;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * s * q_stride + hh * D;

  copy_tile<D>(qs, qb, q_stride, q0, s);
  __syncthreads();
  // This warp's 16 q rows as A operands, one per 16-wide k-step.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * LDS + kk * 16 + (lane / 16) * 8);

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oacc[DB][4];
#pragma unroll
  for (int dn = 0; dn < DB; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[dn][i] = 0.f;

  const int k_end = causal ? min(s, q0 + kBq) : s;
  int k_begin = window ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBk) * kBk;

  for (int k0 = k_begin; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile's readers are done
    copy_tile<D>(ks, kb, kv_stride, k0, s);
    copy_tile<D>(vs, vb, kv_stride, k0, s);
    __syncthreads();

    float sacc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[nb][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t kf[4];  // B operands for k-steps kk and kk + 1
        ldmatrix_x4(kf, ks + (nb * 8 + lane % 8) * LDS + kk * 16 + (lane / 8) * 8);
        mma_bf16(sacc[nb], qf[kk], kf[0], kf[1]);
        mma_bf16(sacc[nb], qf[kk + 1], kf[2], kf[3]);
      }
    }

    // Mask, scale, and the online softmax of rows row0 (i = 0, 1) and
    // row0 + 8 (i = 2, 3); a row's 64 columns sit on the 4 lanes of a quad.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = row0 + (i >= 2 ? 8 : 0);
        const int kpos = k0 + nb * 8 + 2 * c + (i & 1);
        const bool ok =
            kpos < s && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
        sacc[nb][i] = ok ? sacc[nb][i] * scale : kNegInf;
        mx[i / 2] = fmaxf(mx[i / 2], sacc[nb][i]);
      }
    float corr[2], rs[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A masked score is exactly kNegInf; its p is 0, not exp(0).
        const float p = sacc[nb][i] == kNegInf ? 0.f : expf(sacc[nb][i] - m_new[i / 2]);
        sacc[nb][i] = p;
        rs[i / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int dn = 0; dn < DB; ++dn) {
      oacc[dn][0] *= corr[0];
      oacc[dn][1] *= corr[0];
      oacc[dn][2] *= corr[1];
      oacc[dn][3] *= corr[1];
    }

    // O += P V: P's accumulators become bf16 A operands in place.
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * j][0], sacc[2 * j][1]);
      pa[1] = pack_bf16(sacc[2 * j][2], sacc[2 * j][3]);
      pa[2] = pack_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1]);
      pa[3] = pack_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        uint32_t vf[4];  // B operands for output columns dp*16 .. +8 and +8 .. +16
        ldmatrix_x4_trans(vf, vs + (j * 16 + lane % 16) * LDS + dp * 16 + (lane / 16) * 8);
        mma_bf16(oacc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos < s) {
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + qpos * q_stride + 2 * c;
#pragma unroll
      for (int dn = 0; dn < DB; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) =
            __floats2bfloat162_rn(oacc[dn][2 * r] / den, oacc[dn][2 * r + 1] / den);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b, int h, int kvh,
               int s, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((s + kBq - 1) / kBq, b * h);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_attention_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), h, kvh, s, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(int d, const void* q, const void* k, const void* v, void* o, int b, int h,
                 int kvh, int s, int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_f32<32>(q, k, v, o, b, h, kvh, s, causal, window, stream);
    case 64: return launch_f32<64>(q, k, v, o, b, h, kvh, s, causal, window, stream);
    case 128: return launch_f32<128>(q, k, v, o, b, h, kvh, s, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(int d, const void* q, const void* k, const void* v, void* o, int b, int h,
                  int kvh, int s, int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_mma<32>(q, k, v, o, b, h, kvh, s, causal, window, stream);
    case 64: return launch_mma<64>(q, k, v, o, b, h, kvh, s, causal, window, stream);
    case 128: return launch_mma<128>(q, k, v, o, b, h, kvh, s, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o (B, S, H, D); k/v (B, S, KVH, D).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int h, int kvh, int s, int d, int causal,
                                      int window, int dtype, void* stream) {
  if (b == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  if (kvh <= 0 || h % kvh != 0 || window < 0 || static_cast<int64_t>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(d, q, k, v, o, b, h, kvh, s, causal, window, st);
  if (dtype == 1) return dispatch_bf16(d, q, k, v, o, b, h, kvh, s, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
