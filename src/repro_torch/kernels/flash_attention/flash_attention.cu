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
// product, with an f32 accumulator and l summed from the unrounded p, as
// the TPU kernel does.
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
// blocks in VMEM; here a work item is one (bh, 128-row q tile), which loops
// over 128-row kv tiles with (m, l, acc) in registers.
//
// bf16, the model's path, is built for the tensor cores' full rate:
// - warp specialisation: warpgroup 0 is the producer, of which one thread
//   issues every TMA load (Q; K and V tiles into a 3-stage ring in shared
//   memory with a full and an empty mbarrier per stage); warpgroups 1 and
//   2 consume, 64 q rows each. setmaxnreg moves registers from the
//   producer (24) to the consumers (240).
// - TMA over 4-D tensor maps of the model layout, q (D, H, S, B) and k/v
//   (D, KVH, S, B), encoded on the host per call and passed by value as
//   __grid_constant__ parameters (so a CUDA graph carries them). A box is
//   64 columns (128 bytes, 128-byte swizzle) or, at D = 32, 32 (64-byte
//   swizzle); D = 128 takes two boxes. TMA's zero fill past S replaces
//   tail padding, so any S runs; rows past S are never stored.
// - QK^T is wgmma m64n128k16 with Q and K both read from shared memory
//   (K's row-major tile is B in K-major form); PV is wgmma m64nDk16 with P
//   from registers (the S accumulators exponentiated and packed to bf16 in
//   place, as FlashAttention-3 does) and V from shared memory in MN-major
//   form (the transpose bit).
// - the softmax works in base 2: p = exp2(s * D^-0.5 log2(e) - m), one FMA
//   and one exp2 a score. Masks are applied only on the tiles that need
//   them (the tail, the causal diagonal, a window's first tiles), by
//   setting the score to -inf, whose p is exactly 0: that is the guard.
// - within a consumer, tile i's QK^T and tile i - 1's PV are issued
//   together, so tile i's softmax runs on the CUDA cores while the tensor
//   cores run the PV (FlashAttention-3's intra-warpgroup overlap).
// - the two consumer warpgroups take turns to issue their wgmma (named
//   barriers), so one's softmax overlaps the other's products (FA3's
//   ping-pong), and the softmax's exponentials are one ex2.approx each.
// - key tiles the mask empties for the whole q tile are skipped.
// - persistent blocks, one per SM, take work items (a head and a 128-row
//   q tile each) from a counter in device memory; the K/V ring runs on
//   across items, so the next item's Q and first tiles load while the last
//   one's final PV and stores run, and a block that drew short items takes
//   more. Items are numbered head-major, a head's q tiles longest first,
//   so the blocks in flight share a few heads' K and V in L2. No grid axis
//   carries B*H, so it has no 65,535 cap.
// - a logit softcap (the reference's `logit_softcap`: s = cap * tanh(s /
//   cap) on the f32 scaled logits, before the mask) is a template flag of
//   both kernels, so a cap of 0 runs the uncapped code unchanged. The
//   capped scores use tanhf (accurate, not tanh.approx.f32: the f32 grid
//   holds the kernel to 2e-5); the bf16 kernel caps the S accumulators in
//   place, as cap log2(e) * tanhf(s * D^-0.5 / cap), and its softmax then
//   takes them at scale 1.
// Where it still falls short: the diagonal tile computes its masked half;
// every 128-row q tile rereads its K and V from L2 (32 KB a kv tile at
// D = 64), more than the L2 delivers at the tensor cores' rate (clusters
// sharing tiles by TMA multicast would halve it); and at D = 64 the SFU's
// exponentials (16 a clock per SM) take about as long as the products.
//
// f32 keeps the CUDA cores (the tensor cores' TF32 would not hold f32 to
// 2e-5): 256 threads, each owning 4 q rows x 4 key columns of S and 4 rows
// x D/16 columns of the output, all in f32 FMA; one block per (bh, 64-row
// q tile), 64-row kv tiles staged through shared memory. It serves parity
// and the reduced f32 checks only.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int h, int kvh, int s, int causal, int window, float scale,
    float cap) {
  constexpr int LD = D + 4;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBq * LD;
  float* vs = ks + kBk * LD;
  float* ps = vs + kBk * LD;

  const int q0 = blockIdx.y * kBq;
  const int bh = blockIdx.x;
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
        float sv = sc[i][j] * scale;
        if constexpr (kCap) sv = cap * tanhf(sv / cap);
        sc[i][j] = ok[j] ? sv : kNegInf;
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

template <int D, bool kCap>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int h, int kvh,
               int s, int causal, int window, float cap, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<D, kCap>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(b * h, (s + kBq - 1) / kBq);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_attention_f32_kernel<D, kCap><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), h, kvh, s, causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16
constexpr int kTile = 128;   // q rows and kv rows of a tile
constexpr int kStages = 3;   // K/V ring depth (5 measured no faster at D = 64)
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory layout TMA writes and wgmma reads. A tile of 128 rows
// is kBoxes column boxes, each 128 rows of kSw bytes in kSw-byte swizzle.
template <int D>
struct Tiles {
  static constexpr int kSw = D * 2 < 128 ? D * 2 : 128;  // bytes of a box row
  static constexpr int kBoxCols = kSw / 2;
  static constexpr int kBoxes = D * 2 / kSw;
  static constexpr int kBoxBytes = kTile * kSw;
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : 2;  // wgmma: 128B or 64B swizzle
  // Q, then (K, V) per stage, and room to align the base to 1024 bytes.
  static constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of parity `parity` has completed. A wait that lasts
// 10 s traps: a fault in the barrier protocol then ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// One box of a 4-D tensor map at (column, head, row, batch) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (all in 16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// K-major operand (Q as A, K as B): rows [row0, row0 + 64 or 128) of a
// tile, k-step kk (columns 16 kk .. 16 kk + 15). Eight rows are one
// swizzle atom, kSw * 8 bytes apart; a k-step inside a box row advances
// the start by 32 bytes, and the swizzle follows from the address bits.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0, int kk) {
  using T = Tiles<D>;
  const int col = kk * 16;
  const uint32_t addr = tile + (col / T::kBoxCols) * T::kBoxBytes + row0 * T::kSw +
                        (col % T::kBoxCols) * 2;
  return smem_desc(addr, 16, 8 * T::kSw, T::kLayout);
}

// MN-major operand (V as B of PV): kv rows 16 kk .. 16 kk + 15, all D
// columns. Eight kv rows are one atom (stride kSw * 8); a second 64-column
// box lies kBoxBytes on (the leading offset).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using T = Tiles<D>;
  return smem_desc(tile + kk * 16 * T::kSw, T::kBoxBytes, 8 * T::kSw, T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending (they retire in
// order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the SFU in one instruction (flushes results below 2^-126 to 0;
// exp2(-inf) = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers that take the two consumer warpgroups' wgmma issues in
// turn (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * kWgThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * kWgThreads) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major);
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

// S = Q K^T for this warpgroup's 64 rows and a 128-row K tile, committed
// as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[64], uint32_t q_tile, int cw,
                                         uint32_t k_tile) {
  reg_fence(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(sacc, kmajor_desc<D>(q_tile, 64 * cw, kk), kmajor_desc<D>(k_tile, 0, kk),
                  kk > 0);
  wgmma_commit();
}

// O += P V for a 128-row V tile, P as bf16 A fragments, committed as one
// group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
  reg_fence(oacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_pv<D>(oacc, pa[kk], mnmajor_desc<D>(v_tile, kk));
  wgmma_commit();
}

// The online softmax of one tile's S accumulators, in place: with the cap,
// s becomes cap_out * tanhf(s * cap_in) (cap log2(e) * tanh(s D^-0.5 /
// cap)) and is taken at scale 1 from there; mask where needed, the new
// running max m (of s * scale_log2, per row, from -1e30), p = exp2(s *
// scale_log2 - m), l rescaled and increased by the unrounded p. corr[r]
// is what the output rows take for the new max. Fragment: this thread's
// rows are row0 (e < 2) and row0 + 8 (e >= 2) of n8 block j, columns 8 j
// + col0 + (e & 1).
template <bool kCap>
__device__ __forceinline__ void softmax_tile(float (&sacc)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool masked, int k0, int row0,
                                             int col0, int s, int causal, int window,
                                             float scale_log2, float cap_in, float cap_out) {
  if constexpr (kCap) {
#pragma unroll
    for (int j = 0; j < 64; ++j) sacc[j] = cap_out * tanhf(sacc[j] * cap_in);
    scale_log2 = 1.f;
  }
  if (masked) {
    // Key k0 + col0 + x (x = 8 j + (e & 1), a constant) is valid for row r
    // when lo[r] < x <= hi[r]: x below S, not after the row if causal, and
    // inside the window.
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rel = row0 + 8 * r - k0 - col0;
      hi[r] = min(s - 1 - k0 - col0, causal ? rel : INT_MAX);
      lo[r] = window ? rel - window : INT_MIN;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 8 * j + (e & 1);
        if (x <= lo[e >> 1] || x > hi[e >> 1])
          sacc[4 * j + e] = -INFINITY;  // exp2(-inf) = 0: the p guard
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 64; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sacc[j]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's 128 columns sit on the 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // stays >= -1e30
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int r = (j >> 1) & 1;
    sacc[j] = fast_exp2(fmaf(sacc[j], scale_log2, neg_m[r]));
    l[r] += sacc[j];
  }
}

// p (f32, in the S fragments) as the bf16 A fragments of PV: kv columns
// 16 kk .. 16 kk + 15 are n8 blocks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_p(const float (&sacc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// One work item: a (batch, head) and a 128-row q tile. Items are numbered
// head-major, a head's q tiles longest first, so the blocks in flight share
// a few heads' K and V in L2. (With heads on the fastest axis, 132 heads'
// K and V were live at once at zamba2's shape, 121 MB against a 50 MB L2.)
struct WorkItem {
  int b, hh, hk, q0, k_begin, n_tiles;
};

__device__ __forceinline__ WorkItem work_item(int idx, int ny, int h, int kvh, int s,
                                              int causal, int window) {
  WorkItem w;
  const int bh = idx / ny;
  w.b = bh / h;
  w.hh = bh % h;
  w.hk = w.hh / (h / kvh);
  w.q0 = (ny - 1 - idx % ny) * kTile;
  const int k_end = causal ? min(s, w.q0 + kTile) : s;
  w.k_begin = window ? max(0, w.q0 - window + 1) / kTile * kTile : 0;
  w.n_tiles = (k_end - w.k_begin + kTile - 1) / kTile;  // >= 1
  return w;
}

// Persistent: each block's producer takes the next work item from a
// counter in device memory (atomicAdd) and hands its index to the
// consumers beside Q; the K/V ring and its phases run on across items, so
// the producer loads the next item's Q and first tiles while the consumers
// finish the last one. The last block to stop taking items sets both
// counters back to 0 for the next launch.
template <int D, bool kCap>
__global__ void __launch_bounds__(kWgmmaThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int h, int kvh,
    int s, int causal, int window, float scale_log2, int n_items, int* __restrict__ sched,
    float cap_in, float cap_out) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 2];  // full[], empty[], q full, q empty
  __shared__ int item;  // the work item whose Q is loaded (>= n_items: no more)

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t q_tile = base;
  const uint32_t full_bar = smem_u32(&bars[0]);
  const uint32_t empty_bar = smem_u32(&bars[kStages]);
  const uint32_t q_full = smem_u32(&bars[2 * kStages]);
  const uint32_t q_empty = smem_u32(&bars[2 * kStages + 1]);
  const int ny = (s + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);                 // the producer's expect_tx
      mbar_init(empty_bar + 8 * st, kConsumerWarps);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ---- producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // tiles loaded so far: the ring position
      for (int n = 0;; ++n) {
        const int idx = atomicAdd(&sched[0], 1);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // the last item's QK^T are done
        *reinterpret_cast<volatile int*>(&item) = idx;
        if (idx >= n_items) {
          mbar_arrive(q_full);  // no load: the consumers read the end
          break;
        }
        const WorkItem w = work_item(idx, ny, h, kvh, s, causal, window);
        mbar_expect_tx(q_full, T::kTileBytes);
        for (int box = 0; box < T::kBoxes; ++box)
          tma_load(q_tile + box * T::kBoxBytes, &q_map, q_full, box * T::kBoxCols, w.hh, w.q0,
                   w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(empty_bar + 8 * st, (it / kStages - 1) & 1);
          const uint32_t k_tile = base + (1 + 2 * st) * T::kTileBytes;
          const uint32_t v_tile = k_tile + T::kTileBytes;
          const int k0 = w.k_begin + i * kTile;
          mbar_expect_tx(full_bar + 8 * st, 2 * T::kTileBytes);
          for (int box = 0; box < T::kBoxes; ++box) {
            tma_load(k_tile + box * T::kBoxBytes, &k_map, full_bar + 8 * st,
                     box * T::kBoxCols, w.hk, k0, w.b);
            tma_load(v_tile + box * T::kBoxBytes, &v_map, full_bar + 8 * st,
                     box * T::kBoxCols, w.hk, k0, w.b);
          }
        }
      }
      if (atomicAdd(&sched[1], 1) == static_cast<int>(gridDim.x) - 1) {
        sched[0] = 0;  // every block has taken its last item
        sched[1] = 0;
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns q rows [q0 + 64 cw, q0 + 64 cw + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / kWgThreads - 1;
  const int t = threadIdx.x % kWgThreads;
  const int lane = t % 32;
  const int col0 = 2 * (lane % 4);
  // Ping-pong: the warpgroups issue their wgmma in turn (warpgroup 0
  // first), so one's softmax runs while the other's products do. Each
  // waits for its turn before an issue and hands the turn over after it;
  // warpgroup 0 takes one more turn at the end, so every arrival is
  // matched.
  const int my_turn = 1 + cw, their_turn = 2 - cw;
  if (cw == 1) named_arrive(their_turn);

  float sacc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) sacc[j] = 0.f;
  float oacc[D / 2];
  uint32_t pa[8][4];
  float m[2], l[2], corr[2];
  int it = 0;  // tiles consumed so far: the ring position
  for (int n = 0;; ++n) {
    mbar_wait(q_full, n & 1);
    const int idx = *reinterpret_cast<volatile int*>(&item);
    if (idx >= n_items) break;
    const WorkItem w = work_item(idx, ny, h, kvh, s, causal, window);
    const int wg_row = w.q0 + 64 * cw;
    // Accumulator fragments: this thread's rows are row0 (e < 2) and
    // row0 + 8 (e >= 2) of n8 block j, columns 8 j + col0 + (e & 1).
    const int row0 = wg_row + 16 * (t / 32) + lane / 4;
    // Some pair of this warpgroup's rows and the keys from k0 can be
    // invalid: the tail, the causal diagonal, a window's edge.
    auto masked = [&](int k0) {
      return k0 + kTile > s || (causal && k0 + kTile - 1 > wg_row) ||
             (window && k0 <= wg_row + 63 - window);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    m[0] = m[1] = kNegInf;  // running max of s * scale_log2
    l[0] = l[1] = 0.f;      // this thread's share of the row sums

    // Tile 0: QK^T, then its softmax (the output is still 0).
    mbar_wait(full_bar + 8 * (it % kStages), (it / kStages) & 1);
    named_sync(my_turn);
    issue_qk<D>(sacc, q_tile, cw, base + (1 + 2 * (it % kStages)) * T::kTileBytes);
    named_arrive(their_turn);
    wgmma_wait<0>();
    reg_fence(sacc);
    if (w.n_tiles == 1 && lane == 0) mbar_arrive(q_empty);  // Q is no longer read
    softmax_tile<kCap>(sacc, m, l, corr, masked(w.k_begin), w.k_begin, row0, col0, s, causal,
                       window, scale_log2, cap_in, cap_out);
    pack_p(sacc, pa);
    for (int i = 1; i < w.n_tiles; ++i) {
      const int prev = it % kStages;
      ++it;
      const int st = it % kStages;
      const int k0 = w.k_begin + i * kTile;
      mbar_wait(full_bar + 8 * st, (it / kStages) & 1);
      // QK^T of tile i, then PV of tile i - 1: tile i's softmax runs on the
      // CUDA cores while the tensor cores run the PV.
      named_sync(my_turn);
      issue_qk<D>(sacc, q_tile, cw, base + (1 + 2 * st) * T::kTileBytes);
      issue_pv<D>(oacc, pa, base + (2 + 2 * prev) * T::kTileBytes);
      named_arrive(their_turn);
      wgmma_wait<1>();  // QK^T of tile i has landed
      reg_fence(sacc);
      if (i == w.n_tiles - 1 && lane == 0) mbar_arrive(q_empty);
      softmax_tile<kCap>(sacc, m, l, corr, masked(k0), k0, row0, col0, s, causal, window,
                         scale_log2, cap_in, cap_out);
      reg_fence(sacc);  // the exponentials stay ahead of the wait: they overlap the PV
      wgmma_wait<0>();  // PV of tile i - 1 has landed
      reg_fence(oacc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);  // this warp is done with the stage
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= corr[e >> 1];
      pack_p(sacc, pa);
    }
    const int last = it % kStages;
    ++it;
    named_sync(my_turn);
    issue_pv<D>(oacc, pa, base + (2 + 2 * last) * T::kTileBytes);
    named_arrive(their_turn);
    wgmma_wait<0>();
    reg_fence(oacc);
    if (lane == 0) mbar_arrive(empty_bar + 8 * last);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = row0 + 8 * r;
      if (row < s) {
        const float inv = 1.f / fmaxf(lr, 1e-30f);
        __nv_bfloat16* orow =
            o + ((static_cast<int64_t>(w.b) * s + row) * h + w.hh) * D + col0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
  if (cw == 0) named_sync(my_turn);  // warpgroup 1's last hand-over
}

// cuTensorMapEncodeTiled is a driver-API function; it is fetched through
// the runtime, so the library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 (B, S, heads, D) tensor as the 4-D map (D, heads, S, B), boxes of
// (kBoxCols, 1, 128, 1), zero fill past S.
template <int D>
int encode_map(CUtensorMap* map, const void* base, int heads, int s, int b) {
  using T = Tiles<D>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row, row * s};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBoxCols), 1, kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, bool kCap>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* sched, int b,
                 int h, int kvh, int s, int causal, int window, float cap,
                 cudaStream_t stream) {
  constexpr int bytes = Tiles<D>::kSmemBytes;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D, kCap>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map;
  int err = encode_map<D>(&q_map, q, h, s, b);
  if (err == 0) err = encode_map<D>(&k_map, k, kvh, s, b);
  if (err == 0) err = encode_map<D>(&v_map, v, kvh, s, b);
  if (err != 0) return err;
  const int64_t items = static_cast<int64_t>(b) * h * ((s + kTile - 1) / kTile);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err2 = cudaGetDevice(&device);
  if (err2 == cudaSuccess)
    err2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err2 != cudaSuccess) return static_cast<int>(err2);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block per SM
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const float cap_in = kCap ? 1.0f / sqrtf(static_cast<float>(D)) / cap : 0.f;
  flash_attention_wgmma_kernel<D, kCap><<<grid, kWgmmaThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), h, kvh, s, causal, window,
      scale_log2, static_cast<int>(items), static_cast<int*>(sched), cap_in, cap * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCap>
int dispatch_f32(int d, const void* q, const void* k, const void* v, void* o, int b, int h,
                 int kvh, int s, int causal, int window, float cap, cudaStream_t st) {
  switch (d) {
    case 32: return launch_f32<32, kCap>(q, k, v, o, b, h, kvh, s, causal, window, cap, st);
    case 64: return launch_f32<64, kCap>(q, k, v, o, b, h, kvh, s, causal, window, cap, st);
    case 128: return launch_f32<128, kCap>(q, k, v, o, b, h, kvh, s, causal, window, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kCap>
int dispatch_bf16(int d, const void* q, const void* k, const void* v, void* o, void* sched,
                  int b, int h, int kvh, int s, int causal, int window, float cap,
                  cudaStream_t st) {
  switch (d) {
    case 32:
      return launch_wgmma<32, kCap>(q, k, v, o, sched, b, h, kvh, s, causal, window, cap, st);
    case 64:
      return launch_wgmma<64, kCap>(q, k, v, o, sched, b, h, kvh, s, causal, window, cap, st);
    case 128:
      return launch_wgmma<128, kCap>(q, k, v, o, sched, b, h, kvh, s, causal, window, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o (B, S, H, D); k/v (B, S, KVH, D).
// sched: two int32 counters, 0 on entry and left 0 (bf16 only; one stream
// at a time per device). softcap > 0 caps the scaled logits (0: uncapped).
// Neither kernel's grid caps B*H at 65,535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* sched, int b, int h, int kvh, int s, int d,
                                      int causal, int window, int dtype, float softcap,
                                      void* stream) {
  if (b == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  if (kvh <= 0 || h % kvh != 0 || window < 0 || static_cast<int64_t>(b) * h > 0x7fffffff ||
      !(softcap >= 0.f) || isinf(softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (dtype == 0)
    return cap ? dispatch_f32<true>(d, q, k, v, o, b, h, kvh, s, causal, window, softcap, st)
               : dispatch_f32<false>(d, q, k, v, o, b, h, kvh, s, causal, window, softcap, st);
  if (dtype == 1) {
    if (sched == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return cap ? dispatch_bf16<true>(d, q, k, v, o, sched, b, h, kvh, s, causal, window,
                                     softcap, st)
               : dispatch_bf16<false>(d, q, k, v, o, sched, b, h, kvh, s, causal, window,
                                      softcap, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
