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
//
// Training (`ops._FlashTrain`, bf16 only) runs a second instantiation of
// the bf16 forward, with the template flag kLse, that also stores each
// row's f32 log-sum-exp, lse_i = ln(sum_j exp(s_ij)), (B, H, S), +inf for
// a row with no valid key; the prefill instantiation (kLse false) is the
// code above unchanged. Head dim 80 (hubert) is held in the D = 128 tiles
// (two 64-column boxes; TMA zero-fills columns 80..127 and reads nothing
// there): QK^T takes only the 5 k-steps that hold data and PV runs at
// N = 80 (m64n80k16 over the first 80 of the tile's columns), so the
// padding costs shared memory and no products.
//
// The backward (flash_attention_bwd_launch) is four launches, none of which
// forms a (B, H, S, S) array:
// - a pre-pass, one thread a row: delta_i = sum_d dO_id O_id in f32,
//   lse_i log2(e) and the row's dQ unit (below) into (B*H, S rounded up to
//   64) buffers (+inf and 0 past S, so rows past S get p = 0), and zeroes
//   the dQ workspace;
// - the main kernel, FlashAttention-2/3's: a persistent block takes a work
//   item (a query head and a 128-row kv tile; GQA's kv head is read in
//   place) from a self-resetting counter, loads K and V once by TMA, and
//   loops over the 64-row q tiles the mask leaves it, which its thread 0
//   streams (Q, dO by TMA, lse and delta by bulk copy) into a 2-stage
//   mbarrier ring. Each of two warpgroups owns 64 kv rows and, per
//   q tile, on wgmma: S^T = K Q^T and dP^T = V dO^T (both operands from
//   shared memory), p = exp2(s log2(e) D^-0.5 - lse log2(e)) and
//   ds = p (dp - delta) in f32 on the CUDA cores (times 1 - tanh^2 under a
//   softcap), dV += bf(P)^T dO and dK += bf(dS)^T Q with P and dS as
//   register A fragments (dK and dV stay in registers for the whole item),
//   then dQ_part = bf(dS) K with dS written to shared memory (both operands
//   MN-major); the two warpgroups' dQ_parts are summed in shared memory as
//   int64 fixed point and go to the workspace by one TMA bulk reduce-add
//   (cp.reduce.async.bulk .add.u64): integer sums do not depend on the
//   order the blocks add in, so dQ, like dK and dV, is the same bit for bit
//   from run to run (f32 reduce-adds were not, and moved a MoE cell's loss
//   1e-4 between runs; ordering them by counters cost 33-150%, a reduce a
//   warpgroup in int64 29-58%). Row i's unit is 2^(e_i - 32), 2^e_i the
//   power of two just above max_d |dO_id|: dQ_i is linear in dO_i, so the
//   sum keeps 32 bits below the row's gradient scale whatever the loss's
//   scale, and holds (dS K)_i, dQ_i before D^-0.5, up to 2^31 times that
//   scale. As |(dS K)_i| <= 2 D max|V| max|K| max|dO_i|, that holds while
//   max|V| max|K| < 2^30 / D (8.3e6 at D = 128). Masked tiles are skipped
//   as in the forward (a kv tile's q range is cut to the causal and window
//   bounds); the tiles on a mask's edge zero p and ds where a pair is
//   invalid.
// - dQ = bf16(D^-0.5 workspace) into (B, S, H, D);
// - with GQA (H > KVH) the main kernel writes f32 dK and dV per query head
//   to a (B, S, H, D) workspace and a last launch sums each kv head's group
//   into bf16 (B, S, KVH, D); without it the main kernel writes bf16 dK and
//   dV directly.
// The dQ workspace is kept in the consumers' fragment order (tile of 64 q
// rows: [pair][thread][2] int64, 64 x D), so the shared-memory stores are
// free of bank conflicts.
// What bounds it: operations, 10 B H D P FLOP for P kept (q, k) pairs,
// against 4 arrays of B S H D bf16 in and 3 out, plus the workspace's
// int64 reduce traffic (one 64 x D tile per (q tile, kv tile)). It runs at
// 19% of the bf16 peak at hubert's and nemotron's shapes (24-26% with f32
// reduce-adds): each warpgroup's tile is a chain (products, softmax,
// products, the dQ tile through shared memory) that only the other
// warpgroup overlaps, and the dQ sum now ties the two together; taking out
// any one link (with f32 reduce-adds: the dQ epilogue, the softmax's
// arithmetic, the dK / dV products) gained 8-20%, none of them leads.
//
// Multi-head latent attention's core (DeepSeek-V3, Kimi-K2: q and k 192
// wide, 128 without rotary positions and 64 with them, v 128, MHA) runs in
// the flash_mla_* kernels, training only: the same bodies instantiated for a
// query / key width D = 192 and a value width DV = 128, with the softmax at
// the caller's scale (YaRN's, not D^-0.5). The forward keeps its log-sum-exp;
// its Q tile and two ring stages of K (192) and V (128) are 208 KB, so the
// ring is 2 deep. The backward keeps the (D, D) design: a warpgroup's dK (96
// registers) and dV (64) stay in registers beside S^T and dP^T (32 each);
// its dQ part goes through shared memory as three 64-column chunks of int64
// (32 KB each; the whole 64 x 192 tile, 96 KB, does not fit beside K, V,
// the Q / dO ring and dS), each summed over the two warpgroups and
// reduce-added as the (D, D) kernels' tile is. A launch's FLOPs are
// 2 B H P (D + DV) forward and 2 B H P (3 D + 2 DV) backward.

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
constexpr float kLn2 = 0.6931471805599453f;

// The width of the tiles that hold head dim D: 80 runs in 128 columns.
__host__ __device__ constexpr int pad_dim(int d) { return d == 80 ? 128 : d; }

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

// d (64 x 80, f32) += A (64 x 16, bf16 registers) * B (16 x 80, smem, MN-major):
// D = 80's products over the first 80 of a 128-column tile's columns.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192, f32) += A (64 x 16, bf16 registers) * B (16 x 192, smem, MN-major):
// the MLA backward's dK += dS^T Q at the query/key width of 192.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (D == 80) {
    wgmma_rs_n80(o, a, db);
  } else if constexpr (D == 192) {
    wgmma_rs_n192(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

// S = Q K^T for this warpgroup's 64 rows and a 128-row K tile, committed
// as one group. Only the k-steps below D: the columns a padded tile holds
// past D are zeros.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[64], uint32_t q_tile, int cw,
                                         uint32_t k_tile) {
  constexpr int DP = pad_dim(D);
  reg_fence(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(sacc, kmajor_desc<DP>(q_tile, 64 * cw, kk), kmajor_desc<DP>(k_tile, 0, kk),
                  kk > 0);
  wgmma_commit();
}

// O += P V for a 128-row V tile, P as bf16 A fragments, committed as one
// group. N = D: at D = 80 the products read the first 80 of the padded
// tile's 128 columns.
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
  reg_fence(oacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv<D>(oacc, pa[kk], mnmajor_desc<pad_dim(D)>(v_tile, kk));
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
// counters back to 0 for the next launch. kLse (training) also stores each
// row's log-sum-exp to lse (B, H, S).
//
// D is the query / key width and DV the value (and output) width; each
// stage of the ring holds a K tile of D columns and a V tile of DV
// (FwdSmem). The prefill and training kernels run D = DV over kStages
// stages; the MLA kernel D = 192, DV = 128 over 2 (208 KB).
template <int D, int DV, int STAGES>
struct FwdSmem {
  static constexpr int kQBytes = Tiles<pad_dim(D)>::kTileBytes;
  static constexpr int kVBytes = Tiles<pad_dim(DV)>::kTileBytes;
  static constexpr int kStageBytes = kQBytes + kVBytes;  // K, then V
  static constexpr int kBytes = kQBytes + STAGES * kStageBytes + 1024;
  __device__ static uint32_t k_tile(uint32_t base, int st) {
    return base + kQBytes + st * kStageBytes;
  }
  __device__ static uint32_t v_tile(uint32_t base, int st) { return k_tile(base, st) + kQBytes; }
};

template <int D, int DV, int STAGES, bool kCap, bool kLse>
__device__ __forceinline__ void flash_fwd_body(
    const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
    __nv_bfloat16* __restrict__ o, int h, int kvh, int s, int causal, int window,
    float scale_log2, int n_items, int* __restrict__ sched, float cap_in, float cap_out,
    float* __restrict__ lse) {
  constexpr int DP = pad_dim(D);
  using T = Tiles<DP>;
  using TV = Tiles<pad_dim(DV)>;
  using L = FwdSmem<D, DV, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 2];  // full[], empty[], q full, q empty
  __shared__ int item;  // the work item whose Q is loaded (>= n_items: no more)

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t q_tile = base;
  const uint32_t full_bar = smem_u32(&bars[0]);
  const uint32_t empty_bar = smem_u32(&bars[STAGES]);
  const uint32_t q_full = smem_u32(&bars[2 * STAGES]);
  const uint32_t q_empty = smem_u32(&bars[2 * STAGES + 1]);
  const int ny = (s + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
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
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(empty_bar + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t k_tile = L::k_tile(base, st);
          const uint32_t v_tile = L::v_tile(base, st);
          const int k0 = w.k_begin + i * kTile;
          mbar_expect_tx(full_bar + 8 * st, L::kStageBytes);
          if constexpr (D == DV) {
            for (int box = 0; box < T::kBoxes; ++box) {
              tma_load(k_tile + box * T::kBoxBytes, &k_map, full_bar + 8 * st,
                       box * T::kBoxCols, w.hk, k0, w.b);
              tma_load(v_tile + box * T::kBoxBytes, &v_map, full_bar + 8 * st,
                       box * T::kBoxCols, w.hk, k0, w.b);
            }
          } else {
            for (int box = 0; box < T::kBoxes; ++box)
              tma_load(k_tile + box * T::kBoxBytes, &k_map, full_bar + 8 * st,
                       box * T::kBoxCols, w.hk, k0, w.b);
            for (int box = 0; box < TV::kBoxes; ++box)
              tma_load(v_tile + box * TV::kBoxBytes, &v_map, full_bar + 8 * st,
                       box * TV::kBoxCols, w.hk, k0, w.b);
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
  float oacc[DV / 2];
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
    for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
    m[0] = m[1] = kNegInf;  // running max of s * scale_log2
    l[0] = l[1] = 0.f;      // this thread's share of the row sums

    // Tile 0: QK^T, then its softmax (the output is still 0).
    mbar_wait(full_bar + 8 * (it % STAGES), (it / STAGES) & 1);
    named_sync(my_turn);
    issue_qk<D>(sacc, q_tile, cw, L::k_tile(base, it % STAGES));
    named_arrive(their_turn);
    wgmma_wait<0>();
    reg_fence(sacc);
    if (w.n_tiles == 1 && lane == 0) mbar_arrive(q_empty);  // Q is no longer read
    softmax_tile<kCap>(sacc, m, l, corr, masked(w.k_begin), w.k_begin, row0, col0, s, causal,
                       window, scale_log2, cap_in, cap_out);
    pack_p(sacc, pa);
    for (int i = 1; i < w.n_tiles; ++i) {
      const int prev = it % STAGES;
      ++it;
      const int st = it % STAGES;
      const int k0 = w.k_begin + i * kTile;
      mbar_wait(full_bar + 8 * st, (it / STAGES) & 1);
      // QK^T of tile i, then PV of tile i - 1: tile i's softmax runs on the
      // CUDA cores while the tensor cores run the PV.
      named_sync(my_turn);
      issue_qk<D>(sacc, q_tile, cw, L::k_tile(base, st));
      issue_pv<DV>(oacc, pa, L::v_tile(base, prev));
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
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= corr[e >> 1];
      pack_p(sacc, pa);
    }
    const int last = it % STAGES;
    ++it;
    named_sync(my_turn);
    issue_pv<DV>(oacc, pa, L::v_tile(base, last));
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
            o + ((static_cast<int64_t>(w.b) * s + row) * h + w.hh) * DV + col0;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
        if constexpr (kLse) {
          // m is in log2 units of the scaled (capped) score: lse = (m + log2 l) ln 2.
          if ((lane & 3) == 0)
            lse[(static_cast<int64_t>(w.b) * h + w.hh) * s + row] =
                lr > 0.f ? (m[r] + log2f(lr)) * kLn2 : INFINITY;
        }
      }
    }
  }
  if (cw == 0) named_sync(my_turn);  // warpgroup 1's last hand-over
}

template <int D, bool kCap, bool kLse>
__global__ void __launch_bounds__(kWgmmaThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int h, int kvh,
    int s, int causal, int window, float scale_log2, int n_items, int* __restrict__ sched,
    float cap_in, float cap_out, float* __restrict__ lse) {
  flash_fwd_body<D, D, kStages, kCap, kLse>(q_map, k_map, v_map, o, h, kvh, s, causal, window,
                                            scale_log2, n_items, sched, cap_in, cap_out, lse);
}

// Multi-head latent attention's core, training only: q / k (B, S, H, 192),
// v and o (B, S, H, 128), each row's log-sum-exp stored, no cap.
constexpr int kMlaQk = 192, kMlaV = 128, kMlaStages = 2;

__global__ void __launch_bounds__(kWgmmaThreads, 1) flash_mla_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int h, int s,
    int causal, float scale_log2, int n_items, int* __restrict__ sched,
    float* __restrict__ lse) {
  flash_fwd_body<kMlaQk, kMlaV, kMlaStages, false, true>(q_map, k_map, v_map, o, h, h, s,
                                                         causal, 0, scale_log2, n_items, sched,
                                                         0.f, 0.f, lse);
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
// (kBoxCols, 1, rows, 1), zero fill past S (and past D in a padded tile).
template <int D>
int encode_map(CUtensorMap* map, const void* base, int heads, int s, int b, int rows = kTile) {
  using T = Tiles<pad_dim(D)>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row, row * s};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBoxCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, bool kCap, bool kLse>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* sched, int b,
                 int h, int kvh, int s, int causal, int window, float cap, float* lse,
                 cudaStream_t stream) {
  constexpr int bytes = Tiles<pad_dim(D)>::kSmemBytes;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D, kCap, kLse>,
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
  flash_attention_wgmma_kernel<D, kCap, kLse><<<grid, kWgmmaThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), h, kvh, s, causal, window,
      scale_log2, static_cast<int>(items), static_cast<int*>(sched), cap_in, cap * kLog2e, lse);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward
constexpr int kBwdKv = 128;    // kv rows of a work item (64 a consumer warpgroup)
constexpr int kBwdQ = 64;      // q rows of a ring stage
constexpr int kBwdStages = 2;  // Q / dO ring depth
// Two consumer warpgroups and no producer warp (see the kernel).
constexpr int kBwdThreads = 2 * kWgThreads;

// The backward's shared memory, in bytes from a 1024-aligned base: K and V
// tiles (128 rows), the Q and dO ring (64-row tiles), dS (128 kv rows of
// 64 q columns, 128-byte rows in 128-byte swizzle: MN-major A of dQ), the
// block's dQ tile in fragment order, and the ring's lse and delta rows.
// K and Q are D wide, V and dO DV. The dQ tile holds kDqCols of its D
// columns: all of them when D == DV; at MLA's D = 192 a 64-column chunk at a
// time (the whole 64 x 192 int64 tile, 96 KB, does not fit beside the rest).
template <int D, int DV>
struct BwdSmem {
  static constexpr int DP = pad_dim(D);
  static constexpr int DVP = pad_dim(DV);
  static constexpr int kDqCols = D == DV ? D : 64;
  static constexpr int kKBytes = kBwdKv * DP * 2;
  static constexpr int kVBytes = kBwdKv * DVP * 2;
  static constexpr int kQBytes = kBwdQ * DP * 2;
  static constexpr int kDoBytes = kBwdQ * DVP * 2;
  static constexpr int kV = kKBytes;
  static constexpr int kQ = kKBytes + kVBytes;              // + stage * kQBytes
  static constexpr int kDo = kQ + kBwdStages * kQBytes;    // + stage * kDoBytes
  static constexpr int kDs = kDo + kBwdStages * kDoBytes;
  static constexpr int kDq = kDs + kBwdKv * 128;
  static constexpr int kDqBytes = kBwdQ * kDqCols * 8;     // the block's 64-row int64 dQ tile
  static constexpr int kRows = kDq + kDqBytes;             // + stage * 512: lse2[64], delta[64]
  static constexpr int kBytes = kRows + kBwdStages * 2 * kBwdQ * 4 + 1024;
};

// K-major operand of a tile of `rows`-row boxes: rows [row0, row0 + 64 or
// N), k-step kk. (kmajor_desc for any box height.)
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int row0, int kk) {
  using T = Tiles<DP>;
  const int col = kk * 16;
  const uint32_t addr = tile + (col / T::kBoxCols) * (ROWS * T::kSw) + row0 * T::kSw +
                        (col % T::kBoxCols) * 2;
  return smem_desc(addr, 16, 8 * T::kSw, T::kLayout);
}

// MN-major operand of a tile of `rows`-row boxes: K rows [row0, row0 + 16),
// all DP columns (a second box lies ROWS * kSw bytes on).
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int row0) {
  using T = Tiles<DP>;
  return smem_desc(tile + row0 * T::kSw, ROWS * T::kSw, 8 * T::kSw, T::kLayout);
}

// d (64 x N, f32) (+)= A (64 x 16, smem) * B (16 x N, smem); TA / TB: the
// operand is MN-major (1) or K-major (0). accumulate = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128t(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// dQ's product, both operands MN-major, N = D.
template <int D>
__device__ __forceinline__ void wgmma_dq(float (&d)[D / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (D == 32) {
    wgmma_ss_n32<1, 1>(d, da, db, accumulate);
  } else if constexpr (D == 64) {
    wgmma_ss_n64<1, 1>(d, da, db, accumulate);
  } else if constexpr (D == 80) {
    wgmma_ss_n80<1, 1>(d, da, db, accumulate);
  } else {
    wgmma_ss_n128t<1, 1>(d, da, db, accumulate);
  }
}

// An m64n64 accumulator (64 kv rows x 64 q columns) as bf16 A fragments of
// four k16 steps over q (pack_p's layout).
__device__ __forceinline__ void pack_frag4(const float (&acc)[32], uint32_t (&fr)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fr[kk][0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
    fr[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    fr[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    fr[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cw), "n"(kWgThreads) : "memory");
}

// Barriers of both warpgroups around the block's dQ tile in shared memory:
// kDqFree (id 3) once the last tile's reduce has read it, kDqPart (id 4)
// once warpgroup 1 has stored its part (it arrives, warpgroup 0 waits).
constexpr int kDqFree = 3, kDqPart = 4;
__device__ __forceinline__ void block_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * kWgThreads) : "memory");
}
__device__ __forceinline__ void block_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * kWgThreads) : "memory");
}

// `bytes` from global memory to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// dQ's partial sums are added as int64 fixed point, row i in units of
// 2^(e_i - kDqBits) for 2^e_i just above max_d |dO_id| (the pre-pass stores
// the factor 2^(kDqBits - e_i), a power of two, so scaling is exact):
// integer adds give one sum in any order, so dQ is the same bit for bit
// from run to run, as dK and dV are.
constexpr int kDqBits = 32;

// dst[i] += src[i] for `bytes` / 8 int64 (two's complement, so .u64),
// shared to global, by the TMA unit (one bulk group).
__device__ __forceinline__ void bulk_reduce_add_i64(long long* dst, uint32_t src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst), "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One backward work item: a (batch, query head) and a 128-row kv tile, with
// the 64-row q tiles that can see it: from the tile's first row if causal,
// up to the window's reach past its last row. Numbered head-major, kv tiles
// in order: a causal head's longest first.
struct BwdItem {
  int b, hh, hk, k0, q_begin, n_q;
};

__device__ __forceinline__ BwdItem bwd_item(int idx, int nk, int h, int kvh, int s, int causal,
                                            int window) {
  BwdItem w;
  const int bh = idx / nk;
  w.b = bh / h;
  w.hh = bh % h;
  w.hk = w.hh / (h / kvh);
  w.k0 = (idx % nk) * kBwdKv;
  w.q_begin = causal ? w.k0 : 0;
  const int q_end = window ? min(s, w.k0 + kBwdKv - 1 + window) : s;
  w.n_q = (q_end - w.q_begin + kBwdQ - 1) / kBwdQ;  // >= 1
  return w;
}

// The pre-pass, one thread a row of (B*H, s_pad): lse2 = lse log2(e) and
// delta = rowsum(dO o O) in f32 (+inf and 0 past S), dq_fix = the row's
// fixed-point factor 2^(kDqBits - e) with 2^e just above max |dO| (e = 0
// for a zero row or past S; the exponent capped so the factor and its
// inverse stay normal), and the row's D int64 of the dQ workspace set to 0
// (the workspace holds B*H*s_pad*D).
// o and dout are DV wide, the dQ workspace's rows D.
template <int D, int DV>
__device__ __forceinline__ void bwd_prep_body(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
    float* __restrict__ dq_fix, long long* __restrict__ dq_acc, int bh_total, int h, int s,
    int s_pad) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(bh_total) * s_pad) return;
  const int bh = static_cast<int>(idx / s_pad);
  const int row = static_cast<int>(idx % s_pad);
  float l2 = INFINITY, dl = 0.f, mx = 0.f;
  if (row < s) {
    const int64_t off = ((static_cast<int64_t>(bh / h) * s + row) * h + bh % h) * DV;
    const uint4* op = reinterpret_cast<const uint4*>(o + off);
    const uint4* gp = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      const uint4 a = op[c], g = gp[c];
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
        const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[i]));
        dl = fmaf(af.x, gf.x, dl);
        dl = fmaf(af.y, gf.y, dl);
        mx = fmaxf(mx, fmaxf(fabsf(gf.x), fabsf(gf.y)));
      }
    }
    l2 = lse[static_cast<int64_t>(bh) * s + row] * kLog2e;  // +inf stays +inf
  }
  int e = 0;
  frexpf(mx, &e);  // mx = f 2^e, f in [0.5, 1); e = 0 for mx = 0
  lse2[idx] = l2;
  delta[idx] = dl;
  dq_fix[idx] = ldexpf(1.f, min(max(kDqBits - e, -120), 120));
  longlong2* z = reinterpret_cast<longlong2*>(dq_acc + idx * D);
#pragma unroll
  for (int c = 0; c < D / 2; ++c) z[c] = make_longlong2(0, 0);
}

template <int D>
__global__ void __launch_bounds__(256) flash_attention_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
    float* __restrict__ dq_fix, long long* __restrict__ dq_acc, int bh_total, int h, int s,
    int s_pad) {
  bwd_prep_body<D, D>(o, dout, lse, lse2, delta, dq_fix, dq_acc, bh_total, h, s, s_pad);
}

// One q tile's loads into the next ring stage (the loader's ring position
// `load_it`), once both warpgroups have released it: Q and dO by TMA, the
// tile's lse2 and delta rows by bulk copy.
template <int D, int DV>
__device__ __forceinline__ void bwd_load_q(uint32_t base, const CUtensorMap* q_map,
                                           const CUtensorMap* do_map, uint32_t full_bar,
                                           uint32_t empty_bar, const float* lse2,
                                           const float* delta, const BwdItem& w, int h,
                                           int s_pad, int i, int& load_it) {
  using T = Tiles<pad_dim(D)>;
  using TV = Tiles<pad_dim(DV)>;
  using L = BwdSmem<D, DV>;
  const int st = load_it % kBwdStages;
  if (load_it >= kBwdStages) mbar_wait(empty_bar + 8 * st, (load_it / kBwdStages - 1) & 1);
  const int q0 = w.q_begin + i * kBwdQ;
  const uint32_t bar = full_bar + 8 * st;
  const uint32_t q_tile = base + L::kQ + st * L::kQBytes;
  const uint32_t do_tile = base + L::kDo + st * L::kDoBytes;
  const uint32_t rows = base + L::kRows + st * 2 * kBwdQ * 4;
  const int64_t row = (static_cast<int64_t>(w.b) * h + w.hh) * s_pad + q0;
  mbar_expect_tx(bar, L::kQBytes + L::kDoBytes + 2 * kBwdQ * 4);
  if constexpr (D == DV) {
    for (int box = 0; box < T::kBoxes; ++box) {
      tma_load(q_tile + box * kBwdQ * T::kSw, q_map, bar, box * T::kBoxCols, w.hh, q0, w.b);
      tma_load(do_tile + box * kBwdQ * T::kSw, do_map, bar, box * T::kBoxCols, w.hh, q0, w.b);
    }
  } else {
    for (int box = 0; box < T::kBoxes; ++box)
      tma_load(q_tile + box * kBwdQ * T::kSw, q_map, bar, box * T::kBoxCols, w.hh, q0, w.b);
    for (int box = 0; box < TV::kBoxes; ++box)
      tma_load(do_tile + box * kBwdQ * TV::kSw, do_map, bar, box * TV::kBoxCols, w.hh, q0,
               w.b);
  }
  bulk_load(rows, lse2 + row, kBwdQ * 4, bar);
  bulk_load(rows + kBwdQ * 4, delta + row, kBwdQ * 4, bar);
  ++load_it;
}

// Persistent, as the forward, but with no producer warp: a block is the
// two consumer warpgroups alone (8 warps, so up to 255 registers a thread;
// a ninth warp would cap them at 168, as the forward's D = 128 spill
// shows), and its thread 0 is the loader. At an item's start it takes the
// item from sched[0], waits until both warpgroups are done with the last
// item's K and V (kv_empty), publishes the item beside its K and V
// (kv_full) and loads its first q tile; at each q tile it loads the next
// one into the other ring stage. dk / dv: bf16 (B, S, KVH, D / DV) when
// kv_f32 is 0, else f32 (B, S, H, D / DV) per query head. D is the
// query / key width and DV the value width: D = DV for every kernel but
// MLA's, D = 192 and DV = 128, whose dQ part goes through shared memory a
// 64-column chunk at a time (BwdSmem::kDqCols), each chunk by the
// protocol below.
template <int D, int DV, bool kCap>
__device__ __forceinline__ void flash_bwd_body(
    const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
    const CUtensorMap& do_map, const float* __restrict__ lse2, const float* __restrict__ delta,
    const float* __restrict__ dq_fix, long long* __restrict__ dq_acc,
    void* __restrict__ dk_out, void* __restrict__ dv_out,
    int kv_f32, int h, int kvh, int s, int s_pad, int causal, int window, float scale_log2,
    float scale, int n_items, int* __restrict__ sched, float cap_in, float cap_out) {
  constexpr int DP = pad_dim(D);
  constexpr int DVP = pad_dim(DV);
  using T = Tiles<DP>;
  using L = BwdSmem<D, DV>;
  constexpr int DC = L::kDqCols;
  extern __shared__ uint8_t smem_raw[];
  // full[], empty[] of the ring; kv full, kv empty
  __shared__ __align__(8) uint64_t bars[2 * kBwdStages + 2];
  __shared__ int item;  // the work item whose K and V are loaded (>= n_items: no more)

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t k_tile = base;
  const uint32_t v_tile = base + L::kV;
  const uint32_t full_bar = smem_u32(&bars[0]);
  const uint32_t empty_bar = smem_u32(&bars[kBwdStages]);
  const uint32_t kv_full = smem_u32(&bars[2 * kBwdStages]);
  const uint32_t kv_empty = smem_u32(&bars[2 * kBwdStages + 1]);
  const int nk = (s + kBwdKv - 1) / kBwdKv;
  const bool loader = threadIdx.x == 0;

  if (loader) {
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, kConsumerWarps);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup cw owns kv rows [k0 + 64 cw, k0 + 64 cw + 64).
  const int cw = threadIdx.x / kWgThreads;
  const int t = threadIdx.x % kWgThreads;
  const int lane = t % 32;
  const int col0 = 2 * (lane % 4);
  const int frag_row = 16 * (t / 32) + lane / 4;  // rows frag_row and frag_row + 8 of 64
  const int nq64 = s_pad / kBwdQ;
  const uint32_t ds_tile = base + L::kDs;
  const uint32_t dq_tile = base + L::kDq;
  long long* const dq_s = reinterpret_cast<long long*>(base_ptr + L::kDq);

  float dk[D / 2], dv[DV / 2];
  int it = 0;       // q tiles consumed so far: the ring position
  int load_it = 0;  // the loader's: q tiles loaded so far
  for (int n = 0;; ++n) {
    if (loader) {
      const int idx = atomicAdd(&sched[0], 1);
      if (n > 0) mbar_wait(kv_empty, (n - 1) & 1);  // the last item is done with K and V
      *reinterpret_cast<volatile int*>(&item) = idx;
      if (idx >= n_items) {
        mbar_arrive(kv_full);  // no load: every thread reads the end
      } else {
        const BwdItem w = bwd_item(idx, nk, h, kvh, s, causal, window);
        mbar_expect_tx(kv_full, L::kKBytes + L::kVBytes);
        if constexpr (D == DV) {
          for (int box = 0; box < T::kBoxes; ++box) {
            tma_load(k_tile + box * kBwdKv * T::kSw, &k_map, kv_full, box * T::kBoxCols, w.hk,
                     w.k0, w.b);
            tma_load(v_tile + box * kBwdKv * T::kSw, &v_map, kv_full, box * T::kBoxCols, w.hk,
                     w.k0, w.b);
          }
        } else {
          using TV = Tiles<DVP>;
          for (int box = 0; box < T::kBoxes; ++box)
            tma_load(k_tile + box * kBwdKv * T::kSw, &k_map, kv_full, box * T::kBoxCols, w.hk,
                     w.k0, w.b);
          for (int box = 0; box < TV::kBoxes; ++box)
            tma_load(v_tile + box * kBwdKv * TV::kSw, &v_map, kv_full, box * TV::kBoxCols,
                     w.hk, w.k0, w.b);
        }
        bwd_load_q<D, DV>(base, &q_map, &do_map, full_bar, empty_bar, lse2, delta, w, h, s_pad,
                          0, load_it);
      }
    }
    mbar_wait(kv_full, n & 1);
    const int idx = *reinterpret_cast<volatile int*>(&item);
    if (idx >= n_items) break;
    const BwdItem w = bwd_item(idx, nk, h, kvh, s, causal, window);
    const int kv_lo = w.k0 + 64 * cw;  // this warpgroup's first kv row
    const int kv_r0 = kv_lo + frag_row;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

    for (int i = 0; i < w.n_q; ++i, ++it) {
      if (loader && i + 1 < w.n_q)  // the next q tile, into the stage released at i - 1
        bwd_load_q<D, DV>(base, &q_map, &do_map, full_bar, empty_bar, lse2, delta, w, h, s_pad,
                          i + 1, load_it);
      const int st = it % kBwdStages;
      const int q0 = w.q_begin + i * kBwdQ;
      const uint32_t q_tile = base + L::kQ + st * L::kQBytes;
      const uint32_t do_tile = base + L::kDo + st * L::kDoBytes;
      const float* const lse_s =
          reinterpret_cast<const float*>(base_ptr + L::kRows + st * 2 * kBwdQ * 4);
      const float* const dl_s = lse_s + kBwdQ;
      mbar_wait(full_bar + 8 * st, (it / kBwdStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q columns each.
      float sacc[32], dpacc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sacc[j] = dpacc[j] = 0.f;
      reg_fence(sacc);
      reg_fence(dpacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64<0, 0>(sacc, kdesc<DP, kBwdKv>(k_tile, 64 * cw, kk),
                           kdesc<DP, kBwdQ>(q_tile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss_n64<0, 0>(dpacc, kdesc<DVP, kBwdKv>(v_tile, 64 * cw, kk),
                           kdesc<DVP, kBwdQ>(do_tile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sacc);
      reg_fence(dpacc);

      // p = exp2(s - lse2) (s in log2 units of the scaled, capped score) and
      // ds = p (dp - delta), in place; 0 where the pair is invalid. Fragment
      // (j, e): kv row kv_r0 + 8 (e >> 1), q column 8 j + col0 + (e & 1).
      const bool masked = q0 + kBwdQ > s || kv_lo + 63 >= s || (causal && q0 < kv_lo + 63) ||
                          (window && q0 + kBwdQ - 1 >= kv_lo + window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + col0 + (e & 1);
          const float l2 = lse_s[qc];
          const float dl = dl_s[qc];
          float p, ds;
          if constexpr (kCap) {
            const float th = tanhf(sacc[4 * j + e] * cap_in);
            p = fast_exp2(fmaf(cap_out, th, -l2));
            ds = p * (dpacc[4 * j + e] - dl) * (1.f - th * th);
          } else {
            p = fast_exp2(fmaf(sacc[4 * j + e], scale_log2, -l2));
            ds = p * (dpacc[4 * j + e] - dl);
          }
          if (masked) {
            const int kv = kv_r0 + 8 * (e >> 1);
            const int q = q0 + qc;
            const bool ok = kv < s && q < s && (!causal || kv <= q) &&
                            (!window || q < kv + window);
            p = ok ? p : 0.f;
            ds = ok ? ds : 0.f;
          }
          sacc[4 * j + e] = p;
          dpacc[4 * j + e] = ds;
        }
      uint32_t pa[4][4], da[4][4];
      pack_frag4(sacc, pa);
      pack_frag4(dpacc, da);

      // dV += P^T dO and dK += dS^T Q (B: dO and Q, MN-major).
      reg_fence(dv);
      reg_fence(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<DV>(dv, pa[kk], mndesc<DVP, kBwdQ>(do_tile, 16 * kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(dk, da[kk], mndesc<DP, kBwdQ>(q_tile, 16 * kk));
      wgmma_commit();

      // dS as bf16 into this warpgroup's 64 rows of the dS tile: row r (kv)
      // holds 64 q columns in 128 bytes, 16-byte chunk c at c ^ (r & 7).
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * cw + frag_row + 8 * r;
          *reinterpret_cast<uint32_t*>(base_ptr + L::kDs + row * 128 +
                                       ((j ^ (row & 7)) << 4) + col0 * 2) =
              da[j >> 1][2 * (j & 1) + r];
        }
      fence_proxy_async();
      wg_sync(cw);  // the warpgroup's dS is in shared memory

      // The fixed-point factors of this thread's two q rows.
      const float* const fix_row =
          dq_fix + (static_cast<int64_t>(w.b) * h + w.hh) * s_pad + q0 + frag_row;
      float fix[2];
#pragma unroll
      for (int c = 0; c < D / DC; ++c) {
        // dQ part (64 q rows x DC columns from c DC) = dS K over this
        // warpgroup's 64 kv rows; chunk 0 issued behind dV and dK.
        float dq[DC / 2];
#pragma unroll
        for (int j = 0; j < DC / 2; ++j) dq[j] = 0.f;
        reg_fence(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_dq<DC>(dq, smem_desc(ds_tile + (64 * cw + 16 * kk) * 128, kBwdKv * 128, 1024, 1),
                       mndesc<DP, kBwdKv>(k_tile + c * (DC / T::kBoxCols) * kBwdKv * T::kSw,
                                          64 * cw + 16 * kk),
                       kk > 0);
        wgmma_commit();
        if (c == 0) {
          wgmma_wait<1>();  // dV and dK have landed
          reg_fence(dv);
          reg_fence(dk);
          if (lane == 0) mbar_arrive(empty_bar + 8 * st);  // Q, dO, lse and delta are read
          fix[0] = __ldg(fix_row);
          fix[1] = __ldg(fix_row + 8);
        }
        wgmma_wait<0>();
        reg_fence(dq);

        // The two warpgroups' parts (the same 64 q rows, fragment for
        // fragment) as int64 fixed point in shared memory ([pair][thread][2]):
        // warpgroup 1 stores its part, warpgroup 0 adds its own, and one bulk
        // reduce-add takes the chunk's sum to the workspace.
        if (cw == 0 && t == 0) bulk_wait_read();  // the last reduce has read it
        block_sync(kDqFree);
        if (cw == 1) {
#pragma unroll
          for (int j = 0; j < DC / 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<longlong2*>(dq_s + ((2 * j + r) * kWgThreads + t) * 2) =
                  make_longlong2(__float2ll_rn(dq[4 * j + 2 * r] * fix[r]),
                                 __float2ll_rn(dq[4 * j + 2 * r + 1] * fix[r]));
          block_arrive(kDqPart);
        } else {
          block_sync(kDqPart);
#pragma unroll
          for (int j = 0; j < DC / 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              longlong2* const slot =
                  reinterpret_cast<longlong2*>(dq_s + ((2 * j + r) * kWgThreads + t) * 2);
              const longlong2 part = *slot;
              *slot = make_longlong2(part.x + __float2ll_rn(dq[4 * j + 2 * r] * fix[r]),
                                     part.y + __float2ll_rn(dq[4 * j + 2 * r + 1] * fix[r]));
            }
          fence_proxy_async();
          wg_sync(0);
          if (t == 0) {
            // the tile's [pair][thread][2] layout over D: chunk c's pairs are
            // c DC / 4 onwards
            const int64_t tile = (static_cast<int64_t>(w.b) * h + w.hh) * nq64 + q0 / kBwdQ;
            bulk_reduce_add_i64(dq_acc + tile * kBwdQ * D + c * (DC / 4) * kWgThreads * 2,
                                dq_tile, L::kDqBytes);
          }
        }
      }
    }
    if (lane == 0) mbar_arrive(kv_empty);  // this warp is done with K and V

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv_r0 + 8 * r;
      if (row >= s) continue;
      const int64_t at = kv_f32 ? (static_cast<int64_t>(w.b) * s + row) * h + w.hh
                                : (static_cast<int64_t>(w.b) * s + row) * kvh + w.hk;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int64_t off = at * D + 8 * j + col0;
        const float kx = dk[4 * j + 2 * r] * scale, ky = dk[4 * j + 2 * r + 1] * scale;
        if (kv_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(dk_out) + off) = make_float2(kx, ky);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dk_out) + off) =
              __floats2bfloat162_rn(kx, ky);
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int64_t off = at * DV + 8 * j + col0;
        const float vx = dv[4 * j + 2 * r], vy = dv[4 * j + 2 * r + 1];
        if (kv_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(dv_out) + off) = make_float2(vx, vy);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dv_out) + off) =
              __floats2bfloat162_rn(vx, vy);
      }
    }
  }
  if (t == 0) bulk_wait_all();  // the reduces are done before the block's memory goes
  if (loader && atomicAdd(&sched[1], 1) == static_cast<int>(gridDim.x) - 1) {
    sched[0] = 0;  // every block has taken its last item
    sched[1] = 0;
  }
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_attention_bwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    const float* __restrict__ dq_fix, long long* __restrict__ dq_acc,
    void* __restrict__ dk_out, void* __restrict__ dv_out,
    int kv_f32, int h, int kvh, int s, int s_pad, int causal, int window, float scale_log2,
    float scale, int n_items, int* __restrict__ sched, float cap_in, float cap_out) {
  flash_bwd_body<D, D, kCap>(q_map, k_map, v_map, do_map, lse2, delta, dq_fix, dq_acc, dk_out,
                             dv_out, kv_f32, h, kvh, s, s_pad, causal, window, scale_log2, scale,
                             n_items, sched, cap_in, cap_out);
}

// MLA's backward main kernel: MHA, bf16 dK (B, S, H, 192) and dV (B, S, H,
// 128), no cap.
__global__ void __launch_bounds__(kBwdThreads, 1) flash_mla_bwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    const float* __restrict__ dq_fix, long long* __restrict__ dq_acc,
    __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out, int h, int s,
    int s_pad, int causal, float scale_log2, float scale, int n_items,
    int* __restrict__ sched) {
  flash_bwd_body<kMlaQk, kMlaV, false>(q_map, k_map, v_map, do_map, lse2, delta, dq_fix, dq_acc,
                                       dk_out, dv_out, 0, h, h, s, s_pad, causal, 0, scale_log2,
                                       scale, n_items, sched, 0.f, 0.f);
}

__global__ void __launch_bounds__(256) flash_mla_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
    float* __restrict__ dq_fix, long long* __restrict__ dq_acc, int bh_total, int h, int s,
    int s_pad) {
  bwd_prep_body<kMlaQk, kMlaV>(o, dout, lse, lse2, delta, dq_fix, dq_acc, bh_total, h, s,
                               s_pad);
}

// dq (B, S, H, D) bf16 = scale * the workspace, one thread a pair of a
// tile's fragment order.
template <int D>
__device__ __forceinline__ void bwd_dq_body(
    const long long* __restrict__ dq_acc, const float* __restrict__ dq_fix,
    __nv_bfloat16* __restrict__ dq, int bh_total, int h, int s, int s_pad, float scale) {
  constexpr int kPairs = D / 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int nq64 = s_pad / kBwdQ;
  if (idx >= static_cast<int64_t>(bh_total) * nq64 * kPairs * kWgThreads) return;
  const int t = static_cast<int>(idx % kWgThreads);
  const int pi = static_cast<int>((idx / kWgThreads) % kPairs);
  const int64_t tile = idx / (static_cast<int64_t>(kWgThreads) * kPairs);
  const int bh = static_cast<int>(tile / nq64);
  const int row = static_cast<int>(tile % nq64) * kBwdQ + 16 * (t / 32) + (t % 32) / 4 +
                  8 * (pi & 1);
  if (row >= s) return;
  const int col = 8 * (pi >> 1) + 2 * (t % 4);
  const longlong2 v = *reinterpret_cast<const longlong2*>(
      dq_acc + tile * kBwdQ * D + (static_cast<int64_t>(pi) * kWgThreads + t) * 2);
  // the scale over the row's factor, a power of two: exact
  const float unfix = scale / dq_fix[static_cast<int64_t>(bh) * s_pad + row];
  *reinterpret_cast<__nv_bfloat162*>(
      dq + ((static_cast<int64_t>(bh / h) * s + row) * h + bh % h) * D + col) =
      __floats2bfloat162_rn(__ll2float_rn(v.x) * unfix, __ll2float_rn(v.y) * unfix);
}

template <int D>
__global__ void __launch_bounds__(256) flash_attention_bwd_dq_kernel(
    const long long* __restrict__ dq_acc, const float* __restrict__ dq_fix,
    __nv_bfloat16* __restrict__ dq, int bh_total, int h, int s, int s_pad, float scale) {
  bwd_dq_body<D>(dq_acc, dq_fix, dq, bh_total, h, s, s_pad, scale);
}

__global__ void __launch_bounds__(256) flash_mla_bwd_dq_kernel(
    const long long* __restrict__ dq_acc, const float* __restrict__ dq_fix,
    __nv_bfloat16* __restrict__ dq, int bh_total, int h, int s, int s_pad, float scale) {
  bwd_dq_body<kMlaQk>(dq_acc, dq_fix, dq, bh_total, h, s, s_pad, scale);
}

// GQA: dk / dv (B, S, KVH, D) bf16 = the sum over each kv head's g query
// heads of the f32 (B, S, H, D) workspaces; one thread a column pair.
__global__ void __launch_bounds__(256) flash_attention_bwd_dkv_kernel(
    const float* __restrict__ dk32, const float* __restrict__ dv32,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int64_t pairs, int kvh,
    int g, int d) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const int half = d / 2;
  const int c = static_cast<int>(idx % half) * 2;
  const int64_t row = idx / half;  // (b, s, kv head)
  const int64_t bs = row / kvh;
  const int hk = static_cast<int>(row % kvh);
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int gi = 0; gi < g; ++gi) {
    const int64_t off = (bs * kvh * g + static_cast<int64_t>(hk) * g + gi) * d + c;
    const float2 a = *reinterpret_cast<const float2*>(dk32 + off);
    const float2 b = *reinterpret_cast<const float2*>(dv32 + off);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += b.x;
    sv.y += b.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + row * d + c) = __floats2bfloat162_rn(sk.x, sk.y);
  *reinterpret_cast<__nv_bfloat162*>(dv + row * d + c) = __floats2bfloat162_rn(sv.x, sv.y);
}

int blocks_of(int64_t threads) { return static_cast<int>((threads + 255) / 256); }

// The workspace (f32 units): lse2, delta and dq_fix (B*H*s_pad each), the
// dQ tiles (B*H*s_pad*D int64), and with GQA f32 dK and dV (B*S*H*D each).
template <int D, bool kCap>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* ws, void* sched, int b,
               int h, int kvh, int s, int causal, int window, float cap, cudaStream_t stream) {
  using L = BwdSmem<D, D>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_kernel<D, kCap>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int s_pad = (s + kBwdQ - 1) / kBwdQ * kBwdQ;
  const int bh = b * h;
  const int64_t rows = static_cast<int64_t>(bh) * s_pad;
  float* lse2 = ws;
  float* delta = ws + rows;
  float* dq_fix = ws + 2 * rows;
  long long* dq_acc = reinterpret_cast<long long*>(ws + 3 * rows);  // 16-byte aligned: 64 | rows
  const bool gqa = h != kvh;
  float* dk32 = ws + 3 * rows + 2 * rows * D;
  float* dv32 = dk32 + static_cast<int64_t>(b) * s * h * D;

  CUtensorMap q_map, k_map, v_map, do_map;
  int err = encode_map<D>(&q_map, q, h, s, b, kBwdQ);
  if (err == 0) err = encode_map<D>(&do_map, dout, h, s, b, kBwdQ);
  if (err == 0) err = encode_map<D>(&k_map, k, kvh, s, b, kBwdKv);
  if (err == 0) err = encode_map<D>(&v_map, v, kvh, s, b, kBwdKv);
  if (err != 0) return err;
  const int64_t items = static_cast<int64_t>(bh) * ((s + kBwdKv - 1) / kBwdKv);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err2 = cudaGetDevice(&device);
  if (err2 == cudaSuccess)
    err2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err2 != cudaSuccess) return static_cast<int>(err2);

  flash_attention_bwd_prep_kernel<D><<<blocks_of(rows), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, lse2,
      delta, dq_fix, dq_acc, bh, h, s, s_pad);
  err2 = cudaGetLastError();
  if (err2 != cudaSuccess) return static_cast<int>(err2);

  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float cap_in = kCap ? scale / cap : 0.f;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_attention_bwd_kernel<D, kCap><<<grid, kBwdThreads, L::kBytes, stream>>>(
      q_map, k_map, v_map, do_map, lse2, delta, dq_fix, dq_acc,
      gqa ? static_cast<void*>(dk32) : dk,
      gqa ? static_cast<void*>(dv32) : dv, gqa ? 1 : 0, h, kvh, s, s_pad, causal, window,
      kLog2e / sqrtf(static_cast<float>(D)), scale, static_cast<int>(items),
      static_cast<int*>(sched), cap_in, cap * kLog2e);
  err2 = cudaGetLastError();
  if (err2 != cudaSuccess) return static_cast<int>(err2);

  flash_attention_bwd_dq_kernel<D><<<blocks_of(rows / kBwdQ * (D / 4) * kWgThreads), 256, 0,
                                     stream>>>(dq_acc, dq_fix, static_cast<__nv_bfloat16*>(dq),
                                               bh, h, s, s_pad, scale);
  err2 = cudaGetLastError();
  if (err2 != cudaSuccess || !gqa) return static_cast<int>(err2);
  const int64_t pairs = static_cast<int64_t>(b) * s * kvh * (D / 2);
  flash_attention_bwd_dkv_kernel<<<blocks_of(pairs), 256, 0, stream>>>(
      dk32, dv32, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), pairs, kvh,
      h / kvh, D);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCap>
int dispatch_bwd(int d, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, void* dk, void* dv, float* ws,
                 void* sched, int b, int h, int kvh, int s, int causal, int window, float cap,
                 cudaStream_t st) {
  switch (d) {
    case 32:
      return launch_bwd<32, kCap>(q, k, v, o, dout, lse, dq, dk, dv, ws, sched, b, h, kvh, s,
                                  causal, window, cap, st);
    case 64:
      return launch_bwd<64, kCap>(q, k, v, o, dout, lse, dq, dk, dv, ws, sched, b, h, kvh, s,
                                  causal, window, cap, st);
    case 80:
      return launch_bwd<80, kCap>(q, k, v, o, dout, lse, dq, dk, dv, ws, sched, b, h, kvh, s,
                                  causal, window, cap, st);
    case 128:
      return launch_bwd<128, kCap>(q, k, v, o, dout, lse, dq, dk, dv, ws, sched, b, h, kvh, s,
                                   causal, window, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

template <bool kCap, bool kLse>
int dispatch_bf16(int d, const void* q, const void* k, const void* v, void* o, void* sched,
                  int b, int h, int kvh, int s, int causal, int window, float cap, float* lse,
                  cudaStream_t st) {
  switch (d) {
    case 32:
      return launch_wgmma<32, kCap, kLse>(q, k, v, o, sched, b, h, kvh, s, causal, window, cap,
                                          lse, st);
    case 64:
      return launch_wgmma<64, kCap, kLse>(q, k, v, o, sched, b, h, kvh, s, causal, window, cap,
                                          lse, st);
    case 80:
      return launch_wgmma<80, kCap, kLse>(q, k, v, o, sched, b, h, kvh, s, causal, window, cap,
                                          lse, st);
    case 128:
      return launch_wgmma<128, kCap, kLse>(q, k, v, o, sched, b, h, kvh, s, causal, window, cap,
                                           lse, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int b, int h, int kvh, int window, float softcap) {
  return kvh <= 0 || h % kvh != 0 || window < 0 || static_cast<int64_t>(b) * h > 0x7fffffff ||
         !(softcap >= 0.f) || isinf(softcap);
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
}

// MLA's training forward: q / k (B, S, H, 192), v (B, S, H, 128) -> o (B, S, H,
// 128) and lse (B, H, S), the softmax at `scale`.
int launch_mla_fwd(const void* q, const void* k, const void* v, void* o, void* sched, int b,
                   int h, int s, int causal, float scale, float* lse, cudaStream_t stream) {
  constexpr int bytes = FwdSmem<kMlaQk, kMlaV, kMlaStages>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_mla_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map;
  int err = encode_map<kMlaQk>(&q_map, q, h, s, b);
  if (err == 0) err = encode_map<kMlaQk>(&k_map, k, h, s, b);
  if (err == 0) err = encode_map<kMlaV>(&v_map, v, h, s, b);
  if (err != 0) return err;
  const int64_t items = static_cast<int64_t>(b) * h * ((s + kTile - 1) / kTile);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = sm_count(&sms);
  if (err != 0) return err;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_mla_fwd_kernel<<<grid, kWgmmaThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), h, s, causal, scale * kLog2e,
      static_cast<int>(items), static_cast<int*>(sched), lse);
  return static_cast<int>(cudaGetLastError());
}

// MLA's backward: the pre-pass, the main kernel and the dQ conversion, as
// launch_bwd's for MHA; ws holds lse2, delta, dq_fix and the dQ tiles.
int launch_mla_bwd(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv, float* ws,
                   void* sched, int b, int h, int s, int causal, float scale,
                   cudaStream_t stream) {
  using L = BwdSmem<kMlaQk, kMlaV>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_mla_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int s_pad = (s + kBwdQ - 1) / kBwdQ * kBwdQ;
  const int bh = b * h;
  const int64_t rows = static_cast<int64_t>(bh) * s_pad;
  float* lse2 = ws;
  float* delta = ws + rows;
  float* dq_fix = ws + 2 * rows;
  long long* dq_acc = reinterpret_cast<long long*>(ws + 3 * rows);  // 16-byte aligned: 64 | rows

  CUtensorMap q_map, k_map, v_map, do_map;
  int err = encode_map<kMlaQk>(&q_map, q, h, s, b, kBwdQ);
  if (err == 0) err = encode_map<kMlaV>(&do_map, dout, h, s, b, kBwdQ);
  if (err == 0) err = encode_map<kMlaQk>(&k_map, k, h, s, b, kBwdKv);
  if (err == 0) err = encode_map<kMlaV>(&v_map, v, h, s, b, kBwdKv);
  if (err != 0) return err;
  const int64_t items = static_cast<int64_t>(bh) * ((s + kBwdKv - 1) / kBwdKv);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = sm_count(&sms);
  if (err != 0) return err;

  flash_mla_bwd_prep_kernel<<<blocks_of(rows), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, lse2,
      delta, dq_fix, dq_acc, bh, h, s, s_pad);
  cudaError_t err2 = cudaGetLastError();
  if (err2 != cudaSuccess) return static_cast<int>(err2);
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_mla_bwd_kernel<<<grid, kBwdThreads, L::kBytes, stream>>>(
      q_map, k_map, v_map, do_map, lse2, delta, dq_fix, dq_acc,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), h, s, s_pad, causal,
      scale * kLog2e, scale, static_cast<int>(items), static_cast<int*>(sched));
  err2 = cudaGetLastError();
  if (err2 != cudaSuccess) return static_cast<int>(err2);
  flash_mla_bwd_dq_kernel<<<blocks_of(rows / kBwdQ * (kMlaQk / 4) * kWgThreads), 256, 0,
                            stream>>>(dq_acc, dq_fix, static_cast<__nv_bfloat16*>(dq), bh, h, s,
                                      s_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

// MLA's (192, 128) instantiation takes bf16 MHA with no window or cap, and
// always stores the log-sum-exp (it is built for training only).
bool bad_mla(int dtype, int h, int kvh, int window, float softcap, const void* sched,
             const void* lse) {
  return dtype != 1 || h != kvh || window != 0 || softcap != 0.f || sched == nullptr ||
         lse == nullptr;
}

float mla_scale(float scale) {
  return scale > 0.f ? scale : 1.0f / sqrtf(static_cast<float>(kMlaQk));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, S, H, D); k (B, S, KVH, D); v and
// o (B, S, KVH or H, DV). DV equals D, or (D, DV) is multi-head latent
// attention's (192, 128): bf16 MHA with no window or cap, lse required.
// scale: 0 for D^-0.5; another value only at (192, 128). sched: two int32
// counters, 0 on entry and left 0 (bf16 only; one stream at a time per
// device). softcap > 0 caps the scaled logits (0: uncapped). lse: null, or
// (B, H, S) f32 for each row's log-sum-exp (bf16 only: the training
// instantiation). Neither kernel's grid caps B*H at 65,535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* sched, int b, int h, int kvh, int s, int d, int dv,
                                      int causal, int window, int dtype, float softcap,
                                      float scale, void* lse, void* stream) {
  if (b == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(b, h, kvh, window, softcap) || !(scale >= 0.f) || isinf(scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == kMlaQk && dv == kMlaV) {
    if (bad_mla(dtype, h, kvh, window, softcap, sched, lse))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mla_fwd(q, k, v, o, sched, b, h, s, causal, mla_scale(scale),
                          static_cast<float*>(lse), static_cast<cudaStream_t>(stream));
  }
  if (dv != d || scale != 0.f) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (dtype == 0) {
    if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return cap ? dispatch_f32<true>(d, q, k, v, o, b, h, kvh, s, causal, window, softcap, st)
               : dispatch_f32<false>(d, q, k, v, o, b, h, kvh, s, causal, window, softcap, st);
  }
  if (dtype == 1) {
    if (sched == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    float* l = static_cast<float*>(lse);
    if (lse == nullptr)
      return cap ? dispatch_bf16<true, false>(d, q, k, v, o, sched, b, h, kvh, s, causal,
                                              window, softcap, l, st)
                 : dispatch_bf16<false, false>(d, q, k, v, o, sched, b, h, kvh, s, causal,
                                               window, softcap, l, st);
    return cap ? dispatch_bf16<true, true>(d, q, k, v, o, sched, b, h, kvh, s, causal, window,
                                           softcap, l, st)
               : dispatch_bf16<false, true>(d, q, k, v, o, sched, b, h, kvh, s, causal, window,
                                            softcap, l, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 backward: dq (B, S, H, D), dk (B, S, KVH, D), dv (B, S, KVH, DV)
// from q, k, v, the forward's out and lse, and dout; (D, DV) and scale as
// the forward's. ws: f32 workspace of flash_attention_bwd_workspace floats;
// sched: two int32 counters, 0 on entry and left 0 (not the forward's:
// either may run while the other's are in use by nothing, but they are kept
// apart).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* ws, void* sched,
                                          int b, int h, int kvh, int s, int d, int dvw,
                                          int causal, int window, float softcap, float scale,
                                          void* stream) {
  if (b == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(b, h, kvh, window, softcap) || sched == nullptr || ws == nullptr ||
      !(scale >= 0.f) || isinf(scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == kMlaQk && dvw == kMlaV) {
    if (bad_mla(1, h, kvh, window, softcap, sched, lse))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mla_bwd(q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
                          static_cast<float*>(ws), sched, b, h, s, causal, mla_scale(scale),
                          static_cast<cudaStream_t>(stream));
  }
  if (dvw != d || scale != 0.f) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(ws);
  return softcap > 0.f
             ? dispatch_bwd<true>(d, q, k, v, o, dout, l, dq, dk, dv, w, sched, b, h, kvh, s,
                                  causal, window, softcap, st)
             : dispatch_bwd<false>(d, q, k, v, o, dout, l, dq, dk, dv, w, sched, b, h, kvh, s,
                                   causal, window, softcap, st);
}

// Floats of the backward's workspace (at MLA's (192, 128) too, with d 192).
extern "C" long long flash_attention_bwd_workspace(int b, int h, int kvh, int s, int d) {
  const long long s_pad = (s + kBwdQ - 1) / kBwdQ * kBwdQ;
  const long long rows = static_cast<long long>(b) * h * s_pad;
  return rows * (3 + 2 * d) + (h != kvh ? 2LL * b * s * h * d : 0);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
