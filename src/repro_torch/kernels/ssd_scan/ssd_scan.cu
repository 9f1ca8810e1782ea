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
// be NaN. The state is f32 throughout and the state after the last tile is
// written as a second output (the Mamba-2 decode cache); the TPU kernel
// keeps it in VMEM scratch and drops it. Any chunk the caller names gives
// the same function up to f32 rounding, so both kernels tile 64 steps.
// Tail tiles are zero-padded: padded rows have dt = 0, so they add nothing
// to the state, and they are never stored.
//
// Layouts in place: x and y in the model's (B, S, H, P), dt (B, S, H), and
// one B and C (B, S, N) shared by every head (n_groups = 1) are read
// through strides, with a head stride of 0 for B and C; x, B and C may be
// column slices of the conv output (a row stride of H*P + 2N). The
// reference kernel's (BH, S, P) layout is the same code with H = 1.
//
// What bounds it: bytes. At Zamba2's prefill (B = 8, 64 heads, S = 3584,
// P = N = 64) the function reads bf16 x, B, C and f32 dt and writes f32 y
// and the final state: 727,712,000 bytes, 0.2172 ms at 3.35 TB/s. Its least
// work, the bare recurrence (4 P N FLOP a step and head, 30.1 GFLOP),
// takes 0.030 ms on the bf16 tensor cores, where every product of two bf16
// inputs is exact in f32.
//
// The bf16 kernel (ssd_scan_bf16_kernel), against those bytes and the
// serial chain of 56 tiles a head:
// - One block per (batch, group of kGroup = 2 heads), 4 warps a head, each
//   warp 16 rows p of its head's state; heads past H in the last group are
//   masked. 256 blocks at Zamba2's shape: one wave at 2 blocks an SM.
// - Tile t + 1 lands while tile t computes (a ring of kStages = 2). The
//   operands stay bf16 in shared memory, 128-byte rows whose 16-byte chunks
//   are XOR-swizzled by row, zero-padded to P = N = 64 and past S. Where
//   x, B and C start and step on 16 bytes (the main path) one thread hands
//   C, B and each head's x to TMA (128-byte swizzle, the same pattern);
//   else every thread issues cp.async copies of 8 or 4 bytes. dt comes by
//   4-byte cp.async. The wrapper checks the alignment and picks the width.
// - Phase A, between the tile's two barriers: every warp runs each head's
//   cumsum of dt a in registers (log2 units; the tile's total is seg[63]
//   itself, so exp(total - seg_j) is exactly 1 at its last step); then C Bᵀ
//   once per 16 x 8 half of each 16 x 16 block on or below the diagonal
//   (20 halves over the 8 warps; mma.sync m16n8k16, bf16 in, f32 out:
//   exact products), and for each head straight from those accumulators
//   att = C Bᵀ exp(seg_i - seg_j) dt_j in f32, the exponent taken only
//   where j <= i, split hi + lo into shared memory (10 KB a head).
// - Phase C, each warp for its head: yᵀ (p by i) = state Cᵀ, scaled by
//   exp(seg_i); yᵀ += xᵀ attᵀ; y stored from the accumulators; then state
//   = state exp(total) + (w x)ᵀ B with w_j = exp(total - seg_j) dt_j folded
//   into x in f32. Every f32 operand of a product is split as hi + lo (hi
//   = bf16(v), lo = bf16(v - hi)), two bf16 products into one f32
//   accumulator, about 2^-16 of the operand: att, the state, w x. The
//   state's accumulator layout is also the A operand layout, so it never
//   leaves registers; nothing carried across tiles is rounded to bf16.
// - Exponentials on the SFU with results below 2^-126 flushed to 0
//   (ex2.approx.ftz): such a factor scales a term that vanishes anyway.
// Per full tile and block: 80 mma for C Bᵀ and 672 per head (intra 160 on
// and below the diagonal, inter 256, update 256, the splits doubled):
// 8.36e10 FLOP issued at Zamba2's shape, 0.085 ms at 989 TFLOP/s. mma.sync
// rather than wgmma: the bytes and the per-tile chain bound the kernel,
// not the tensor cores.
//
// The f32 kernel (ssd_scan_f32_kernel) serves f32 inputs, for the parity
// grid and the reduced f32 checks: one block per (batch, head), the same
// 64-step tiles, f32 on the CUDA cores (TF32 would not hold the registry's
// f32 2e-4), each thread a 4 x 4 block of every product and of the state.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;    // time steps per tile
constexpr int kMax = 64;  // largest P and N

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

// ===================================================== bf16: tensor cores

constexpr int kGroup = 2;                    // heads a block
constexpr int kStages = 2;                   // ring depth
constexpr int kWarps = 4 * kGroup;           // 4 warps a head, 16 rows p each
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4 / kGroup;       // 128 registers a thread
constexpr int kTileBytes = kT * kMax * 2;    // a bf16 (64, 64) tile, 128-byte rows
constexpr int kStageBytes = (2 + kGroup) * kTileBytes;  // C, B, each head's x
constexpr int kBlocks = 10;  // 16 x 16 blocks of a tile on and below the diagonal
constexpr int kAttBytes = kBlocks * 2 * 16 * 32;  // a head's att, bf16 hi and lo per block
// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's atom):
// the ring's tiles, each stage's dt (kGroup, T) f32, att per head, the
// cumsum seg, exp(seg_i) and w_j per head, one mbarrier per stage.
constexpr int kDtOff = kStages * kStageBytes;
constexpr int kAttOff = kDtOff + kStages * kGroup * kT * 4;
constexpr int kSegOff = kAttOff + kGroup * kAttBytes;
constexpr int kBarOff = kSegOff + 3 * kGroup * kT * 4;
constexpr int kSmemBytes = kBarOff + kStages * 8 + 1024;
static_assert(kGroup == 1 || kGroup == 2 || kGroup == 4, "128 registers a thread, even copies");

template <int CW>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(CW),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
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
// 10 s traps: a fault in the protocol then ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}
// One box of a 3-D (x, B or C) or 4-D tensor map into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate. Not
// volatile: registers only, so the compiler may schedule it.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU, results below 2^-126 flushed to 0: every such factor
// scales a term that vanishes against the outputs' scale anyway.
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
// (v0, v1) = hi + lo, each a bf16 pair (v0 in the low half).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}
// Byte offset of 16-byte chunk `chunk` (0 or 1) of row `row` in a 16 x 16
// bf16 block of att, swizzled so that ldmatrix and the accumulator-layout
// stores are conflict-free.
__device__ __forceinline__ uint32_t blk_at(int row, int chunk) {
  return static_cast<uint32_t>(row * 32 + ((chunk ^ ((row >> 2) & 1)) << 4));
}

// seg at step t of the tile, from the lanes' (s0, s1) = seg at (2 lane, 2 lane + 1).
__device__ __forceinline__ float seg_at(float s0, float s1, int t) {
  const float v0 = __shfl_sync(0xffffffffu, s0, t / 2);
  const float v1 = __shfl_sync(0xffffffffu, s1, t / 2);
  return t % 2 ? v1 : v0;
}

// Rows [0, rows) of one (64, width) bf16 tile, rows `rstride` elements
// apart, into a swizzled shared tile; everything else zero-filled.
template <int CW>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long rstride, int rows, int width) {
  static_assert(CW == 8 || CW == 4, "16-byte aligned tiles come by TMA");
  constexpr int kPieces = 128 / CW;  // copies a row
  constexpr int kEach = kT * kPieces / kThreads;  // copies a thread
  static_assert(kEach * kThreads == kT * kPieces, "copies split evenly");
  const char* base = reinterpret_cast<const char*>(src);
  const int ob = threadIdx.x % kPieces * CW;  // the same byte column for each copy
  const int valid = min(CW, max(0, 2 * width - ob));
#pragma unroll
  for (int k = 0; k < kEach; ++k) {
    const int r = (threadIdx.x + k * kThreads) / kPieces;
    const int bytes = r < rows ? valid : 0;
    cp_async<CW>(dst + swz(r, ob >> 4) + (ob & 15), base + (bytes ? r * rstride * 2 + ob : 0),
                 bytes);
  }
}

struct TileSrc {
  const __nv_bfloat16* x;  // step 0 of the group's first head
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  const float* dt;         // step 0 of the group's first head
  int heads;               // heads of the group below H
  int h0, bb;              // the group's first head, the batch row
  // 16-byte aligned operands (CW = 16): (P, H, S, B) for x, (N, S, B) for B and C.
  const CUtensorMap* xmap;
  const CUtensorMap* bmap;
  const CUtensorMap* cmap;
};

// Tile starting at step t0 (len rows) into ring stage `stage`, its dt into
// `dts`. With CW = 16 one thread hands C, B and each live head's x to TMA,
// which zero-fills past S and P or N and counts the bytes on `bar`; else
// every thread issues cp.async copies of CW bytes (zero-filled likewise).
template <int CW>
__device__ void load_stage(uint32_t stage, uint32_t dts, uint32_t bar, const TileSrc& src,
                           int t0, int len, int p, int n, const Strides& st) {
  if constexpr (CW == 16) {
    if (threadIdx.x == 0) {  // a masked head's x is never read: not loaded
      mbar_expect_tx(bar, (2 + src.heads) * kTileBytes);
      tma_load3(stage, src.cmap, bar, 0, t0, src.bb);
      tma_load3(stage + kTileBytes, src.bmap, bar, 0, t0, src.bb);
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (k < src.heads)
          tma_load4(stage + (2 + k) * kTileBytes, src.xmap, bar, 0, src.h0 + k, t0, src.bb);
    }
  } else {
    load_tile<CW>(stage, src.c + t0 * st.c_t, st.c_t, len, n);
    load_tile<CW>(stage + kTileBytes, src.b + t0 * st.b_t, st.b_t, len, n);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const bool ok = k < src.heads;  // a masked head reads nothing: zeros
      load_tile<CW>(stage + (2 + k) * kTileBytes,
                    ok ? src.x + k * st.x_h + t0 * st.x_t : src.c + t0 * st.c_t, st.x_t,
                    ok ? len : 0, p);
    }
  }
  for (int idx = threadIdx.x; idx < kGroup * kT; idx += kThreads) {
    const int k = idx / kT;
    const int j = idx % kT;
    const bool ok = k < src.heads && j < len;
    cp_async<4>(dts + idx * 4, ok ? src.dt + k * st.dt_h + (t0 + j) * st.dt_t : src.dt,
                ok ? 4 : 0);
  }
}

template <int CW>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ssd_scan_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const __nv_bfloat16* __restrict__ bmat,
    const __nv_bfloat16* __restrict__ cmat, float* __restrict__ y,
    const float* __restrict__ state0, float* __restrict__ final_state, int h, int s, int p,
    int n, Strides st, const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap cmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (ring - raw);
  // att per head: block (mi, kj), kj <= mi, at index mi (mi + 1) / 2 + kj,
  // rows i = 16 mi + r, columns j = 16 kj + col; hi then lo.
  const uint32_t att = ring + kAttOff;
  const uint32_t bars = ring + kBarOff;
  float* seg = reinterpret_cast<float*>(smem + kSegOff);
  float* ev = seg + kGroup * kT;      // exp(seg_i)
  float* wv = ev + kGroup * kT;       // exp(total - seg_j) dt_j

  const int bb = blockIdx.y;
  const int h0 = blockIdx.x * kGroup;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int c = lane % 4;  // accumulator column pair
  const int lr = lane % 8;  // ldmatrix: row within a matrix
  const int lq = lane / 8;  // ldmatrix: which matrix

  TileSrc src;
  src.x = x + bb * st.x_b + h0 * st.x_h;
  src.b = bmat + bb * st.b_b;
  src.c = cmat + bb * st.c_b;
  src.dt = dt + bb * st.dt_b + h0 * st.dt_h;
  src.heads = min(kGroup, h - h0);
  src.h0 = h0;
  src.bb = bb;
  src.xmap = &xmap;
  src.bmap = &bmap;
  src.cmap = &cmap;

  // This warp's head and its 16 rows p of the state, in registers:
  // sreg[nb] holds (p = 16 m + g (+8 for [2], [3]), n = 8 nb + 2 c (+1)).
  const int hl = warp / 4;
  const int m = warp % 4;
  const int head = h0 + hl;
  const bool live = head < h;
  const int64_t sbase = (static_cast<int64_t>(bb) * h + head) * p * n;
  float sreg[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = 16 * m + g + 8 * (e / 2);
      const int nn = 8 * nb + 2 * c + e % 2;
      sreg[nb][e] = live && state0 != nullptr && pp < p && nn < n ? state0[sbase + pp * n + nn]
                                                                  : 0.f;
    }
  float* yb = y + bb * st.y_b + head * st.y_h;
  float a2[kGroup];  // a in log2 units, each head of the group
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    a2[k] = k < src.heads ? a[bb * st.a_b + (h0 + k) * st.a_h] * 1.4426950408889634f : 0.f;

  if (CW == 16 && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kStages; ++k) mbar_init(bars + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntiles = (s + kT - 1) / kT;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntiles)
      load_stage<CW>(ring + k * kStageBytes, ring + kDtOff + k * kGroup * kT * 4, bars + 8 * k,
                     src, k * kT, min(kT, s - k * kT), p, n, st);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * kT;
    const int len = min(kT, s - t0);
    if constexpr (CW == 16) mbar_wait(bars + 8 * (tile % kStages), (tile / kStages) % 2);
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the tile has landed; the previous tile's readers are done
    {
      const int next = tile + kStages - 1;
      const int at = next % kStages;
      if (next < ntiles)
        load_stage<CW>(ring + at * kStageBytes, ring + kDtOff + at * kGroup * kT * 4,
                       bars + 8 * at, src, next * kT, min(kT, s - next * kT), p, n, st);
      cp_async_commit();  // an empty group keeps the count uniform
    }
    const uint32_t cs = ring + (tile % kStages) * kStageBytes;
    const uint32_t bs = cs + kTileBytes;
    const float* dts =
        reinterpret_cast<const float*>(smem + kDtOff + (tile % kStages) * kGroup * kT * 4);

    // ---- every warp: each head's cumsum of dt a over the tile, two steps a
    // lane; warp k keeps head k's seg, exp(seg_i) and w_j for phase C
    float s0[kGroup], s1[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float2 d = *reinterpret_cast<const float2*>(dts + k * kT + 2 * lane);
      const float v0 = d.x * a2[k];
      const float v1 = v0 + d.y * a2[k];
      float incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      s0[k] = excl + v0;
      s1[k] = incl;
      if (warp == k && k < src.heads) {
        // total is seg[63] itself (padded steps add 0), so exp(total - seg_j)
        // is exactly 1 at the tile's last step: a total rounded apart from
        // seg[63] would scale the state by 1 + ulp(seg) ln 2.
        const float total = __shfl_sync(0xffffffffu, incl, 31);
        *reinterpret_cast<float2*>(seg + k * kT + 2 * lane) = make_float2(s0[k], s1[k]);
        *reinterpret_cast<float2*>(ev + k * kT + 2 * lane) =
            make_float2(exp2_ftz(s0[k]), exp2_ftz(s1[k]));
        *reinterpret_cast<float2*>(wv + k * kT + 2 * lane) =
            make_float2(exp2_ftz(total - s0[k]) * d.x, exp2_ftz(total - s1[k]) * d.y);
      }
    }

    // ---- C Bᵀ once per (16 x 8) half of each 16 x 16 block on or below the
    // diagonal (20 halves over the warps), then each head's att = C Bᵀ
    // exp(seg_i - seg_j) dt_j (0 where j > i), split hi + lo
    for (int half = warp; half < 2 * kBlocks; half += kWarps) {
      const int blk = half / 2;
      const int e = half % 2;  // columns j = 16 kj + 8 e + [0, 8)
      const int mi = (blk >= 1) + (blk >= 3) + (blk >= 6);
      const int kj = blk - mi * (mi + 1) / 2;
      float acc[4] = {};
#pragma unroll
      for (int kn = 0; kn < 4; kn += 2) {
        uint32_t bf[4];  // (b0, b1) of k-steps kn and kn + 1
        ldmatrix_x4(bf, bs + swz(16 * kj + 8 * e + lr, 2 * kn + lq));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t ca[4];
          ldmatrix_x4(ca, cs + swz(16 * mi + lr + 8 * (lq % 2), 2 * (kn + q) + lq / 2));
          mma(acc, ca, bf[2 * q], bf[2 * q + 1]);
        }
      }
      const int j = 16 * kj + 8 * e + 2 * c;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (k >= src.heads) break;
        const float sj[2] = {seg_at(s0[k], s1[k], j), seg_at(s0[k], s1[k], j + 1)};
        const float2 dj = *reinterpret_cast<const float2*>(dts + k * kT + j);
        unsigned char* out = smem + kAttOff + k * kAttBytes + blk * 1024;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * mi + g + 8 * r;
          const float si = seg_at(s0[k], s1[k], i);
          // Masked first: exp only where j <= i, so its exponent is <= 0.
          const float v0 = j <= i ? acc[2 * r] * exp2_ftz(si - sj[0]) * dj.x : 0.f;
          const float v1 = j + 1 <= i ? acc[2 * r + 1] * exp2_ftz(si - sj[1]) * dj.y : 0.f;
          uint32_t vhi, vlo;
          split(v0, v1, vhi, vlo);
          const uint32_t at = blk_at(g + 8 * r, e) + 4 * c;
          *reinterpret_cast<uint32_t*>(out + at) = vhi;
          *reinterpret_cast<uint32_t*>(out + 512 + at) = vlo;
        }
      }
    }
    __syncthreads();
    if (!live) continue;

    const float* sg = seg + hl * kT;
    const float* evh = ev + hl * kT;
    const float* wvh = wv + hl * kT;
    const uint32_t xs = cs + (2 + hl) * kTileBytes;

    // ---- yᵀ (p by i) = state (C)ᵀ, state split hi + lo; rows i scaled by exp(seg_i)
    float yacc[8][4] = {};
#pragma unroll
    for (int kn = 0; kn < 4; ++kn) {
      uint32_t ahi[4], alo[4];
      split(sreg[2 * kn][0], sreg[2 * kn][1], ahi[0], alo[0]);
      split(sreg[2 * kn][2], sreg[2 * kn][3], ahi[1], alo[1]);
      split(sreg[2 * kn + 1][0], sreg[2 * kn + 1][1], ahi[2], alo[2]);
      split(sreg[2 * kn + 1][2], sreg[2 * kn + 1][3], ahi[3], alo[3]);
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cs + swz(8 * (2 * pair + lq / 2) + lr, 2 * kn + lq % 2));
        mma(yacc[2 * pair], ahi, bf[0], bf[1]);
        mma(yacc[2 * pair], alo, bf[0], bf[1]);
        mma(yacc[2 * pair + 1], ahi, bf[2], bf[3]);
        mma(yacc[2 * pair + 1], alo, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 e = *reinterpret_cast<const float2*>(evh + 8 * nb + 2 * c);
      yacc[nb][0] *= e.x;
      yacc[nb][1] *= e.y;
      yacc[nb][2] *= e.x;
      yacc[nb][3] *= e.y;
    }
    // ---- yᵀ += xᵀ attᵀ, 16 steps j at a time, att split hi + lo
    const uint32_t atth = att + hl * kAttBytes;
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      uint32_t ax[4];  // xᵀ: rows p, columns j
      ldmatrix_x4_trans(ax, xs + swz(16 * kj + lr + 8 * (lq / 2), 2 * m + lq % 2));
#pragma unroll
      for (int mi = kj; mi < 4; ++mi) {
        const uint32_t blk = atth + (mi * (mi + 1) / 2 + kj) * 1024 +
                             blk_at(lr + 8 * (lq / 2), lq % 2);
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, blk);
        ldmatrix_x4(bl, blk + 512);
        mma(yacc[2 * mi], ax, bh[0], bh[1]);
        mma(yacc[2 * mi], ax, bl[0], bl[1]);
        mma(yacc[2 * mi + 1], ax, bh[2], bh[3]);
        mma(yacc[2 * mi + 1], ax, bl[2], bl[3]);
      }
    }

    // ---- y: lane (g, c) holds rows p = 16 m + g (+8), steps i = 8 nb + 2 c (+1)
    float* yrow = yb + (t0 + 2 * c) * st.y_t + 16 * m + g;  // step 2 c, row p
    if (len == kT && p == kMax) {  // a full tile: no masks, pointers stepped
#pragma unroll
      for (int nb = 0; nb < 8; ++nb, yrow += 8 * st.y_t) {
        yrow[0] = yacc[nb][0];
        yrow[8] = yacc[nb][2];
        yrow[st.y_t] = yacc[nb][1];
        yrow[st.y_t + 8] = yacc[nb][3];
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * nb + 2 * c + e % 2;
          const int pp = 16 * m + g + 8 * (e / 2);
          if (i < len && pp < p) yb[(t0 + i) * st.y_t + pp] = yacc[nb][e];
        }
    }

    // ---- state <- state exp(total) + (w x)ᵀ B, w x split hi + lo. The
    // tile's sum gets an accumulator of its own (yacc's registers) and is
    // added to the state in f32: the tensor cores truncate what they add
    // to an accumulator, which the state would collect tile after tile.
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nb][e] = 0.f;
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      uint32_t ax[4];
      ldmatrix_x4_trans(ax, xs + swz(16 * kj + lr + 8 * (lq / 2), 2 * m + lq % 2));
      const int j0 = 16 * kj + 2 * c;
      const float2 w0 = *reinterpret_cast<const float2*>(wvh + j0);
      const float2 w8 = *reinterpret_cast<const float2*>(wvh + j0 + 8);
      uint32_t xhi[4], xlo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack(ax[r]);
        const float2 w = r < 2 ? w0 : w8;  // registers 2, 3 hold steps j + 8, j + 9
        split(v.x * w.x, v.y * w.y, xhi[r], xlo[r]);
      }
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bs + swz(16 * kj + lr + 8 * (lq % 2), 2 * pair + lq / 2));
        mma(yacc[2 * pair], xhi, bf[0], bf[1]);
        mma(yacc[2 * pair], xlo, bf[0], bf[1]);
        mma(yacc[2 * pair + 1], xhi, bf[2], bf[3]);
        mma(yacc[2 * pair + 1], xlo, bf[2], bf[3]);
      }
    }
    const float decay = exp2_ftz(sg[kT - 1]);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sreg[nb][e] = fmaf(sreg[nb][e], decay, yacc[nb][e]);
  }
  cp_async_wait<0>();

  if (live && final_state != nullptr) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 16 * m + g + 8 * (e / 2);
        const int nn = 8 * nb + 2 * c + e % 2;
        if (pp < p && nn < n) final_state[sbase + pp * n + nn] = sreg[nb][e];
      }
  }
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

// A bf16 tensor of `rank` dims (innermost first; element strides of the
// outer dims) as a map with boxes of 64 x 1 ... x 64 rows x 1 (the row dim
// is `row_dim`), 128-byte swizzle, zero fill past the edges. A dim of size 1
// is never stepped, so its stride may be anything: it gets the packed one,
// rounded up to 16 bytes, which the encoder takes.
int encode_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
               const long long* strides, int row_dim) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t box[4], elem[4];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = i == 0 || i == row_dim ? kT : 1;
    elem[i] = 1;
  }
  for (int i = 1; i < rank; ++i) {
    const cuuint64_t below = i == 1 ? 2 * gdim[0] : gstride[i - 2] * gdim[i - 1];
    const cuuint64_t packed = (below + 15) / 16 * 16;
    gstride[i - 1] = dims[i] == 1 ? packed : static_cast<cuuint64_t>(strides[i - 1]) * 2;
  }
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                              const_cast<void*>(base), gdim, gstride, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int CW>
int launch_bf16(const void* x, const void* dt, const void* a, const void* b, const void* c,
                void* y, const void* state0, void* final_state, int batch, int h, int s, int p,
                int n, const Strides& st, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_scan_bf16_kernel<CW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap xmap = {}, bmap = {}, cmap = {};
  if (CW == 16) {
    const long long xdims[4] = {p, h, s, batch}, xstr[3] = {st.x_h, st.x_t, st.x_b};
    const long long bdims[3] = {n, s, batch};
    const long long bstr[2] = {st.b_t, st.b_b}, cstr[2] = {st.c_t, st.c_b};
    int err = encode_map(&xmap, x, 4, xdims, xstr, 2);
    if (err == 0) err = encode_map(&bmap, b, 3, bdims, bstr, 1);
    if (err == 0) err = encode_map(&cmap, c, 3, bdims, cstr, 1);
    if (err != 0) return err;
  }
  const dim3 grid((h + kGroup - 1) / kGroup, batch);
  ssd_scan_bf16_kernel<CW><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<float*>(y),
      static_cast<const float*>(state0), static_cast<float*>(final_state), h, s, p, n, st, xmap,
      bmap, cmap);
  return static_cast<int>(cudaGetLastError());
}

// ======================================================= f32: CUDA cores

constexpr int kF32Threads = 256;   // 16 x 16
constexpr int kLd = kMax + 4;      // shared row stride: float4 reads stay conflict-free
constexpr int kF32SmemFloats = 4 * kT * kLd + kMax * kLd + 4 * kT;
constexpr int kF32SmemBytes = kF32SmemFloats * static_cast<int>(sizeof(float));

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

__global__ void __launch_bounds__(kF32Threads, 2) ssd_scan_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ bmat, const float* __restrict__ cmat, float* __restrict__ y,
    const float* __restrict__ state0, float* __restrict__ final_state, int h, int s, int p,
    int n, Strides st) {
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;            // (T, kLd) x tile
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
  const float* xb = x + bb * st.x_b + hh * st.x_h;
  const float* dtb = dt + bb * st.dt_b + hh * st.dt_h;
  const float* bb_ = bmat + bb * st.b_b;
  const float* cb_ = cmat + bb * st.c_b;
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
    for (int idx = tid; idx < kT * kMax; idx += kF32Threads) {
      const int i = idx / kMax;
      const int col = idx % kMax;
      const bool row = i < len;
      const int64_t t = t0 + i;
      xs[i * kLd + col] = row && col < p ? xb[t * st.x_t + col] : 0.f;
      bs[i * kLd + col] = row && col < n ? bb_[t * st.b_t + col] : 0.f;
      cs[i * kLd + col] = row && col < n ? cb_[t * st.c_t + col] : 0.f;
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
    for (int idx = tid; idx < kT * kMax; idx += kF32Threads) {
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

int launch_f32(const void* x, const void* dt, const void* a, const void* b, const void* c,
               void* y, const void* state0, void* final_state, int batch, int h, int s, int p,
               int n, const Strides& st, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_scan_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kF32SmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(h, batch);
  ssd_scan_f32_kernel<<<grid, kF32Threads, kF32SmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<const float*>(state0),
      static_cast<float*>(final_state), h, s, p, n, st);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

// in_dtype (x, B, C): 0 = float32, 1 = bfloat16; y, dt, a, state0 and
// final_state are float32. `strides` holds the 15 element strides of
// struct Strides in order. state0 (initial state) and final_state may be
// null: zeros in, nothing out. Shapes (B, H, P, N) for both states.
// copy_bytes (bf16 only: 4, 8 or 16) is the width of each cp.async; x, B
// and C and their row strides must be aligned to it (the wrapper checks
// the strides; the pointers are checked here too).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, void* y, const void* state0, void* final_state,
                               int batch, int h, int s, int p, int n,
                               const long long* strides, int num_strides, int in_dtype,
                               int copy_bytes, void* stream) {
  if (num_strides != kNumStrides || p < 1 || p > kMax || n < 1 || n > kMax || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  Strides st;
  long long* dst = reinterpret_cast<long long*>(&st);
  for (int i = 0; i < kNumStrides; ++i) dst[i] = strides[i];
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return launch_f32(x, dt, a, b, c, y, state0, final_state, batch, h, s, p, n, st, str);
  if (in_dtype != 1 || !(copy_bytes == 4 || copy_bytes == 8 || copy_bytes == 16) ||
      !aligned(x, copy_bytes) || !aligned(b, copy_bytes) || !aligned(c, copy_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (copy_bytes == 16)
    return launch_bf16<16>(x, dt, a, b, c, y, state0, final_state, batch, h, s, p, n, st, str);
  if (copy_bytes == 8)
    return launch_bf16<8>(x, dt, a, b, c, y, state0, final_state, batch, h, s, p, n, st, str);
  return launch_bf16<4>(x, dt, a, b, c, y, state0, final_state, batch, h, s, p, n, st, str);
}

// Heads a block of the bf16 kernel.
extern "C" int ssd_scan_heads_per_block() { return kGroup; }

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
