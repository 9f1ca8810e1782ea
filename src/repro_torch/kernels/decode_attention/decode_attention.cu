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
// p cast to the input type before the PV product and l summed from the
// unrounded p, as the TPU kernel does. The fold costs nothing here: q
// (B, H, D) is (B*KVH, G, D) as it lies, the cache is read in place in its
// (B, S, KVH, D) layout (row stride KVH * D), and the (B, S) mask is read
// per batch, not repeated per kv head.
//
// What bounds it: memory. A step must read q, the mask and the K and V
// rows of valid slots once, and write the output: at zamba2's decode (B =
// 8, KVH = 32, G = 1, S = 4096, D = 64, bf16) 268 MB, 80 us at 3.35 TB/s;
// at tinyllama's (B = 8, KVH = 4, G = 8, S = 2048) 16.8 MB, 5.0 us. The
// TPU kernel walks the cache in order on one core and carries (m, l, acc)
// across blocks in VMEM. Here:
// - a block serves one (batch, kv head) and a query group of GQ = 1, 2, 4
//   or 8, the smallest that covers G (G > 8 in groups of 8), so a G = 1
//   block does one query's dot products, reductions and exponentials a
//   row. Grid (B*KVH*ceil(G/GQ), splits of S).
// - each of the 4 warps streams its own tiles (2 KB of K and 2 KB of V,
//   or 16 rows on the tensor cores) through a 4-stage cp.async ring in
//   shared memory, 16 bytes a copy: 64 KB in flight a block at D = 64.
//   Chunks are XOR-swizzled by row so the reads do not collide in banks.
// - on the CUDA cores (f32, and bf16 at GQ < 8) a lane owns CH 16-byte
//   chunks of a row (CH chosen so q and the accumulators fit in registers),
//   LPR = D / (CH * 16 B) lanes a row. Per tile the warp computes all its
//   scores, takes one max per query, applies one correction to (l, acc),
//   then accumulates p v: one exp2 a row and query plus one a tile and
//   query, in base 2 with D^-0.5 log2(e) folded into the scores. A lane
//   keeps p in its registers for the V of the same row, so no p crosses
//   lanes; lanes and warps merge once, at the end.
// - bf16 at GQ = 8 (tinyllama's G) runs both products on the tensor cores,
//   mma.sync m16n8k16 with the 8 queries as rows 0-7 of A (rows 8-15 zero):
//   K through ldmatrix, P straight from the score accumulators, V through
//   ldmatrix.trans. On the CUDA cores the 8 queries' dot products and their
//   lane reductions took far more instructions than the bytes need.
// - the splits merge in the same launch: with one split the block
//   normalises and writes the output; otherwise each block writes its
//   partial (m, l, acc) to scratch, fences, and takes a ticket from a
//   per-(row group) counter with atomicAdd; the block that draws the last
//   ticket merges the splits, writes the output and resets the counter to
//   0. The counters therefore assume one stream at a time per device, which
//   is how decode runs; the wrapper keeps them, zeroed once.
// - a logit softcap (the reference's `logit_softcap`, applied where its
//   decode applies it: s = cap * tanh(s / cap) on the f32 scaled score,
//   before the mask) is a template flag, so a cap of 0 runs the uncapped
//   code unchanged. The capped score is tanhf (accurate, not
//   tanh.approx.f32: the f32 grid holds the kernel to 2e-5), then taken to
//   base 2: cap_out * tanhf(dot * cap_in), cap_in = D^-0.5 / cap and
//   cap_out = cap * log2(e).
// Where it still falls short: invalid slots are read and masked rather than
// skipped (the ring mask of decode is all but fully valid); the tensor-core
// path wastes half of each mma on the zero rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D, int GQ>
struct Shape {
  // bf16 at GQ = 8 runs its two products on the tensor cores.
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && GQ == 8;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  static constexpr int kCpr = D / kVec;                            // chunks a row
  // Cache rows of a warp tile: 2 KB of K (16 rows on the tensor cores).
  static constexpr int kRows = kMma ? 16 : 2048 / (D * static_cast<int>(sizeof(T)));
  static constexpr int kStageBytes = 2 * kRows * D * static_cast<int>(sizeof(T));
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kMergeBytes = kWarps * GQ * (D + 2) * 4;
  static constexpr int kSmemBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

// Physical chunk of logical chunk c in row r: 8 rows' reads of one chunk
// land in 8 distinct 16-byte bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  return CPR >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

// The score of a valid slot in base 2: dot * D^-0.5 * log2(e), or with the
// cap, cap * tanh(dot * D^-0.5 / cap) * log2(e).
struct Scale {
  float log2;     // D^-0.5 log2(e)
  float cap_in;   // D^-0.5 / cap
  float cap_out;  // cap log2(e)
};

template <bool kCap>
__device__ __forceinline__ float score(float dot, const Scale& sc) {
  if constexpr (kCap) {
    return sc.cap_out * tanhf(dot * sc.cap_in);
  } else {
    return dot * sc.log2;
  }
}

template <int CPR>
__device__ __forceinline__ const uint8_t* chunk_at(const uint8_t* tile, int r, int c) {
  return tile + (r * CPR + swz<CPR>(r, c)) * 16;
}

// One warp's share of a block on the CUDA cores. A lane owns CH 16-byte
// chunks of a row (CH as large as keeps q and acc in 64 registers each),
// LPR lanes a row, RPP rows a pass, PASSES passes a tile.
template <typename T, int D, int GQ>
struct CoreWarp {
  using Sh = Shape<T, D, GQ>;
  static constexpr int VEC = Sh::kVec, CPR = Sh::kCpr;
  static constexpr int CH0 = 64 / (VEC * GQ);
  static constexpr int CH = CH0 < 1 ? 1 : (CH0 > 4 ? 4 : CH0);
  static constexpr int LPR = CPR / CH, RPP = 32 / LPR, PASSES = Sh::kRows / RPP;
  static constexpr int W = CH * VEC;  // columns a lane owns
  static_assert(CH <= CPR && LPR <= 32 && PASSES * RPP == Sh::kRows, "unsupported shape");

  float qv[GQ][W], m[GQ], l[GQ], acc[GQ][W];
  int lane, col;

  __device__ __forceinline__ void init(const T* qg, int ng, int lane_) {
    lane = lane_;
    col = (lane % LPR) * W;
#pragma unroll
    for (int gi = 0; gi < GQ; ++gi) {
      m[gi] = kNegInf;
      l[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        qv[gi][e] = gi < ng ? to_f(qg[gi * D + col + e]) : 0.f;
        acc[gi][e] = 0.f;
      }
    }
  }

  // All the tile's scores, one max and one correction per query, then p v.
  template <bool kCap>
  __device__ __forceinline__ void tile(const uint8_t* kt, const uint8_t* vt, int r0, int hi,
                                       const uint8_t* mb, const Scale& scale) {
    float sc[PASSES][GQ], mx[GQ];
#pragma unroll
    for (int gi = 0; gi < GQ; ++gi) mx[gi] = -INFINITY;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = p * RPP + lane / LPR;
      float dot[GQ];
#pragma unroll
      for (int gi = 0; gi < GQ; ++gi) dot[gi] = 0.f;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(chunk_at<CPR>(kt, r, (lane % LPR) * CH + u));
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float kf = to_f(kv[e]);
#pragma unroll
          for (int gi = 0; gi < GQ; ++gi) dot[gi] = fmaf(qv[gi][u * VEC + e], kf, dot[gi]);
        }
      }
      const int j = r0 + r;
      const bool ok = j < hi && mb[j] != 0;
#pragma unroll
      for (int gi = 0; gi < GQ; ++gi) {
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2)
          dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], off);
        sc[p][gi] = ok ? score<kCap>(dot[gi], scale) : -INFINITY;  // exp2(-inf) = 0: the p guard
        mx[gi] = fmaxf(mx[gi], sc[p][gi]);
      }
    }
#pragma unroll
    for (int gi = 0; gi < GQ; ++gi) {
#pragma unroll
      for (int off = LPR; off < 32; off *= 2)
        mx[gi] = fmaxf(mx[gi], __shfl_xor_sync(0xffffffffu, mx[gi], off));
      const float m_new = fmaxf(m[gi], mx[gi]);  // stays >= -1e30
      const float corr = exp2f(m[gi] - m_new);
      m[gi] = m_new;
      l[gi] *= corr;
#pragma unroll
      for (int e = 0; e < W; ++e) acc[gi][e] *= corr;
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = p * RPP + lane / LPR;
      float pt[GQ];
#pragma unroll
      for (int gi = 0; gi < GQ; ++gi) {
        const float pv = exp2f(sc[p][gi] - m[gi]);
        l[gi] += pv;
        pt[gi] = round_to(pv, T());
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(chunk_at<CPR>(vt, r, (lane % LPR) * CH + u));
        const T* vv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float vf = to_f(vv[e]);
#pragma unroll
          for (int gi = 0; gi < GQ; ++gi)
            acc[gi][u * VEC + e] = fmaf(pt[gi], vf, acc[gi][u * VEC + e]);
        }
      }
    }
  }

  // Merge the lanes that own the same columns (m is uniform in the warp)
  // and write (m, l, acc) of each query to red[gi][D + 2].
  __device__ __forceinline__ void store(float* red) {
#pragma unroll
    for (int off = LPR; off < 32; off *= 2)
#pragma unroll
      for (int gi = 0; gi < GQ; ++gi) {
        l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], off);
#pragma unroll
        for (int e = 0; e < W; ++e)
          acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      }
    if (lane < LPR) {
#pragma unroll
      for (int gi = 0; gi < GQ; ++gi) {
        float* rw = red + gi * (D + 2);
        if (lane == 0) {
          rw[0] = m[gi];
          rw[1] = l[gi];
        }
#pragma unroll
        for (int e = 0; e < W; ++e) rw[2 + col + e] = acc[gi][e];
      }
    }
  }
};

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

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate; a's rows
// 8-15 (registers a1 and a3) are zero here.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warp's share of a block on the tensor cores (bf16, GQ = 8): the 8
// queries are rows 0-7 of mma.sync m16n8k16's A (rows 8-15 zero); S = Q K^T
// over a 16-row tile is two n8 blocks, and PV takes P straight from S's
// accumulators as its A. Lane (g = lane / 4, c = lane % 4) holds query g's
// scores of rows 8 nb + 2 c + e and its output columns 8 n + 2 c + e.
template <int D>
struct MmaWarp {
  static constexpr int CPR = D / 8;
  uint32_t qa[D / 16][2];  // A registers a0 and a2 of each k-step
  float o[D / 8][4];       // [2], [3] belong to the zero rows
  float m, l;
  int lane;

  __device__ __forceinline__ void init(const __nv_bfloat16* qg, int ng, int lane_) {
    lane = lane_;
    const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qr = qg + g * D + 16 * kk + c2;
      qa[kk][0] = g < ng ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
      qa[kk][1] = g < ng ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m = kNegInf;
    l = 0.f;
  }

  template <bool kCap>
  __device__ __forceinline__ void tile(const uint8_t* kt, const uint8_t* vt, int r0, int hi,
                                       const uint8_t* mb, const Scale& scale) {
    float sc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t kf[4];  // B of k-steps kk and kk + 1 for rows 8 nb .. 8 nb + 7
        ldmatrix_x4(kf, chunk_at<CPR>(kt, nb * 8 + lane % 8, 2 * kk + lane / 8));
        mma_bf16(sc[nb], qa[kk][0], qa[kk][1], kf[0], kf[1]);
        mma_bf16(sc[nb], qa[kk + 1][0], qa[kk + 1][1], kf[2], kf[3]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = r0 + nb * 8 + 2 * (lane % 4) + e;
        const bool ok = j < hi && mb[j] != 0;
        sc[nb][e] = ok ? score<kCap>(sc[nb][e], scale) : -INFINITY;  // exp2(-inf) = 0: the p guard
        mx = fmaxf(mx, sc[nb][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // a query's 16 rows: one quad
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);  // stays >= -1e30
    const float corr = exp2f(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr;
      o[n][1] *= corr;
    }
    float p[2][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nb][e] = exp2f(sc[nb][e] - m);
        l += p[nb][e];
      }
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]);  // rows 2c, 2c + 1
    const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]);  // rows 8 + 2c, 9 + 2c
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];  // B of output columns 16 dp .. +8 and +8 .. +16
      ldmatrix_x4_trans(vf, chunk_at<CPR>(vt, lane % 16, 2 * dp + lane / 16));
      mma_bf16(o[2 * dp], pa0, pa2, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa0, pa2, vf[2], vf[3]);
    }
  }

  __device__ __forceinline__ void store(float* red) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float* rw = red + (lane / 4) * (D + 2);
    if (lane % 4 == 0) {
      rw[0] = m;
      rw[1] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      rw[2 + 8 * n + 2 * (lane % 4)] = o[n][0];
      rw[3 + 8 * n + 2 * (lane % 4)] = o[n][1];
    }
  }
};

template <typename T, int D, int GQ, bool kCap>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ part,
    int* __restrict__ tickets, int kvh, int g, int s, int chunk, Scale scale) {
  using Sh = Shape<T, D, GQ>;
  using Warp = typename std::conditional<Sh::kMma, MmaWarp<D>, CoreWarp<T, D, GQ>>::type;
  constexpr int VEC = Sh::kVec, CPR = Sh::kCpr, ROWS = Sh::kRows;
  extern __shared__ __align__(16) uint8_t smem[];

  const int groups = (g + GQ - 1) / GQ;
  const int bkv = blockIdx.x / groups;
  const int g0 = (blockIdx.x % groups) * GQ;
  const int ng = min(GQ, g - g0);
  const int b = bkv / kvh;
  const int hk = bkv % kvh;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int lo = min(s, split * chunk);
  const int hi = min(s, lo + chunk);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t row_base = static_cast<int64_t>(bkv) * g + g0;  // the block's first q row

  Warp w;
  w.init(q + row_base * D, ng, lane);

  const int64_t row_stride = static_cast<int64_t>(kvh) * D;
  const T* kb = k + static_cast<int64_t>(b) * s * row_stride + hk * D;
  const T* vb = v + static_cast<int64_t>(b) * s * row_stride + hk * D;
  const uint8_t* mb = mask + static_cast<int64_t>(b) * s;
  const uint8_t* ring = smem + warp * kStages * Sh::kStageBytes;
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // This warp's tiles start at lo + (warp + kWarps * it) * ROWS.
  const int first = lo + warp * ROWS;
  const int n_it = first < hi ? (hi - first + kWarps * ROWS - 1) / (kWarps * ROWS) : 0;

  auto issue = [&](int it) {
    if (it < n_it) {
      const int r0 = first + it * kWarps * ROWS;
      const uint32_t kdst = ring_s + (it % kStages) * Sh::kStageBytes;
      const uint32_t vdst = kdst + Sh::kStageBytes / 2;
#pragma unroll
      for (int i = 0; i < ROWS * CPR / 32; ++i) {
        const int idx = lane + 32 * i;
        const int r = idx / CPR, c = idx % CPR;
        const int j = r0 + r;
        const bool ok = j < hi;
        const int64_t off = ok ? j * row_stride + c * VEC : 0;
        const uint32_t at = (r * CPR + swz<CPR>(r, c)) * 16;
        cp_async16(kdst + at, kb + off, ok);  // zero fill past hi
        cp_async16(vdst + at, vb + off, ok);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // the tile is visible, and the stage refilled next is free
    issue(it + kStages - 1);
    const uint8_t* kt = ring + (it % kStages) * Sh::kStageBytes;
    w.template tile<kCap>(kt, kt + Sh::kStageBytes / 2, first + it * kWarps * ROWS, hi, mb,
                          scale);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it for the merge
  float* red = reinterpret_cast<float*>(smem);  // [warp][gi][m, l, acc D]
  w.store(red + warp * GQ * (D + 2));
  __syncthreads();

  // Merge the warps: one thread per (query, entry), entries m, l, acc.
  float* mine = part + (static_cast<int64_t>(blockIdx.x) * splits + split) * GQ * (D + 2);
  for (int t = threadIdx.x; t < GQ * (D + 2); t += kThreads) {
    const int gi = t / (D + 2), c = t % (D + 2);
    float mm = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) mm = fmaxf(mm, red[(wi * GQ + gi) * (D + 2)]);
    float val = mm, ll = 0.f;
    if (c > 0) {
      val = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        const float* rw = red + (wi * GQ + gi) * (D + 2);
        const float f = exp2f(rw[0] - mm);
        val = fmaf(rw[c], f, val);
        ll = fmaf(rw[1], f, ll);
      }
    }
    if (splits > 1) {
      mine[t] = val;
    } else if (c >= 2 && gi < ng) {
      out[(row_base + gi) * D + c - 2] = from_f<T>(val / fmaxf(ll, 1e-30f));
    }
  }
  if (splits == 1) return;

  // The last of the row group's split blocks merges the partials.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + static_cast<int64_t>(blockIdx.x) * splits * GQ * (D + 2);
  for (int t = threadIdx.x; t < ng * D; t += kThreads) {
    const int gi = t / D, d = t % D;
    float mm = kNegInf;
    for (int i = 0; i < splits; ++i) mm = fmaxf(mm, __ldcg(all + (i * GQ + gi) * (D + 2)));
    float ll = 0.f, aa = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float* p = all + (i * GQ + gi) * (D + 2);
      const float c = exp2f(__ldcg(p) - mm);
      ll = fmaf(__ldcg(p + 1), c, ll);
      aa = fmaf(__ldcg(p + 2 + d), c, aa);
    }
    out[(row_base + gi) * D + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;  // ready for the next call
}

template <typename T, int D, int GQ, bool kCap>
int launch_cap(const void* q, const void* k, const void* v, const void* mask, void* out,
               void* part, void* tickets, int b, int kvh, int g, int s, int splits, float cap,
               cudaStream_t stream) {
  using Sh = Shape<T, D, GQ>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, D, GQ, kCap>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Sh::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // Whole block tiles per split, so the warps share a split evenly.
  const int span = kWarps * Sh::kRows;
  const int chunk = ((s + splits - 1) / splits + span - 1) / span * span;
  const dim3 grid(b * kvh * ((g + GQ - 1) / GQ), splits);
  const float rsqrt_d = 1.0f / sqrtf(static_cast<float>(D));
  const Scale scale{kLog2e / sqrtf(static_cast<float>(D)), kCap ? rsqrt_d / cap : 0.f,
                    cap * kLog2e};
  decode_attention_kernel<T, D, GQ, kCap><<<grid, kThreads, Sh::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), kvh, g, s, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int GQ>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           void* part, void* tickets, int b, int kvh, int g, int s, int splits, float cap,
           cudaStream_t stream) {
  if (cap > 0.f)
    return launch_cap<T, D, GQ, true>(q, k, v, mask, out, part, tickets, b, kvh, g, s, splits,
                                      cap, stream);
  return launch_cap<T, D, GQ, false>(q, k, v, mask, out, part, tickets, b, kvh, g, s, splits,
                                     cap, stream);
}

template <typename T, int D>
int dispatch_gq(int gq, const void* q, const void* k, const void* v, const void* mask,
                void* out, void* part, void* tickets, int b, int kvh, int g, int s, int splits,
                float cap, cudaStream_t st) {
  switch (gq) {
    case 1:
      return launch<T, D, 1>(q, k, v, mask, out, part, tickets, b, kvh, g, s, splits, cap, st);
    case 2:
      return launch<T, D, 2>(q, k, v, mask, out, part, tickets, b, kvh, g, s, splits, cap, st);
    case 4:
      return launch<T, D, 4>(q, k, v, mask, out, part, tickets, b, kvh, g, s, splits, cap, st);
    case 8:
      return launch<T, D, 8>(q, k, v, mask, out, part, tickets, b, kvh, g, s, splits, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_d(int d, int gq, const void* q, const void* k, const void* v, const void* mask,
               void* out, void* part, void* tickets, int b, int kvh, int g, int s, int splits,
               float cap, cudaStream_t st) {
  switch (d) {
    case 32:
      return dispatch_gq<T, 32>(gq, q, k, v, mask, out, part, tickets, b, kvh, g, s, splits,
                                cap, st);
    case 64:
      return dispatch_gq<T, 64>(gq, q, k, v, mask, out, part, tickets, b, kvh, g, s, splits,
                                cap, st);
    case 128:
      return dispatch_gq<T, 128>(gq, q, k, v, mask, out, part, tickets, b, kvh, g, s, splits,
                                 cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out (B, KVH*G, D); k/v (B, S, KVH, D);
// mask (B, S) bool; gq the query group (1, 2, 4 or 8, >= G unless 8);
// softcap > 0 caps the scaled scores (0: uncapped).
// With splits > 1: part (B*KVH*ceil(G/gq), splits, gq, D + 2) float32
// scratch, and tickets B*KVH*ceil(G/gq) int32 counters that are 0 on entry
// and are left 0.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, void* part, void* tickets,
                                       int b, int kvh, int g, int s, int d, int gq, int splits,
                                       int dtype, float softcap, void* stream) {
  if (b == 0 || kvh == 0 || g == 0) return static_cast<int>(cudaSuccess);
  if (s <= 0 || splits <= 0 || splits > 65535 || (gq < g && gq != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && (part == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(softcap >= 0.f) || isinf(softcap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, gq, q, k, v, mask, out, part, tickets, b, kvh, g, s, splits,
                             softcap, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, gq, q, k, v, mask, out, part, tickets, b, kvh, g, s,
                                     splits, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
