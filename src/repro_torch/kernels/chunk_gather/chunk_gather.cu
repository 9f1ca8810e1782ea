// chunk_gather_train and chunk_gather for Hopper (sm_90a): redirected
// batch assembly.
//
// chunk_gather_train replaces the Pallas kernel `chunk_gather_train` in
// src/repro/kernels/chunk_gather/chunk_gather.py (body `_train_kernel`).
// For each output row i it reads slot row s = idx[i] of the slot buffer
// (U, Lp) and its length n = lens[s], and writes
//   tokens[i, p]  = p     < n ? row[p]     : pad_id
//   targets[i, p] = p + 1 < n ? row[p + 1] : pad_id
//   mask[i, p]    = p + 1 < n ? 1.0f       : 0.0f        for p < S.
//
// chunk_gather replaces the raw Pallas gather `chunk_gather` in the same
// file (body `_kernel`): for output row i, slot s = idx[i], n = lens[s],
//   tokens[i, p] = p < n ? row[p] : pad_id,   mask[i, p] = p < n ? 1 : 0
// for p < L, the slot row's length.
//
// What bounds them. Bytes are small: at the trainer's shape (B = 8,
// S = 2048) the function must move about 217 KB, 0.065 us at 3.35 TB/s.
// What a call costs there is the launch and the latency of the loads that
// depend on one another, so the trainer's shape sits on the floor of one
// launch. Only a large batch (B = 256, S = 4096: about 15 MB) is bound by
// bytes. The design does four things about that:
//
// * A two-deep load chain. A block reads idx[row] (load 1), then issues
//   lens[slot] and its run of the slot row together (load 2). The row
//   loads do not wait for the length: every slot row is in bounds for
//   p < S + 1 (train; the packer pads rows to Lp >= S + 1) or p < L (raw),
//   so the pad-and-mask select comes after both loads. A slot outside
//   [0, num_slots), which the host rejects before any copy, still reads
//   nothing and writes a padded, fully masked row.
// * 16-byte accesses. On the vector path each thread takes kRun
//   consecutive tokens as int4 loads and writes tokens, targets and mask as
//   int4 / float4 stores. The +1 shift of the targets takes the first
//   token of the next lane's run by __shfl_down_sync; lane 31 makes one
//   scalar load for it. The path needs 16-byte aligned bases and row
//   strides (S and Lp multiples of 4 for the training gather, L for the
//   raw one); with S % 4 == 0 and Lp % 4 == 0, Lp >= S + 4, so the quad
//   that starts at S is in bounds too.
// * A scalar path in the same kernel for any other row length or base (an
//   odd L, a view at an element offset): kRun coalesced 4-byte tokens a
//   thread, the same two-deep chain. The wrapper picks the path from the
//   pointers and strides; the launcher refuses a vector launch it cannot
//   make.
// * A grid sized to the work: one thread per run of kRun tokens, kThreads
//   a block, blocks x tiling the row and y the output row, so the trainer's
//   batch launches 32 full blocks and B = 256, S = 4096 launches 2048, one
//   wave over the 132 SMs. kThreads and kRun come from a sweep on the card
//   (`python -m repro_torch.kernels.chunk_gather.sweep`): at B = 8 every
//   block size from 32 to 256 threads lands within noise of the others,
//   128 is best at both shapes by a little; runs of 8 or 16 tokens put a
//   warp's lanes 32 or 64 bytes apart, so each access uses half a sector
//   or less, and lose at every shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kRun = 4;        // tokens a thread: a multiple of 4
constexpr int kQuads = kRun / 4;
static_assert(kRun % 4 == 0, "a run is whole 16-byte quads");

__device__ __forceinline__ int4 ldg4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ int pick(bool ok, int v, int pad) { return ok ? v : pad; }

// The block's output row reads slot row `slot` (load 1); `ok` says whether
// it may be read at all.
struct Source {
  const int32_t* row;
  int slot;
  bool ok;
};

__device__ __forceinline__ Source source(const int32_t* slots, const int32_t* idx,
                                         int num_slots, int stride) {
  const int slot = __ldg(idx + blockIdx.y);
  const bool ok = slot >= 0 && slot < num_slots;
  return {slots + (ok ? static_cast<int64_t>(slot) * stride : 0), slot, ok};
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) chunk_gather_train_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ idx, int32_t* __restrict__ tokens,
    int32_t* __restrict__ targets, float* __restrict__ mask, int num_slots,
    int seq_len, int lp, int pad_id) {
  const Source src = source(slots, idx, num_slots, lp);
  const int64_t out = static_cast<int64_t>(blockIdx.y) * seq_len;
  if constexpr (kVec) {
    const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kRun;
    const bool last_lane = (threadIdx.x & 31) == 31;
    // Load 2: the length, the run's quads (one past S at most) and lane
    // 31's next token, all issued before any of them is used.
    int n = 0, tail = 0;
    int4 v[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) v[k] = make_int4(0, 0, 0, 0);
    if (src.ok && p0 <= seq_len) {
      n = __ldg(lens + src.slot);
#pragma unroll
      for (int k = 0; k < kQuads; ++k)
        if (p0 + 4 * k <= seq_len) v[k] = ldg4(src.row + p0 + 4 * k);
      if (last_lane && p0 + kRun <= seq_len) tail = __ldg(src.row + p0 + kRun);
    }
    const int from_next = __shfl_down_sync(0xffffffffu, v[0].x, 1);
    const int after = last_lane ? tail : from_next;  // row[p0 + kRun]
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int p = p0 + 4 * k;
      if (p >= seq_len) break;
      const int nx = k + 1 < kQuads ? v[(k + 1) % kQuads].x : after;  // row[p + 4]
      const int4 tok = make_int4(pick(p < n, v[k].x, pad_id), pick(p + 1 < n, v[k].y, pad_id),
                                 pick(p + 2 < n, v[k].z, pad_id), pick(p + 3 < n, v[k].w, pad_id));
      const int4 tgt = make_int4(pick(p + 1 < n, v[k].y, pad_id), pick(p + 2 < n, v[k].z, pad_id),
                                 pick(p + 3 < n, v[k].w, pad_id), pick(p + 4 < n, nx, pad_id));
      const float4 m = make_float4(p + 1 < n ? 1.0f : 0.0f, p + 2 < n ? 1.0f : 0.0f,
                                   p + 3 < n ? 1.0f : 0.0f, p + 4 < n ? 1.0f : 0.0f);
      *reinterpret_cast<int4*>(tokens + out + p) = tok;
      *reinterpret_cast<int4*>(targets + out + p) = tgt;
      *reinterpret_cast<float4*>(mask + out + p) = m;
    }
  } else {
    const int base = blockIdx.x * kThreads * kRun + threadIdx.x;
    int n = 0;
    int cur[kRun], nxt[kRun];
    if (src.ok) n = __ldg(lens + src.slot);
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int p = base + k * kThreads;
      const bool load = src.ok && p < seq_len;  // p + 1 <= S < Lp: in bounds
      cur[k] = load ? __ldg(src.row + p) : 0;
      nxt[k] = load ? __ldg(src.row + p + 1) : 0;
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int p = base + k * kThreads;
      if (p >= seq_len) break;
      tokens[out + p] = pick(p < n, cur[k], pad_id);
      targets[out + p] = pick(p + 1 < n, nxt[k], pad_id);
      mask[out + p] = p + 1 < n ? 1.0f : 0.0f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) chunk_gather_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ idx, int32_t* __restrict__ tokens,
    float* __restrict__ mask, int num_slots, int row_len, int pad_id) {
  const Source src = source(slots, idx, num_slots, row_len);
  const int64_t out = static_cast<int64_t>(blockIdx.y) * row_len;
  if constexpr (kVec) {
    const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kRun;
    int n = 0;
    int4 v[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) v[k] = make_int4(0, 0, 0, 0);
    if (src.ok && p0 < row_len) {
      n = __ldg(lens + src.slot);
#pragma unroll
      for (int k = 0; k < kQuads; ++k)
        if (p0 + 4 * k < row_len) v[k] = ldg4(src.row + p0 + 4 * k);
    }
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int p = p0 + 4 * k;
      if (p >= row_len) break;
      const int4 tok = make_int4(pick(p < n, v[k].x, pad_id), pick(p + 1 < n, v[k].y, pad_id),
                                 pick(p + 2 < n, v[k].z, pad_id), pick(p + 3 < n, v[k].w, pad_id));
      const float4 m = make_float4(p < n ? 1.0f : 0.0f, p + 1 < n ? 1.0f : 0.0f,
                                   p + 2 < n ? 1.0f : 0.0f, p + 3 < n ? 1.0f : 0.0f);
      *reinterpret_cast<int4*>(tokens + out + p) = tok;
      *reinterpret_cast<float4*>(mask + out + p) = m;
    }
  } else {
    const int base = blockIdx.x * kThreads * kRun + threadIdx.x;
    int n = 0;
    int cur[kRun];
    if (src.ok) n = __ldg(lens + src.slot);
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int p = base + k * kThreads;
      cur[k] = src.ok && p < row_len ? __ldg(src.row + p) : 0;
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int p = base + k * kThreads;
      if (p >= row_len) break;
      tokens[out + p] = pick(p < n, cur[k], pad_id);
      mask[out + p] = p < n ? 1.0f : 0.0f;
    }
  }
}

// Blocks x along a row of `row_len` tokens: one thread per run of kRun.
dim3 gather_grid(int row_len, int batch) {
  const int per_block = kThreads * kRun;
  return dim3((row_len + per_block - 1) / per_block, batch);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int chunk_gather_launch(const void* slots, const void* lens, const void* idx,
                                   void* tokens, void* mask, int num_slots, int batch,
                                   int row_len, int pad_id, int vec, void* stream) {
  if (batch == 0 || row_len == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid = gather_grid(row_len, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* tok = static_cast<int32_t*>(tokens);
  auto* msk = static_cast<float*>(mask);
  if (vec) {
    if (row_len % 4 || !aligned16(slots) || !aligned16(tokens) || !aligned16(mask))
      return static_cast<int>(cudaErrorMisalignedAddress);
    chunk_gather_kernel<true><<<grid, kThreads, 0, s>>>(sl, ln, ix, tok, msk, num_slots,
                                                        row_len, pad_id);
  } else {
    chunk_gather_kernel<false><<<grid, kThreads, 0, s>>>(sl, ln, ix, tok, msk, num_slots,
                                                         row_len, pad_id);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunk_gather_train_launch(const void* slots, const void* lens,
                                         const void* idx, void* tokens,
                                         void* targets, void* mask,
                                         int num_slots, int batch, int seq_len,
                                         int lp, int pad_id, int vec, void* stream) {
  if (batch == 0 || seq_len == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid = gather_grid(seq_len, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* tok = static_cast<int32_t*>(tokens);
  auto* tgt = static_cast<int32_t*>(targets);
  auto* msk = static_cast<float*>(mask);
  if (vec) {
    if (seq_len % 4 || lp % 4 || !aligned16(slots) || !aligned16(tokens) ||
        !aligned16(targets) || !aligned16(mask))
      return static_cast<int>(cudaErrorMisalignedAddress);
    chunk_gather_train_kernel<true><<<grid, kThreads, 0, s>>>(sl, ln, ix, tok, tgt, msk,
                                                              num_slots, seq_len, lp, pad_id);
  } else {
    chunk_gather_train_kernel<false><<<grid, kThreads, 0, s>>>(sl, ln, ix, tok, tgt, msk,
                                                               num_slots, seq_len, lp, pad_id);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chunk_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
