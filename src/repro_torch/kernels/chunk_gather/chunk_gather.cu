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
// What bounds it: memory, and at the trainer's shapes launch latency. It
// must read idx (B * 4 bytes), and lens and the first min(lens[s], S + 1)
// tokens of each distinct selected slot row s (4 bytes each), and write
// B * S * 12 bytes. At B = 8, S = 2048 that is at most about 66 KB read
// and 197 KB written, under 0.08 us at 3.35 TB/s; the smoke's timed inputs
// (5 distinct rows, 5,017 tokens) need 216,728 bytes, 0.065 us. Either is
// far below the few us a launch costs. So the design is the simplest one
// that keeps every access
// coalesced. The TPU kernel DMAs the selected slot row into VMEM through a
// scalar-prefetched index map; here each block reads its own idx[i] and
// lens[idx[i]] (a broadcast load), and threads stride over S with scalar
// int32 loads, neighbouring threads on neighbouring addresses. The +1 shift
// of the targets makes 16-byte vector loads misaligned, so the loads stay
// scalar. Grid: x tiles S, y is the output row.
//
// A slot index outside [0, num_slots) is validated on the host before the
// copy to the device; the kernel still refuses to read through one and
// writes a padded, fully masked row instead.

// chunk_gather replaces the raw Pallas gather `chunk_gather` in the same
// file (body `_kernel`): for output row i, slot s = idx[i], n = lens[s],
//   tokens[i, p] = p < n ? row[p] : pad_id,   mask[i, p] = p < n ? 1 : 0
// for p < L, the slot row's length. It is memory- and launch-bound like
// the training gather, and built the same way: one block row per output
// row, threads striding over L with coalesced scalar int32 loads, and the
// same refusal to read through an index outside [0, num_slots).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) chunk_gather_train_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ idx, int32_t* __restrict__ tokens,
    int32_t* __restrict__ targets, float* __restrict__ mask, int num_slots,
    int seq_len, int lp, int pad_id) {
  const int row = blockIdx.y;
  const int slot = idx[row];
  const bool in_range = slot >= 0 && slot < num_slots;
  const int n = in_range ? lens[slot] : 0;
  const int32_t* src = slots + static_cast<int64_t>(in_range ? slot : 0) * lp;
  const int64_t out = static_cast<int64_t>(row) * seq_len;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < seq_len;
       p += gridDim.x * blockDim.x) {
    const bool tok_ok = p < n;
    const bool tgt_ok = p + 1 < n;
    tokens[out + p] = tok_ok ? src[p] : pad_id;
    targets[out + p] = tgt_ok ? src[p + 1] : pad_id;
    mask[out + p] = tgt_ok ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) chunk_gather_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ idx, int32_t* __restrict__ tokens,
    float* __restrict__ mask, int num_slots, int row_len, int pad_id) {
  const int row = blockIdx.y;
  const int slot = idx[row];
  const bool in_range = slot >= 0 && slot < num_slots;
  const int n = in_range ? lens[slot] : 0;
  const int32_t* src = slots + static_cast<int64_t>(in_range ? slot : 0) * row_len;
  const int64_t out = static_cast<int64_t>(row) * row_len;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < row_len;
       p += gridDim.x * blockDim.x) {
    const bool ok = p < n;
    tokens[out + p] = ok ? src[p] : pad_id;
    mask[out + p] = ok ? 1.0f : 0.0f;
  }
}

dim3 gather_grid(int row_len, int batch) {
  const int tiles = (row_len + kThreads - 1) / kThreads;
  return dim3(tiles < 64 ? tiles : 64, batch);
}

}  // namespace

extern "C" int chunk_gather_launch(const void* slots, const void* lens, const void* idx,
                                   void* tokens, void* mask, int num_slots, int batch,
                                   int row_len, int pad_id, void* stream) {
  if (batch == 0 || row_len == 0) return static_cast<int>(cudaSuccess);
  chunk_gather_kernel<<<gather_grid(row_len, batch), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(tokens),
      static_cast<float*>(mask), num_slots, row_len, pad_id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunk_gather_train_launch(const void* slots, const void* lens,
                                         const void* idx, void* tokens,
                                         void* targets, void* mask,
                                         int num_slots, int batch, int seq_len,
                                         int lp, int pad_id, void* stream) {
  if (batch == 0 || seq_len == 0) return static_cast<int>(cudaSuccess);
  chunk_gather_train_kernel<<<gather_grid(seq_len, batch), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(tokens),
      static_cast<int32_t*>(targets), static_cast<float*>(mask), num_slots,
      seq_len, lp, pad_id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chunk_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
