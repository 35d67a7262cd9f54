// collate.cpp — the training batches' collation on the host, for
// sparse_matrix_tuning_tpu_torch/data/native.py (the C++ collator of
// sparse_matrix_tuning_tpu's csrc/smt_native.cpp, fill_batch and max_len).
//
// The examples lie end to end in a token arena: example e's int32 ids and
// labels are ids[offsets[e] .. offsets[e + 1]) and labels[...] alike,
// offsets int64 and non-decreasing (data/native.TokenArena builds them).
// Plain C entry points, bound with ctypes, which releases the GIL for the
// call: PrefetchLoader's thread collates while the main thread steps. Built
// by g++ alone (data/native.py); not a CUDA source, so the kernels' nvcc
// build (ops/cuda/_build.py, csrc/*.cu) leaves it out.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// *out = the longest of examples indices[0 .. n_rows). Returns 0, or 1 when
// an index lies outside [0, n_examples) (*out untouched).
int smt_max_len(const int64_t* offsets, int64_t n_examples, const int64_t* indices,
                int64_t n_rows, int64_t* out) {
  int64_t longest = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t e = indices[r];
    if (e < 0 || e >= n_examples) return 1;
    longest = std::max(longest, offsets[e + 1] - offsets[e]);
  }
  *out = longest;
  return 0;
}

// Row r of the (n_rows, seq_len) int32 outputs from example indices[r]: its
// ids and labels truncated to seq_len, then pad_id and ignore_index; the
// mask 1 over its tokens, 0 after. Returns 0, or 1 when an index lies
// outside [0, n_examples) (nothing written).
int smt_fill_batch(const int32_t* ids, const int32_t* labels, const int64_t* offsets,
                   int64_t n_examples, const int64_t* indices, int64_t n_rows,
                   int64_t seq_len, int32_t pad_id, int32_t ignore_index, int32_t* out_ids,
                   int32_t* out_labels, int32_t* out_mask) {
  for (int64_t r = 0; r < n_rows; ++r) {
    if (indices[r] < 0 || indices[r] >= n_examples) return 1;
  }
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t e = indices[r];
    const int64_t start = offsets[e];
    const int64_t len = std::min(offsets[e + 1] - start, seq_len);
    int32_t* row_ids = out_ids + r * seq_len;
    int32_t* row_labels = out_labels + r * seq_len;
    int32_t* row_mask = out_mask + r * seq_len;
    std::memcpy(row_ids, ids + start, len * sizeof(int32_t));
    std::memcpy(row_labels, labels + start, len * sizeof(int32_t));
    std::fill(row_ids + len, row_ids + seq_len, pad_id);
    std::fill(row_labels + len, row_labels + seq_len, ignore_index);
    std::fill(row_mask, row_mask + len, 1);
    std::fill(row_mask + len, row_mask + seq_len, 0);
  }
  return 0;
}

}  // extern "C"
