// Native host-side preprocessing of the PyTorch port (mgnns_tpu_torch).
//
// The port's own copy of the JAX package's native/host_preproc.cpp, with the
// same C ABI: the hottest host loops of the reference (utils/pmi.py:40-105
// windowed pair counting; models/Text_GCN.py:142-166 per-doc window edge
// construction), bound through ctypes by mgnns_tpu_torch/native.py, which
// keeps the numpy versions beside them.
//
// Exposed C ABI:
//   pmi_pair_count   — sparse windowed co-occurrence counting via open
//                      addressing (linear probing) on 64-bit keys.
//   window_edge_ids  — per-(doc, position, offset) global edge-id lookup by
//                      binary search over the sorted key table.
//
// Built at first use by mgnns_tpu_torch/kernels/build.py:load_host
// (c++ -O3 -march=native -fPIC -shared -std=c++17) into build/torch_ext/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Open-addressing hash accumulation of (src * V + dst) pair keys.
// ids: [n_docs, doc_len] int32; -1 marks out-of-vocab, 0 is PAD.
// Window semantics replicate the reference exactly: for source position i,
// targets j in [max(0, i-window), min(doc_len, i+window)), j != i; sources
// must be in-vocab and non-PAD; targets in-vocab (PAD targets are counted
// and later killed by their zero unigram count).
// Returns the number of distinct pairs written to out_keys/out_counts
// (capacity `cap`), or -1 as soon as a pair past the cap-th distinct one
// appears (out_word_counts is then partial: the caller retries from zeros).
int64_t pmi_pair_count(const int32_t* ids, int64_t n_docs, int64_t doc_len,
                       int64_t vocab_size, int64_t window,
                       int64_t* out_keys, int64_t* out_counts, int64_t cap,
                       int64_t* out_word_counts /* [vocab_size] */) {
  // table size: next power of two >= 2 * cap for low load factor
  uint64_t tsize = 1;
  while (tsize < static_cast<uint64_t>(cap) * 2) tsize <<= 1;
  std::vector<int64_t> keys(tsize, -1);
  std::vector<int64_t> counts(tsize, 0);
  const uint64_t mask = tsize - 1;

  // A key past the cap-th distinct one overflows at once: the table then
  // stays at most half full, so a probe always finds a key or a free slot
  // (filled past its size, the probe would never end).
  int64_t distinct = 0;
  auto bump = [&](int64_t key) -> bool {
    uint64_t h = static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull;
    uint64_t slot = h & mask;
    while (true) {
      if (keys[slot] == key) {
        counts[slot]++;
        return true;
      }
      if (keys[slot] == -1) {
        if (distinct >= cap) return false;
        keys[slot] = key;
        counts[slot] = 1;
        distinct++;
        return true;
      }
      slot = (slot + 1) & mask;
    }
  };

  for (int64_t d = 0; d < n_docs; ++d) {
    const int32_t* doc = ids + d * doc_len;
    for (int64_t i = 0; i < doc_len; ++i) {
      int32_t src = doc[i];
      if (src <= 0) continue;  // PAD or OOV source
      out_word_counts[src]++;
      int64_t lo = std::max<int64_t>(0, i - window);
      int64_t hi = std::min<int64_t>(doc_len, i + window);
      for (int64_t j = lo; j < hi; ++j) {
        if (j == i) continue;
        int32_t dst = doc[j];
        if (dst < 0) continue;  // OOV target
        if (!bump(static_cast<int64_t>(src) * vocab_size + dst)) return -1;
      }
    }
  }
  int64_t n = 0;
  for (uint64_t s = 0; s < tsize; ++s) {
    if (keys[s] != -1) {
      out_keys[n] = keys[s];
      out_counts[n] = counts[s];
      n++;
    }
  }
  // callers sort (keys, counts) — the reference enumerates row-major
  return n;
}

// Binary-search lookup of window edge ids.
// sorted_keys: [n_edges] ascending (src * V + dst) of real edges; the edge
// id of sorted_keys[k] is k + 1 (id 0 = reserved "no edge").
// ids: [n_docs, L] suffix-PAD token ids; lens: [n_docs], each <= L (the
// loop reads doc[s] for s < len with no bound on L; the binding checks).
// out: [n_docs, L, 2*ngram+1] int32, 0 where invalid/absent.
void window_edge_ids(const int32_t* ids, const int32_t* lens,
                     int64_t n_docs, int64_t L, int64_t ngram,
                     const int64_t* sorted_keys, int64_t n_edges,
                     int64_t vocab_size, int32_t* out) {
  const int64_t W = 2 * ngram + 1;
  for (int64_t d = 0; d < n_docs; ++d) {
    const int32_t* doc = ids + d * L;
    const int64_t len = lens[d];
    int32_t* dst_row = out + d * L * W;
    for (int64_t j = 0; j < L; ++j) {
      for (int64_t k = 0; k < W; ++k) {
        int64_t s = j + k - ngram;
        int32_t eid = 0;
        if (j < len && s >= 0 && s < len) {
          int64_t key = static_cast<int64_t>(doc[s]) * vocab_size + doc[j];
          const int64_t* it =
              std::lower_bound(sorted_keys, sorted_keys + n_edges, key);
          if (it != sorted_keys + n_edges && *it == key) {
            eid = static_cast<int32_t>(it - sorted_keys) + 1;
          }
        }
        dst_row[j * W + k] = eid;
      }
    }
  }
}

}  // extern "C"
