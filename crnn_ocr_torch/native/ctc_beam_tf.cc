// TF-exact CTC beam-search decoder on the host, C ABI (the PyTorch port's
// copy of crnn_ocr_tpu/native/src/ctc_beam_tf.cc).
//
// The reference decodes with TF's C++ CTCBeamSearchDecoderOp. This file
// implements the same observable semantics, from the behavioural spec in
// crnn_ocr_torch/ops/ctc_beam_exact.py (TF's ctc_beam_search.h and
// ctc_beam_entry.h, Apache-2.0, the TensorFlow authors, pin the
// sequential-eviction semantics; names like oldp/newp follow them):
//
//   * per step: log-softmax normalization of the input frame;
//   * phase 1: every current beam's "stay" update (blank mass from old
//     total; label mass self-recursion + fold from a still-active parent),
//     all pushed back into the leaf set;
//   * phase 2: children generated per (beam-in-old-score-order, label),
//     sequentially, each inserted only if it beats the *current* bottom,
//     evicting+deactivating it; a rejected child gets BOTH prob sets
//     zeroed, which gates it out of spawning its own children this step;
//   * output: top paths by total prob, adjacent duplicate labels merged
//     when asked.
//
// Inputs are post-softmax probabilities (Keras convention); scoring uses
// log_softmax(log(p + 1e-7)) exactly like K.ctc_decode. Built with
// g++ -O3 -std=c++17 -fPIC -shared by crnn_ocr_torch/native/__init__.py;
// tests/test_torch_beam_exact.py holds it to the numpy oracle and to the
// JAX package's decoders.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kLogZero = -std::numeric_limits<float>::infinity();
constexpr float kKerasEps = 1e-7f;

inline float LogSumExp(float a, float b) {
  if (a == kLogZero) return b;
  if (b == kLogZero) return a;
  const float m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct Probs {
  float total = kLogZero;
  float blank = kLogZero;
  float label = kLogZero;
  void Reset() { total = blank = label = kLogZero; }
};

struct Entry {
  Entry* parent = nullptr;
  int label = -1;
  Probs oldp, newp;
  std::unordered_map<int, Entry*> children;
  bool Active() const { return newp.total != kLogZero; }
};

class Arena {
 public:
  Entry* New(Entry* parent, int label) {
    pool_.emplace_back();
    Entry* e = &pool_.back();
    e->parent = parent;
    e->label = label;
    return e;
  }

 private:
  std::deque<Entry> pool_;  // stable addresses
};

Entry* GetChild(Arena& arena, Entry* b, int label) {
  auto it = b->children.find(label);
  if (it != b->children.end()) return it->second;
  Entry* c = arena.New(b, label);
  b->children.emplace(label, c);
  return c;
}

// Decode one (T, C) example.
void DecodeOne(const float* probs, int64_t T, int64_t C, int64_t seq_len,
               int beam_width, int top_paths, bool merge_repeated,
               int32_t* out_paths /* (top_paths, T) */,
               int32_t* out_lens /* (top_paths) */,
               float* out_scores /* (top_paths) */) {
  const int blank = static_cast<int>(C) - 1;
  Arena arena;
  Entry* root = arena.New(nullptr, -1);
  root->newp.total = 0.0f;
  root->newp.blank = 0.0f;

  // leaves kept sorted by newp.total descending; ties keep insertion order
  std::vector<Entry*> leaves{root};
  std::vector<Entry*> branches;
  std::vector<float> lp(C);

  for (int64_t t = 0; t < seq_len && t < T; ++t) {
    const float* row = probs + t * C;
    // log(p + eps), then log-softmax
    float maxv = kLogZero;
    for (int64_t c = 0; c < C; ++c) {
      lp[c] = std::log(row[c] + kKerasEps);
      maxv = std::max(maxv, static_cast<float>(lp[c]));
    }
    double sum = 0.0;
    for (int64_t c = 0; c < C; ++c) sum += std::exp(lp[c] - maxv);
    const float norm = maxv + static_cast<float>(std::log(sum));
    for (int64_t c = 0; c < C; ++c) lp[c] -= norm;

    branches = leaves;  // already sorted desc by newp.total
    leaves.clear();
    for (Entry* b : branches) b->oldp = b->newp;

    // Phase 1: stays.
    for (Entry* b : branches) {
      if (b->parent != nullptr) {
        if (b->parent->Active()) {
          const float previous = (b->label == b->parent->label)
                                     ? b->parent->oldp.blank
                                     : b->parent->oldp.total;
          b->newp.label = LogSumExp(b->newp.label, previous);
        }
        b->newp.label += lp[b->label];
      }
      b->newp.blank = b->oldp.total + lp[blank];
      b->newp.total = LogSumExp(b->newp.blank, b->newp.label);
      leaves.push_back(b);
    }
    std::stable_sort(leaves.begin(), leaves.end(),
                     [](const Entry* a, const Entry* b) {
                       return a->newp.total > b->newp.total;
                     });

    auto bottom = [&]() -> float { return leaves.back()->newp.total; };
    auto is_cand = [&](const Probs& p) {
      return p.total > kLogZero &&
             (static_cast<int>(leaves.size()) < beam_width ||
              p.total > bottom());
    };

    // Phase 2: sequential child creation with in-step eviction.
    for (Entry* b : branches) {
      if (!is_cand(b->oldp)) continue;
      for (int label = 0; label < blank; ++label) {
        Entry* c = GetChild(arena, b, label);
        if (c->Active()) continue;  // folded in phase 1
        const float previous =
            (label == b->label) ? b->oldp.blank : b->oldp.total;
        c->newp.blank = kLogZero;
        c->newp.label = lp[label] + previous;
        c->newp.total = c->newp.label;
        if (is_cand(c->newp)) {
          if (static_cast<int>(leaves.size()) == beam_width) {
            leaves.back()->newp.Reset();
            leaves.pop_back();
          }
          // insert keeping descending order, after equal scores
          auto pos = std::upper_bound(
              leaves.begin(), leaves.end(), c,
              [](const Entry* a, const Entry* b) {
                return a->newp.total > b->newp.total;
              });
          leaves.insert(pos, c);
        } else {
          c->oldp.Reset();
          c->newp.Reset();
        }
      }
    }
  }

  std::stable_sort(leaves.begin(), leaves.end(),
                   [](const Entry* a, const Entry* b) {
                     return a->newp.total > b->newp.total;
                   });

  for (int p = 0; p < top_paths; ++p) {
    int32_t* path = out_paths + p * T;
    for (int64_t i = 0; i < T; ++i) path[i] = -1;
    if (p >= static_cast<int>(leaves.size())) {
      out_lens[p] = 0;
      out_scores[p] = kLogZero;
      continue;
    }
    const Entry* e = leaves[p];
    out_scores[p] = e->newp.total;
    // walk up, then reverse; merge adjacent repeats if requested
    std::vector<int> seq;
    int prev = -1;
    for (const Entry* c = e; c->parent != nullptr; c = c->parent) {
      if (!merge_repeated || c->label != prev) seq.push_back(c->label);
      prev = c->label;
    }
    std::reverse(seq.begin(), seq.end());
    out_lens[p] = static_cast<int32_t>(seq.size());
    for (size_t i = 0; i < seq.size() && i < static_cast<size_t>(T); ++i)
      path[i] = seq[i];
  }
}

}  // namespace

extern "C" {

// probs: (B, T, C) float32 post-softmax; seq_len: (B,) int32.
// out_paths: (B, top_paths, T) int32 (-1 padded); out_lens: (B, top_paths);
// out_scores: (B, top_paths) float32 total log-probs.
void ctc_beam_decode_tf(const float* probs, int64_t B, int64_t T, int64_t C,
                        const int32_t* seq_len, int beam_width, int top_paths,
                        int merge_repeated, int32_t* out_paths,
                        int32_t* out_lens, float* out_scores) {
  for (int64_t b = 0; b < B; ++b) {
    DecodeOne(probs + b * T * C, T, C, seq_len[b], beam_width, top_paths,
              merge_repeated != 0, out_paths + b * top_paths * T,
              out_lens + b * top_paths, out_scores + b * top_paths);
  }
}

}  // extern "C"
