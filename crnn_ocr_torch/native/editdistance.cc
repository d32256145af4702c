// Levenshtein distance, C ABI (the PyTorch port's copy of
// crnn_ocr_tpu/native/src/editdistance.cc). The reference computes CER and
// WER with the C++ `editdistance` package; this is the same unit-cost
// distance, loaded with ctypes by crnn_ocr_torch/native/__init__.py.
//
// Two-row DP, O(min(na,nb)) memory.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int64_t levenshtein_i32(const int32_t* a, int64_t na, const int32_t* b,
                        int64_t nb) {
  if (na < nb) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  if (nb == 0) return na;
  std::vector<int64_t> prev(nb + 1), cur(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const int32_t ca = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      const int64_t sub = prev[j - 1] + (ca != b[j - 1] ? 1 : 0);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

}  // extern "C"
