// Host helpers of multike_tpu_torch, built at first use by
// multike_tpu_torch/kernels/_build.py (build_host) with the host C++ compiler
// and bound with ctypes in multike_tpu_torch/utils/native.py.
//
// A copy of the three entry points of native/multike_native.cpp (the JAX
// package's helpers) and the functions they call, with the same arithmetic,
// so both libraries and the Python versions give bitwise equal results:
//
//   lev_ratio_matrix: dense Levenshtein-ratio matrix between two lists of
//     UTF-8 strings, over codepoints, multithreaded. ratio(a, b) follows
//     python-Levenshtein: (|a|+|b|-D)/(|a|+|b|), D the edit distance with
//     insert/delete cost 1 and substitution cost 2.
//   vec_scan, vec_parse: a fastText-style .vec word-vector file.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Decode UTF-8 into codepoints; invalid bytes are kept as raw values so the
// function is total.
std::vector<uint32_t> decode_utf8(const char* s) {
  std::vector<uint32_t> out;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
  while (*p) {
    uint32_t cp = 0;
    int extra = 0;
    unsigned char c = *p;
    if (c < 0x80) {
      cp = c;
    } else if ((c >> 5) == 0x6) {
      cp = c & 0x1F; extra = 1;
    } else if ((c >> 4) == 0xE) {
      cp = c & 0x0F; extra = 2;
    } else if ((c >> 3) == 0x1E) {
      cp = c & 0x07; extra = 3;
    } else {
      out.push_back(c); ++p; continue;
    }
    ++p;
    bool ok = true;
    for (int i = 0; i < extra; ++i) {
      if ((*p & 0xC0) != 0x80) { ok = false; break; }
      cp = (cp << 6) | (*p & 0x3F);
      ++p;
    }
    out.push_back(ok ? cp : 0xFFFD);
  }
  return out;
}

double lev_ratio(const std::vector<uint32_t>& a, const std::vector<uint32_t>& b,
                 std::vector<uint32_t>& prev, std::vector<uint32_t>& cur) {
  const size_t la = a.size(), lb = b.size();
  const size_t total = la + lb;
  if (total == 0) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  prev.resize(lb + 1);
  cur.resize(lb + 1);
  for (size_t j = 0; j <= lb; ++j) prev[j] = static_cast<uint32_t>(j);
  for (size_t i = 1; i <= la; ++i) {
    cur[0] = static_cast<uint32_t>(i);
    const uint32_t ca = a[i - 1];
    for (size_t j = 1; j <= lb; ++j) {
      uint32_t sub = prev[j - 1] + (ca == b[j - 1] ? 0u : 2u);
      uint32_t v = std::min(std::min(prev[j] + 1u, cur[j - 1] + 1u), sub);
      cur[j] = v;
    }
    std::swap(prev, cur);
  }
  return static_cast<double>(total - prev[lb]) / static_cast<double>(total);
}

}  // namespace

// ---------------------------------------------------------------------------
// fastText-style .vec parser: vec_scan counts conforming lines (a word, then
// exactly dim floats, separated by runs of spaces) and the bytes of their
// words; vec_parse fills caller-allocated buffers (row-major float32 matrix +
// '\n'-joined words).
// ---------------------------------------------------------------------------

namespace {

struct VecLine {
  const char* word_begin;
  size_t word_len;
  bool ok;
};

// Parses one line; on success writes dim floats into out (if not null).
VecLine parse_vec_line(char* line, int dim, float* out) {
  VecLine r{nullptr, 0, false};
  char* p = line;
  while (*p == ' ') ++p;
  r.word_begin = p;
  while (*p && *p != ' ') ++p;
  r.word_len = static_cast<size_t>(p - r.word_begin);
  if (r.word_len == 0) return r;
  int count = 0;
  while (*p) {
    while (*p == ' ') ++p;
    if (*p == '\0' || *p == '\n' || *p == '\r') break;
    char* end = nullptr;
    float v = strtof(p, &end);
    if (end == p) return r;  // not a float => malformed line
    if (count < dim && out != nullptr) out[count] = v;
    ++count;
    p = end;
  }
  r.ok = (count == dim);
  return r;
}

}  // namespace

extern "C" {

// Returns 0 on success. n_out/word_bytes_out: number of conforming lines and
// total bytes of their words incl. one '\n' separator each.
int vec_scan(const char* path, int dim, long long* n_out,
             long long* word_bytes_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  long long n = 0, wb = 0;
  size_t cap = 1 << 20;
  char* line = static_cast<char*>(malloc(cap));
  ssize_t len;
  while ((len = getline(&line, &cap, f)) >= 0) {
    VecLine r = parse_vec_line(line, dim, nullptr);
    if (r.ok) {
      ++n;
      wb += static_cast<long long>(r.word_len) + 1;
    }
  }
  free(line);
  fclose(f);
  *n_out = n;
  *word_bytes_out = wb;
  return 0;
}

// mat: (n, dim) float32 row-major; words: word_bytes chars, '\n'-joined.
int vec_parse(const char* path, int dim, float* mat, char* words,
              long long n, long long word_bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  long long row = 0;
  long long wpos = 0;
  size_t cap = 1 << 20;
  char* line = static_cast<char*>(malloc(cap));
  ssize_t len;
  while ((len = getline(&line, &cap, f)) >= 0 && row < n) {
    VecLine r = parse_vec_line(line, dim, mat + row * dim);
    if (r.ok) {
      if (wpos + static_cast<long long>(r.word_len) + 1 > word_bytes) break;
      for (size_t i = 0; i < r.word_len; ++i) words[wpos++] = r.word_begin[i];
      words[wpos++] = '\n';
      ++row;
    }
  }
  free(line);
  fclose(f);
  return (row == n && wpos == word_bytes) ? 0 : 2;
}

// out is row-major (n1, n2) double.
void lev_ratio_matrix(const char** names1, int n1, const char** names2, int n2,
                      double* out, int threads) {
  std::vector<std::vector<uint32_t>> d1(n1), d2(n2);
  for (int i = 0; i < n1; ++i) d1[i] = decode_utf8(names1[i]);
  for (int j = 0; j < n2; ++j) d2[j] = decode_utf8(names2[j]);

  if (threads < 1) threads = 1;
  threads = std::min(threads, std::max(1, n1));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t]() {
      std::vector<uint32_t> prev, cur;
      for (int i = t; i < n1; i += threads) {
        for (int j = 0; j < n2; ++j) {
          out[static_cast<size_t>(i) * n2 + j] = lev_ratio(d1[i], d2[j], prev, cur);
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
