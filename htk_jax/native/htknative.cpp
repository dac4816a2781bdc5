// Native runtime components for htk_jax (C++, built on demand by
// htk_jax/native/__init__.py with the system g++).
//
// ARPA n-gram codec: mirrors `HTKLib/HLM.c : ReadLModel()` (SURVEY.md
// §2.1 HLM row) at the format level and htk_jax/io/lm.py : read_arpa()
// at the semantic level — every accepted/skipped-line rule below is the
// same rule the pure-Python reader applies, so the two parsers are
// interchangeable (tested in tests/test_native.py). The native parser
// exists because the Python line loop measured 13.7 s on a 44 MB /
// 2M-gram ARPA file; recipes load LMs 10x that size.
//
// ABI: plain C, consumed via ctypes. The parse result is an opaque
// handle; callers copy vocab/ids/probs out into numpy buffers and free
// the handle. No Python.h dependency (works without pybind11/CPython
// headers per the environment constraints).

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct ArpaResult {
  std::string buf;                       // whole file (vocab views point in)
  std::vector<std::string_view> vocab;   // intern table, first-seen order
  std::unordered_map<std::string_view, uint32_t> intern;
  // per order 1..4 (index order-1), entries in file order
  std::vector<uint32_t> ids[4];          // count * order word ids
  std::vector<double> logp[4];           // raw log10 (caller scales)
  std::vector<double> bo[4];             // raw log10 back-off, 0 if absent
  std::vector<uint8_t> has_bo[4];        // per-entry back-off presence
  int max_order = 1;
  std::string err;

  uint32_t intern_word(std::string_view w) {
    auto it = intern.find(w);
    if (it != intern.end()) return it->second;
    uint32_t id = (uint32_t)vocab.size();
    vocab.push_back(w);
    intern.emplace(w, id);
    return id;
  }
};

inline bool is_space(char c) {
  // bytes str.split()/strip() treat as whitespace (ASCII subset; the
  // Python reader decodes with errors="replace" first, so multi-byte
  // unicode whitespace inside tokens is a documented divergence)
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

// parse a float the way Python float() does for ARPA-style tokens
inline bool parse_double(std::string_view tok, double* out) {
  // std::from_chars: locale-independent, exact (same correctly-rounded
  // result as Python float()); '+' prefix is the one Python-accepted
  // form it rejects, so strip it
  if (!tok.empty() && tok[0] == '+') tok.remove_prefix(1);
  auto res = std::from_chars(tok.data(), tok.data() + tok.size(), *out);
  return res.ec == std::errc() && res.ptr == tok.data() + tok.size();
}

// split line into up to `maxf` fields; returns field count (may exceed
// maxf to signal "more fields existed", capped at maxf + 1)
inline int split_fields(std::string_view line, std::string_view* f,
                        int maxf) {
  int n = 0;
  size_t i = 0, len = line.size();
  while (i < len) {
    while (i < len && is_space(line[i])) i++;
    if (i >= len) break;
    size_t j = i;
    while (j < len && !is_space(line[j])) j++;
    if (n < maxf) {
      f[n++] = line.substr(i, j - i);
    } else {
      return maxf + 1;
    }
    i = j;
  }
  return n;
}

inline std::string_view strip(std::string_view s) {
  size_t a = 0, b = s.size();
  while (a < b && is_space(s[a])) a++;
  while (b > a && is_space(s[b - 1])) b--;
  return s.substr(a, b - a);
}

}  // namespace

extern "C" {

void* ht_arpa_parse(const char* path) {
  auto* r = new ArpaResult();
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    r->err = "cannot open";
    return r;
  }
  fseek(fp, 0, SEEK_END);
  long sz = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  r->buf.resize((size_t)sz);
  if (sz && fread(&r->buf[0], 1, (size_t)sz, fp) != (size_t)sz) {
    fclose(fp);
    r->err = "short read";
    return r;
  }
  fclose(fp);

  const std::string_view all(r->buf);
  int section = 0;  // 0 = preamble, -1 = \data\, 1..4 = n-gram sections
  size_t pos = 0;
  std::string_view f[8];
  while (pos <= all.size()) {
    size_t nl = all.find('\n', pos);
    size_t end = (nl == std::string_view::npos) ? all.size() : nl;
    std::string_view line = strip(all.substr(pos, end - pos));
    pos = end + 1;
    if (line.empty()) {
      if (nl == std::string_view::npos) break;
      continue;
    }
    if (line[0] == '\\') {
      if (line.substr(0, 6) == "\\data\\") { section = -1; goto next; }
      if (line.substr(0, 8) == "\\1-grams") { section = 1; goto next; }
      if (line.substr(0, 8) == "\\2-grams") {
        section = 2;
        if (r->max_order < 2) r->max_order = 2;
        goto next;
      }
      if (line.substr(0, 8) == "\\3-grams") {
        section = 3;
        if (r->max_order < 3) r->max_order = 3;
        goto next;
      }
      if (line.substr(0, 8) == "\\4-grams") {
        section = 4;
        r->max_order = 4;
        goto next;
      }
      if (line.substr(0, 5) == "\\end\\") break;
      if (section != 0 && line.find("-grams") != std::string_view::npos) {
        // \5-grams: or higher — fail the parse; the Python fallback
        // reader raises the numbered error (HError 8153)
        r->err = "unsupported n-gram section";
        return r;
      }
    }
    if (section <= 0) goto next;
    {
      int order = section;
      // need p + order words; optional back-off field after
      int nf = split_fields(line, f, order + 2);
      if (nf >= order + 1) {
        double p;
        if (!parse_double(f[0], &p)) {
          // Python float() raises here -> numbered HError 8154; fail
          // the parse so the fallback reader reports it identically
          r->err = "bad number in n-gram line";
          return r;
        }
        double b = 0.0;
        uint8_t hb = 0;
        if (nf >= order + 2) {
          if (parse_double(f[order + 1], &b)) {
            hb = 1;
          } else {
            r->err = "bad number in n-gram line";
            return r;
          }
        }
        int k = order - 1;
        r->logp[k].push_back(p);
        r->bo[k].push_back(b);
        r->has_bo[k].push_back(hb);
        for (int q = 1; q <= order; q++)
          r->ids[k].push_back(r->intern_word(f[q]));
      }
    }
  next:
    if (nl == std::string_view::npos) break;
  }
  return r;
}

const char* ht_arpa_error(void* h) {
  auto* r = (ArpaResult*)h;
  return r->err.empty() ? nullptr : r->err.c_str();
}

int ht_arpa_order(void* h) { return ((ArpaResult*)h)->max_order; }

int64_t ht_arpa_nwords(void* h) {
  return (int64_t)((ArpaResult*)h)->vocab.size();
}

int64_t ht_arpa_vocab_bytes(void* h) {
  auto* r = (ArpaResult*)h;
  int64_t n = 0;
  for (auto& w : r->vocab) n += (int64_t)w.size() + 1;
  return n;
}

void ht_arpa_copy_vocab(void* h, char* out) {
  auto* r = (ArpaResult*)h;
  for (auto& w : r->vocab) {
    memcpy(out, w.data(), w.size());
    out += w.size();
    *out++ = 0;
  }
}

int64_t ht_arpa_count(void* h, int order) {
  auto* r = (ArpaResult*)h;
  if (order < 1 || order > 4) return 0;
  return (int64_t)r->logp[order - 1].size();
}

void ht_arpa_copy(void* h, int order, uint32_t* ids, double* logp,
                  double* bo, uint8_t* has_bo) {
  auto* r = (ArpaResult*)h;
  int k = order - 1;
  memcpy(ids, r->ids[k].data(), r->ids[k].size() * sizeof(uint32_t));
  memcpy(logp, r->logp[k].data(), r->logp[k].size() * sizeof(double));
  memcpy(bo, r->bo[k].data(), r->bo[k].size() * sizeof(double));
  memcpy(has_bo, r->has_bo[k].data(), r->has_bo[k].size());
}

void ht_arpa_free(void* h) { delete (ArpaResult*)h; }

}  // extern "C"
