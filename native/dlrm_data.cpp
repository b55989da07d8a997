// Native Criteo data engine: fast text->binary parsing and batch marshal.
//
// The reference's data plane is CPU-native for speed (SIMD gather kernels in
// EmbeddingTables.jl, mmap'd records, Polyester-threaded marshaling —
// SURVEY.md §2.2/§2.3).  On the GPU the *device* side of that is XLA's job, but
// the host-side preprocessing (parsing a terabyte of tab-separated text) is
// still CPU-bound and far too slow in Python — this is its C++ equivalent.
//
// Record layout is byte-compatible with /root/reference/src/data/criteo.jl:91-95:
//   int32 label | 13 x float32 log(max(x,0)+1) | 26 x uint32 hex ids  = 160 B.
//
// Exposed as a plain C ABI consumed via ctypes (dlrm_tpu/data/native.py).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kDense = 13;
constexpr int kSparse = 26;
constexpr int kFields = 1 + kDense + kSparse;

#pragma pack(push, 1)
struct DacRecord {
  int32_t label;
  float dense[kDense];
  uint32_t cat[kSparse];
};
#pragma pack(pop)
static_assert(sizeof(DacRecord) == 160, "record layout must be 160 bytes");

// Parse a base-10 integer field ending at '\t'/'\n'/end.  *digits is
// the digit count, or -1 on overflow (>18 digits — numpy's int64
// conversion raises there on the Python path; silently wrapping here
// would be signed-overflow UB AND a silent divergence).  Empty (0
// digits) is left to the caller's policy: dense fields allow it
// (empty -> 0, criteo.jl:55), the label does not.
inline const char* parse_i64(const char* p, const char* end, int64_t* out,
                             int* digits) {
  int64_t v = 0;
  bool neg = false;
  int nd = 0;
  if (p < end && *p == '-') {
    neg = true;
    ++p;
  }
  while (p < end && *p >= '0' && *p <= '9') {
    if (++nd > 18) {
      *digits = -1;
      return p;
    }
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = neg ? -v : v;
  *digits = nd;
  return p;
}

// Parse a base-16 field; empty -> 0.  Values over 32 bits are malformed
// (*ok = false) — the Python path raises OverflowError there; silently
// truncating to the low 32 bits would corrupt ids on only one path.
// Leading zeros are fine (the value, not the digit count, is bounded).
inline const char* parse_hex(const char* p, const char* end, uint32_t* out,
                             bool* ok) {
  uint64_t v = 0;
  while (p < end) {
    char c = *p;
    uint32_t d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else break;
    v = (v << 4) | d;
    if (v > 0xFFFFFFFFull) {
      *ok = false;
      return p;
    }
    ++p;
  }
  *out = static_cast<uint32_t>(v);
  *ok = true;
  return p;
}

// Parse one line [p, nl) into rec. Returns false on malformed line.
bool parse_line(const char* p, const char* nl, DacRecord* rec) {
  int64_t label;
  int nd;
  p = parse_i64(p, nl, &label, &nd);
  // the label must actually be present (Python: int('') raises) and fit
  // int32 (numpy's i4 field assignment raises past that)
  if (nd <= 0 || label > INT32_MAX || label < INT32_MIN) return false;
  if (p >= nl || *p != '\t') return false;
  ++p;
  rec->label = static_cast<int32_t>(label);
  for (int i = 0; i < kDense; ++i) {
    int64_t v;
    p = parse_i64(p, nl, &v, &nd);
    if (nd < 0) return false;  // overflow
    if (p >= nl || *p != '\t') return false;
    ++p;
    // Compute in double, round once to f32 — keeps the C++ and numpy
    // (which promotes through double libm) paths bit-identical.
    double x = v > 0 ? static_cast<double>(v) : 0.0;
    rec->dense[i] = static_cast<float>(std::log1p(x));
  }
  for (int i = 0; i < kSparse; ++i) {
    bool ok;
    p = parse_hex(p, nl, &rec->cat[i], &ok);
    if (!ok) return false;
    if (i + 1 < kSparse) {
      if (p >= nl || *p != '\t') return false;
      ++p;
    }
  }
  return p == nl;
}

// Parse text[lo, hi) (must start/end at line boundaries) into out.
// On a malformed line, returns -1 and stores the line's byte offset
// (relative to `text`) in *err_off so the caller can locate it.
int64_t parse_span(const char* text, size_t lo, size_t hi,
                   std::vector<DacRecord>* out, int64_t* err_off) {
  const char* p = text + lo;
  const char* end = text + hi;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (nl == nullptr) nl = end;
    if (nl > p) {
      DacRecord rec;
      if (!parse_line(p, nl, &rec)) {
        *err_off = static_cast<int64_t>(p - text);
        return -1;
      }
      out->push_back(rec);
    }
    p = nl + 1;
  }
  return static_cast<int64_t>(out->size());
}

// -- vocabulary build / reindex ----------------------------------------------
//
// The reference's reindex (criteo.jl:194-264) maps each categorical
// column's raw values to dense 1-based ids in FIRST-APPEARANCE order.
// numpy does this at ~100 k records/s (per-column unique + argsort +
// searchsorted passes); here it is one hash probe per value with
// column-parallel build — the whole Terabyte preprocessing stays
// CPU-bound without this.

struct ColMap {
  std::vector<uint32_t> keys;
  std::vector<uint32_t> ranks;   // UINT32_MAX == empty slot
  std::vector<uint32_t> appear;  // values in first-appearance order
  size_t mask = 0;

  static inline size_t hash(uint32_t v) {
    uint64_t h = v * 0x9E3779B97F4A7C15ull;
    return static_cast<size_t>(h >> 32);
  }
  void init(size_t cap) {
    size_t c = 64;
    while (c < cap) c <<= 1;
    keys.assign(c, 0);
    ranks.assign(c, UINT32_MAX);
    mask = c - 1;
  }
  void rehash() {
    size_t c = keys.size() * 2;
    keys.assign(c, 0);
    ranks.assign(c, UINT32_MAX);
    mask = c - 1;
    for (uint32_t r = 0; r < appear.size(); ++r) {
      size_t h = hash(appear[r]) & mask;
      while (ranks[h] != UINT32_MAX) h = (h + 1) & mask;
      keys[h] = appear[r];
      ranks[h] = r;
    }
  }
  inline uint32_t get_or_add(uint32_t v) {
    size_t h = hash(v) & mask;
    while (ranks[h] != UINT32_MAX) {
      if (keys[h] == v) return ranks[h];
      h = (h + 1) & mask;
    }
    uint32_t r = static_cast<uint32_t>(appear.size());
    keys[h] = v;
    ranks[h] = r;
    appear.push_back(v);
    if (appear.size() * 10 >= keys.size() * 7) rehash();  // 0.7 load
    return r;
  }
  inline uint32_t lookup(uint32_t v) const {
    size_t h = hash(v) & mask;
    while (ranks[h] != UINT32_MAX) {
      if (keys[h] == v) return ranks[h];
      h = (h + 1) & mask;
    }
    return UINT32_MAX;
  }
};

struct Vocab {
  ColMap cols[kSparse];
};

}  // namespace

extern "C" {

// Build the 26-column vocabulary over records[0..n) in first-appearance
// order (byte-identical semantics to the Python Vocabulary fold,
// data/criteo.py).  Column-parallel.  Returns an opaque handle.
void* dlrm_vocab_build(const void* records, int64_t n,
                       int32_t num_threads) {
  const auto* recs = static_cast<const DacRecord*>(records);
  auto* v = new (std::nothrow) Vocab();
  if (v == nullptr) return nullptr;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > kSparse) num_threads = kSparse;
  std::vector<std::thread> threads;
  std::vector<int32_t> failed(num_threads, 0);
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([=, &failed]() {
      // an exception escaping a std::thread is std::terminate — a
      // bad_alloc during a Terabyte-scale build must surface as a NULL
      // handle (Python raises RuntimeError), not kill the process
      try {
        for (int j = t; j < kSparse; j += num_threads) {
          ColMap& m = v->cols[j];
          m.init(1024);
          for (int64_t i = 0; i < n; ++i) m.get_or_add(recs[i].cat[j]);
        }
      } catch (...) {
        failed[t] = 1;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < num_threads; ++t) {
    if (failed[t]) {
      delete v;
      return nullptr;
    }
  }
  return v;
}

int64_t dlrm_vocab_size(void* handle, int32_t col) {
  return static_cast<int64_t>(
      static_cast<Vocab*>(handle)->cols[col].appear.size());
}

// Export column `col`'s values in first-appearance order.
void dlrm_vocab_export(void* handle, int32_t col, uint32_t* out) {
  const auto& a = static_cast<Vocab*>(handle)->cols[col].appear;
  memcpy(out, a.data(), a.size() * sizeof(uint32_t));
}

// Rewrite every categorical value to its dense 1-BASED id (the on-disk
// convention, criteo.jl:256-264).  Row-parallel (lookup-only).  Returns
// -1 if a value is missing from the vocabulary (never happens when the
// vocabulary was built over the same records), else 0.
int32_t dlrm_vocab_reindex(void* handle, void* records, int64_t n,
                           int32_t num_threads) {
  auto* recs = static_cast<DacRecord*>(records);
  const auto* v = static_cast<Vocab*>(handle);
  if (num_threads < 1) num_threads = 1;
  std::vector<int32_t> status(num_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([=, &status]() {
      int64_t lo = n * t / num_threads;
      int64_t hi = n * (t + 1) / num_threads;
      for (int64_t i = lo; i < hi; ++i) {
        for (int j = 0; j < kSparse; ++j) {
          uint32_t r = v->cols[j].lookup(recs[i].cat[j]);
          if (r == UINT32_MAX) {
            status[t] = -1;
            return;
          }
          recs[i].cat[j] = r + 1;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < num_threads; ++t)
    if (status[t] < 0) return -1;
  return 0;
}

void dlrm_vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Parse an in-memory text buffer into caller-allocated records (capacity
// records).  Multithreaded: the buffer is split at line boundaries.
// Returns the number of records written, or -1 on parse error /
// overflow; on a malformed line, *err_off (when non-NULL) receives the
// byte offset of the line's start within `text` (else -1) so a bad line
// hours into a 45 GB day file is locatable.
int64_t dlrm_parse_buffer(const char* text, int64_t text_len,
                          void* records_out, int64_t capacity,
                          int32_t num_threads, int64_t* err_off) {
  if (err_off != nullptr) *err_off = -1;
  if (num_threads < 1) num_threads = 1;
  size_t len = static_cast<size_t>(text_len);
  // Split points at line boundaries.
  std::vector<size_t> splits{0};
  for (int t = 1; t < num_threads; ++t) {
    size_t target = len * t / num_threads;
    const char* nl = static_cast<const char*>(
        memchr(text + target, '\n', len - target));
    splits.push_back(nl ? static_cast<size_t>(nl - text) + 1 : len);
  }
  splits.push_back(len);

  std::vector<std::vector<DacRecord>> parts(num_threads);
  std::vector<int64_t> status(num_threads, 0);
  std::vector<int64_t> offs(num_threads, -1);
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([&, t]() {
      try {
        if (splits[t + 1] > splits[t]) {
          status[t] = parse_span(text, splits[t], splits[t + 1],
                                 &parts[t], &offs[t]);
        }
      } catch (...) {
        status[t] = -1;  // bad_alloc etc.: fail the call, not the process
      }
    });
  }
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (int t = 0; t < num_threads; ++t) {
    if (status[t] < 0) {
      if (err_off != nullptr) *err_off = offs[t];
      return -1;
    }
    total += static_cast<int64_t>(parts[t].size());
  }
  if (total > capacity) return -1;
  auto* dst = static_cast<DacRecord*>(records_out);
  for (int t = 0; t < num_threads; ++t) {
    memcpy(dst, parts[t].data(), parts[t].size() * sizeof(DacRecord));
    dst += parts[t].size();
  }
  return total;
}

// Marshal a batch out of the record array: labels (B,) f32, dense (B,13)
// f32, sparse (B,26) i32 with id_shift subtracted (1-based file -> 0-based).
void dlrm_marshal_batch(const void* records, int64_t start, int64_t count,
                        float* labels, float* dense, int32_t* sparse,
                        int32_t id_shift) {
  const auto* recs = static_cast<const DacRecord*>(records) + start;
  for (int64_t i = 0; i < count; ++i) {
    labels[i] = static_cast<float>(recs[i].label);
    memcpy(dense + i * kDense, recs[i].dense, kDense * sizeof(float));
    for (int j = 0; j < kSparse; ++j) {
      sparse[i * kSparse + j] =
          static_cast<int32_t>(recs[i].cat[j]) - id_shift;
    }
  }
}

}  // extern "C"
