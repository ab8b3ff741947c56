// Native graph IO: MatrixMarket / edge-list parsing + CSR construction.
//
// TPU-native equivalent of the reference's C++ IO layer (sample/IO.h
// ReadASCII/ReadBinary + CSC→CSR conversion, sample/CSC.h:147-190 and
// sample/CSR.h:155-186) — built from scratch: mmap the file, parse with
// OpenMP over newline-aligned chunks, counting-sort straight to CSR (no
// CSC intermediate), parallel per-row column sort.  Python binds via
// ctypes (force2vec_tpu/graphs/native.py); at com-Orkut scale (117M
// edges) the pure-numpy reader is minutes, this is seconds.
//
// Semantics match sample/IO.h:60-156: a `symmetric` header mirrors every
// off-diagonal entry and drops self-loops; a missing value column means
// weight 1.0; duplicates are kept as distinct nonzeros.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.size = static_cast<size_t>(st.st_size);
  void* p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  return m;
}

void unmap_file(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  bool neg = (p < end && *p == '-');
  if (neg) ++p;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_f32(const char* p, const char* end, float* out) {
  p = skip_ws(p, end);
  char* q = nullptr;
  *out = strtof(p, &q);
  return (q && q <= end) ? q : p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Parsed COO edges for one thread's file chunk.
struct CooChunk {
  std::vector<int64_t> rows, cols;
  std::vector<float> vals;
};

// Parse [begin, stop) line-aligned region: `ncols` numeric columns per line.
void parse_region(const char* begin, const char* stop, int ncols, bool has_vals,
                  CooChunk* out) {
  const char* p = begin;
  while (p < stop) {
    p = skip_ws(p, stop);
    if (p >= stop) break;
    if (*p == '%' || *p == '#' || *p == '\n') {
      p = next_line(p, stop);
      continue;
    }
    int64_t r, c;
    p = parse_i64(p, stop, &r);
    p = parse_i64(p, stop, &c);
    float v = 1.0f;
    if (ncols >= 3 && has_vals) p = parse_f32(p, stop, &v);
    out->rows.push_back(r);
    out->cols.push_back(c);
    if (has_vals) out->vals.push_back(v);
    p = next_line(p, stop);
  }
}

struct Graph {
  int64_t n = 0;
  int64_t nnz = 0;
  std::vector<int64_t> rowptr;
  std::vector<int32_t> colids;
  std::vector<float> values;  // empty when the file carries no values
};

// COO (possibly with mirror flag) → CSR with per-row sorted columns.
void coo_to_csr(const std::vector<CooChunk>& chunks, int64_t n, bool mirror,
                bool drop_self, bool has_vals, Graph* g) {
  int64_t total = 0;
  for (const auto& ch : chunks) {
    for (size_t i = 0; i < ch.rows.size(); ++i) {
      bool self = ch.rows[i] == ch.cols[i];
      if (self && drop_self) continue;
      total += (mirror && !self) ? 2 : 1;
    }
  }
  g->n = n;
  g->nnz = total;
  g->rowptr.assign(n + 1, 0);
  // count
  for (const auto& ch : chunks) {
    for (size_t i = 0; i < ch.rows.size(); ++i) {
      int64_t r = ch.rows[i], c = ch.cols[i];
      if (r == c) {
        if (drop_self) continue;
        g->rowptr[r + 1]++;
      } else {
        g->rowptr[r + 1]++;
        if (mirror) g->rowptr[c + 1]++;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) g->rowptr[i + 1] += g->rowptr[i];
  // scatter
  g->colids.resize(total);
  if (has_vals) g->values.resize(total);
  std::vector<int64_t> cursor(g->rowptr.begin(), g->rowptr.end() - 1);
  for (const auto& ch : chunks) {
    for (size_t i = 0; i < ch.rows.size(); ++i) {
      int64_t r = ch.rows[i], c = ch.cols[i];
      float v = has_vals ? ch.vals[i] : 1.0f;
      if (r == c) {
        if (drop_self) continue;
        int64_t k = cursor[r]++;
        g->colids[k] = static_cast<int32_t>(c);
        if (has_vals) g->values[k] = v;
      } else {
        int64_t k = cursor[r]++;
        g->colids[k] = static_cast<int32_t>(c);
        if (has_vals) g->values[k] = v;
        if (mirror) {
          int64_t k2 = cursor[c]++;
          g->colids[k2] = static_cast<int32_t>(r);
          if (has_vals) g->values[k2] = v;
        }
      }
    }
  }
  // per-row column sort (values follow their column)
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1024)
#endif
  for (int64_t r = 0; r < n; ++r) {
    int64_t s = g->rowptr[r], e = g->rowptr[r + 1];
    if (e - s <= 1) continue;
    if (has_vals) {
      std::vector<std::pair<int32_t, float>> tmp(e - s);
      for (int64_t i = s; i < e; ++i) tmp[i - s] = {g->colids[i], g->values[i]};
      std::sort(tmp.begin(), tmp.end());
      for (int64_t i = s; i < e; ++i) {
        g->colids[i] = tmp[i - s].first;
        g->values[i] = tmp[i - s].second;
      }
    } else {
      std::sort(g->colids.begin() + s, g->colids.begin() + e);
    }
  }
}

// Parse the body region in parallel over newline-aligned chunks.
std::vector<CooChunk> parse_parallel(const char* body, const char* end,
                                     int ncols, bool has_vals) {
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  size_t len = static_cast<size_t>(end - body);
  if (len < (1u << 20)) nthreads = 1;  // small file: skip the fork
  std::vector<CooChunk> chunks(nthreads);
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads)
#endif
  {
    int t = 0;
#ifdef _OPENMP
    t = omp_get_thread_num();
#endif
    const char* b = body + len * t / nthreads;
    const char* e = body + len * (t + 1) / nthreads;
    if (t > 0) b = next_line(b, end);  // align to line starts
    if (t + 1 < nthreads) e = next_line(e, end);
    parse_region(b, e, ncols, has_vals, &chunks[t]);
  }
  return chunks;
}

}  // namespace

extern "C" {

// Opaque handle returned to Python; freed with graphio_free.
struct GraphHandle {
  Graph g;
};

// Load a MatrixMarket coordinate file.  Returns nullptr on failure.
// has_values_out: 1 if the file carried a value column.
GraphHandle* graphio_load_mtx(const char* path, int32_t* has_values_out) {
  Mapped m = map_file(path);
  if (!m.ok()) return nullptr;
  const char* p = m.data;
  const char* end = m.data + m.size;

  // header line: %%MatrixMarket matrix coordinate <field> <symmetry>
  const char* hdr_end = p;
  while (hdr_end < end && *hdr_end != '\n') ++hdr_end;
  bool symmetric = memmem(p, hdr_end - p, "symmetric", 9) != nullptr;
  bool pattern = memmem(p, hdr_end - p, "pattern", 7) != nullptr;
  p = next_line(p, end);
  // skip comments
  while (p < end && *p == '%') p = next_line(p, end);
  int64_t nrows, ncols_mat, nnz_decl;
  p = parse_i64(p, end, &nrows);
  p = parse_i64(p, end, &ncols_mat);
  p = parse_i64(p, end, &nnz_decl);
  p = next_line(p, end);

  bool has_vals = !pattern;
  auto chunks = parse_parallel(p, end, has_vals ? 3 : 2, has_vals);
  // 1-based → 0-based
  for (auto& ch : chunks)
    for (size_t i = 0; i < ch.rows.size(); ++i) {
      ch.rows[i] -= 1;
      ch.cols[i] -= 1;
    }
  unmap_file(m);

  auto* h = new GraphHandle();
  int64_t n = nrows > ncols_mat ? nrows : ncols_mat;
  // symmetric: mirror off-diagonals, drop self-loops (sample/IO.h:130-134)
  coo_to_csr(chunks, n, /*mirror=*/symmetric, /*drop_self=*/symmetric,
             has_vals, &h->g);
  if (has_values_out) *has_values_out = has_vals ? 1 : 0;
  return h;
}

// Load a whitespace edge list (u v [w]).  zero_based: ids start at 0.
GraphHandle* graphio_load_edgelist(const char* path, int32_t zero_based,
                                   int32_t symmetrize, int32_t drop_self,
                                   int32_t* has_values_out) {
  Mapped m = map_file(path);
  if (!m.ok()) return nullptr;
  // Column sniff: first non-comment line.
  const char* p = m.data;
  const char* end = m.data + m.size;
  while (p < end && (*p == '%' || *p == '#')) p = next_line(p, end);
  int cols_in_line = 0;
  {
    const char* q = p;
    const char* le = q;
    while (le < end && *le != '\n') ++le;
    bool in_tok = false;
    for (; q < le; ++q) {
      bool sp = (*q == ' ' || *q == '\t' || *q == '\r');
      if (!sp && !in_tok) {
        cols_in_line++;
        in_tok = true;
      } else if (sp) {
        in_tok = false;
      }
    }
  }
  bool has_vals = cols_in_line >= 3;
  auto chunks = parse_parallel(m.data, end, has_vals ? 3 : 2, has_vals);
  unmap_file(m);

  int64_t n = 0;
  for (auto& ch : chunks)
    for (size_t i = 0; i < ch.rows.size(); ++i) {
      if (!zero_based) {
        ch.rows[i] -= 1;
        ch.cols[i] -= 1;
      }
      if (ch.rows[i] >= n) n = ch.rows[i] + 1;
      if (ch.cols[i] >= n) n = ch.cols[i] + 1;
    }

  auto* h = new GraphHandle();
  coo_to_csr(chunks, n, /*mirror=*/symmetrize != 0, /*drop_self=*/drop_self != 0,
             has_vals, &h->g);
  if (has_values_out) *has_values_out = has_vals ? 1 : 0;
  return h;
}

// Write a text .embd file — header "N D", then "id+1 v0 … vD-1 \n" per
// node (schema of algorithms::writeToFile, sample/algorithms.h:118-136).
// OpenMP-parallel formatting into per-thread buffers, one write each; at
// com-Orkut scale (3M x 128) the per-row Python formatting path is minutes,
// this is ~a second.  Returns 0 on success.
int32_t graphio_write_embd(const char* path, const float* emb, int64_t n,
                           int64_t d) {
  FILE* f = fopen(path, "w");
  if (!f) return 1;
  fprintf(f, "%lld %lld\n", static_cast<long long>(n),
          static_cast<long long>(d));
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::string> bufs(nthreads);
  int32_t err = 0;
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads)
#endif
  {
    int t = 0;
#ifdef _OPENMP
    t = omp_get_thread_num();
#endif
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    std::string& buf = bufs[t];
    buf.reserve(static_cast<size_t>((hi - lo) * (d * 10 + 12)));
    char tmp[48];
    for (int64_t i = lo; i < hi; ++i) {
      int len = snprintf(tmp, sizeof tmp, "%lld", static_cast<long long>(i + 1));
      buf.append(tmp, len);
      const float* row = emb + i * d;
      for (int64_t j = 0; j < d; ++j) {
        tmp[0] = ' ';
        len = snprintf(tmp + 1, sizeof tmp - 1, "%.6g",
                       static_cast<double>(row[j]));
        buf.append(tmp, len + 1);
      }
      buf.append(" \n", 2);
    }
  }
  for (auto& buf : bufs) {
    if (!buf.empty() && fwrite(buf.data(), 1, buf.size(), f) != buf.size())
      err = 2;
  }
  if (fclose(f) != 0) err = 3;
  return err;
}

int64_t graphio_n(GraphHandle* h) { return h->g.n; }
int64_t graphio_nnz(GraphHandle* h) { return h->g.nnz; }
const int64_t* graphio_rowptr(GraphHandle* h) { return h->g.rowptr.data(); }
const int32_t* graphio_colids(GraphHandle* h) { return h->g.colids.data(); }
const float* graphio_values(GraphHandle* h) {
  return h->g.values.empty() ? nullptr : h->g.values.data();
}
void graphio_free(GraphHandle* h) { delete h; }

}  // extern "C"
