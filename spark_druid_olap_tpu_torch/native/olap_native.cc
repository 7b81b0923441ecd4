// Host-side CSV decode for the PyTorch/CUDA port: a single-pass CSV parser
// with per-column type inference and sorted-unique dictionary encoding (the
// encoding catalog/segment.py's DimensionDict produces), so a CSV file
// arrives as the int64 / float64 columns and int32 rank codes the segment
// builder uploads to the card.  The port keeps its own copy of the JAX
// package's decoder; this copy adds an error kind (olap_csv_error_kind), so
// the caller can tell a file the parser cannot take (ragged rows, an
// unterminated quote, no header: it reads the file with pandas and records
// why) from an I/O failure (which raises); and it builds its columns on
// several threads, each column's numbers parsed once (the same results as
// the one-thread build).
//
// Exposed as a plain C ABI consumed via ctypes.  Column-major results;
// numeric columns are written straight into caller (numpy) buffers, string
// columns come back as int32 rank codes plus a sorted dictionary.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <deque>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Field {
  // View into the file buffer; materialized into `arena` when the field
  // contained quote escapes ("" -> ").
  const char* ptr;
  int64_t len;
};

enum ColType : int {
  COL_INT64 = 0,
  COL_DOUBLE = 1,
  COL_STRING = 2,  // dictionary-encoded
};

struct Column {
  std::string name;
  ColType type = COL_STRING;
  // exactly one of these is populated after finish():
  std::vector<int64_t> i64;
  std::vector<double> f64;
  std::vector<int32_t> codes;          // rank codes, -1 = null
  std::vector<std::string> dict;       // sorted unique values
};

// what olap_csv_error_kind reports
enum ErrorKind : int {
  ERR_NONE = 0,
  ERR_SHAPE = 1,  // a file this parser does not take (pandas may)
  ERR_IO = 2,     // the file could not be read
};

struct CsvTable {
  std::string error;
  int error_kind = ERR_NONE;
  std::string buf;                     // whole file
  // Unescaped quoted fields live here.  Field.ptr points INTO these strings,
  // so the container must never move elements — deque (stable addresses on
  // push_back), not vector.
  std::deque<std::string> arena;
  std::vector<Column> cols;
  int64_t num_rows = 0;
};

// pandas' default na_values set: these read as null in every column type
// (the python fallback is pd.read_csv — inference must not fork from it).
bool is_null_field(const char* p, int64_t len) {
  if (len == 0) return true;
  if (len > 9) return false;
  struct Na {
    const char* s;
    int64_t n;
  };
  static const Na kNa[] = {
      {"#N/A", 4}, {"#N/A N/A", 8}, {"#NA", 3}, {"-1.#IND", 7},
      {"-1.#QNAN", 8}, {"-NaN", 4}, {"-nan", 4}, {"1.#IND", 6},
      {"1.#QNAN", 7}, {"<NA>", 4}, {"N/A", 3}, {"NA", 2},
      {"NULL", 4}, {"NaN", 3}, {"None", 4}, {"n/a", 3},
      {"nan", 3}, {"null", 4}};
  for (const Na& s : kNa) {
    if (s.n == len && memcmp(p, s.s, (size_t)len) == 0) return true;
  }
  return false;
}

bool parse_i64(const char* p, int64_t len, int64_t* out) {
  if (len == 0) return false;
  char tmp[32];
  if (len >= (int64_t)sizeof(tmp)) return false;
  memcpy(tmp, p, len);
  tmp[len] = 0;
  char* end = nullptr;
  errno = 0;
  long long v = strtoll(tmp, &end, 10);
  if (errno != 0 || end != tmp + len) return false;
  *out = (int64_t)v;
  return true;
}

bool parse_f64(const char* p, int64_t len, double* out) {
  if (len == 0) return false;
  char tmp[64];
  if (len >= (int64_t)sizeof(tmp)) return false;
  memcpy(tmp, p, len);
  tmp[len] = 0;
  char* end = nullptr;
  errno = 0;
  double v = strtod(tmp, &end);
  if (end != tmp + len) return false;
  *out = v;
  return true;
}

// Single-pass RFC4180-ish tokenizer: quoted fields may contain commas,
// newlines, and doubled quotes.  Fills row-major `fields`; returns column
// count from the header row.
// the bytes that end an unquoted field
struct StopTable {
  bool v[256] = {};
  StopTable() { v[(unsigned char)','] = v[(unsigned char)'\n'] = v[(unsigned char)'\r'] = true; }
  bool operator[](unsigned char c) const { return v[c]; }
};
const StopTable kStop;

bool tokenize(CsvTable* t, std::vector<Field>* fields, int* ncols_out) {
  const char* p = t->buf.data();
  const char* end = p + t->buf.size();
  std::vector<Field> row;
  int ncols = -1;
  bool header_done = false;
  std::vector<std::string> names;

  while (p < end) {
    // parse one field
    Field f{p, 0};
    if (*p == '"') {
      ++p;
      const char* start = p;
      bool escaped = false;
      while (p < end) {
        if (*p == '"') {
          if (p + 1 < end && p[1] == '"') { escaped = true; p += 2; continue; }
          break;
        }
        ++p;
      }
      if (p >= end) {
        t->error = "unterminated quoted field";
        t->error_kind = ERR_SHAPE;
        return false;
      }
      if (!escaped) {
        f.ptr = start;
        f.len = p - start;
      } else {
        std::string s;
        s.reserve(p - start);
        for (const char* q = start; q < p; ++q) {
          s.push_back(*q);
          if (*q == '"') ++q;  // skip the doubled quote
        }
        t->arena.push_back(std::move(s));
        f.ptr = t->arena.back().data();
        f.len = (int64_t)t->arena.back().size();
      }
      ++p;  // closing quote
    } else {
      const char* start = p;
      while (p < end && !kStop[(unsigned char)*p]) ++p;
      f.ptr = start;
      f.len = p - start;
    }
    row.push_back(f);

    bool end_of_row = false;
    if (p < end && *p == ',') {
      ++p;
      // trailing comma then EOF => one empty final field
      if (p == end) { row.push_back(Field{p, 0}); end_of_row = true; }
    } else {
      if (p < end && *p == '\r') ++p;
      if (p < end && *p == '\n') ++p;
      end_of_row = true;
    }

    if (end_of_row) {
      if (!header_done) {
        ncols = (int)row.size();
        for (auto& h : row) names.emplace_back(h.ptr, (size_t)h.len);
        header_done = true;
        // room for a row per remaining line (more where quoted fields
        // hold newlines: the vector grows as it would have)
        size_t lines = 1;
        for (const char* q = p; (q = (const char*)memchr(q, '\n', end - q)) != nullptr; ++q)
          ++lines;
        fields->reserve(lines * (size_t)ncols);
      } else {
        if ((int)row.size() != ncols) {
          // tolerate a trailing blank line
          if (row.size() == 1 && row[0].len == 0 && p >= end) { row.clear(); break; }
          t->error = "row with " + std::to_string(row.size()) +
                     " fields, expected " + std::to_string(ncols);
          t->error_kind = ERR_SHAPE;
          return false;
        }
        for (auto& f2 : row) fields->push_back(f2);
        ++t->num_rows;
      }
      row.clear();
    }
  }
  if (!row.empty()) {  // file ended without newline mid-row
    if ((int)row.size() == ncols) {
      for (auto& f2 : row) fields->push_back(f2);
      ++t->num_rows;
    } else if (!(row.size() == 1 && row[0].len == 0)) {
      t->error = "ragged final row";
      t->error_kind = ERR_SHAPE;
      return false;
    }
  }
  if (ncols <= 0) {
    t->error = "empty file / no header";
    t->error_kind = ERR_SHAPE;
    return false;
  }
  t->cols.resize(ncols);
  for (int c = 0; c < ncols; ++c) t->cols[c].name = names[c];
  *ncols_out = ncols;
  return true;
}

// Arena-stable string_view substitute (pre-C++17-string_view-in-map safety).
struct SV {
  const char* p;
  int64_t n;
  bool operator==(const SV& o) const {
    return n == o.n && memcmp(p, o.p, (size_t)n) == 0;
  }
};
struct SVHash {
  size_t operator()(const SV& s) const {
    // FNV-1a
    size_t h = 1469598103934665603ull;
    for (int64_t i = 0; i < s.n; ++i) {
      h ^= (unsigned char)s.p[i];
      h *= 1099511628211ull;
    }
    return h;
  }
};

// One column: infer its type, then fill it.  The numbers parsed while
// inferring are kept, so a numeric field is parsed once (the rows before a
// column's first non-integer field, parsed as integers then, are parsed
// again as doubles where the column ends up double).
void build_column(CsvTable* t, const std::vector<Field>& fields, int ncols, int c) {
  const int64_t R = t->num_rows;
  Column& col = t->cols[c];
  bool all_int = true, all_num = true, any_null = false, any_val = false;
  std::vector<int64_t> ivals((size_t)R);
  std::vector<double> dvals;
  int64_t first_double = R;  // first row parsed as a double
  for (int64_t r = 0; r < R; ++r) {
    const Field& f = fields[(size_t)r * ncols + c];
    if (is_null_field(f.ptr, f.len)) { any_null = true; continue; }
    any_val = true;
    if (all_int && !parse_i64(f.ptr, f.len, &ivals[r])) {
      all_int = false;
      first_double = r;
      dvals.resize((size_t)R);
    }
    if (!all_int && !parse_f64(f.ptr, f.len, &dvals[r])) {
      all_num = false;
      break;
    }
  }
  if (!any_val) { all_int = all_num = false; }  // all-null -> string/null col

  if (all_int && !any_null) {
    col.type = COL_INT64;
    col.i64 = std::move(ivals);
  } else if (all_num) {
    // ints-with-nulls also land here (pandas parity: NaN promotes to float)
    col.type = COL_DOUBLE;
    col.f64.resize(R);
    for (int64_t r = 0; r < R; ++r) {
      const Field& f = fields[(size_t)r * ncols + c];
      double dv;
      if (is_null_field(f.ptr, f.len)) {
        col.f64[r] = NAN;
      } else if (r >= first_double) {
        col.f64[r] = dvals[r];
      } else {
        col.f64[r] = parse_f64(f.ptr, f.len, &dv) ? dv : NAN;
      }
    }
  } else {
    col.type = COL_STRING;
    col.codes.resize(R);
    std::unordered_map<SV, int32_t, SVHash> seen;
    std::vector<SV> uniq;
    std::vector<int32_t> tmp((size_t)R);
    for (int64_t r = 0; r < R; ++r) {
      const Field& f = fields[(size_t)r * ncols + c];
      if (is_null_field(f.ptr, f.len)) { tmp[r] = -1; continue; }
      SV sv{f.ptr, f.len};
      auto it = seen.find(sv);
      if (it == seen.end()) {
        int32_t id = (int32_t)uniq.size();
        seen.emplace(sv, id);
        uniq.push_back(sv);
        tmp[r] = id;
      } else {
        tmp[r] = it->second;
      }
    }
    // sorted-unique dictionary + rank remap (DimensionDict contract:
    // codes are ranks in the sorted value domain, so bound filters on
    // strings push down as integer ranges on codes)
    std::vector<int32_t> order((size_t)uniq.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
    std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
      const SV &x = uniq[a], &y = uniq[b];
      int cmp = memcmp(x.p, y.p, (size_t)std::min(x.n, y.n));
      if (cmp != 0) return cmp < 0;
      return x.n < y.n;
    });
    std::vector<int32_t> rank((size_t)uniq.size());
    col.dict.resize(uniq.size());
    for (size_t i = 0; i < order.size(); ++i) {
      rank[(size_t)order[i]] = (int32_t)i;
      col.dict[i].assign(uniq[(size_t)order[i]].p,
                         (size_t)uniq[(size_t)order[i]].n);
    }
    for (int64_t r = 0; r < R; ++r)
      col.codes[r] = tmp[r] < 0 ? -1 : rank[(size_t)tmp[r]];
  }
}

// Columns are independent: they build on up to kMaxThreads threads, each
// taking every n-th column, so the result is the same at any thread count.
constexpr unsigned kMaxThreads = 16;

void infer_and_build(CsvTable* t, const std::vector<Field>& fields, int ncols) {
  unsigned n = std::min<unsigned>(
      {(unsigned)ncols, std::max(1u, std::thread::hardware_concurrency()), kMaxThreads});
  if (n <= 1 || t->num_rows < 4096) {
    for (int c = 0; c < ncols; ++c) build_column(t, fields, ncols, c);
    return;
  }
  std::vector<std::thread> pool;
  for (unsigned i = 0; i < n; ++i)
    pool.emplace_back([=, &fields] {
      for (int c = (int)i; c < ncols; c += (int)n) build_column(t, fields, ncols, c);
    });
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void* olap_csv_read(const char* path) {
  auto t = std::make_unique<CsvTable>();
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    t->error = std::string("cannot open ") + path;
    t->error_kind = ERR_IO;
    return t.release();
  }
  fseek(fp, 0, SEEK_END);
  long sz = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  t->buf.resize((size_t)sz);
  if (sz > 0 && fread(&t->buf[0], 1, (size_t)sz, fp) != (size_t)sz) {
    fclose(fp);
    t->error = "short read";
    t->error_kind = ERR_IO;
    return t.release();
  }
  fclose(fp);

  std::vector<Field> fields;
  int ncols = 0;
  if (!tokenize(t.get(), &fields, &ncols)) return t.release();
  infer_and_build(t.get(), fields, ncols);
  return t.release();
}

const char* olap_csv_error(void* h) {
  auto* t = (CsvTable*)h;
  return t->error.empty() ? nullptr : t->error.c_str();
}

int olap_csv_error_kind(void* h) { return ((CsvTable*)h)->error_kind; }

long long olap_csv_num_rows(void* h) { return ((CsvTable*)h)->num_rows; }
int olap_csv_num_cols(void* h) { return (int)((CsvTable*)h)->cols.size(); }

const char* olap_csv_col_name(void* h, int c) {
  return ((CsvTable*)h)->cols[c].name.c_str();
}

int olap_csv_col_type(void* h, int c) {
  return (int)((CsvTable*)h)->cols[c].type;
}

void olap_csv_col_int64(void* h, int c, long long* out) {
  auto& col = ((CsvTable*)h)->cols[c];
  memcpy(out, col.i64.data(), col.i64.size() * sizeof(long long));
}

void olap_csv_col_double(void* h, int c, double* out) {
  auto& col = ((CsvTable*)h)->cols[c];
  memcpy(out, col.f64.data(), col.f64.size() * sizeof(double));
}

void olap_csv_col_codes(void* h, int c, int32_t* out) {
  auto& col = ((CsvTable*)h)->cols[c];
  memcpy(out, col.codes.data(), col.codes.size() * sizeof(int32_t));
}

int olap_csv_dict_size(void* h, int c) {
  return (int)((CsvTable*)h)->cols[c].dict.size();
}

const char* olap_csv_dict_value(void* h, int c, int i) {
  return ((CsvTable*)h)->cols[c].dict[i].c_str();
}

void olap_csv_free(void* h) { delete (CsvTable*)h; }

// ---------------------------------------------------------------------------
// Standalone dictionary encoder: char** values -> sorted dict + rank codes.
// Used to accelerate DimensionDict.build/encode for in-memory object columns.
// ---------------------------------------------------------------------------

struct DictResult {
  std::vector<int32_t> codes;
  std::vector<std::string> dict;
};

void* olap_dict_encode(const char** vals, long long n) {
  auto r = std::make_unique<DictResult>();
  r->codes.resize((size_t)n);
  std::unordered_map<SV, int32_t, SVHash> seen;
  std::vector<SV> uniq;
  std::vector<int32_t> tmp((size_t)n);
  for (long long i = 0; i < n; ++i) {
    if (vals[i] == nullptr) { tmp[i] = -1; continue; }
    SV sv{vals[i], (int64_t)strlen(vals[i])};
    auto it = seen.find(sv);
    if (it == seen.end()) {
      int32_t id = (int32_t)uniq.size();
      seen.emplace(sv, id);
      uniq.push_back(sv);
      tmp[i] = id;
    } else {
      tmp[i] = it->second;
    }
  }
  std::vector<int32_t> order((size_t)uniq.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    const SV &x = uniq[a], &y = uniq[b];
    int cmp = memcmp(x.p, y.p, (size_t)std::min(x.n, y.n));
    if (cmp != 0) return cmp < 0;
    return x.n < y.n;
  });
  std::vector<int32_t> rank((size_t)uniq.size());
  r->dict.resize(uniq.size());
  for (size_t i = 0; i < order.size(); ++i) {
    rank[(size_t)order[i]] = (int32_t)i;
    r->dict[i].assign(uniq[(size_t)order[i]].p, (size_t)uniq[(size_t)order[i]].n);
  }
  for (long long i = 0; i < n; ++i)
    r->codes[(size_t)i] = tmp[i] < 0 ? -1 : rank[(size_t)tmp[i]];
  return r.release();
}

void olap_dict_codes(void* h, int32_t* out) {
  auto* r = (DictResult*)h;
  memcpy(out, r->codes.data(), r->codes.size() * sizeof(int32_t));
}

int olap_dict_size(void* h) { return (int)((DictResult*)h)->dict.size(); }

const char* olap_dict_value(void* h, int i) {
  return ((DictResult*)h)->dict[i].c_str();
}

void olap_dict_free(void* h) { delete (DictResult*)h; }

int olap_abi_version() { return 2; }

}  // extern "C"
