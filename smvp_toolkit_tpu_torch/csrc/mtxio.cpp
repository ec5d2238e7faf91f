// MatrixMarket coordinate-file parser of io/native.py, in host C++.
//
// A copy of the JAX package's native/mtxio.cpp with the same C signatures
// and one change: a coordinate is read as the Python reader reads it, a
// number truncated toward zero (so `1.0` and `1e0` name row 1), where the
// JAX package's native parser accepts digits only. The whole file is read
// in one call and tokenized with a branch-light scanner (no locale, no
// per-line stdio), filling caller-allocated numpy buffers directly.
//
// Semantics match io/mtx.py:read_mtx_raw for coordinate real/integer/
// pattern files: 1-based -> 0-based indices, pattern -> 1.0 values,
// '%' comment lines skipped. Array/complex files return ERR_UNSUPPORTED so
// the caller takes the Python parser. ops/_build.py compiles it with the
// host compiler on first use.

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum ErrorCode {
  OK = 0,
  ERR_OPEN = 1,
  ERR_NO_HEADER = 2,
  ERR_PREMATURE_EOF = 3,
  ERR_UNSUPPORTED = 4,
  ERR_BAD_DATA = 5,
};

enum Field { FIELD_REAL = 0, FIELD_INTEGER = 1, FIELD_PATTERN = 2, FIELD_COMPLEX = 3 };
enum Sym { SYM_GENERAL = 0, SYM_SYMMETRIC = 1, SYM_SKEW = 2, SYM_HERMITIAN = 3 };

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  ~FileBuf() { free(data); }
};

int read_file(const char* path, FileBuf* out, size_t limit = 0) {
  // limit > 0: read at most that many bytes (header-only probe — the
  // banner + size line sit in the leading comment block).
  FILE* f = fopen(path, "rb");
  if (!f) return ERR_OPEN;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  if (sz < 0) {
    fclose(f);
    return ERR_OPEN;
  }
  size_t want = static_cast<size_t>(sz);
  if (limit > 0 && want > limit) want = limit;
  fseek(f, 0, SEEK_SET);
  out->data = static_cast<char*>(malloc(want + 1));
  if (!out->data) {
    fclose(f);
    return ERR_OPEN;
  }
  size_t got = fread(out->data, 1, want, f);
  fclose(f);
  out->data[got] = '\0';
  out->size = got;
  return OK;
}

// Case-insensitive token match.
bool tok_eq(const char* tok, size_t len, const char* word) {
  size_t wl = strlen(word);
  if (len != wl) return false;
  for (size_t i = 0; i < len; i++) {
    if (tolower(static_cast<unsigned char>(tok[i])) != word[i]) return false;
  }
  return true;
}

struct Cursor {
  const char* p;
  const char* end;

  void skip_ws_and_comments() {
    while (p < end) {
      if (*p == '%') {  // comment to end of line
        while (p < end && *p != '\n') p++;
      } else if (isspace(static_cast<unsigned char>(*p))) {
        p++;
      } else {
        break;
      }
    }
  }

  bool next_token(const char** tok, size_t* len) {
    skip_ws_and_comments();
    if (p >= end) return false;
    const char* start = p;
    while (p < end && !isspace(static_cast<unsigned char>(*p))) p++;
    *tok = start;
    *len = static_cast<size_t>(p - start);
    return true;
  }

  // Fast positive/negative integer scan.
  bool next_int(long long* out) {
    skip_ws_and_comments();
    if (p >= end) return false;
    bool neg = false;
    if (*p == '-') {
      neg = true;
      p++;
    } else if (*p == '+') {
      p++;
    }
    if (p >= end || !isdigit(static_cast<unsigned char>(*p))) return false;
    long long v = 0;
    while (p < end && isdigit(static_cast<unsigned char>(*p))) {
      v = v * 10 + (*p - '0');
      p++;
    }
    *out = neg ? -v : v;
    return true;
  }

  // A coordinate as the Python reader takes it: the token read as a
  // number and truncated toward zero. Up to 12 digits take the integer
  // scan; anything else ("1.0", "1e0", a sign and a fraction) goes through
  // strtod. A value outside int32 becomes -1, which the caller's bounds
  // check refuses, as it refuses the Python reader's wrapped cast.
  bool next_index(long long* out) {
    skip_ws_and_comments();
    if (p >= end) return false;
    const char* start = p;
    long long v;
    if (next_int(&v) && p - start <= 12 &&
        (p >= end || isspace(static_cast<unsigned char>(*p)))) {
      *out = (v >= -2147483648LL && v <= 2147483647LL) ? v : -1;
      return true;
    }
    p = start;
    char* stop = nullptr;
    double d = strtod(p, &stop);
    if (stop == p) return false;
    p = stop;
    *out = (d > -2147483649.0 && d < 2147483648.0)
               ? static_cast<long long>(d)
               : -1;
    return true;
  }

  // Double scan via strtod (handles exponents, inf/nan); strtod stops at
  // whitespace so it is safe on the in-memory buffer (NUL-terminated).
  bool next_double(double* out) {
    skip_ws_and_comments();
    if (p >= end) return false;
    char* stop = nullptr;
    double v = strtod(p, &stop);
    if (stop == p) return false;
    p = stop;
    *out = v;
    return true;
  }
};

int parse_banner(Cursor* cur, int* field, int* sym) {
  // First line must start with %%MatrixMarket (mmio.c:104-115 semantics).
  const char* p = cur->p;
  const char* end = cur->end;
  if (end - p < 14 || strncmp(p, "%%MatrixMarket", 14) != 0) return ERR_NO_HEADER;
  cur->p += 14;
  // Read 4 banner words from the rest of the line (manually — the comment
  // skipper would eat them because the line starts with '%').
  const char* line_end = cur->p;
  while (line_end < end && *line_end != '\n') line_end++;
  Cursor line{cur->p, line_end};
  const char* tok;
  size_t len;
  const char* words[4];
  size_t lens[4];
  for (int i = 0; i < 4; i++) {
    // No comments inside the banner line; plain token scan.
    while (line.p < line.end && isspace(static_cast<unsigned char>(*line.p))) line.p++;
    if (line.p >= line.end) return ERR_PREMATURE_EOF;
    const char* start = line.p;
    while (line.p < line.end && !isspace(static_cast<unsigned char>(*line.p))) line.p++;
    words[i] = start;
    lens[i] = static_cast<size_t>(line.p - start);
  }
  (void)tok;
  (void)len;
  if (!tok_eq(words[0], lens[0], "matrix")) return ERR_UNSUPPORTED;
  if (!tok_eq(words[1], lens[1], "coordinate")) return ERR_UNSUPPORTED;
  if (tok_eq(words[2], lens[2], "real")) *field = FIELD_REAL;
  else if (tok_eq(words[2], lens[2], "integer")) *field = FIELD_INTEGER;
  else if (tok_eq(words[2], lens[2], "pattern")) *field = FIELD_PATTERN;
  else if (tok_eq(words[2], lens[2], "complex")) return ERR_UNSUPPORTED;
  else return ERR_UNSUPPORTED;
  if (tok_eq(words[3], lens[3], "general")) *sym = SYM_GENERAL;
  else if (tok_eq(words[3], lens[3], "symmetric")) *sym = SYM_SYMMETRIC;
  else if (tok_eq(words[3], lens[3], "skew-symmetric")) *sym = SYM_SKEW;
  else if (tok_eq(words[3], lens[3], "hermitian")) *sym = SYM_HERMITIAN;
  else return ERR_UNSUPPORTED;
  cur->p = line_end;
  return OK;
}

}  // namespace

extern "C" {

// Parse banner + size line. Returns an ErrorCode.
int mtx_read_header(const char* path, long long* rows, long long* cols,
                    long long* nnz, int* field, int* sym) {
  FileBuf buf;
  // 1 MiB covers any sane banner/comment block without pulling the
  // whole payload into memory twice.
  int rc = read_file(path, &buf, 1 << 20);
  if (rc != OK) return rc;
  if (buf.size == 0) return ERR_PREMATURE_EOF;
  Cursor cur{buf.data, buf.data + buf.size};
  rc = parse_banner(&cur, field, sym);
  if (rc != OK) return rc;
  long long m, n, k;
  if (!cur.next_int(&m) || !cur.next_int(&n) || !cur.next_int(&k))
    return ERR_PREMATURE_EOF;
  *rows = m;
  *cols = n;
  *nnz = k;
  return OK;
}

// Parse the coordinate payload into caller-allocated buffers
// (int32 r/c 0-based, float64 v; pattern files get v = 1.0).
int mtx_read_coo(const char* path, long long nnz, int field, int32_t* r,
                 int32_t* c, double* v) {
  FileBuf buf;
  int rc = read_file(path, &buf);
  if (rc != OK) return rc;
  Cursor cur{buf.data, buf.data + buf.size};
  int f_ignored, s_ignored;
  rc = parse_banner(&cur, &f_ignored, &s_ignored);
  if (rc != OK) return rc;
  long long m, n, k;
  if (!cur.next_int(&m) || !cur.next_int(&n) || !cur.next_int(&k))
    return ERR_PREMATURE_EOF;
  for (long long i = 0; i < nnz; i++) {
    long long ri, ci;
    if (!cur.next_index(&ri) || !cur.next_index(&ci)) return ERR_PREMATURE_EOF;
    r[i] = static_cast<int32_t>(ri - 1);
    c[i] = static_cast<int32_t>(ci - 1);
    if (field == FIELD_PATTERN) {
      v[i] = 1.0;
    } else {
      double val;
      if (!cur.next_double(&val)) return ERR_PREMATURE_EOF;
      v[i] = val;
    }
  }
  return OK;
}

}  // extern "C"
