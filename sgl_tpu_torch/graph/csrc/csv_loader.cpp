// Native CSV / csv.gz parser of sgl_tpu_torch's dataset layer.
//
// The OGB raw files (edge lists, node features, labels, splits) are
// headerless numeric csv, mostly gzipped; at ogbn-products scale (124M
// edge lines, 2.4M x 100 feature rows) numpy.loadtxt is the slowest host
// step of ingestion.  This parser splits the text into chunks at line
// boundaries and parses each chunk's segments in parallel with OpenMP,
// using hand-rolled integer and float scanners.  With zlib (built with
// -DSGL_CSV_ZLIB -lz) it streams the file itself through gzread (plain
// files pass through unchanged), a reader thread inflating chunk i+1
// while chunk i parses; without it, the caller decompresses and hands
// the text over in memory.  Built with g++ at first use and loaded with
// ctypes by sgl_tpu_torch/graph/native.py, whose callers fall back to
// numpy.loadtxt.
//
// C ABI:
//   int64_t sgl_csv_parse(text, n_bytes, dtype /*0=f32, 1=i64*/,
//                         &data, &rows, &cols)
//   int64_t sgl_csv_load(path, dtype, &data, &rows, &cols)  // zlib builds
//   int     sgl_csv_has_zlib()                             // 1 with zlib
//     -> 0 on success; data is malloc'd row-major [rows x cols], released
//        with sgl_buf_free.  Negative codes: -1 open or read failure,
//        -2 parse error (ragged row, non-numeric field, a line over 4 MiB),
//        -3 out of memory, -4 unknown dtype, -5 no zlib in this build.
//   void sgl_buf_free(void* p)

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <future>
#include <vector>

#ifdef SGL_CSV_ZLIB
#include <zlib.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
#endif

namespace {

// Scanners for the OGB numeric csv dialect: optional sign, digits,
// optional fraction and exponent; fields separated by ',' and rows by
// '\n' (with optional '\r').  Spaces and tabs around a field are skipped.

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline bool parse_i64(const char*& p, const char* end, int64_t& out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  if (p >= end || *p < '0' || *p > '9') return false;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  out = neg ? -v : v;
  p = skip_ws(p, end);
  return true;
}

// exact double powers of ten (10^k is exactly representable for k <= 22)
static const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline bool parse_f32(const char*& p, const char* end, float& out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  const char* digits_start = p;
  // every significant digit goes into one uint64 (19 digits are exact);
  // the decimal point and any digits past 19 only move the power of ten,
  // so the double is within one rounding of the true value and its f32
  // rounding agrees with strtof's in practice
  uint64_t mant = 0;
  int n_digits = 0;
  int e10 = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    any = true;
    if (n_digits < 19) {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      ++n_digits;
    } else {
      ++e10;
    }
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      any = true;
      if (n_digits < 19) {
        mant = mant * 10 + static_cast<uint64_t>(*p - '0');
        ++n_digits;
        --e10;
      }
      ++p;
    }
  }
  if (!any && p == digits_start) {
    // nan / inf, as numpy.loadtxt reads them
    if (end - p >= 3 && (std::strncmp(p, "nan", 3) == 0 || std::strncmp(p, "NaN", 3) == 0)) {
      p += 3;
      out = std::nanf("");
      p = skip_ws(p, end);
      return true;
    }
    if (end - p >= 3 && (std::strncmp(p, "inf", 3) == 0 || std::strncmp(p, "Inf", 3) == 0)) {
      p += 3;
      out = neg ? -INFINITY : INFINITY;
      p = skip_ws(p, end);
      return true;
    }
    return false;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
    if (p >= end || *p < '0' || *p > '9') return false;
    int ev = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      if (ev < 100000) ev = ev * 10 + (*p - '0');
      ++p;
    }
    e10 += eneg ? -ev : ev;
  }
  double v = static_cast<double>(mant);
  if (e10 >= 0) {
    v = (e10 <= 22) ? v * kPow10[e10] : v * std::pow(10.0, e10);
  } else {
    v = (e10 >= -22) ? v / kPow10[-e10] : v * std::pow(10.0, e10);
  }
  out = static_cast<float>(neg ? -v : v);
  p = skip_ws(p, end);
  return true;
}

// Parse one text segment (starting and ending at line boundaries) into a
// packed vector of values.  Returns false on any malformed row.
template <typename T, bool (*PARSE)(const char*&, const char*, T&)>
bool parse_segment(const char* p, const char* end, int64_t n_cols,
                   std::vector<T>& out, int64_t& rows) {
  rows = 0;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q < line_end) {  // blank lines are skipped, as numpy.loadtxt does
      for (int64_t c = 0; c < n_cols; ++c) {
        T v;
        if (!PARSE(q, line_end, v)) return false;
        out.push_back(v);
        if (c + 1 < n_cols) {
          if (q >= line_end || *q != ',') return false;
          ++q;
        }
      }
      if (q < line_end && *q == ',') return false;  // too many columns
      if (skip_ws(q, line_end) != line_end) return false;
      ++rows;
    }
    p = (line_end == end) ? end : line_end + 1;
  }
  return true;
}

struct GrowBuf {
  char* data = nullptr;
  int64_t size = 0;      // bytes used
  int64_t capacity = 0;  // bytes allocated
  bool reserve_more(int64_t extra) {
    if (size + extra <= capacity) return true;
    int64_t cap = capacity ? capacity : (64 << 10);
    while (cap < size + extra) cap += cap / 2;
    char* p = static_cast<char*>(std::realloc(data, static_cast<size_t>(cap)));
    if (p == nullptr) return false;
    data = p;
    capacity = cap;
    return true;
  }
};

constexpr int64_t kMaxCarry = 4 << 20;  // longest supported line
constexpr int64_t kChunk = 32 << 20;    // text bytes parsed per round

// The chunk pipeline over any source: ``read(dst, n)`` fills up to n bytes
// and returns how many (fewer only at the end), or < 0 on failure.  While
// chunk i parses, an asynchronous read fills chunk i+1 (``async_read``:
// worth a thread when reading inflates, not when it copies memory).
template <typename T, bool (*PARSE)(const char*&, const char*, T&), typename Read>
int64_t load_csv(Read read, bool async_read, void** out_data, int64_t* out_rows,
                 int64_t* out_cols) {
  // buffer layout: [kMaxCarry area for the previous chunk's partial line][kChunk read area]
  std::vector<char> bufs[2];
  bufs[0].resize(static_cast<size_t>(kMaxCarry + kChunk));
  bufs[1].resize(static_cast<size_t>(kMaxCarry + kChunk));

  GrowBuf buf;
  int64_t total_rows = 0;
  int64_t n_cols = -1;
  const int n_threads = omp_get_max_threads();
  const auto policy = async_read ? std::launch::async : std::launch::deferred;

  int64_t carry = 0;  // bytes of partial line sitting before cur's read area
  std::future<int64_t> pending =
      std::async(std::launch::deferred, read, bufs[0].data() + kMaxCarry, kChunk);
  int cur = 0;
  bool reader_ahead = true;
  auto fail = [&](int64_t code) {
    if (reader_ahead) pending.get();
    std::free(buf.data);
    return code;
  };

  for (;;) {
    const int64_t nread = pending.get();
    reader_ahead = false;
    if (nread < 0) return fail(-1);
    const bool eof = (nread < kChunk);
    if (!eof) {  // start the next read while this chunk parses
      pending = std::async(policy, read, bufs[cur ^ 1].data() + kMaxCarry, kChunk);
      reader_ahead = true;
    }
    char* base = bufs[cur].data() + kMaxCarry - carry;
    const int64_t avail = carry + nread;
    if (avail == 0) break;

    // parse up to the last complete line unless at the end
    int64_t parse_len = avail;
    if (!eof) {
      const char* nl = static_cast<const char*>(
          memrchr(base, '\n', static_cast<size_t>(avail)));
      if (nl == nullptr || (avail - ((nl - base) + 1)) > kMaxCarry) return fail(-2);
      parse_len = (nl - base) + 1;
    }

    if (n_cols < 0) {  // the column count comes from the first line
      const char* first_end = static_cast<const char*>(
          std::memchr(base, '\n', static_cast<size_t>(parse_len)));
      if (first_end == nullptr) first_end = base + parse_len;
      n_cols = 1;
      for (const char* p = base; p < first_end; ++p) {
        if (*p == ',') ++n_cols;
      }
    }

    // split [0, parse_len) into per-thread segments at line boundaries
    std::vector<int64_t> bounds;
    bounds.push_back(0);
    for (int t = 1; t < n_threads; ++t) {
      int64_t pos = parse_len * t / n_threads;
      if (pos < bounds.back()) pos = bounds.back();
      const char* nl = static_cast<const char*>(
          std::memchr(base + pos, '\n', static_cast<size_t>(parse_len - pos)));
      pos = (nl == nullptr) ? parse_len : (nl - base) + 1;
      if (pos > bounds.back()) bounds.push_back(pos);
    }
    if (bounds.back() != parse_len) bounds.push_back(parse_len);
    const int n_seg = static_cast<int>(bounds.size()) - 1;

    std::vector<std::vector<T>> seg_vals(n_seg);
    std::vector<int64_t> seg_rows(n_seg, 0);
    bool ok = true;
#pragma omp parallel for schedule(static) reduction(&& : ok) if (n_seg > 1)
    for (int s = 0; s < n_seg; ++s) {
      seg_vals[s].reserve(static_cast<size_t>((bounds[s + 1] - bounds[s]) / 2));
      ok = ok && parse_segment<T, PARSE>(base + bounds[s], base + bounds[s + 1], n_cols,
                                         seg_vals[s], seg_rows[s]);
    }
    if (!ok) return fail(-2);
    for (int s = 0; s < n_seg; ++s) {
      const int64_t bytes = static_cast<int64_t>(seg_vals[s].size()) *
                            static_cast<int64_t>(sizeof(T));
      if (!buf.reserve_more(bytes)) return fail(-3);
      std::memcpy(buf.data + buf.size, seg_vals[s].data(), static_cast<size_t>(bytes));
      buf.size += bytes;
      total_rows += seg_rows[s];
    }

    const int64_t new_carry = avail - parse_len;
    if (eof) break;
    // the partial line goes before the next buffer's read area, which the
    // read in flight does not touch
    if (new_carry > 0) {
      std::memcpy(bufs[cur ^ 1].data() + kMaxCarry - new_carry, base + parse_len,
                  static_cast<size_t>(new_carry));
    }
    carry = new_carry;
    cur ^= 1;
  }

  *out_data = buf.data;
  *out_rows = total_rows;
  *out_cols = (n_cols < 0) ? 0 : n_cols;
  return 0;
}

template <typename Read>
int64_t load_any(int dtype, Read read, bool async_read, void** out_data,
                 int64_t* out_rows, int64_t* out_cols) {
  *out_data = nullptr;
  if (dtype == 0) return load_csv<float, parse_f32>(read, async_read, out_data, out_rows, out_cols);
  if (dtype == 1) return load_csv<int64_t, parse_i64>(read, async_read, out_data, out_rows, out_cols);
  return -4;
}

}  // namespace

extern "C" {

int64_t sgl_csv_parse(const char* text, int64_t n_bytes, int dtype, void** out_data,
                      int64_t* out_rows, int64_t* out_cols) {
  int64_t offset = 0;
  auto read = [text, n_bytes, &offset](char* dst, int64_t n) -> int64_t {
    const int64_t k = (n_bytes - offset < n) ? n_bytes - offset : n;
    std::memcpy(dst, text + offset, static_cast<size_t>(k));
    offset += k;
    return k;
  };
  return load_any(dtype, read, false, out_data, out_rows, out_cols);
}

int sgl_csv_has_zlib() {
#ifdef SGL_CSV_ZLIB
  return 1;
#else
  return 0;
#endif
}

int64_t sgl_csv_load(const char* path, int dtype, void** out_data, int64_t* out_rows,
                     int64_t* out_cols) {
#ifdef SGL_CSV_ZLIB
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) return -1;
  gzbuffer(f, 1 << 20);
  auto read = [f](char* dst, int64_t n) -> int64_t {
    return gzread(f, dst, static_cast<unsigned>(n));
  };
  const int64_t status = load_any(dtype, read, true, out_data, out_rows, out_cols);
  gzclose(f);
  return status;
#else
  (void)path;
  (void)dtype;
  *out_data = nullptr;
  (void)out_rows;
  (void)out_cols;
  return -5;
#endif
}

void sgl_buf_free(void* p) { std::free(p); }

}  // extern "C"
