// CSV block formatter for metric result batches: the port's copy of the JAX
// package's csvformat.cpp.
//
// The device metrics path produces whole batches of entity rows as int64 /
// float64 matrices; rendering them through Python's per-value str() is a
// bottleneck at 10^4-entity batch sizes. This formatter emits the exact bytes
// Python's str(float(x)) / str(int(x)) would produce (the CSV contract of
// the reference writer, src/sctools/metrics/writer.py:84-103, where every
// value is rendered via str()) at std::to_chars speed.
//
// Float rendering reproduces CPython's repr algorithm: shortest
// round-trip digits, fixed notation for decimal exponents in [-4, 16),
// scientific ("1e+16", two-plus exponent digits) outside it, "nan"/"inf"
// spellings, and a trailing ".0" on integral values.

#include <cstdint>
#include <cstring>
#include <charconv>
#include <cmath>
#include <cstdio>
#include <cstdlib>

namespace {

// Render one double exactly as CPython str()/repr() would. Returns the
// number of bytes written to `out` (caller guarantees >= 32 bytes).
int format_double_py(double v, char* out) {
  if (std::isnan(v)) {
    std::memcpy(out, "nan", 3);
    return 3;
  }
  char* p = out;
  if (std::signbit(v)) {
    *p++ = '-';
    v = -v;
  }
  if (std::isinf(v)) {
    std::memcpy(p, "inf", 3);
    return int(p - out) + 3;
  }
  if (v == 0.0) {
    std::memcpy(p, "0.0", 3);
    return int(p - out) + 3;
  }
  // Shortest round-trip mantissa in scientific form: "d[.ddd]e±XX".
  char sci[40];
  const char* sci_end;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto res = std::to_chars(sci, sci + sizeof(sci), v,
                           std::chars_format::scientific);
  sci_end = res.ptr;
#else
  // libstdc++ < 11 has no floating-point to_chars. The shortest
  // correctly-rounded decimal that round-trips is found by precision
  // search: printf %.*e is correctly rounded, so the first precision
  // whose output parses back to exactly `v` carries the same digit
  // string to_chars would produce (both are the unique shortest
  // round-trip representation).
  {
    int prec = 0;
    for (; prec < 17; ++prec) {
      std::snprintf(sci, sizeof(sci), "%.*e", prec, v);
      if (std::strtod(sci, nullptr) == v) break;
    }
    if (prec == 17) std::snprintf(sci, sizeof(sci), "%.17e", v);
    sci_end = sci + std::strlen(sci);
  }
#endif
  // Parse digits and decimal exponent out of the scientific form. The
  // mantissa scan keeps digit bytes and skips everything else up to the
  // exponent marker: snprintf's decimal separator is locale-dependent
  // (possibly multi-byte), and trusting a '.'-shaped parse under a
  // non-C LC_NUMERIC would corrupt the exponent and overrun `out`.
  char digits[32];
  int n_digits = 0;
  const char* s = sci;
  while (s != sci_end && *s != 'e' && *s != 'E') {
    if (*s >= '0' && *s <= '9' &&
        n_digits < static_cast<int>(sizeof(digits)))
      digits[n_digits++] = *s;
    ++s;
  }
  int exp10 = 0;
  bool exp_neg = false;
  if (s != sci_end) {
    ++s;  // exponent marker
    if (s != sci_end && (*s == '-' || *s == '+')) exp_neg = (*s++ == '-');
    while (s != sci_end && *s >= '0' && *s <= '9')
      exp10 = exp10 * 10 + (*s++ - '0');
  }
  if (exp_neg) exp10 = -exp10;

  if (exp10 >= -4 && exp10 < 16) {
    // Fixed notation.
    if (exp10 >= n_digits - 1) {
      // All digits left of the point: digits, zero padding, ".0".
      std::memcpy(p, digits, n_digits);
      p += n_digits;
      for (int i = n_digits - 1; i < exp10; ++i) *p++ = '0';
      *p++ = '.';
      *p++ = '0';
    } else if (exp10 >= 0) {
      std::memcpy(p, digits, exp10 + 1);
      p += exp10 + 1;
      *p++ = '.';
      std::memcpy(p, digits + exp10 + 1, n_digits - exp10 - 1);
      p += n_digits - exp10 - 1;
    } else {
      *p++ = '0';
      *p++ = '.';
      for (int i = 0; i < -exp10 - 1; ++i) *p++ = '0';
      std::memcpy(p, digits, n_digits);
      p += n_digits;
    }
  } else {
    // Scientific notation, Python style: "1e+16", "1.5e-05".
    *p++ = digits[0];
    if (n_digits > 1) {
      *p++ = '.';
      std::memcpy(p, digits + 1, n_digits - 1);
      p += n_digits - 1;
    }
    *p++ = 'e';
    *p++ = exp10 < 0 ? '-' : '+';
    int a = exp10 < 0 ? -exp10 : exp10;
    char eb[8];
    int ne = 0;
    while (a) {
      eb[ne++] = char('0' + a % 10);
      a /= 10;
    }
    while (ne < 2) eb[ne++] = '0';  // at least two exponent digits
    while (ne) *p++ = eb[--ne];
  }
  return int(p - out);
}

}  // namespace

extern "C" {

// Format a block of CSV rows: index[i] , col0[i] , col1[i] ... "\n".
// Index strings arrive as one concatenated byte buffer plus n_rows+1
// offsets. Values arrive as two row-major matrices (int64 and float64);
// col_is_float / col_src map each output column to its matrix and column.
// Returns bytes written to `out`, or -1 when `capacity` is insufficient.
long scx_format_csv_block(const char* index_bytes,
                          const int64_t* index_offsets, long n_rows,
                          const int64_t* int_vals, int32_t n_int_cols,
                          const double* float_vals, int32_t n_float_cols,
                          const int8_t* col_is_float, const int32_t* col_src,
                          int32_t n_cols, char* out, long capacity) {
  char* p = out;
  char* const end = out + capacity;
  for (long r = 0; r < n_rows; ++r) {
    const long idx_len = long(index_offsets[r + 1] - index_offsets[r]);
    // Worst case per row: index + n_cols * (1 + 32) + newline.
    if (end - p < idx_len + long(n_cols) * 33 + 1) return -1;
    std::memcpy(p, index_bytes + index_offsets[r], idx_len);
    p += idx_len;
    for (int32_t c = 0; c < n_cols; ++c) {
      *p++ = ',';
      if (col_is_float[c]) {
        p += format_double_py(float_vals[r * n_float_cols + col_src[c]], p);
      } else {
        auto res = std::to_chars(p, p + 24, int_vals[r * n_int_cols + col_src[c]]);
        p = res.ptr;
      }
    }
    *p++ = '\n';
  }
  return long(p - out);
}

}  // extern "C"
