// Fast libsvm / libffm chunk parser.
//
// TPU-native counterpart of the reference's C++ line parsers
// (reference: src/data/parser.cpp:11-41 libsvm, :62-103 libffm), re-designed
// for batch semantics: one pass over a whole text chunk writes directly into
// padded fixed-shape [cap, max_nnz] arrays ready for device upload.  Called
// from Python via ctypes with the GIL released, so the host-side thread pool
// (data/loader.py) gets real parallelism — the equivalent of the reference's
// byte-range reader tasks (src/data/reader.cpp:50-91).
//
// Parity behaviors preserved (see data/parser.py for the full list):
//   * label binarization y > 0 -> 1       (src/data/parser.cpp:16, :67)
//   * zero-valued features dropped        (src/data/parser.cpp:37, :99)
//   * out-of-range field/feat filtering   (src/model/ftrl_model.cpp:36-42)
//   * padding: feat = n_feats (sentinel), val = 0, field = 0
//
// Build: g++ -O3 -march=native -fno-strict-aliasing -shared -fPIC -o libftrlparse.so parser.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Fast non-negative integer parse; returns -1 if no digits.
inline long parse_int(const char*& p, const char* end) {
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    if (p >= end || *p < '0' || *p > '9') return -1;
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    return neg ? -v : v;
}

// Float parse: fast path for plain decimals, strtod fallback for exponents.
inline double parse_float(const char*& p, const char* end) {
    const char* start = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    double v = 0.0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10.0 + (*p++ - '0'); any = true; }
    if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        while (p < end && *p >= '0' && *p <= '9') { v += (*p++ - '0') * scale; scale *= 0.1; any = true; }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        // rare: defer to strtod for exact exponent handling
        char buf[64];
        size_t n = static_cast<size_t>(end - start);
        if (n > 63) n = 63;
        std::memcpy(buf, start, n);
        buf[n] = '\0';
        char* q = nullptr;
        double r = std::strtod(buf, &q);
        p = start + (q - buf);
        return r;
    }
    if (!any) return 0.0;
    return neg ? -v : v;
}

}  // namespace

extern "C" {

// Parse `text[0:len)` (newline-separated samples) into padded arrays.
// stride: 2 = libsvm (feat:val), 3 = libffm (field:feat:val).
// Returns the number of samples written, or -1 on malformed input.
int64_t ftrl_parse_chunk(
    const char* text, int64_t len,
    int32_t stride, int32_t max_nnz, int32_t n_feats, int32_t n_fields,
    int32_t* out_fields,   // [cap, max_nnz]
    int32_t* out_feats,    // [cap, max_nnz]
    float* out_vals,       // [cap, max_nnz]
    float* out_y,          // [cap]
    int32_t* out_nnz,      // [cap] true (pre-truncation) nnz
    int64_t cap) {
    const char* p = text;
    const char* end = text + len;
    int64_t n = 0;

    while (p < end && n < cap) {
        // skip blank lines
        while (p < end && (*p == '\n' || is_space(*p))) ++p;
        if (p >= end) break;

        const char* line_end = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;

        double label = parse_float(p, line_end);
        out_y[n] = label > 0.0 ? 1.0f : 0.0f;

        int32_t* f_row = out_fields + n * max_nnz;
        int32_t* i_row = out_feats + n * max_nnz;
        float* v_row = out_vals + n * max_nnz;
        for (int32_t k = 0; k < max_nnz; ++k) {
            f_row[k] = 0;
            i_row[k] = n_feats;
            v_row[k] = 0.0f;
        }

        int32_t count = 0;
        while (p < line_end) {
            while (p < line_end && is_space(*p)) ++p;
            if (p >= line_end) break;

            const char* tok = p;
            long a = parse_int(p, line_end);
            if (p == tok) return -1;  // empty integer token (e.g. ":5:1")
            if (p >= line_end || *p != ':') return -1;  // malformed token
            ++p;
            long field, feat;
            double val;
            if (stride == 3) {
                field = a;
                tok = p;
                feat = parse_int(p, line_end);
                if (p == tok) return -1;  // empty feat token
                if (p >= line_end || *p != ':') return -1;
                ++p;
                val = parse_float(p, line_end);
            } else {
                field = 0;  // dummy field (src/data/parser.cpp:29)
                feat = a;
                val = parse_float(p, line_end);
            }
            if (count < max_nnz) {
                bool bad = feat < 0 || feat >= n_feats || val == 0.0 ||
                           field < 0 || field >= n_fields;
                if (!bad) {
                    f_row[count] = static_cast<int32_t>(field);
                    i_row[count] = static_cast<int32_t>(feat);
                    v_row[count] = static_cast<float>(val);
                }
                // bad tokens keep the inert padding triple in their slot,
                // matching the numpy parser's disable-in-place behavior
            }
            ++count;
        }
        out_nnz[n] = count;
        ++n;
        p = (line_end < end) ? line_end + 1 : end;
    }
    return n;
}

// Multi-threaded chunk parse: split text at newline boundaries into
// n_threads ranges, count non-blank lines per range (to assign disjoint
// output row offsets), then parse ranges concurrently with std::thread.
// Byte-identical output to ftrl_parse_chunk — the per-range parser is the
// same loop, just pointed at a row offset.  The GIL is already released by
// ctypes, so this is real host parallelism inside ONE library call (the
// reference's consumer-thread parallelism, src/concurrent/pc_task.cpp:57-80,
// reborn without per-chunk Python fan-out overhead).
int64_t ftrl_parse_chunk_mt(
    const char* text, int64_t len,
    int32_t stride, int32_t max_nnz, int32_t n_feats, int32_t n_fields,
    int32_t* out_fields, int32_t* out_feats, float* out_vals,
    float* out_y, int32_t* out_nnz, int64_t cap, int32_t n_threads) {
    if (n_threads <= 1 || len < (1 << 16)) {
        return ftrl_parse_chunk(text, len, stride, max_nnz, n_feats, n_fields,
                                out_fields, out_feats, out_vals, out_y,
                                out_nnz, cap);
    }
    int t_count = n_threads > 16 ? 16 : n_threads;
    std::vector<const char*> bounds(static_cast<size_t>(t_count) + 1);
    bounds[0] = text;
    bounds[t_count] = text + len;
    for (int i = 1; i < t_count; ++i) {
        const char* p = text + (len * i) / t_count;
        if (p <= bounds[i - 1]) {
            bounds[i] = bounds[i - 1];
            continue;
        }
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(text + len - p)));
        bounds[i] = nl ? nl + 1 : text + len;
        if (bounds[i] < bounds[i - 1]) bounds[i] = bounds[i - 1];
    }

    // phase 1: count non-blank lines per range (matches the parse loop's
    // blank-line skipping) — parallel, it is a measurable fraction of parse
    std::vector<int64_t> counts(t_count, 0);
    {
        std::vector<std::thread> ts;
        ts.reserve(t_count);
        for (int i = 0; i < t_count; ++i) {
            ts.emplace_back([&, i] {
                const char* p = bounds[i];
                const char* end = bounds[i + 1];
                int64_t lines = 0;
                bool in_line = false;
                for (; p < end; ++p) {
                    char c = *p;
                    if (c == '\n') {
                        if (in_line) ++lines;
                        in_line = false;
                    } else if (!is_space(c)) {
                        in_line = true;
                    }
                }
                if (in_line) ++lines;
                counts[i] = lines;
            });
        }
        for (auto& t : ts) t.join();
    }
    std::vector<int64_t> offs(static_cast<size_t>(t_count) + 1, 0);
    for (int i = 0; i < t_count; ++i) offs[i + 1] = offs[i] + counts[i];

    // phase 2: parse ranges into disjoint row windows
    std::vector<int64_t> results(t_count, 0);
    {
        std::vector<std::thread> ts;
        ts.reserve(t_count);
        for (int i = 0; i < t_count; ++i) {
            ts.emplace_back([&, i] {
                int64_t row0 = offs[i];
                int64_t room = cap > row0 ? cap - row0 : 0;
                int64_t want = counts[i] < room ? counts[i] : room;
                if (want <= 0) {
                    results[i] = 0;
                    return;
                }
                results[i] = ftrl_parse_chunk(
                    bounds[i],
                    static_cast<int64_t>(bounds[i + 1] - bounds[i]),
                    stride, max_nnz, n_feats, n_fields,
                    out_fields + row0 * max_nnz,
                    out_feats + row0 * max_nnz,
                    out_vals + row0 * max_nnz,
                    out_y + row0,
                    out_nnz + row0,
                    want);
            });
        }
        for (auto& t : ts) t.join();
    }
    int64_t total = 0;
    for (int i = 0; i < t_count; ++i) {
        if (results[i] < 0) return -1;  // malformed input in range i
        total += results[i];
    }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Compact-transfer batch encoding (the native form of train.py::_compact).
//
// The feeder thread narrows upload dtypes per batch — uint16 delta ids
// against per-column bases, int8/bfloat16 values when exact, int8 fields —
// before host->HBM transfer.  In numpy that is several full-batch
// single-threaded passes on the one upload thread (min/max, round-trip
// checks, where, astype), which sits exactly at the device-step budget at
// B=16384; here it is two fused multi-threaded passes with the GIL
// released.  Output is byte-identical to the numpy path (tests/test_parser
// fuzzes equality), and every narrowing stays LOSSLESS-ONLY: an encoding is
// chosen only when the round trip is exact.
//
// Fact flags returned by ftrl_compact_analyze (bitmask) — raw observations;
// the Python caller combines them into encoding decisions (train.py):
constexpr int64_t kHasPad = 1;    // any feat id == sentinel
constexpr int64_t kAllOnes = 4;   // every val exactly 1.0f
constexpr int64_t kValsI8 = 8;    // every val integral in [-128, 127]
constexpr int64_t kValsBf16 = 16; // every val exactly bf16-representable
constexpr int64_t kFieldsIota = 32;  // every row's fields are exactly 0..F-1

namespace {

inline uint16_t bf16_round(float v) {
    uint32_t b;
    std::memcpy(&b, &v, 4);
    return static_cast<uint16_t>((b + 0x7fffu + ((b >> 16) & 1u)) >> 16);
}

// Per-range analyze: per-column id lo/hi (sentinel excluded) + padding
// flag, and the three value-exactness facts.  Every loop is branchless and
// single-domain (ints or floats, never mixed) with __restrict__ pointers —
// gcc auto-vectorizes each; the first fused scalar/branchy version of this
// measured SLOWER than the numpy passes it replaces (8 ns/element).
void compact_scan_range(const int32_t* __restrict__ feats,
                        const float* __restrict__ vals,
                        const int32_t* __restrict__ fields,  // nullable
                        int64_t row0, int64_t row1, int64_t f,
                        int32_t sentinel,
                        int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                        int32_t* __restrict__ pad_m,
                        int32_t* __restrict__ bads /* [4] */) {
    for (int64_t i = row0; i < row1; ++i) {
        const int32_t* __restrict__ fr = feats + i * f;
        for (int64_t j = 0; j < f; ++j) {
            int32_t id = fr[j];
            int32_t is_pad = id == sentinel;
            pad_m[j] |= is_pad;
            int32_t idv = is_pad ? INT32_MAX : id;
            int32_t idh = is_pad ? -1 : id;
            lo[j] = idv < lo[j] ? idv : lo[j];
            hi[j] = idh > hi[j] ? idh : hi[j];
        }
    }
    const float* __restrict__ v = vals + row0 * f;
    const int64_t m = (row1 - row0) * f;
    int32_t ones_bad = 0, i8_bad = 0, bf16_bad = 0;
    for (int64_t k = 0; k < m; ++k) ones_bad |= (v[k] != 1.0f);
    for (int64_t k = 0; k < m; ++k) {
        float x = v[k];
        // integral test via round-to-nearest (exact for |x| < 2^22; larger
        // magnitudes fail the range check anyway): matches numpy's
        // astype(int8) round trip exactly — non-integral, out-of-[-128,127]
        // and NaN all fail
        float r = (x + 12582912.0f) - 12582912.0f;  // 1.5 * 2^23
        i8_bad |= !((x >= -128.0f) & (x <= 127.0f) & (r == x));
    }
    const uint32_t* __restrict__ b =
        reinterpret_cast<const uint32_t*>(v);  // built -fno-strict-aliasing
    for (int64_t k = 0; k < m; ++k) {
        uint32_t x = b[k];
        uint32_t back = ((x + 0x7fffu + ((x >> 16) & 1u)) >> 16) << 16;
        float fb;
        std::memcpy(&fb, &back, 4);
        bf16_bad |= (fb != v[k]);  // NaN: != is true -> rides as f32
    }
    bads[0] = ones_bad;
    bads[1] = i8_bad;
    bads[2] = bf16_bad;
    int32_t iota_bad = 0;
    if (fields) {
        for (int64_t i = row0; i < row1; ++i) {
            const int32_t* __restrict__ fr = fields + i * f;
            for (int64_t j = 0; j < f; ++j)
                iota_bad |= (fr[j] != static_cast<int32_t>(j));
        }
    } else {
        iota_bad = 1;
    }
    bads[3] = iota_bad;
}

}  // namespace

extern "C" {

// Pass 1 of compact-transfer encoding: one fused scan computing everything
// train.py::_compact's numpy passes computed separately.  Writes per-column
// id minima to out_lo (sentinel-masked; all-padding columns -> 0) and
// returns a fact bitmask; the CALLER decides the encodings (delta fits in
// u16, all-ones marker, i8 vs bf16) and allocates only the output buffers
// pass 2 will actually write.
int64_t ftrl_compact_analyze(
    const int32_t* feats, const float* vals, const int32_t* fields,
    int64_t n, int64_t f, int32_t sentinel,
    int32_t* out_lo, int32_t* out_hi, int32_t n_threads) {
    if (n <= 0 || f <= 0) {
        for (int64_t j = 0; j < f; ++j) { out_lo[j] = 0; out_hi[j] = 0; }
        // empty: vacuously all-ones / iota, no padding
        return kAllOnes | (fields ? kFieldsIota : 0);
    }
    int t_count = n_threads > 8 ? 8 : (n_threads < 1 ? 1 : n_threads);
    if (n * f < (1 << 17)) t_count = 1;  // thread spawn beats the work below
    size_t fs = static_cast<size_t>(f);
    size_t stride = fs * 3 + 4;  // lo | hi | pad_m | bads[4] per thread
    std::vector<int32_t> acc(static_cast<size_t>(t_count) * stride);
    auto run = [&](int t, int64_t a, int64_t b) {
        int32_t* base = acc.data() + static_cast<size_t>(t) * stride;
        int32_t* lo = base;
        int32_t* hi = base + fs;
        for (size_t j = 0; j < fs; ++j) { lo[j] = INT32_MAX; hi[j] = -1; }
        // pad_m zero-initialized by the vector
        compact_scan_range(feats, vals, fields, a, b, f, sentinel, lo, hi,
                           base + 2 * fs, base + 3 * fs);
    };
    if (t_count == 1) {
        run(0, 0, n);
    } else {
        std::vector<std::thread> ts;
        ts.reserve(t_count);
        for (int t = 0; t < t_count; ++t)
            ts.emplace_back(run, t, n * t / t_count, n * (t + 1) / t_count);
        for (auto& th : ts) th.join();
    }
    int32_t* lo = acc.data();
    int32_t* hi = acc.data() + fs;
    int32_t pad = 0, ones_bad = 0, i8_bad = 0, bf16_bad = 0, iota_bad = 0;
    for (int t = 0; t < t_count; ++t) {
        int32_t* base = acc.data() + static_cast<size_t>(t) * stride;
        for (size_t j = 0; j < fs; ++j) {
            if (t) {
                if (base[j] < lo[j]) lo[j] = base[j];
                if (base[fs + j] > hi[j]) hi[j] = base[fs + j];
            }
            pad |= base[2 * fs + j];
        }
        ones_bad |= base[3 * fs + 0];
        i8_bad |= base[3 * fs + 1];
        bf16_bad |= base[3 * fs + 2];
        iota_bad |= base[3 * fs + 3];
    }
    for (size_t j = 0; j < fs; ++j) {
        if (hi[j] < lo[j]) lo[j] = 0;  // all-padding column: base 0 (numpy)
        out_lo[j] = lo[j];
        out_hi[j] = hi[j];
    }
    int64_t flags = 0;
    if (pad) flags |= kHasPad;
    if (!ones_bad) flags |= kAllOnes;
    if (!i8_bad) flags |= kValsI8;
    if (!bf16_bad) flags |= kValsBf16;
    if (!iota_bad) flags |= kFieldsIota;
    return flags;
}

// Pass 2: fused encode of whichever outputs the caller chose (non-null).
// u16 deltas need `lo` from pass 1; every loop is branchless/vectorizable.
void ftrl_compact_encode(
    const int32_t* feats, const float* vals, const int32_t* fields,
    int64_t n, int64_t f, int32_t sentinel, const int32_t* lo,
    uint16_t* out_feats_u16, int8_t* out_vals_i8, uint16_t* out_vals_bf16,
    int8_t* out_fields_i8, int32_t n_threads) {
    if (n <= 0 || f <= 0) return;
    int t_count = n_threads > 8 ? 8 : (n_threads < 1 ? 1 : n_threads);
    if (n * f < (1 << 17)) t_count = 1;
    auto encode = [&](int64_t row0, int64_t row1) {
        if (out_feats_u16) {
            for (int64_t i = row0; i < row1; ++i) {
                const int32_t* fr = feats + i * f;
                uint16_t* out = out_feats_u16 + i * f;
                for (int64_t j = 0; j < f; ++j) {
                    int32_t id = fr[j];
                    int32_t d = id - lo[j];
                    out[j] = static_cast<uint16_t>(
                        id == sentinel ? 65535 : d);
                }
            }
        }
        if (out_vals_i8) {
            const float* v0 = vals + row0 * f;
            int8_t* out = out_vals_i8 + row0 * f;
            int64_t m = (row1 - row0) * f;
            for (int64_t k = 0; k < m; ++k)
                out[k] = static_cast<int8_t>(v0[k]);
        } else if (out_vals_bf16) {
            const float* v0 = vals + row0 * f;
            uint16_t* out = out_vals_bf16 + row0 * f;
            int64_t m = (row1 - row0) * f;
            for (int64_t k = 0; k < m; ++k) out[k] = bf16_round(v0[k]);
        }
        if (out_fields_i8 && fields) {
            const int32_t* f0 = fields + row0 * f;
            int8_t* out = out_fields_i8 + row0 * f;
            int64_t m = (row1 - row0) * f;
            for (int64_t k = 0; k < m; ++k)
                out[k] = static_cast<int8_t>(f0[k]);
        }
    };
    if (t_count == 1) {
        encode(0, n);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve(t_count);
    for (int t = 0; t < t_count; ++t)
        ts.emplace_back(encode, n * t / t_count, n * (t + 1) / t_count);
    for (auto& th : ts) th.join();
}

}  // extern "C"

extern "C" {

// Count lines and max token count (for sizing) in one cheap pass.
void ftrl_count_chunk(const char* text, int64_t len, int32_t stride,
                      int64_t* out_lines, int64_t* out_max_nnz) {
    int64_t lines = 0, max_nnz = 0, colons = 0;
    bool in_line = false;
    for (int64_t i = 0; i < len; ++i) {
        char c = text[i];
        if (c == '\n') {
            if (in_line) {
                ++lines;
                int64_t nnz = colons / (stride - 1);
                if (nnz > max_nnz) max_nnz = nnz;
            }
            in_line = false;
            colons = 0;
        } else {
            if (c == ':') ++colons;
            if (!is_space(c)) in_line = true;
        }
    }
    if (in_line) {
        ++lines;
        int64_t nnz = colons / (stride - 1);
        if (nnz > max_nnz) max_nnz = nnz;
    }
    *out_lines = lines;
    *out_max_nnz = max_nnz;
}

}  // extern "C"
