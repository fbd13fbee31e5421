// Native data-path runtime: event text parsing + CPU voxelization.
// The port's own copy of v2e2v_tpu/runtime/ev_io.cpp, kept byte for byte in
// its code so that both packages give the same voxel grids.
//
// The reference's data path leaned on pandas' C CSV engine and numpy
// scatter-adds (data_readers/event_readers.py:18-24,
// utils/event_process.py:53-58 in lsying009/V2E2V). This module is the
// framework's native equivalent: an mmap'd single-pass text parser for
// "t x y p" event tables and a cache-friendly voxelizer with reference
// semantics (timestamps normalized to [0, num_bins-1], polarity 0 -> -1,
// bilinear split between neighboring temporal bins).
//
// Exposed via ctypes (see __init__.py); no Python.h dependency. Built with
// g++ -O3 -march=native into build/runtime/ at the repo root.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <cstdio>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Fast strtod-lite for the common "%f %d %d %d" rows; falls back to strtod
// for exotic floats (exponents).
inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == ',')) ++p;
    return p;
}

inline const char* parse_double(const char* p, const char* end, double* out) {
    // strtod assumes a NUL-terminated string; near the end of an mmap'd
    // buffer it could read past the mapping (SIGSEGV when a numeric token
    // ends exactly at a page boundary with no trailing newline) — bounce
    // the tail through a NUL-terminated stack copy.
    if (end - p < 64) {
        char tmp[65];
        size_t len = static_cast<size_t>(end - p);
        memcpy(tmp, p, len);
        tmp[len] = '\0';
        char* q = nullptr;
        *out = strtod(tmp, &q);
        if (q == tmp) return nullptr;
        return p + (q - tmp);
    }
    char* q = nullptr;
    *out = strtod(p, &q);
    if (q == p || q > end) return nullptr;
    return q;
}

}  // namespace

extern "C" {

// Parse a whitespace/comma separated "t x y p" table.
// Returns the number of events; *out receives a malloc'd [n*4] interleaved
// array (caller frees with ev_free). Returns -1 on IO error, -2 on parse
// error.
long ev_parse_txt(const char* path, double** out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t size = static_cast<size_t>(st.st_size);
    if (size == 0) { close(fd); *out = nullptr; return 0; }

    const char* data = static_cast<const char*>(
        mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    close(fd);
    if (data == MAP_FAILED) return -1;

    // Upper bound on rows: number of newlines + 1.
    size_t max_rows = 1;
    for (size_t i = 0; i < size; ++i) max_rows += (data[i] == '\n');

    double* buf = static_cast<double*>(malloc(max_rows * 4 * sizeof(double)));
    if (!buf) { munmap(const_cast<char*>(data), size); return -1; }

    const char* p = data;
    const char* end = data + size;
    long n = 0;
    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        double vals[4];
        bool ok = true;
        for (int c = 0; c < 4; ++c) {
            p = skip_ws(p, end);
            const char* q = parse_double(p, end, &vals[c]);
            if (!q) { ok = false; break; }
            p = q;
        }
        if (!ok) { free(buf); munmap(const_cast<char*>(data), size); return -2; }
        buf[n * 4 + 0] = vals[0];
        buf[n * 4 + 1] = vals[1];
        buf[n * 4 + 2] = vals[2];
        buf[n * 4 + 3] = vals[3];
        ++n;
        while (p < end && *p != '\n') ++p;  // rest of line
    }

    munmap(const_cast<char*>(data), size);
    *out = buf;
    return n;
}

void ev_free(double* p) { free(p); }

// Voxelize [n*4] interleaved (t, x, y, p) events into a
// [num_bins, height, width] float32 grid (zeroed here). Reference
// semantics: normalize t to [0, num_bins-1] by the window's first/last
// stamps (deltaT==0 -> 1), polarity 0 -> -1, bilinear split across bins.
// Returns the number of events whose (x, y) fell outside [0,width)x
// [0,height) — those are SKIPPED, not written (the numpy oracle raises
// IndexError there; an unchecked write here is a heap smash, observed as
// a SIGSEGV when a 180x240 dataset met --image_dim 32 40).
long ev_voxelize(const double* events, long n, int num_bins, int width,
                 int height, float* grid) {
    const long plane = static_cast<long>(width) * height;
    memset(grid, 0, sizeof(float) * plane * num_bins);
    if (n <= 0) return 0;

    const double first = events[0];
    double delta_t = events[(n - 1) * 4] - first;
    if (delta_t == 0.0) delta_t = 1.0;

    long oob = 0;
    for (long i = 0; i < n; ++i) {
        // expression order matches the numpy reference exactly — a 1-ulp
        // difference here flips exact-zero bilinear weights into residues
        // that the nonzero-mask normalization later amplifies
        const double ts = (num_bins - 1) * (events[i * 4 + 0] - first) / delta_t;
        const long x = static_cast<long>(events[i * 4 + 1]);
        const long y = static_cast<long>(events[i * 4 + 2]);
        if (x < 0 || x >= width || y < 0 || y >= height) { ++oob; continue; }
        double pol = events[i * 4 + 3];
        if (pol == 0.0) pol = -1.0;

        const double tif = floor(ts);
        const long ti = static_cast<long>(tif);
        const double dt = ts - tif;
        const long base = x + y * width;
        if (ti >= 0 && ti < num_bins)
            grid[base + ti * plane] += static_cast<float>(pol * (1.0 - dt));
        if (ti + 1 >= 0 && ti + 1 < num_bins)
            grid[base + (ti + 1) * plane] += static_cast<float>(pol * dt);
    }
    return oob;
}

// Hot-pixel filter + nonzero mean/std normalization (reference
// event_preprocess, utils/event_process.py:132-154). threshold <= 0
// disables the filter.
void ev_preprocess_std(float* grid, long size, float hot_threshold) {
    if (hot_threshold > 0.0f) {
        for (long i = 0; i < size; ++i)
            if (fabsf(grid[i]) > hot_threshold) grid[i] = 0.0f;
    }
    double sum = 0.0, sumsq = 0.0;
    long nonzero = 0;
    for (long i = 0; i < size; ++i) {
        const float v = grid[i];
        if (v != 0.0f) {
            sum += v;
            sumsq += static_cast<double>(v) * v;
            ++nonzero;
        }
    }
    if (nonzero == 0) return;
    const double mean = sum / nonzero;
    const double var = sumsq / nonzero - mean * mean;
    const double stddev = sqrt(var > 0.0 ? var : 0.0);
    const double inv = 1.0 / (stddev + 1e-8);
    for (long i = 0; i < size; ++i)
        if (grid[i] != 0.0f)
            grid[i] = static_cast<float>((grid[i] - mean) * inv);
}

}  // extern "C"
