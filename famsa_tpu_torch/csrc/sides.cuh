// The side descriptors of a launch of the device DP route, read by K5
// (csrc/stage0.cu) and K6 (csrc/merged.cu); must match
// ops/sides.py.  A descriptor is DESC_WORDS int64: kind, the address of
// row 0 (a leaf: of the byte of row 1), the row stride in elements, the
// profile's width w and its cardinality.  Rows 0..w are the profile's
// counters; past them a reader sees zero.  Counter rows (resident or
// uploaded) are int32 [w+1][32]; a leaf is its w symbol bytes, counter
// row r >= 1 the one-hot of byte r - 1, row 0 zero.

#pragma once

#include <cstdint>

namespace famsa_sides {

typedef long long i64;

enum { SIDE_RESIDENT = 0, SIDE_LEAF = 1, SIDE_UPLOADED = 2 };
constexpr int DESC_WORDS = 8;

struct Side {
    i64 kind;
    const void* p;
    i64 stride;
    i64 w;
    i64 card;
};

__device__ __forceinline__ Side load_side(const i64* desc, int k) {
    const i64* d = desc + (i64)k * DESC_WORDS;
    Side s;
    s.kind = d[0];
    s.p = reinterpret_cast<const void*>(d[1]);
    s.stride = d[2];
    s.w = d[3];
    s.card = d[4];
    return s;
}

// counter of symbol l (0..31) in row r of side s; zero outside rows 0..w
__device__ __forceinline__ i64 side_count(const Side& s, i64 r, int l) {
    if (r < 0 || r > s.w) return 0;
    if (s.kind == SIDE_LEAF)
        return r >= 1 && static_cast<const uint8_t*>(s.p)[r - 1] == l;
    return static_cast<const int32_t*>(s.p)[r * s.stride + l];
}

}  // namespace famsa_sides
