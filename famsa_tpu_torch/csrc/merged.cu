// K6: the merged profile counters on the card.  For every merge of a
// launch it reads the forward path that K4 (csrc/traceback.cu) left in
// its output buffer, and the two parents' counters where they lie
// (csrc/sides.cuh descriptors), and writes the merged counters [S+1][32]
// int32: row k+1 is the column that path step k makes; row 0 and the rows
// past the path are zero.  These stay on the card for the parent merge's
// stage 0 (ops/dp_resident.py:MergedRef).
//
// Replaces the jnp device programs famsa_tpu/ops/dp_pallas.py:
// _forward_paths (:1219) and merged_counters_device (:1919), which the
// JAX package runs at the end of the batched DP's program
// (_tb_counters_impl :1239) and of the wide merge's (dp_giant.py
// _giant_core :363).  Plain PyTorch twin: ops/merged_torch.py:
// merged_from_paths_plain (ops/traceback_torch.py:forward_paths, then
// merged_counters).  Contract: the counters core/construct_fast.py
// builds on the host for the same path.
//
// Step k of the path (0 D, 1 H: a gap in parent 1, 2 V: a gap in parent
// 2) adds, for each parent p:
//  - when p advances, its row c_p[pos_p], pos_p the cumulative count of
//    its advances (a block scan);
//  - when p is in a gap run, its cardinality under GAP and the gap-
//    category counts of core/construct_fast.py's closed form: the run's
//    first column, its second, then the fixed point (the step's place in
//    its run from the cummax of the runs' starts, a block max-scan),
//    with the boundary runs (p at column 0 or past its last) terminal;
//  - on the advance right after one of its runs, the open -> ext
//    transfers of profile.cpp:840-975, from c_p[pos_p].
//
// What bounds it: bytes (each parent row read once, a path byte a step,
// 128 bytes written a step), and the latency of the row loads; the scans
// over the path are serial only if one CTA carries them from tile to
// tile (a lone wide merge, ~4150 steps, would be ~9 tiles one after
// another on one SM).
//
// Design: a grid of (merges, ceil(smax / K6_TILE)) CTAs, one tile of
// K6_TILE path steps each, no CTA depending on another.  A CTA first finds
// its own carry, each parent's advances before its tile and the last run
// start before it, by a block reduction over the path bytes [0, tile
// start) of K4's buffer, read with 16-byte loads from the aligned-down
// start (each loaded chunk holds a path byte, so no load leaves the
// buffer's pages).  That reads O(smax^2 / K6_TILE) bytes in all (a few MB
// from L2 at the widest path, ~49k steps) and needs no atomics, so the
// result is deterministic.  Then its tile, one step a thread: two block
// scans (the two parents' positions packed in one uint64 sum, the run
// starts a max), the step's rows and deltas staged in shared memory; each
// warp writes whole rows, lane l the counter of symbol l, with the
// parents' loads of K6_UNROLL rows in flight before their stores.  A tile
// that starts past the path writes zero rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "sides.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned int u32;
using famsa_sides::load_side;
using famsa_sides::Side;
using famsa_sides::side_count;

// path steps a CTA (mirrored in ops/merged_torch.py:MERGED_TILE), one a
// thread, and the rows whose loads a warp keeps in flight
constexpr int K6_TILE = 512;
constexpr int K6_UNROLL = 8;
constexpr int THREADS = K6_TILE;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GO = 25, GE = 26, GTE = 27, GTO = 28, GAP = 30;
constexpr int CODE_H = 1, CODE_V = 2, CODE_END = 3;

// a row's load apart from its use, so that a warp keeps several rows'
// loads in flight: row r of side s, lane l (a leaf: its symbol byte, -1
// outside rows 1..w; counters: the count, 0 outside rows 0..w), and the
// counter it gives
__device__ __forceinline__ int side_raw(const Side& s, i64 r, int l) {
    if (s.kind == famsa_sides::SIDE_LEAF)
        return r >= 1 && r <= s.w ? static_cast<const uint8_t*>(s.p)[r - 1]
                                  : -1;
    return r >= 0 && r <= s.w
               ? static_cast<const int32_t*>(s.p)[r * s.stride + l] : 0;
}

__device__ __forceinline__ i64 side_value(const Side& s, int raw, int l) {
    return s.kind == famsa_sides::SIDE_LEAF ? (i64)(raw == l) : (i64)raw;
}

// the gap-category deltas (open, ext, term open, term ext) and the GAP
// count parent s adds at a step: in a gap run (run; p the step's place in
// it) or on the advance right after one (hit); pos its column
__device__ __forceinline__ void parent_gaps(const Side& s, bool run, bool hit,
                                            i64 pos, i64 p, i64 q[4],
                                            i64& gap) {
    if (!run && !hit) return;
    const i64 size = s.card;
    const i64 cgo = side_count(s, pos, GO), cge = side_count(s, pos, GE);
    const i64 cgto = side_count(s, pos, GTO);
    const i64 cgte = side_count(s, pos, GTE);
    if (hit) {
        const i64 dg_t = pos > 1 ? cgo : 0;
        q[0] -= dg_t;
        q[1] += dg_t;
        q[2] -= cgto;
        q[3] += cgto;
        return;
    }
    const i64 cnt_end = cgto + cgte;
    const bool at0 = pos == 0, atw = pos >= s.w, bnd = at0 || atw;
    const i64 e1 = bnd ? 0 : cgo + cge;
    const i64 to1 = at0 ? size
        : (atw ? size - cnt_end : side_count(s, pos + 1, GTO));
    const i64 te1 = at0 ? 0 : cnt_end;
    const i64 o1 = bnd ? 0 : size - e1 - to1 - te1;
    if (p == 1) {
        q[0] += o1;
        q[1] += e1;
        q[2] += to1;
        q[3] += te1;
    } else if (bnd) {
        q[3] += size;
    } else {
        const i64 e2 = o1 + e1, te2 = to1 + te1;
        if (p == 2) {
            q[0] += size - e2 - te2;
            q[1] += e2;
        } else {
            q[1] += size - te2;
        }
        q[3] += te2;
    }
    gap += size;
}

// the carry of a tile starting at step base < n: each parent's advances
// over steps [0, base) (parent 1 | parent 2 << 32) and the last run start
// among them (0 when none), reduced over the CTA
__device__ __forceinline__ void tile_carry(const uint8_t* fwd, int base,
                                           u64* wsum, i64* wmax,
                                           u64& pos_carry, i64& start_carry) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uintptr_t p0 = reinterpret_cast<uintptr_t>(fwd);
    u32 a1 = 0, a2 = 0;
    i64 mx = 0;
    for (uintptr_t c = (p0 & ~(uintptr_t)15) + 16 * (uintptr_t)tid;
         c < p0 + base; c += 16 * THREADS) {
        const uint4 v = *reinterpret_cast<const uint4*>(c);
        const u32 words[4] = {v.x, v.y, v.z, v.w};
        const i64 k0 = (i64)c - (i64)p0;     // the step of the chunk's byte 0
        int prev = k0 >= 1 ? fwd[k0 - 1] : CODE_END;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            const int code = (words[q >> 2] >> (8 * (q & 3))) & 0xff;
            const i64 k = k0 + q;
            if (k >= 0 && k < base) {
                a1 += code != CODE_H;
                a2 += code != CODE_V;
                if ((code == CODE_H && prev != CODE_H) ||
                    (code == CODE_V && prev != CODE_V))
                    mx = k;
            }
            prev = k >= 0 ? code : CODE_END;
        }
    }
    u64 ps = (u64)a1 | ((u64)a2 << 32);
    for (int d = 16; d >= 1; d >>= 1) {
        ps += __shfl_xor_sync(FULL, ps, d);
        const i64 m = __shfl_xor_sync(FULL, mx, d);
        mx = m > mx ? m : mx;
    }
    if (lane == 0) {
        wsum[warp] = ps;
        wmax[warp] = mx;
    }
    __syncthreads();
    pos_carry = 0;
    start_carry = 0;
    for (int v = 0; v < WARPS; ++v) {
        pos_carry += wsum[v];
        start_carry = wmax[v] > start_carry ? wmax[v] : start_carry;
    }
    __syncthreads();                         // wsum, wmax are reused
}

__global__ void __launch_bounds__(THREADS)
merged_kernel(const i64* __restrict__ desc, const i64* __restrict__ hdr,
              const uint8_t* __restrict__ paths, int nb, int smax,
              int* __restrict__ out) {
    __shared__ u64 wsum[WARPS];
    __shared__ i64 wmax[WARPS];
    __shared__ int src[2][THREADS];
    // a step's deltas by the lane they add to, lanes GO .. GAP
    __shared__ i64 dlt[THREADS][GAP - GO + 1];
    const int b = blockIdx.x, base = blockIdx.y * K6_TILE;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // every load that needs no other, issued before any branch
    const i64 w1 = hdr[8 * (i64)b];
    int n = *reinterpret_cast<const int*>(paths + 16 * (i64)b + 8);
    const Side s1 = load_side(desc, b), s2 = load_side(desc, nb + b);
    i64 poff = 16 * (i64)nb;
    for (int c = 0; c < b; ++c) poff += hdr[8 * (i64)c] + hdr[8 * (i64)c + 1];
    if (w1 < 1) return;                  // a chain step K7 skipped
    if (n < 0) n = 0;                    // a failed walk (resolve raises)
    const uint8_t* fwd = paths + poff;
    int* o = out + (i64)b * (smax + 1) * 32;
    const int steps = min(K6_TILE, smax - base);   // rows base+1 ..
    if (base == 0 && tid < 32) o[tid] = 0;
    if (base >= n) {                     // past the path: zero rows
        int4* z = reinterpret_cast<int4*>(o + (i64)(base + 1) * 32);
        for (int k = tid; k < steps * 8; k += THREADS)
            z[k] = make_int4(0, 0, 0, 0);
        return;
    }
    u64 pos_carry = 0;                   // advances of parent 1 | 2 << 32
    i64 start_carry = 0;                 // the last run start so far
    if (base > 0) tile_carry(fwd, base, wsum, wmax, pos_carry, start_carry);

    const int k = base + tid;
    const int code = k < n ? fwd[k] : CODE_END;
    const int prev = (k >= 1 && k - 1 < n) ? fwd[k - 1] : CODE_END;
    const bool run1 = code == CODE_H, run2 = code == CODE_V;
    const bool adv1 = code != CODE_END && !run1;
    const bool adv2 = code != CODE_END && !run2;
    const bool start = (run1 && prev != CODE_H) || (run2 && prev != CODE_V);
    // inclusive scans: the warp's, then the warps' totals
    u64 ps = (u64)adv1 | ((u64)adv2 << 32);
    i64 ms = start ? k : 0;
    for (int d = 1; d < 32; d <<= 1) {
        const u64 a = __shfl_up_sync(FULL, ps, d);
        const i64 m = __shfl_up_sync(FULL, ms, d);
        if (lane >= d) {
            ps += a;
            ms = m > ms ? m : ms;
        }
    }
    if (lane == 31) {
        wsum[warp] = ps;
        wmax[warp] = ms;
    }
    __syncthreads();
    u64 pre = pos_carry;
    i64 mpre = start_carry;
    for (int v = 0; v < warp; ++v) {
        pre += wsum[v];
        mpre = wmax[v] > mpre ? wmax[v] : mpre;
    }
    ps += pre;
    ms = mpre > ms ? mpre : ms;

    const i64 pos1 = (i64)(ps & 0xffffffffu), pos2 = (i64)(ps >> 32);
    const i64 p = k - ms + 1;            // the step's place in its run
    i64 q[4] = {0, 0, 0, 0}, gap = 0;
    parent_gaps(s1, run1, adv1 && prev == CODE_H, pos1, p, q, gap);
    parent_gaps(s2, run2, adv2 && prev == CODE_V, pos2, p, q, gap);
    src[0][tid] = adv1 ? (int)pos1 : -1;
    src[1][tid] = adv2 ? (int)pos2 : -1;
    i64* d = dlt[tid];
    d[GO - GO] = q[0];
    d[GE - GO] = q[1];
    d[GTO - GO] = q[2];
    d[GTE - GO] = q[3];
    d[GAP - 1 - GO] = 0;
    d[GAP - GO] = gap;
    __syncthreads();

    // rows base+1 .. base+steps, a warp a row, lane l symbol l: the
    // parents' loads of K6_UNROLL rows are all issued before any of them
    // is used
    for (int t0 = warp; t0 < steps; t0 += WARPS * K6_UNROLL) {
        int a[K6_UNROLL], c[K6_UNROLL];
#pragma unroll
        for (int u = 0; u < K6_UNROLL; ++u) {
            const int t = t0 + u * WARPS < steps ? t0 + u * WARPS : t0;
            a[u] = side_raw(s1, src[0][t], lane);
            c[u] = side_raw(s2, src[1][t], lane);
        }
#pragma unroll
        for (int u = 0; u < K6_UNROLL; ++u) {
            const int t = t0 + u * WARPS;
            if (t >= steps) break;
            i64 x = side_value(s1, a[u], lane) + side_value(s2, c[u], lane);
            if (lane >= GO && lane <= GAP) x += dlt[t][lane - GO];
            o[(i64)(base + t + 1) * 32 + lane] = (int)x;
        }
    }
}

}  // namespace

extern "C" {

// desc [2 nb][8] int64: the side descriptors; hdr [nb][8] int64 (w1, w2,
// ...); paths: K4's output buffer (16-byte trailers, then the forward
// paths, merge b's at 16 nb + sum_{c<b} (w1_c + w2_c)); out [nb][smax+1]
// [32] int32, every element written (a merge of w1 0 is skipped: nothing
// of its rows is written); smax >= every w1 + w2 (a chain step: its
// capacity, and a longer path, an overflow, is cut at smax rows).
// Returns the launch's cudaError_t.
int merged_counters(const void* desc, const void* hdr, const void* paths,
                    int nb, int smax, void* out, void* stream) {
    if (nb <= 0 || smax <= 0) return 0;
    const dim3 grid(nb, (smax + K6_TILE - 1) / K6_TILE);
    merged_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const i64*>(desc), static_cast<const i64*>(hdr),
        static_cast<const uint8_t*>(paths), nb, smax,
        static_cast<int*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
