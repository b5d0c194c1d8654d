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
// 128 bytes written a step).  Design: one CTA a merge walks its path in
// tiles of 512 steps, one step a thread: two block scans (the two
// parents' positions packed in one uint64 sum, the last run start a max)
// carried across tiles, the step's rows and deltas staged in shared
// memory; then each warp writes whole rows, lane l the counter of
// symbol l, reading the parents' rows coalesced.  No atomics.

#include <cstdint>
#include <cuda_runtime.h>

#include "sides.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;
using famsa_sides::load_side;
using famsa_sides::Side;
using famsa_sides::side_count;

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GO = 25, GE = 26, GTE = 27, GTO = 28, GAP = 30;
constexpr int CODE_H = 1, CODE_V = 2, CODE_END = 3;

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

__global__ void __launch_bounds__(THREADS)
merged_kernel(const i64* __restrict__ desc, const i64* __restrict__ hdr,
              const uint8_t* __restrict__ paths, int nb, int smax,
              int* __restrict__ out) {
    __shared__ u64 wsum[WARPS];
    __shared__ i64 wmax[WARPS];
    __shared__ int src[2][THREADS];
    __shared__ i64 dlt[5][THREADS];
    const int b = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    if (hdr[8 * (i64)b] < 1) return;     // a chain step K7 skipped
    const Side s1 = load_side(desc, b), s2 = load_side(desc, nb + b);
    i64 poff = 16 * (i64)nb;
    for (int c = 0; c < b; ++c) poff += hdr[8 * (i64)c] + hdr[8 * (i64)c + 1];
    int n = *reinterpret_cast<const int*>(paths + 16 * (i64)b + 8);
    if (n < 0) n = 0;                    // a failed walk (resolve raises)
    const uint8_t* fwd = paths + poff;
    int* o = out + (i64)b * (smax + 1) * 32;
    if (tid < 32) o[tid] = 0;

    u64 pos_carry = 0;                   // advances of parent 1 | 2 << 32
    i64 start_carry = 0;                 // the last run start so far
    for (int base = 0; base < smax; base += THREADS) {
        const int k = base + tid;
        const int code = k < n ? fwd[k] : CODE_END;
        const int prev = (k >= 1 && k - 1 < n) ? fwd[k - 1] : CODE_END;
        const bool run1 = code == CODE_H, run2 = code == CODE_V;
        const bool adv1 = code != CODE_END && !run1;
        const bool adv2 = code != CODE_END && !run2;
        const bool start = (run1 && prev != CODE_H) ||
                           (run2 && prev != CODE_V);
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
        u64 pre = pos_carry, tot = pos_carry;
        i64 mpre = start_carry, mtot = start_carry;
        for (int v = 0; v < WARPS; ++v) {
            if (v < warp) {
                pre += wsum[v];
                mpre = wmax[v] > mpre ? wmax[v] : mpre;
            }
            tot += wsum[v];
            mtot = wmax[v] > mtot ? wmax[v] : mtot;
        }
        ps += pre;
        ms = mpre > ms ? mpre : ms;
        pos_carry = tot;
        start_carry = mtot;

        const i64 pos1 = (i64)(ps & 0xffffffffu), pos2 = (i64)(ps >> 32);
        const i64 p = k - ms + 1;        // the step's place in its run
        i64 q[4] = {0, 0, 0, 0}, gap = 0;
        parent_gaps(s1, run1, adv1 && prev == CODE_H, pos1, p, q, gap);
        parent_gaps(s2, run2, adv2 && prev == CODE_V, pos2, p, q, gap);
        src[0][tid] = adv1 ? (int)pos1 : -1;
        src[1][tid] = adv2 ? (int)pos2 : -1;
        for (int t = 0; t < 4; ++t) dlt[t][tid] = q[t];
        dlt[4][tid] = gap;
        __syncthreads();

        // rows base+1 .. base+steps, a warp a row, lane l symbol l
        const int steps = min(THREADS, smax - base);
        for (int t = warp; t < steps; t += WARPS) {
            i64 v = side_count(s1, src[0][t], lane)
                  + side_count(s2, src[1][t], lane);
            if (lane == GO) v += dlt[0][t];
            else if (lane == GE) v += dlt[1][t];
            else if (lane == GTO) v += dlt[2][t];
            else if (lane == GTE) v += dlt[3][t];
            else if (lane == GAP) v += dlt[4][t];
            o[(i64)(base + t + 1) * 32 + lane] = (int)v;
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
    if (nb <= 0) return 0;
    merged_kernel<<<nb, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const i64*>(desc), static_cast<const i64*>(hdr),
        static_cast<const uint8_t*>(paths), nb, smax,
        static_cast<int*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
