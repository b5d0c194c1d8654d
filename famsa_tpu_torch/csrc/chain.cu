// K7: the carry of a chain chunk from one step to the next, on the card.
//
// A chunk (ops/dp_chain.py) merges up to K leaves, one a step, into the
// chain's profile, all in one CUDA graph: per step K5 (stage 0), the DP
// (K2 staged or stripes, B = 1), K4 (the traceback) and K6 (the merged
// counters,
// into the other of two ping-pong carry buffers).  Step k's profile width
// and cardinality exist only on the card, as the result of step k-1, so
// K7 runs between two steps and writes what the next step's kernels read:
// its header (w1, w2, 0, 0, card1, card2, 0, 0) and its two side
// descriptors (csrc/sides.cuh): the leaf's symbol bytes and the carry
// buffer step k-1's K6 wrote.
//
// Replaces the carry of the scan famsa_tpu/ops/dp_chain.py:_dp_chain_scan
// (:81-101) and the path width of ops/dp_giant.py:_giant_core's
// want_width (:477-479).  Plain PyTorch twin: ops/dp_chain.py:
// chain_carry_plain.
//
// K7(k) folds step k-1 (k > 0) into the state st = (width, cardinality,
// poison): when step k-1 ran (its header's w1 >= 1), the width becomes
// its path length n (K4's trailer: the steps of the path, famsa_tpu's
// emits that are not 3), the cardinality card + 1, and widths[k-1] = n;
// a walk that left its matrix (n < 0) or a width past the chunk's
// capacity poisons the chain.  A step that did not run records -2.  Then
// (k < K) it writes step k's header and descriptors: w1 = lw[k], or 0
// when the lane is invalid (lw 0) or the chain is poisoned, which makes
// every kernel of step k (K5, the DP, K4, K6) return at once.  The
// poison stays until the host seeds the chain again.
//
// What bounds it: launch latency (it reads and writes ~300 bytes); the
// chunk's graph removes the launch's host cost.  One warp: lane 0 the
// state, lanes 0-23 the header's and descriptors' 24 words.

#include <cstdint>
#include <cuda_runtime.h>

#include "sides.cuh"

namespace {

typedef long long i64;
using famsa_sides::DESC_WORDS;
using famsa_sides::SIDE_LEAF;
using famsa_sides::SIDE_RESIDENT;

constexpr int NOT_RUN = -2;

__global__ void __launch_bounds__(32)
chain_kernel(const uint8_t* __restrict__ leaf, const i64* __restrict__ lw,
             i64* __restrict__ st, const uint8_t* __restrict__ paths, i64 ps,
             int* __restrict__ widths, i64* __restrict__ hdr,
             i64* __restrict__ desc, const int* carry0, const int* carry1,
             i64 cap, int w1p, int k, int nk) {
    const int lane = threadIdx.x;
    i64 w = st[0], card = st[1], poison = st[2];
    int rec = NOT_RUN;
    if (k > 0 && hdr[8 * (i64)(k - 1)] >= 1) {
        const int n = *reinterpret_cast<const int*>(paths + (k - 1) * ps + 8);
        rec = n;
        if (n < 0 || n > cap) poison = 1;
        if (n >= 0) {
            w = n;
            card += 1;
        }
    }
    __syncwarp();                        // every lane has read st
    if (k > 0 && lane == 0) {
        st[0] = w;
        st[1] = card;
        st[2] = poison;
        widths[k - 1] = rec;
    }
    if (k >= nk) return;
    const i64 w1 = (poison == 0 && lw[k] >= 1) ? lw[k] : 0;
    const int q = lane & 7;
    i64 v = 0;
    if (lane < 8) {                      // the header
        v = q == 0 ? w1 : q == 1 ? w : q == 4 ? 1 : q == 5 ? card : 0;
        hdr[8 * (i64)k + q] = v;
    } else if (lane < 24) {              // side 1 (the leaf), side 2
        const bool s1 = lane < 16;
        const i64 addr = s1
            ? (i64)(leaf + (i64)k * w1p)
            : (i64)(k % 2 ? carry1 : carry0);
        switch (q) {
        case 0: v = s1 ? SIDE_LEAF : SIDE_RESIDENT; break;
        case 1: v = addr; break;
        case 2: v = s1 ? 1 : 32; break;
        case 3: v = s1 ? w1 : w; break;
        case 4: v = s1 ? 1 : card; break;
        default: v = 0;
        }
        desc[(2 * (i64)k + (s1 ? 0 : 1)) * DESC_WORDS + q] = v;
    }
}

}  // namespace

extern "C" {

// One K7 launch of a chunk of nk steps, before step k (k = 0..nk; k = nk
// only folds the last step).  leaf [nk][w1p] symbol bytes, lw [nk] int64
// leaf widths (0: an invalid lane), st [3] int64 (width, cardinality,
// poison), paths: K4's outputs, step j's at j * ps (ps a multiple of 16),
// widths [nk] int32, hdr [nk][8] int64, desc [nk][2][8] int64, carry0 and
// carry1 the two carry buffers (the side 2 of even and of odd steps), cap
// the chunk's capacity.  Returns the launch's cudaError_t.
int chain_carry(const void* leaf, const void* lw, void* st, const void* paths,
                long long ps, void* widths, void* hdr, void* desc,
                const void* carry0, const void* carry1, long long cap,
                int w1p, int k, int nk, void* stream) {
    if (k < 0 || k > nk || ps % 16 != 0) return (int)cudaErrorInvalidValue;
    chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(leaf), static_cast<const i64*>(lw),
        static_cast<i64*>(st), static_cast<const uint8_t*>(paths), ps,
        static_cast<int*>(widths), static_cast<i64*>(hdr),
        static_cast<i64*>(desc), static_cast<const int*>(carry0),
        static_cast<const int*>(carry1), cap, w1p, k, nk);
    return (int)cudaGetLastError();
}

}  // extern "C"
