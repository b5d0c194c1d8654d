// The carry of a chain chunk from one step to the next (ops/dp_chain.py),
// shared by the two kernels that run it: K5's chain entry (csrc/stage0.cu:
// stage0_chain) before each step, and K7 (csrc/chain.cu) once after the
// chunk's last step.  Plain PyTorch twin: ops/dp_chain.py:
// chain_carry_plain.
//
// Replaces the carry of the scan famsa_tpu/ops/dp_chain.py:_dp_chain_scan
// (:81-101) and the path width of ops/dp_giant.py:_giant_core's
// want_width (:477-479).
//
// The fold before step k (k = 0..nk) folds step k-1 (k > 0) into the
// state (width, cardinality, poison): when step k-1 ran (its header's
// w1 >= 1), the width becomes its path length n (K4's trailer: the steps
// of the path, famsa_tpu's emits that are not 3), the cardinality
// card + 1, and widths[k-1] = n; a walk that left its matrix (n < 0) or
// a width past the chunk's capacity poisons the chain.  A step that did
// not run records -2.  Then (k < nk) it gives step k's header (w1, w2, 0,
// 0, card1, card2, 0, 0) and its two side descriptors (csrc/sides.cuh):
// the leaf's symbol bytes and the carry buffer step k-1's K6 wrote; w1 =
// lw[k], or 0 when the lane is invalid (lw 0) or the chain is poisoned,
// which makes every kernel of step k (K5, the DP, K4, K6) return at once.
// The poison stays until the host seeds the chain again.
//
// The state is double-buffered, st[2][4]: the fold before step k < nk
// reads slot k % 2 and writes slot (k + 1) % 2, so the CTA of K5's chain
// entry that writes it never changes what the launch's other CTAs read;
// the fold after the last step (K7, one warp) updates slot nk % 2 in
// place.  nk is even, so a chunk starts and ends in slot 0.

#pragma once

#include <cstdint>

#include "sides.cuh"

namespace famsa_chain {

typedef long long i64;

constexpr int NOT_RUN = -2;
constexpr int SLOT = 4;                  // int64 words a state slot
constexpr int HDR_WORDS = 8;

// the buffers of a chunk (ops/dp_chain.py:ChainBuffers) and its step
struct ChainArgs {
    const uint8_t* leaf;                 // [nk][w1p] symbol bytes
    const i64* lw;                       // [nk] leaf widths (0: invalid)
    i64* st;                             // [2][SLOT] the state
    const uint8_t* paths;                // K4's output, step j's at j * ps
    i64 ps;
    int* widths;                         // [nk] merged widths recorded
    i64* hdr;                            // [nk][8] headers
    i64* desc;                           // [nk][2][DESC_WORDS] descriptors
    const int* carry0;                   // side 2 of even steps
    const int* carry1;                   // side 2 of odd steps
    i64 cap;
    int w1p, k, nk;
};

// One warp (lane 0..31): the fold before step a.k.  Every lane reads the
// state and step k-1's header and trailer; with `commit`, lane 0 writes
// the new state and widths[k-1].  For k < nk, lanes 0-23 write step k's
// header into h[0..7] and its descriptors into d[0..15] (global or shared
// memory).
__device__ __forceinline__ void fold(const ChainArgs& a, int lane, i64* h,
                                     i64* d, bool commit) {
    const int k = a.k;
    const i64* src = a.st + SLOT * (k & 1);
    i64 w = src[0], card = src[1], poison = src[2];
    int rec = NOT_RUN;
    if (k > 0) {
        // both loads issued before either is used
        const i64 ran = a.hdr[HDR_WORDS * (i64)(k - 1)];
        const int n = *reinterpret_cast<const int*>(
            a.paths + (i64)(k - 1) * a.ps + 8);
        if (ran >= 1) {
            rec = n;
            if (n < 0 || n > a.cap) poison = 1;
            if (n >= 0) {
                w = n;
                card += 1;
            }
        }
    }
    __syncwarp();                        // every lane has read the state
    if (commit && lane == 0) {
        i64* dst = a.st + SLOT * (k < a.nk ? (k + 1) & 1 : k & 1);
        dst[0] = w;
        dst[1] = card;
        dst[2] = poison;
        if (k > 0) a.widths[k - 1] = rec;
    }
    if (k >= a.nk) return;
    const i64 lwk = a.lw[k];
    const i64 w1 = (poison == 0 && lwk >= 1) ? lwk : 0;
    const int q = lane & 7;
    if (lane < 8) {                      // the header
        h[q] = q == 0 ? w1 : q == 1 ? w : q == 4 ? 1 : q == 5 ? card : 0;
    } else if (lane < 24) {              // side 1 (the leaf), side 2
        const bool s1 = lane < 16;
        const i64 addr = s1 ? (i64)(a.leaf + (i64)k * a.w1p)
                            : (i64)(k % 2 ? a.carry1 : a.carry0);
        i64 v;
        switch (q) {
        case 0: v = s1 ? famsa_sides::SIDE_LEAF : famsa_sides::SIDE_RESIDENT;
                break;
        case 1: v = addr; break;
        case 2: v = s1 ? 1 : 32; break;
        case 3: v = s1 ? w1 : w; break;
        case 4: v = s1 ? 1 : card; break;
        default: v = 0;
        }
        d[(s1 ? 0 : 1) * famsa_sides::DESC_WORDS + q] = v;
    }
}

}  // namespace famsa_chain
