// The profile DP row shared by K2 (batched merges: the staged, stripes
// and spans variants in csrc/dp_wide.cu, one cluster or a span of
// clusters of column folds per merge) and K3 (csrc/dp_wide.cu, one merge
// over a cluster of column folds): plane layouts, wrapped int64
// arithmetic and the per-thread body of one DP row.
//
// A CTA walks the columns [c0, c0 + threads * S) of a merge, each thread a
// contiguous stripe of S columns whose previous-row D/H/V stay in
// registers (S = 1, 2 or 4, unrolled).  The row recurrence is that of
// ops/dp_torch.py:dp_plain:
//  - match term t[i,j] = sum_s c1[i,s] * s2[j,s] over the nonzero counts of
//    row i (compacted on the host);
//  - D from the previous row at j-1, V from the previous row at j, with the
//    rank<=4 row x column gap factors and the tmH / tmV corrections;
//  - H by the max-plus prefix scan H = bc + max(cummax(m - bc), -inf), where
//    bc[j] = g1ce[i]*cumE[j] + g1cte[i]*cumT[j] is the prefix sum of the
//    H-continuation costs (exact mod 2^64, so no scan is needed for it);
//  - strict '>' direction picks in the order of core/dp.py
//    _choose_D / _choose_H3 / _choose_V3;
//  - the guided band: cells outside [lo, hi] read -inf, column 0 keeps its
//    boundary V.
// All additions, subtractions and products run on unsigned 64-bit values
// and are cast back, so overflow wraps in two's complement exactly like
// the NumPy, native and XLA paths.
//
// What enters from the left of the CTA's first column (a fold edge):
// the current row's D and V there, read by thread 0, and the running max
// of m - bc over every column left of the CTA (the seed of the block
// max-scan), read by every thread.  H at a stripe's left halo is rebuilt
// from the scan prefix, so it need not be exchanged.
//
// dp_row is one body for every fold body, templated on where its column
// factors come from (Cols: the staged body keeps its column's factors in
// registers and the score planes in shared memory, the stripes body
// reads its planes through two pointers, shared and global,
// csrc/dp_wide.cu) and on how threads exchange the stripe-end D/V and the
// warp maxima of the scan (Xch: shuffles and one CTA barrier a row).
// The row factors are read through a pointer to shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace famsa_dp {

typedef long long i64;
typedef unsigned long long u64;

constexpr i64 NEG = -(1LL << 62);
constexpr i64 IMIN = (i64)0x8000000000000000ULL;
constexpr int MAX_THREADS = 512;

// column-factor planes: colf [B][NCOLF][ldc]; must match ops/dp_torch.py
enum {
    C_S2 = 0,                 // 30 planes: scores2[j, s], s < 30
    C_P2O = 30, C_P2E, C_P2TO, C_P2TE, C_G2CHG,
    C_G2SO, C_G2SE, C_G2STO, C_G2STE, C_G2CE, C_G2CTE,
    C_CUME, C_CUMT, C_H0,
    NCOLF
};
// row-factor planes: rowf [B][ldr][NROWF]; must match ops/dp_torch.py
enum {
    R_NNZ = 0, R_CNT = 1, R_SYM = 31,   // compacted nonzero counts of row i
    R_NNG = 61, R_N1C, R_N1TC,
    R_S1GO, R_S1GE, R_S1GTO, R_S1GTE,
    R_G1SO, R_G1SE, R_G1STO, R_G1STE, R_G1CE, R_G1CTE,
    R_V0COST, R_LO, R_HI,
    NROWF
};

__device__ __forceinline__ i64 add(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 sub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__device__ __forceinline__ i64 mul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }

// A thread's stripe: the previous row's D/H/V of its columns, and at its
// left halo (column j0 - 1).
template <int S>
struct Stripe {
    static_assert(S > 0, "a stripe holds registers");
    static constexpr int SA = S;                         // array size
    i64 pD[SA], pH[SA], pV[SA], mDa[SA], mVa[SA], loc[SA];
    uint8_t pk[SA];
    i64 hD, hH, hV;
};

#define CF(p, j) __ldg(cf + (size_t)(p) * ldc + (j))

// DP row 0 of the stripe starting at global column j0 (profile_seq.cpp:
// 555-579 boundary; h0 carries -inf at columns 0 and w2).  dr: the
// merge's direction bytes, row 0 first.
template <int S>
__device__ __forceinline__ void row0(Stripe<S>& st, const i64* __restrict__ cf,
                                     int ldc, i64 w2, i64 j0, int SS,
                                     uint8_t* __restrict__ dr) {
    constexpr int SU = S;                         // unroll factor
#pragma unroll SU
    for (int k = 0; k < Stripe<S>::SA; ++k) {
        if (k >= SS) break;
        const i64 j = j0 + k;
        st.pD[k] = (j == 0) ? 0 : NEG;
        st.pH[k] = (j <= w2) ? CF(C_H0, j) : NEG;
        st.pV[k] = NEG;
        if (j <= w2) dr[j] = (j == 0) ? 0 : (1 | (1 << 2) | (1 << 4));
    }
    st.hD = st.hH = st.hV = NEG;
    if (j0 > 0 && j0 - 1 <= w2) {
        st.hD = (j0 - 1 == 0) ? 0 : NEG;
        st.hH = CF(C_H0, j0 - 1);
    }
}

// DP row i (1 <= i <= w1) of the stripe starting at global column j0,
// thread t of the CTA (all threads of the CTA call it together: it holds
// the exchange's barriers).  eD, eV: the current row's D and V left of the CTA's
// first column (read by t == 0); seed: the running max of m - bc over the
// columns left of the CTA.  Writes the row's direction bytes to drow and,
// from the thread owning column w2, the last-column (D, H, V) to frow.
// Returns the running max of m - bc through the stripe's last column.
template <int S, class Cols, class Xch>
__device__ __forceinline__ i64 dp_row(Stripe<S>& st, Xch& xch,
                                      const Cols& cols,
                                      const i64* __restrict__ rr, i64 i,
                                      i64 w1, i64 w2, i64 j0, int SS, int t,
                                      i64 eD, i64 eV, i64 seed,
                                      uint8_t* __restrict__ drow,
                                      i64* __restrict__ frow) {
    constexpr int SA = Stripe<S>::SA;
    constexpr int SU = S;
    const int lane = t & 31;
    const int nnz = (int)rr[R_NNZ];
    const i64 nng = rr[R_NNG], n1c = rr[R_N1C], n1tc = rr[R_N1TC];
    const i64 s1go = rr[R_S1GO], s1ge = rr[R_S1GE];
    const i64 s1gto = rr[R_S1GTO], s1gte = rr[R_S1GTE];
    const i64 g1so = rr[R_G1SO], g1se = rr[R_G1SE];
    const i64 g1sto = rr[R_G1STO], g1ste = rr[R_G1STE];
    const i64 g1ce = rr[R_G1CE], g1cte = rr[R_G1CTE];
    const i64 v0cost = rr[R_V0COST], lo = rr[R_LO], hi = rr[R_HI];
    const bool i_gt1 = i > 1;
    auto& pD = st.pD;
    auto& pH = st.pH;
    auto& pV = st.pV;

    // ---- pass A: D and V, right to left so that pD/pV[k-1] still
    // hold the previous row when column k reads them
#pragma unroll SU
    for (int k = SA - 1; k >= 0; --k) {
        const i64 j = j0 + k;
        if (j > w2) { pD[k] = NEG; pV[k] = NEG; st.pk[k] = 0; continue; }
        if (j == 0) {
            const i64 v0 = (i < w1) ? add(imax(pD[0], pV[0]), v0cost) : NEG;
            pD[0] = NEG;
            pV[0] = v0;
            st.pk[0] = 0;
            continue;
        }
        const i64 lpD = k == 0 ? st.hD : pD[k - 1];
        const i64 lpH = k == 0 ? st.hH : pH[k - 1];
        const i64 lpV = k == 0 ? st.hV : pV[k - 1];
        i64 tt = 0;
        if constexpr (Cols::SHARED_SCORES) {
#pragma unroll 4
            for (int q = 0; q < nnz; ++q)
                tt = add(tt, mul(rr[R_CNT + q], cols.score(rr[R_SYM + q], k)));
        } else {
            for (int q = 0; q < nnz; ++q)
                tt = add(tt, mul(rr[R_CNT + q], cols.score(rr[R_SYM + q], k)));
        }
        const i64 p2o = cols(C_P2O, k), p2e = cols(C_P2E, k);
        const i64 p2to = cols(C_P2TO, k), p2te = cols(C_P2TE, k);
        const i64 delta = add(mul(n1c, sub(p2e, p2o)),
                              mul(n1tc, sub(p2te, p2to)));
        // D channel (_choose_D: strict D, then tH > tV -> H else V)
        i64 tD = add(lpD, tt);
        i64 tH = add(add(lpH, tt), delta);
        i64 tV = add(add(lpV, tt), mul(cols(C_G2CHG, k), nng));
        const bool pickD = tD > tH && tD > tV;
        const bool pickH = !pickD && tH > tV;
        i64 D = pickD ? tD : (pickH ? tH : tV);
        const int dD = pickD ? 0 : (pickH ? 1 : 2);
        // V channel (_choose_V3)
        const bool three = i_gt1 && j > 1;
        const i64 gvs = add(add(mul(s1go, cols(C_G2SO, k)), mul(s1ge, cols(C_G2SE, k))),
                            add(mul(s1gto, cols(C_G2STO, k)), mul(s1gte, cols(C_G2STE, k))));
        const i64 gvc = add(mul(s1ge, cols(C_G2CE, k)), mul(s1gte, cols(C_G2CTE, k)));
        tD = add(pD[k], gvs);
        tH = add(pH[k], gvs);
        tV = add(pV[k], gvc);
        i64 V;
        int dV;
        if (three) {
            const bool pD3 = tD > tH && tD > tV;
            const bool pH3 = !pD3 && tH > tV;
            V = pD3 ? tD : (pH3 ? tH : tV);
            dV = pD3 ? 0 : (pH3 ? 1 : 2);
        } else {
            const bool pD2 = tD > tV;
            V = pD2 ? tD : tV;
            dV = pD2 ? 0 : 2;
        }
        if (j < lo || j > hi) { D = NEG; V = NEG; }
        pD[k] = D;
        pV[k] = V;
        st.pk[k] = (uint8_t)(dD | (dV << 4));
    }

    // ---- pass the stripe's last D/V to the right neighbour
    i64 lD, lV;
    xch.edge(i, t, pD[SS - 1], pV[SS - 1], eD, eV, lD, lV);

    // ---- pass B: m, x = m - bc and the stripe's running max of x
    i64 run = IMIN;
#pragma unroll SU
    for (int k = 0; k < SA; ++k) {
        if (k >= SS) break;
        const i64 j = j0 + k;
        if (j == 0 || j > w2) { st.loc[k] = run; continue; }
        const i64 Dl = k == 0 ? lD : pD[k - 1];
        const i64 Vl = k == 0 ? lV : pV[k - 1];
        const i64 ghs = add(add(mul(cols(C_P2O, k), g1so), mul(cols(C_P2E, k), g1se)),
                            add(mul(cols(C_P2TO, k), g1sto), mul(cols(C_P2TE, k), g1ste)));
        const i64 mD = add(Dl, ghs), mV = add(Vl, ghs);
        const i64 m = (i_gt1 && j > 1) ? imax(mD, mV) : mD;
        const i64 bc = add(mul(g1ce, cols(C_CUME, k)), mul(g1cte, cols(C_CUMT, k)));
        run = imax(run, sub(m, bc));
        st.loc[k] = run;
        st.mDa[k] = mD;
        st.mVa[k] = mV;
    }

    // ---- block-wide exclusive max-scan of the stripe maxima, seeded
    // with the running max left of the CTA
    i64 inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const i64 o = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc = imax(inc, o);
    }
    i64 P = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) P = IMIN;
    P = imax(P, xch.warps_left(i, t, inc));
    P = imax(P, seed);

    // ---- pass C: H, its direction, the packed bytes and the finals.
    // H at j0-1 (the left halo) from the prefix: cummax there is P.
    i64 Hl = NEG;
    if (j0 > 0) {
        const i64 jl = j0 - 1;
        if (jl >= 1 && jl <= w2 && jl >= lo && jl <= hi)
            Hl = add(add(mul(g1ce, cols.left(C_CUME)), mul(g1cte, cols.left(C_CUMT))),
                     imax(P, NEG));
    }
    const i64 hHn = Hl;
#pragma unroll SU
    for (int k = 0; k < SA; ++k) {
        if (k >= SS) break;
        const i64 j = j0 + k;
        if (j > w2) { pH[k] = NEG; continue; }
        if (j == 0) {
            pH[0] = NEG;
            Hl = NEG;
            drow[0] = 2 | (2 << 2) | (2 << 4);
            continue;
        }
        const i64 bc = add(mul(g1ce, cols(C_CUME, k)), mul(g1cte, cols(C_CUMT, k)));
        i64 H = add(bc, imax(imax(P, st.loc[k]), NEG));
        if (j < lo || j > hi) H = NEG;
        const i64 ghc = add(mul(cols(C_P2E, k), g1ce), mul(cols(C_P2TE, k), g1cte));
        const i64 tHh = add(Hl, ghc);
        const i64 mD = st.mDa[k], mV = st.mVa[k];
        int dH;
        if (i_gt1 && j > 1) {   // _choose_H3: strict D, then tV > tH -> V
            const bool pD3 = mD > tHh && mD > mV;
            const bool pV3 = !pD3 && mV > tHh;
            dH = pD3 ? 0 : (pV3 ? 2 : 1);
        } else {
            dH = mD > tHh ? 0 : 1;
        }
        drow[j] = (uint8_t)(st.pk[k] | (dH << 2));
        if (j == w2) {
            frow[0] = pD[k];
            frow[1] = H;
            frow[2] = pV[k];
        }
        pH[k] = H;
        Hl = H;
    }
    st.hD = lD;
    st.hV = lV;
    st.hH = hHn;
    return imax(P, st.loc[SS - 1]);
}

#undef CF

}  // namespace famsa_dp
