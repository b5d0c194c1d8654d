// K5: stage 0 of the profile DP on the card.  From the two sides'
// counters, read where they lie through the launch's side descriptors
// (csrc/sides.cuh), it builds the packed inputs of K2 and K3 for every
// merge of a launch in one launch: the column planes colf [B][NCOLF][ldc]
// from side 2, the row planes rowf [B][w1p+1][NROWF] from side 1, and
// meta [B][4], equal in every int64 to ops/dp_pack.py:prepare_merge +
// pack_batch, padding rows and columns (zero) included.
//
// Replaces the jnp device program famsa_tpu/ops/dp_pallas.py:_stage0_one
// (:844), with _scores_from_counters (:791) and _gap_corrections_device
// (:819), which the JAX package runs inside the programs of the batched
// DP (_tb_counters_impl :1239) and of the wide merge (dp_giant.py
// _giant_core :363).  Plain PyTorch twin: ops/dp_stage0.py:stage0_plain.
//
// Per counter row r of a side (one warp a row, lane l = symbol column l):
//  - scores s[r][l] = sum_{k<24} c[r][k] T[k][l] + n_aa T[24][l], plus the
//    row's gap cost sum_{g=25..28} c[r][g] T[24][g] in columns 0..23;
//    row 0 is card * T[24][l] (T: ops/dp_stage0.py:score_table).  Only
//    the nonzero counts of the row enter the sum (a ballot of them);
//  - the six gap-correction counts of core/dp.py:_gap_corrections;
//  - side 1: the compaction of the row's 30 symbol counts, nonzeros
//    first in stable order (R_CNT / R_SYM), by a ballot and a __popc
//    prefix; side 2: the running sums of its GAP_EXT and GAP_TERM_EXT
//    scores (C_CUME, C_CUMT) and the row-0 boundary h0 = cumsum(inc *
//    card1), carried from one tile of rows to the next by a block scan.
// Every add and multiply runs on uint64 and is cast back, so the int64
// results wrap in two's complement as the host's np.errstate(over=
// "ignore") cumsums and products do.  No atomics: every sum has a fixed
// order, so the result is deterministic.
//
// What bounds it: bytes (each input row read once, 8 * (44 ldc + 77 (w1p
// + 1)) bytes written a merge), and the serial carry of side 2's running
// sums.  Design: a CTA a chunk of CHUNK rows of a (merge, side), 16
// warps walking it in tiles of 16 rows; the score table in shared
// memory; the column planes staged in shared memory (padded against bank
// conflicts) so that every plane is written as 16 consecutive int64.  A
// chunk of side 2 starts its running sums from the rows before it
// without walking them: a row's scores are linear in its counts, so the
// sum of the GAP_EXT / GAP_TERM_EXT scores over rows 1..r0-1 is the score
// of the column sums of their counts (exact mod 2^64), and h0's sum is
// card1 (s[1][GTO] + that GAP_TERM_EXT sum - s[1][GTE]).
//
// The chain's entry, stage0_chain (ops/dp_chain.py): one merge of a
// chain chunk, with the grid sized for the chunk's capacity.  Each CTA
// first runs the chain's carry before its step (csrc/chain.cuh:fold,
// K7's body; warp 0): from the state and step k-1's header and path
// length it computes step k's header and side descriptors into its own
// shared memory, and reads its sides from there.  CTA (0, 0) commits the
// fold: the state (double-buffered, so no CTA of the launch sees it half
// written), step k-1's recorded width, and step k's header and
// descriptors in global memory, for the DP, K4 and K6 launches that
// follow in stream order.  Only then may a CTA return: a step the fold
// marked skipped (w1 0) writes its meta and returns, and a CTA whose rows
// start past its side's width + 1 returns at once (the DP kernels read no
// column past w2 + 1 and no row past w1).  This removes K7's launch
// before every step; K7 runs once a chunk, after its last step.

#include <cstdint>
#include <cuda_runtime.h>

#include "chain.cuh"
#include "dp_common.cuh"
#include "sides.cuh"

namespace {

using famsa_dp::add;
using famsa_dp::i64;
using famsa_dp::mul;
using famsa_dp::sub;
using famsa_sides::load_side;
using famsa_sides::Side;
using famsa_sides::side_count;

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 16 * WARPS;        // rows a CTA
constexpr unsigned FULL = 0xffffffffu;
constexpr int NAA = 24;                  // amino acids
constexpr int NAG = 30;                  // amino acids and gap categories
constexpr int GO = 25, GE = 26, GTE = 27, GTO = 28;
constexpr int TROWS = NAA + 1;
constexpr int NCOLF = famsa_dp::NCOLF;
constexpr int NROWF = famsa_dp::NROWF;

// lane-uniform values of one counter row
struct Row {
    i64 naa, cgo, cge, cgte, cgto;       // counts
    i64 sgo, sge, sgte, sgto;            // gap-column scores
    i64 g[6];                            // gap corrections
};

// the warp's sum, wrapped mod 2^64
__device__ __forceinline__ i64 warp_sum(i64 v) {
    for (int o = 16; o; o >>= 1) v = add(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// s[r][lane] of count c (lane's symbol) of row r; fills rw's counts and
// gap-column scores
__device__ __forceinline__ i64 row_scores(const i64 (*T)[32], i64 c, i64 r,
                                          i64 card, int lane, Row& rw) {
    const unsigned nz = __ballot_sync(FULL, lane < NAA && c != 0);
    rw.naa = warp_sum(lane < NAA ? c : 0);
    rw.cgo = __shfl_sync(FULL, c, GO);
    rw.cge = __shfl_sync(FULL, c, GE);
    rw.cgte = __shfl_sync(FULL, c, GTE);
    rw.cgto = __shfl_sync(FULL, c, GTO);
    i64 sc;
    if (r == 0) {
        sc = mul(card, T[NAA][lane]);
    } else {
        sc = mul(rw.naa, T[NAA][lane]);
        for (unsigned m = nz; m; m &= m - 1) {
            const int k = __ffs(m) - 1;
            sc = add(sc, mul(__shfl_sync(FULL, c, k), T[k][lane]));
        }
        if (lane < NAA) {
            i64 gap = mul(rw.cgo, T[NAA][GO]);
            gap = add(gap, mul(rw.cge, T[NAA][GE]));
            gap = add(gap, mul(rw.cgte, T[NAA][GTE]));
            gap = add(gap, mul(rw.cgto, T[NAA][GTO]));
            sc = add(sc, gap);
        }
    }
    rw.sgo = __shfl_sync(FULL, sc, GO);
    rw.sge = __shfl_sync(FULL, sc, GE);
    rw.sgte = __shfl_sync(FULL, sc, GTE);
    rw.sgto = __shfl_sync(FULL, sc, GTO);
    return sc;
}

// st_open, st_ext, st_to, st_te, ct_ext, ct_te of row r of a side of
// width w (core/dp.py:_gap_corrections); cn = the next row's GTO count
__device__ __forceinline__ void gap_corrections(Row& rw, i64 r, i64 w,
                                                i64 card, i64 cn) {
    const i64 cnt = rw.cgto + rw.cgte, ext = rw.cgo + rw.cge;
    const i64 ct_te = cn + cnt;
    if (r >= 1 && r < w) {
        rw.g[0] = card - ext - ct_te;
        rw.g[1] = ext;
        rw.g[2] = cn;
        rw.g[3] = cnt;
        rw.g[4] = card - ct_te;
        rw.g[5] = ct_te;
    } else if (r == w && w >= 1) {
        rw.g[0] = rw.g[1] = rw.g[4] = 0;
        rw.g[2] = card - cnt;
        rw.g[3] = cnt;
        rw.g[5] = card;
    } else {
        for (int q = 0; q < 6; ++q) rw.g[q] = 0;
    }
}

template <bool CHAIN>
__global__ void __launch_bounds__(THREADS)
stage0_kernel(const i64* __restrict__ desc_in, const i64* __restrict__ hdr_in,
              const i64* __restrict__ table, const i64* __restrict__ band,
              int nb, int w1p, int ldc, int nch1, i64* __restrict__ colf,
              i64* __restrict__ rowf, i64* __restrict__ meta,
              famsa_chain::ChainArgs ca) {
    __shared__ i64 T[TROWS][32];
    __shared__ i64 part[3][WARPS];
    __shared__ i64 stage[NCOLF][WARPS + 1];
    __shared__ i64 sums[WARPS][32];
    __shared__ i64 start[3];
    const int b = blockIdx.x;
    const bool cols = (int)blockIdx.y >= nch1;   // side 2: column planes
    const i64 r0 = (i64)(cols ? blockIdx.y - nch1 : blockIdx.y) * CHUNK;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const i64* desc = desc_in;
    const i64* hdr = hdr_in;
    if constexpr (CHAIN) {
        // the chain's carry before step ca.k (see the header)
        constexpr int HW = famsa_chain::HDR_WORDS;
        constexpr int DW = 2 * famsa_sides::DESC_WORDS;
        __shared__ i64 step_hdr[HW];
        __shared__ i64 step_desc[DW];
        const bool commit = blockIdx.y == 0;
        if (warp == 0) famsa_chain::fold(ca, lane, step_hdr, step_desc, commit);
        __syncthreads();
        if (commit && threadIdx.x < HW + DW) {
            const int t = threadIdx.x;
            if (t < HW) ca.hdr[HW * (i64)ca.k + t] = step_hdr[t];
            else ca.desc[DW * (i64)ca.k + t - HW] = step_desc[t - HW];
        }
        desc = step_desc;
        hdr = step_hdr;
    }
    for (int t = threadIdx.x; t < TROWS * 32; t += THREADS)
        T[t / 32][t % 32] = table[t];
    const Side s = load_side(desc, cols ? nb + b : b);
    const Side so = load_side(desc, cols ? b : nb + b);
    if (blockIdx.y == 0 && threadIdx.x < 4)
        meta[4 * (i64)b + threadIdx.x] = hdr[8 * (i64)b + threadIdx.x];
    if constexpr (CHAIN) {
        if (hdr[8 * (i64)b] < 1 || r0 > s.w + 1) return;
    }
    const i64 rows = cols ? ldc : (i64)w1p + 1;
    const i64 r1 = r0 + CHUNK < rows ? r0 + CHUNK : rows;
    __syncthreads();

    // side 2: the running sums over rows 1..r0-1, from their counts' sums
    i64 carry[3] = {0, 0, 0};
    if (cols && r0 > 0) {
        const i64 end = r0 < s.w + 1 ? r0 : s.w + 1;
        i64 acc = 0;
        for (i64 r = 1 + warp; r < end; r += 8 * WARPS) {
            i64 x[8];                    // eight loads in flight a warp
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const i64 q = r + u * WARPS;
                x[u] = q < end ? side_count(s, q, lane) : 0;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) acc += x[u];
        }
        sums[warp][lane] = acc;
        __syncthreads();
        if (warp == 0) {
            i64 n = 0;
            for (int v = 0; v < WARPS; ++v) n += sums[v][lane];
            Row rw;
            row_scores(T, side_count(s, 1, lane), 1, s.card, lane, rw);
            const i64 naa = warp_sum(lane < NAA ? n : 0);
            const i64 ge = add(warp_sum(lane < NAA ? mul(n, T[lane][GE]) : 0),
                               mul(naa, T[NAA][GE]));
            const i64 gte = add(warp_sum(lane < NAA ? mul(n, T[lane][GTE])
                                                    : 0),
                                mul(naa, T[NAA][GTE]));
            if (lane == 0) {
                start[0] = ge;
                start[1] = gte;
                start[2] = mul(so.card, add(rw.sgto, sub(gte, rw.sgte)));
            }
        }
        __syncthreads();
        for (int q = 0; q < 3; ++q) carry[q] = start[q];
    }

    for (i64 base = r0; base < r1; base += WARPS) {
        const i64 r = base + warp;
        const bool live = r <= s.w;
        const i64 c = side_count(s, r, lane);
        Row rw;
        const i64 sc = row_scores(T, c, r, s.card, lane, rw);
        gap_corrections(rw, r, s.w, s.card, side_count(s, r + 1, GTO));
        if (cols) {
            // the running sums: this row's increments, then a block scan
            // of the tile's rows on top of the carry
            i64 inc[3] = {0, 0, 0};
            if (r >= 1 && live) {
                inc[0] = rw.sge;
                inc[1] = rw.sgte;
                inc[2] = mul(r == 1 ? rw.sgto : rw.sgte, so.card);
            }
            if (lane == 0)
                for (int q = 0; q < 3; ++q) part[q][warp] = inc[q];
            __syncthreads();
            i64 pre[3], tot[3];
            for (int q = 0; q < 3; ++q) pre[q] = tot[q] = carry[q];
            for (int v = 0; v < WARPS; ++v)
                for (int q = 0; q < 3; ++q) {
                    if (v <= warp) pre[q] = add(pre[q], part[q][v]);
                    tot[q] = add(tot[q], part[q][v]);
                }
            for (int q = 0; q < 3; ++q) carry[q] = tot[q];
            if (lane < NAG) stage[lane][warp] = live ? sc : 0;
            if (lane < NCOLF - NAG) {
                i64 v;
                switch (lane) {
                case 0: v = rw.sgo; break;
                case 1: v = rw.sge; break;
                case 2: v = rw.sgto; break;
                case 3: v = rw.sgte; break;
                case 4: v = add(mul(rw.cgo, sub(T[NAA][GE], T[NAA][GO])),
                                mul(rw.cgto, sub(T[NAA][GTE], T[NAA][GTO])));
                        break;
                case 11: v = pre[0]; break;
                case 12: v = pre[1]; break;
                case 13: v = (r == 0 || r == s.w) ? famsa_dp::NEG : pre[2];
                         break;
                default: v = rw.g[lane - 5];
                }
                stage[NAG + lane][warp] = live ? v : 0;
            }
            __syncthreads();
            for (int t = threadIdx.x; t < NCOLF * WARPS; t += THREADS) {
                const int p = t / WARPS, k = t % WARPS;
                if (base + k < r1)
                    colf[((i64)b * NCOLF + p) * ldc + base + k] = stage[p][k];
            }
        } else if (r < r1) {
            i64* o = rowf + ((i64)b * rows + r) * NROWF;
            if (!live) {
                for (int t = lane; t < NROWF; t += 32) o[t] = 0;
                continue;
            }
            const unsigned nz = __ballot_sync(FULL, lane < NAG && c != 0);
            const int nnz = __popc(nz);
            const unsigned lt = (1u << lane) - 1;
            if (lane < NAG) {
                const int pos = c != 0 ? __popc(nz & lt)
                    : nnz + __popc(~nz & lt & ((1u << NAG) - 1));
                o[famsa_dp::R_CNT + pos] = c;
                o[famsa_dp::R_SYM + pos] = lane;
            }
            if (lane == 0) o[famsa_dp::R_NNZ] = nnz;
            if (lane < NROWF - famsa_dp::R_NNG) {
                const i64* bd = band ? band + ((i64)b * rows + r) * 2
                                     : nullptr;
                i64 v;
                switch (lane) {
                case 0: v = rw.naa; break;
                case 1: v = rw.cgo; break;
                case 2: v = rw.cgto; break;
                case 3: v = rw.sgo; break;
                case 4: v = rw.sge; break;
                case 5: v = rw.sgto; break;
                case 6: v = rw.sgte; break;
                case 13: v = mul(r == 1 ? rw.sgto : rw.sgte, so.card); break;
                case 14: v = bd ? bd[0] : 0; break;
                case 15: v = bd ? bd[1] : so.w; break;
                default: v = rw.g[lane - 7];
                }
                o[famsa_dp::R_NNG + lane] = v;
            }
        }
    }
}

template <bool CHAIN>
int launch(const void* desc, const void* hdr, const void* table,
           const void* band, int nb, int w1p, int ldc, void* colf, void* rowf,
           void* meta, const famsa_chain::ChainArgs& ca, void* stream) {
    if (nb <= 0) return 0;
    const int nch1 = (w1p + 1 + CHUNK - 1) / CHUNK;
    const int nch2 = (ldc + CHUNK - 1) / CHUNK;
    stage0_kernel<CHAIN><<<dim3(nb, nch1 + nch2), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const i64*>(desc), static_cast<const i64*>(hdr),
        static_cast<const i64*>(table), static_cast<const i64*>(band), nb,
        w1p, ldc, nch1, static_cast<i64*>(colf), static_cast<i64*>(rowf),
        static_cast<i64*>(meta), ca);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// desc [2 nb][8] int64: the side descriptors (side 1 of every merge, then
// side 2); hdr [nb][8] int64: (w1, w2, dirs offset, 0, card1, card2, 0,
// 0); table [25][32] int64; band: [nb][w1p+1][2] int64 (lo, hi) per DP
// row, or null (lo 0, hi w2); colf [nb][NCOLF][ldc], rowf [nb][w1p+1]
// [NROWF], meta [nb][4] int64: outputs, every element written.  Returns
// the launch's cudaError_t.
int stage0(const void* desc, const void* hdr, const void* table,
           const void* band, int nb, int w1p, int ldc, void* colf,
           void* rowf, void* meta, void* stream) {
    return launch<false>(desc, hdr, table, band, nb, w1p, ldc, colf, rowf,
                         meta, famsa_chain::ChainArgs{}, stream);
}

// Step k (0 <= k < nk, nk even) of a chain chunk: the chain's carry
// before it on the chunk's buffers (leaf .. cap, as csrc/chain.cu:
// chain_carry takes them; hdr [nk][8], desc [nk][2][8] receive step k's),
// then stage 0 of its merge, no band (w1 0: a skipped step).  The grid
// covers w1p + 1 rows and ldc columns, but only the rows and columns up
// to each side's width + 1 (rounded up to a chunk of 256) are written.
// meta is always written.  Returns the launch's cudaError_t.
int stage0_chain(const void* leaf, const void* lw, void* st,
                 const void* paths, long long ps, void* widths, void* hdr,
                 void* desc, const void* carry0, const void* carry1,
                 long long cap, const void* table, int w1p, int ldc,
                 void* colf, void* rowf, void* meta, int k, int nk,
                 void* stream) {
    if (k < 0 || k >= nk || nk % 2 != 0 || ps % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const famsa_chain::ChainArgs ca{
        static_cast<const uint8_t*>(leaf), static_cast<const i64*>(lw),
        static_cast<i64*>(st), static_cast<const uint8_t*>(paths), ps,
        static_cast<int*>(widths), static_cast<i64*>(hdr),
        static_cast<i64*>(desc), static_cast<const int*>(carry0),
        static_cast<const int*>(carry1), cap, w1p, k, nk};
    return launch<true>(nullptr, nullptr, table, nullptr, 1, w1p, ldc, colf,
                        rowf, meta, ca, stream);
}

}  // extern "C"
