// K1: bit-parallel LCS (Hyyro) of R reference rows against N queries, in
// two hand-written variants that compute the same words bit for bit.
//
// Replaces the Pallas kernel famsa_tpu/ops/lcs_pallas.py:_make_kernel
// (launched by _lcs_pallas_impl).  Same arithmetic, same symmetric-LCS
// layout: the per-symbol occupancy masks of ALL queries are precomputed
// once and the reference's symbols are streamed, so each reference
// position needs only masks[sym] (no per-query gather).  For each 32-bit
// word of a query's state V:  V2 = V + (V & M) + carry,
// carry = bit 32 of that sum,  V = V2 | (V - (V & M));  LCS = sum popc(~V).
// Symbols >= 20 (pad 22) have all-zero mask rows and are no-ops: V stays
// and the carry out is 0.
//
// Layout: masks [32][W][N] u32 (query fastest), syms [R][L] i32, out
// [R][N] (u16 or i32).  Only queries q < n_queries are computed (the
// triangular-sweep half-work saving of the Pallas kernel's dynamic grid);
// other columns are left untouched.  The carry out of a word is exact
// (the 33rd bit of V + (V & M) + carry), as the plain versions compute
// it: the test V2 < V misses the carry where a word of V is all ones, M
// covers it and a carry comes in (a run of 64 or more equal residues).
//
// What bounds it on the H100: the integer-op issue rate in the ideal,
// ~6 dependent 32-bit ops per (reference position, query, word), against
// tiny bytes.  In practice the carry chain's latency, so each variant is
// built to keep enough independent chains in flight:
//
// lcs_bitpar ("rows", many references: TorchDistanceBackend's 256-row
// blocks).  A warp takes 32 consecutive queries, one a lane, and P
// references at once (refs_in_flight: 4 up to 16 words, 2 past), each
// thread carrying the P references' W-word states in registers (template
// caps 2..64, fully unrolled; past 64 words a local-memory array): the P
// add-carry chains are independent and interleave word by word, so they
// hide each other's latency.  A CTA of ROWS_WARPS warps takes ROWS_WARPS
// x P references against its 32 queries; up to STAGED_MAX_W words it
// stages the queries' 20 valid-symbol mask rows and one all-zero row in
// shared memory once ([symbol][word][lane]: a lane reads its own bank),
// and every reference reuses them; past that the masks are read through
// L1.  The references' symbols are staged as bytes, ROWS_TILE positions
// at a time, [position][reference]: every lane of a warp reads the same
// byte (a broadcast), no-op symbols point at the zero row, and a
// position where all P are no-ops is skipped (warp-uniform).
//
// lcs_wave ("wave", few references: one per MST-Prim round).  With R = 1
// the rows grid holds ceil(N/128) CTAs, a few of the 132 SMs, each thread
// a chain of L x W updates.  The wave variant gives each query a segment
// of wseg lanes (the power of two >= W, capped at 32; past 32 words each
// lane owns wpl = ceil(W/32) consecutive words), lane k owning words
// [k*wpl, (k+1)*wpl).  At step s lane k processes reference position
// s - k; the carry out of lane k-1 reaches it through a segmented
// __shfl_up_sync one step later, so a query takes L + nl - 1 steps (nl
// lanes hold words) instead of L x W dependent updates, and N queries make
// N * wseg / 32 warps.  Each CTA stages its queries' 20 valid-symbol mask
// rows in shared memory once, [query][symbol][word-in-lane][lane] (lanes
// on consecutive banks), and the reference's symbols as bytes, a window
// of WAVE_TILE steps at a time (31 positions of lookback for the lanes
// that lag), so the step loop touches no global memory.  Lanes without
// words, queries >= n_queries and positions outside [0, L) still take
// part in the shuffles with all-zero masks; only the stores are masked.
// Past W_LOCAL_MAX words (65,536 residues) a query's segment spans the
// warps of one CTA (lcs_wave_seg_kernel, "segments across warps" below),
// up to WAVE_MAX_W words.
//
// Dispatch (ops/lcs_torch.py:lcs_variant): the wave variant while
// R x ceil(n_queries / 128) < WAVE_MAX_GRID, the rows variant from there
// on (the crossover measured on an H100: PERF.md), and the wave variant
// whatever the shape past W_LOCAL_MAX words.
//
// K9, lcs_refmask: FAMSA's own layout and carry, for the references whose
// value differs from the exact LCS.  FAMSA (src/lcs/lcsbp_classic.h, the
// host LCS of the reference package famsa_tpu/ops/lcs.py:45 and the
// native library) builds 64-bit masks of the REFERENCE, streams the query
// and takes a word's carry out as V2 < V.  That test drops the carry
// where V & M is all ones and a carry comes in, which can only happen in
// a word k >= 1 whose 64 positions are one valid symbol (a "flagged"
// reference, ops/lcs_torch.py:famsa_flags); for every other reference
// FAMSA's value is the exact LCS that K1 computes.  Replaces no Pallas
// kernel: it computes the host reference's value where the Pallas kernel
// (famsa_tpu/ops/lcs_pallas.py:_make_kernel, 32-bit words) and K1 compute
// the exact LCS.
//
// Design: K1 wave's word wavefront over FAMSA's layout.  A CTA takes one
// reference (grid.y) and REFMASK_THREADS / wseg queries; it builds the
// reference's 20 symbol masks (W64 uint64 words) once in shared memory
// (shared atomicOr), [symbol][word-in-lane][lane], with an all-zero row
// for the no-op symbols.  Each query gets a segment of wseg lanes (the
// power of two >= W64, at most 32; past 32 words a lane holds wpl =
// ceil(W64 / 32) consecutive words in registers), and at step s lane k
// takes query position s - k with the carry out of lane k-1 one step
// late (a segmented __shfl_up_sync).  Word k at position t needs only
// word k-1 at t and word k at t-1, so this is the serial order's
// dependency graph and V2 < V is reproduced exactly; the carry is
// FAMSA's test, not the exact 65th bit.  A no-op position (symbol >= 20,
// outside the query) reads the zero row: the lane before it saw the same
// position, so its carry in is 0 and its words stay.  Words past W64
// have zero masks and stay all ones, so idle lanes and the last lane's
// spare words count nothing.  Each warp stages its queries' symbols as
// bytes in a window of REFMASK_TILE steps (WAVE_LAG positions of
// lookback, REFMASK_STAGE loads in flight a lane) and ends a window's
// steps where every lane that holds words is past the warp's last live
// symbol, so a warp of short queries does not walk the padded length.
// A step's masks are loaded a step ahead (and its symbol two), so the
// loop's critical path is the carry's shuffle and add.  Past
// REFMASK_W_MAX words a reference's segment spans the warps of one CTA
// (lcs_refmask_seg_kernel), up to REFMASK_SEG_MAX_W words.
// Bound: ~12 int32 instructions a (live query position, reference word)
// against tiny bytes; in practice the carry chain's latency, a shuffle
// and ~6 dependent instructions a step.  In a Prim round (cur != null)
// it reads the round's reference id and the flag vector on the card and
// returns at once unless the reference is flagged, so the host never
// waits to choose.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NO_VALID_AMINOACIDS = 20;
constexpr int ROWS_WARPS = 8;        // warps of a rows CTA
constexpr int ROWS_THREADS = ROWS_WARPS * 32;
constexpr int ROWS_TILE = 512;       // positions a staged window of symbols
constexpr int STAGED_MAX_W = 64;     // masks staged in shared memory to here
constexpr int P_NARROW_MAX_W = 16;   // refs_in_flight: P_NARROW to here,
constexpr int P_NARROW = 4;          // P_WIDE past it
constexpr int P_WIDE = 2;
constexpr uint8_t ZERO_ROW = NO_VALID_AMINOACIDS;   // the staged zero row
// the widest query of the rows variant and of a wave segment of one warp
// (32 lanes of 64 words); wider wave queries take a segment across warps
constexpr int W_LOCAL_MAX = 2048;
constexpr int WAVE_TILE = 1024;     // steps per staged window of symbols
constexpr int WAVE_LAG = 31;        // the most a lane lags lane 0
constexpr uint8_t NOOP = 0xFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

// references a thread carries at once, for the W template cap WMAX
__host__ __device__ constexpr int refs_in_flight(int wmax) {
    return wmax <= P_NARROW_MAX_W ? P_NARROW : P_WIDE;
}

// the exact add of one word: V2 = v + tb + carry, carry = its 33rd bit
__device__ __forceinline__ uint32_t add_carry(uint32_t v, uint32_t tb,
                                              uint32_t& carry) {
    const unsigned long long s = (unsigned long long)v + tb + carry;
    carry = (uint32_t)(s >> 32);
    return (uint32_t)s;
}

// one word of one reference: V = V2 | (V - (V & M)); V & M is a subset of
// V's bits, so V - (V & M) = V & ~M
__device__ __forceinline__ void word(uint32_t& V, uint32_t m,
                                    uint32_t& carry) {
    const uint32_t v = V;
    V = add_carry(v, v & m, carry) | (v & ~m);
}

size_t rows_smem(int wmax, int W) {
    const int rpc = ROWS_WARPS * refs_in_flight(wmax);
    const size_t tile = wmax <= STAGED_MAX_W
        ? (size_t)(NO_VALID_AMINOACIDS + 1) * W * 32 * sizeof(uint32_t) : 0;
    return tile + (size_t)ROWS_TILE * rpc;
}

template <int WMAX>
__global__ void __launch_bounds__(ROWS_THREADS)
lcs_kernel(const uint32_t* __restrict__ masks, const int32_t* __restrict__ syms,
           int R, int L, int W, int N, int n_queries,
           uint16_t* __restrict__ out16, int32_t* __restrict__ out32) {
    constexpr int P = refs_in_flight(WMAX);
    constexpr int RPC = ROWS_WARPS * P;          // references a CTA
    constexpr bool STAGED = WMAX <= STAGED_MAX_W;
    extern __shared__ uint32_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int q0 = blockIdx.x * 32;
    const int q = q0 + lane;
    const int r0 = blockIdx.y * RPC;
    const int nr = min(RPC, R - r0);
    const int tile_words = STAGED ? (NO_VALID_AMINOACIDS + 1) * W * 32 : 0;
    uint32_t* tile = smem;                       // [21][W][32]
    uint8_t* win = reinterpret_cast<uint8_t*>(smem + tile_words);

    if constexpr (STAGED) {
        for (int idx = threadIdx.x; idx < tile_words; idx += ROWS_THREADS) {
            const int row = idx >> 5;            // symbol * W + word
            const int qq = q0 + (idx & 31);
            uint32_t v = 0;
            if (row < NO_VALID_AMINOACIDS * W && qq < n_queries)
                v = __ldg(masks + (size_t)row * N + qq);
            tile[idx] = v;
        }
    }
    const uint32_t* mq = masks + min(q, N - 1);  // the unstaged reads

    uint32_t V[P][WMAX];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if constexpr (STAGED) {
#pragma unroll
            for (int k = 0; k < WMAX; ++k) V[p][k] = 0xFFFFFFFFu;
        } else {
            for (int k = 0; k < W; ++k) V[p][k] = 0xFFFFFFFFu;
        }
    }
    for (int base = 0; base < L; base += ROWS_TILE) {
        const int nt = min(ROWS_TILE, L - base);
        __syncthreads();         // the mask tile staged, the last window read
        for (int idx = threadIdx.x; idx < nt * RPC; idx += ROWS_THREADS) {
            const int i = idx / nt, t = idx - i * nt;   // coalesced reads
            uint8_t c = ZERO_ROW;
            if (i < nr) {
                const int sy = __ldg(syms + (size_t)(r0 + i) * L + base + t);
                if ((unsigned)sy < (unsigned)NO_VALID_AMINOACIDS)
                    c = (uint8_t)sy;
            }
            win[t * RPC + i] = c;
        }
        __syncthreads();
        const uint8_t* mine = win + warp * P;
        for (int t = 0; t < nt; ++t) {
            int c[P];
            bool any = false;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                c[p] = mine[t * RPC + p];        // a broadcast
                any |= c[p] != ZERO_ROW;
            }
            if (!any) continue;                  // warp-uniform
            uint32_t carry[P];
#pragma unroll
            for (int p = 0; p < P; ++p) carry[p] = 0;
            if constexpr (STAGED) {
                const uint32_t* m[P];
#pragma unroll
                for (int p = 0; p < P; ++p) m[p] = tile + c[p] * W * 32 + lane;
#pragma unroll
                for (int k = 0; k < WMAX; ++k) {
                    if (k < W) {
#pragma unroll
                        for (int p = 0; p < P; ++p)
                            word(V[p][k], m[p][k * 32], carry[p]);
                    }
                }
            } else {
                const size_t sstride = (size_t)W * N;
                for (int k = 0; k < W; ++k) {
#pragma unroll
                    for (int p = 0; p < P; ++p) {
                        const uint32_t m = c[p] == ZERO_ROW ? 0u
                            : __ldg(mq + c[p] * sstride + (size_t)k * N);
                        word(V[p][k], m, carry[p]);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        int cnt = 0;
        if constexpr (STAGED) {
#pragma unroll
            for (int k = 0; k < WMAX; ++k)
                if (k < W) cnt += __popc(~V[p][k]);
        } else {
            for (int k = 0; k < W; ++k) cnt += __popc(~V[p][k]);
        }
        const int r = warp * P + p;
        if (r < nr && q < n_queries) {
            const size_t o = (size_t)(r0 + r) * N + q;
            if (out16) out16[o] = (uint16_t)cnt;
            else out32[o] = cnt;
        }
    }
}

template <int WMAX>
cudaError_t launch(const uint32_t* masks, const int32_t* syms, int R, int L,
                   int W, int N, int n_queries, uint16_t* out16,
                   int32_t* out32, cudaStream_t stream) {
    constexpr int RPC = ROWS_WARPS * refs_in_flight(WMAX);
    const size_t smem = rows_smem(WMAX, W);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lcs_kernel<WMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    dim3 grid((n_queries + 31) / 32, (R + RPC - 1) / RPC);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    lcs_kernel<WMAX><<<grid, ROWS_THREADS, smem, stream>>>(
        masks, syms, R, L, W, N, n_queries, out16, out32);
    return cudaGetLastError();
}

// ---- the wave variant
// Geometry (mirrored by ops/lcs_torch.py:wave_geometry): wseg lanes a
// query, wpl words a lane, nl lanes that hold words; a CTA of `threads`
// threads holds threads / wseg queries.
struct WaveGeom {
    int wseg, wpl, nl, threads;
    size_t smem;
};

WaveGeom wave_geometry(int W) {
    WaveGeom g;
    g.wseg = 1;
    while (g.wseg < W && g.wseg < 32) g.wseg <<= 1;
    g.wpl = (W + g.wseg - 1) / g.wseg;
    g.nl = (W + g.wpl - 1) / g.wpl;
    g.threads = g.wpl <= 4 ? 128 : 32;       // the mask tile stays <= 160 KB
    g.smem = (size_t)(g.threads / g.wseg) * NO_VALID_AMINOACIDS * g.wpl *
                 g.wseg * sizeof(uint32_t) + WAVE_TILE + 32;
    return g;
}

template <int WPL>
__global__ void __launch_bounds__(128)
lcs_wave_kernel(const uint32_t* __restrict__ masks,
                const int32_t* __restrict__ syms, int L, int W, int N,
                int n_queries, int wseg, int wpl, int nl,
                uint16_t* __restrict__ out16, int32_t* __restrict__ out32) {
    extern __shared__ uint32_t smem[];
    const int qpc = blockDim.x / wseg;           // queries per CTA
    const int q0 = blockIdx.x * qpc;
    const int r = blockIdx.y;
    const int g = threadIdx.x / wseg;            // query slot of the CTA
    const int k = threadIdx.x % wseg;            // lane in the segment
    const int q = q0 + g;
    const int per_q = NO_VALID_AMINOACIDS * wpl * wseg;
    uint32_t* tile = smem;                       // [qpc][20][wpl][wseg]
    uint8_t* win = reinterpret_cast<uint8_t*>(smem + qpc * per_q);

    // stage the masks, query fastest so that global reads coalesce
    for (int idx = threadIdx.x; idx < qpc * per_q; idx += blockDim.x) {
        const int gg = idx % qpc;
        int rest = idx / qpc;
        const int kk = rest % wseg;
        rest /= wseg;
        const int j = rest % wpl;
        const int c = rest / wpl;
        const int w = kk * wpl + j;
        const int qq = q0 + gg;
        uint32_t v = 0;
        if (w < W && qq < n_queries)
            v = __ldg(masks + ((size_t)c * W + w) * N + qq);
        tile[((gg * NO_VALID_AMINOACIDS + c) * wpl + j) * wseg + kk] = v;
    }

    uint32_t V[WPL];
#pragma unroll
    for (int j = 0; j < WPL; ++j) V[j] = 0xFFFFFFFFu;
    const int nw = max(0, min(wpl, W - k * wpl));    // words of this lane
    const uint32_t* mine = tile + g * per_q + k;
    const int32_t* sr = syms + (size_t)r * L;
    const int steps = L + nl - 1;
    uint32_t carry = 0;          // carry out of this lane, previous step
    for (int base = 0; base < steps; base += WAVE_TILE) {
        __syncthreads();         // the previous window is consumed
        // win[p] = symbol of position base - WAVE_LAG + p, NOOP if none;
        // one spare entry for the last step's prefetch
        for (int p = threadIdx.x; p <= WAVE_TILE + WAVE_LAG; p += blockDim.x) {
            const int pos = base - WAVE_LAG + p;
            uint8_t c = NOOP;
            if (pos >= 0 && pos < L) {
                const int s = __ldg(sr + pos);
                if ((unsigned)s < (unsigned)NO_VALID_AMINOACIDS) c = (uint8_t)s;
            }
            win[p] = c;
        }
        __syncthreads();
        const int end = min(WAVE_TILE, steps - base);
        int c = win[WAVE_LAG - k];
        for (int st = 0; st < end; ++st) {
            // prefetch the next step's symbol (the window has one spare)
            const int cn = win[st + 1 + WAVE_LAG - k];
            uint32_t cy = __shfl_up_sync(FULL, carry, 1, wseg);
            if (k == 0) cy = 0;
            carry = 0;
            if (c != NOOP && nw > 0) {
                const uint32_t* m = mine + c * wpl * wseg;
#pragma unroll
                for (int j = 0; j < WPL; ++j) {
                    if (j < nw) {
                        word(V[j], m[j * wseg], cy);
                    }
                }
                carry = cy;
            }
            c = cn;
        }
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j)
        if (j < nw) cnt += __popc(~V[j]);
    for (int o = wseg >> 1; o > 0; o >>= 1)
        cnt += __shfl_xor_sync(FULL, cnt, o, wseg);
    if (k == 0 && q < n_queries) {
        const size_t o = (size_t)r * N + q;
        if (out16) out16[o] = (uint16_t)cnt;
        else out32[o] = cnt;
    }
}

template <int WPL>
cudaError_t launch_wave(const WaveGeom& g, const uint32_t* masks,
                        const int32_t* syms, int R, int L, int W, int N,
                        int n_queries, uint16_t* out16, int32_t* out32,
                        cudaStream_t stream) {
    const int qpc = g.threads / g.wseg;
    if (g.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lcs_wave_kernel<WPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)g.smem);
        if (e != cudaSuccess) return e;
    }
    dim3 grid((n_queries + qpc - 1) / qpc, R);
    lcs_wave_kernel<WPL><<<grid, g.threads, g.smem, stream>>>(
        masks, syms, L, W, N, n_queries, g.wseg, g.wpl, g.nl, out16, out32);
    return cudaGetLastError();
}

// ---- segments across warps: K1 wave past W_LOCAL_MAX words, K9 past
// REFMASK_W_MAX 64-bit words.  A query is one CTA of wseg threads (a
// power of two, 64 to SEG_MAX_LANES), lane k owning wpl consecutive words
// (wpl <= wpl_max: 64 for K1's 32-bit words, 32 for K9's 64-bit ones),
// and at step s lane k takes position s - k, as in a segment of one warp.
// Inside a warp the carry moves by __shfl_up_sync; lane 31's carry reaches
// the next warp's lane 0 one step late through shared memory: the warp
// stores it in a ring of SEG_TILE slots, one a step of the window, and
// publishes the count of steps stored (a volatile store after
// __threadfence_block); the next warp's lane 0 spins on that count
// (SegXch).  The hand-off is a flag a warp boundary, not a named barrier a
// pair of warps as the DP's WarpXch: a CTA has 16 hardware barriers and a
// segment up to 31 boundaries; no barrier of the whole CTA is taken a
// step.  The CTA stages a window of SEG_TILE steps (the symbols of
// positions base - (wseg - 1) .. base + SEG_TILE - 1) between two CTA
// barriers, which also make the ring and the counts free to reuse: no
// warp stores into the next window's slots before every warp has left
// this one.  The carry across a window's edge goes through xc,
// double-buffered by window parity.  A window ends after the step past
// which every lane that holds words sees no live symbol (the window's
// last live position + nl - 1), and a window without one is skipped: such
// steps change no word and pass zero carries.  The masks sit in shared
// memory while they fit with the window (staged), else they are read
// from global memory through L1 and L2 (K1: the query mask table itself;
// K9: the reference's masks built by refmask_build_kernel into scratch).
// A thread holds its wpl words in registers; at 1024 threads a thread has
// at most 64 registers, so the widest segments (past 32768 32-bit or
// 16384 64-bit words, 1,048,576 residues) spill their words to local
// memory.  Bound: as the one-warp kernels, the carry chain's latency.
constexpr int SEG_TILE = 256;          // steps a staged window
constexpr int SEG_MAX_LANES = 1024;    // the widest segment
constexpr int SEG_WARPS = SEG_MAX_LANES / 32;
constexpr int WAVE_WPL_MAX = 64;       // K1's words a lane
constexpr int WAVE_MAX_W = SEG_MAX_LANES * WAVE_WPL_MAX;   // 65536 words
constexpr size_t SEG_SMEM_MAX = 232448;   // a CTA's opt-in shared memory
// control words after the ring: head [SEG_WARPS], xc [2][SEG_WARPS],
// last [2], counts [SEG_WARPS]
constexpr int SEG_CTRL = 4 * SEG_WARPS + 2;

struct SegGeom {
    int wseg, wpl, nl;
    bool staged;
    size_t smem;
};

// Geometry of a segment across warps (mirrored by ops/lcs_torch.py:
// seg_geometry) of W words of word_bytes, wpl_max words a lane, and
// masks of `rows` symbol rows: the ring, the control words and the
// window always; the masks too where all of it fits SEG_SMEM_MAX.
SegGeom seg_geometry(int W, int wpl_max, int word_bytes, int rows) {
    SegGeom g;
    g.wseg = 64;
    while (g.wseg * wpl_max < W) g.wseg <<= 1;
    g.wpl = (W + g.wseg - 1) / g.wseg;
    g.nl = (W + g.wpl - 1) / g.wpl;
    const size_t common = (size_t)(g.wseg / 32) * SEG_TILE * 4 +
                          SEG_CTRL * 4 + ((SEG_TILE + g.wseg + 7) & ~7);
    const size_t masks = (size_t)rows * g.wpl * g.wseg * word_bytes;
    g.staged = masks + common <= SEG_SMEM_MAX;
    g.smem = common + (g.staged ? masks : 0);
    return g;
}

// The carry hand-off of a segment across warps (above).
struct SegXch {
    unsigned* ring;              // [nwarps][SEG_TILE]
    volatile unsigned* head;     // [SEG_WARPS]: steps stored this window
    unsigned* xc;                // [2][SEG_WARPS]: carries across windows
    int warp, lane, nwarps;
    // the carry into this lane at step st of a window of parity par:
    // lane k - 1's of the last step, for lane 0 the previous warp's lane
    // 31's (0 into the segment's first lane)
    __device__ __forceinline__ uint32_t in(uint32_t carry, int st, int par) {
        uint32_t cy = __shfl_up_sync(FULL, carry, 1);
        if (lane == 0) {
            if (warp == 0) {
                cy = 0;
            } else if (st == 0) {
                cy = xc[par * SEG_WARPS + warp - 1];
            } else {
                while (head[warp - 1] < (unsigned)st) {
                }
                __threadfence_block();
                cy = ring[(warp - 1) * SEG_TILE + st - 1];
            }
        }
        return cy;
    }
    // lane 31 publishes its carry out of step st to the next warp
    __device__ __forceinline__ void out(uint32_t carry, int st) {
        if (lane == 31 && warp + 1 < nwarps) {
            ring[warp * SEG_TILE + st] = carry;
            __threadfence_block();
            head[warp] = st + 1;
        }
    }
    // ... and its carry out of the window's last step, for the window of
    // parity par
    __device__ __forceinline__ void end(uint32_t carry, int par) {
        if (lane == 31 && warp + 1 < nwarps)
            xc[par * SEG_WARPS + warp] = carry;
    }
};

// The window of a segment CTA (the symbols of `sr`, a row of n positions,
// from base - lag) into win, NOOP where none or no-op, between two CTA
// barriers; the first also frees the last window's ring and counts.
// Returns the window's steps: SEG_TILE, fewer where its live symbols end
// (or steps end), 0 without a live symbol.
__device__ __forceinline__ int seg_window(const int32_t* sr, int n, int base,
                                          int lag, int nl, int steps,
                                          int par, uint8_t* win,
                                          volatile unsigned* head,
                                          int* last) {
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 0; w < SEG_WARPS; ++w) head[w] = 0;
        last[par ^ 1] = -1;
    }
    int ml = -1;
    for (int p = threadIdx.x; p < SEG_TILE + lag; p += blockDim.x) {
        const int pos = base - lag + p;
        uint8_t c = NOOP;
        if (pos >= 0 && pos < n) {
            const int s = __ldg(sr + pos);
            if ((unsigned)s < (unsigned)NO_VALID_AMINOACIDS) {
                c = (uint8_t)s;
                ml = pos;
            }
        }
        win[p] = c;
    }
    ml = __reduce_max_sync(FULL, ml);
    if ((threadIdx.x & 31) == 0 && ml >= 0) atomicMax(last + par, ml);
    __syncthreads();
    const int lst = last[par];
    return lst < 0 ? 0 : min(min(SEG_TILE, steps - base), lst - base + nl);
}

// the segment's count: the sum over its warps (every thread, a barrier)
__device__ __forceinline__ int seg_count(int cnt, int* part, int nwarps) {
    cnt = __reduce_add_sync(FULL, cnt);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = cnt;
    __syncthreads();
    int tot = 0;
    for (int w = 0; w < nwarps; ++w) tot += part[w];
    return tot;
}

// K1 wave past W_LOCAL_MAX words: query blockIdx.x against reference
// blockIdx.y, a segment across warps (above), the query's masks staged
// [20][wpl][wseg] (lanes on consecutive banks) or read from the table.
template <int MAXT>
__global__ void __launch_bounds__(MAXT)
lcs_wave_seg_kernel(const uint32_t* __restrict__ masks,
                    const int32_t* __restrict__ syms, int L, int W, int N,
                    int wseg, int wpl, int nl, int staged,
                    uint16_t* __restrict__ out16,
                    int32_t* __restrict__ out32) {
    constexpr int WPL = WAVE_WPL_MAX;
    extern __shared__ __align__(16) uint32_t sseg[];
    const int q = blockIdx.x, r = blockIdx.y;
    const int k = threadIdx.x, nwarps = wseg >> 5;
    const int per = staged ? NO_VALID_AMINOACIDS * wpl * wseg : 0;
    uint32_t* tile = sseg;                       // [20][wpl][wseg]
    unsigned* ring = sseg + per;
    unsigned* ctrl = ring + nwarps * SEG_TILE;
    int* last = reinterpret_cast<int*>(ctrl + 3 * SEG_WARPS);
    int* part = last + 2;
    uint8_t* win = reinterpret_cast<uint8_t*>(ctrl + SEG_CTRL);
    SegXch x{ring, ctrl, ctrl + SEG_WARPS, k >> 5, k & 31, nwarps};

    for (int idx = k; idx < per; idx += wseg) {
        const int kk = idx % wseg, rest = idx / wseg;
        const int j = rest % wpl, c = rest / wpl, w = kk * wpl + j;
        tile[idx] = w < W ? __ldg(masks + ((size_t)c * W + w) * N + q) : 0u;
    }
    for (int i = k; i < 3 * SEG_WARPS; i += wseg) ctrl[i] = 0;
    if (k == 0) last[0] = -1;    // the first window's barrier publishes it
    // this lane's masks: symbol c, word j at mb[c * sc + j * sj]
    const uint32_t* mb = staged ? tile + k : masks + (size_t)k * wpl * N + q;
    const size_t sc = staged ? (size_t)wpl * wseg : (size_t)W * N;
    const size_t sj = staged ? (size_t)wseg : (size_t)N;
    const int nw = max(0, min(wpl, W - k * wpl));    // words of this lane

    uint32_t V[WPL];
#pragma unroll
    for (int j = 0; j < WPL; ++j) V[j] = 0xFFFFFFFFu;
    const int32_t* sr = syms + (size_t)r * L;
    const int lag = wseg - 1, steps = L + nl - 1;
    uint32_t carry = 0;          // carry out of this lane, previous step
    int par = 0;
    for (int base = 0; base < steps; base += SEG_TILE, par ^= 1) {
        const int end = seg_window(sr, L, base, lag, nl, steps, par, win,
                                   x.head, last);
        for (int st = 0; st < end; ++st) {
            const int c = win[st + lag - k];
            uint32_t cy = x.in(carry, st, par);
            carry = 0;
            if (c != NOOP && nw > 0) {
                const uint32_t* m = mb + c * sc;
#pragma unroll
                for (int j = 0; j < WPL; ++j)
                    if (j < nw) word(V[j], m[j * sj], cy);
                carry = cy;
            }
            x.out(carry, st);
        }
        if (end < SEG_TILE) carry = 0;
        x.end(carry, par ^ 1);
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j)
        if (j < nw) cnt += __popc(~V[j]);
    cnt = seg_count(cnt, part, nwarps);
    if (k == 0) {
        const size_t o = (size_t)r * N + q;
        if (out16) out16[o] = (uint16_t)cnt;
        else out32[o] = cnt;
    }
}

template <int MAXT>
cudaError_t launch_wave_seg(const SegGeom& g, const uint32_t* masks,
                            const int32_t* syms, int R, int L, int W, int N,
                            int n_queries, uint16_t* out16, int32_t* out32,
                            cudaStream_t stream) {
    if (g.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lcs_wave_seg_kernel<MAXT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
        if (e != cudaSuccess) return e;
    }
    lcs_wave_seg_kernel<MAXT><<<dim3(n_queries, R), g.wseg, g.smem,
                                stream>>>(masks, syms, L, W, N, g.wseg, g.wpl,
                                          g.nl, (int)g.staged, out16, out32);
    return cudaGetLastError();
}

// ---- K9, FAMSA's layout (see the header)
// Geometry: K1 wave's (wave_geometry: wseg lanes a query, wpl words a
// lane, nl lanes that hold words) over the reference's W64 64-bit words;
// a CTA of REFMASK_THREADS threads holds REFMASK_THREADS / wseg queries.
constexpr int REFMASK_THREADS = 128;
// the widest reference of a segment of one warp (32 lanes of 32 words);
// wider ones take a segment across warps
constexpr int REFMASK_W_MAX = 1024;
constexpr int REFMASK_TILE = 256;        // steps a staged window of symbols
// a query's window: REFMASK_TILE steps, WAVE_LAG positions of lookback
// and 2 of prefetch, padded to an odd number of words (the segments of a
// warp read their windows on distinct banks)
constexpr int REFMASK_WIN = REFMASK_TILE + WAVE_LAG + 5;
constexpr int REFMASK_STAGE = 8;         // symbol loads in flight a lane

// shared memory of a K9 CTA: the masks and a window a query slot
size_t refmask_smem(const WaveGeom& g) {
    return (size_t)(NO_VALID_AMINOACIDS + 1) * g.wpl * g.wseg * 8 +
           (size_t)(REFMASK_THREADS / g.wseg) * REFMASK_WIN;
}

template <int WPL>
__global__ void __launch_bounds__(REFMASK_THREADS)
lcs_refmask_kernel(const int32_t* __restrict__ refs,
                   const int32_t* __restrict__ queries, int Lr, int N,
                   int Lq, int n_queries, int wseg, int wpl, int nl,
                   const long long* __restrict__ cur,
                   const uint8_t* __restrict__ flags,
                   uint16_t* __restrict__ out16, int32_t* __restrict__ out32) {
    if (cur != nullptr && flags[*cur] == 0) return;     // CTA-uniform
    // the reference's masks [21][wpl][wseg] (word w = lane * wpl + j at
    // [j][lane]; row 20 all zero, the no-op symbols' row), then a window
    // of symbol bytes a query slot
    extern __shared__ unsigned long long M[];
    const int row = wpl * wseg;
    uint8_t* win = reinterpret_cast<uint8_t*>(
        M + (NO_VALID_AMINOACIDS + 1) * row);
    for (int idx = threadIdx.x; idx < (NO_VALID_AMINOACIDS + 1) * row;
         idx += REFMASK_THREADS)
        M[idx] = 0ull;
    __syncthreads();
    const int32_t* ref = refs + (size_t)blockIdx.y * Lr;
    for (int p = threadIdx.x; p < Lr; p += REFMASK_THREADS) {
        const int s = __ldg(ref + p);
        if ((unsigned)s < (unsigned)NO_VALID_AMINOACIDS) {
            const int w = p >> 6;
            atomicOr(M + s * row + (w % wpl) * wseg + w / wpl,
                     1ull << (p & 63));
        }
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int qpw = 32 / wseg;                   // query slots a warp
    const int g0 = (threadIdx.x >> 5) * qpw;     // the warp's first slot
    const int g = threadIdx.x / wseg;            // query slot of the CTA
    const int k = threadIdx.x % wseg;            // lane in the segment
    const int q0 = blockIdx.x * (REFMASK_THREADS / wseg);
    const int q = q0 + g;
    if (q0 + g0 >= n_queries) return;            // warp-uniform
    const unsigned long long* mk = M + k;        // this lane's column
    const uint8_t* mine = win + g * REFMASK_WIN;
    unsigned long long X[WPL];
#pragma unroll
    for (int j = 0; j < WPL; ++j) X[j] = ~0ull;
    const int steps = Lq + nl - 1;
    // positions a window stages: the tile's, the lookback and two more
    // for the prefetch of the symbol two steps ahead
    constexpr int SPAN = REFMASK_TILE + WAVE_LAG + 2;
    uint32_t carry = 0;          // carry out of this lane, previous step
    for (int base = 0; base < steps; base += REFMASK_TILE) {
        // the warp's windows: win[slot][p] = the symbol of position
        // base - WAVE_LAG + p, ZERO_ROW where none or no-op; `last` the
        // window's last live position over the warp's queries
        __syncwarp();
        int last = -1;
        for (int i0 = lane; i0 < qpw * SPAN; i0 += 32 * REFMASK_STAGE) {
            int s[REFMASK_STAGE];
#pragma unroll
            for (int u = 0; u < REFMASK_STAGE; ++u) {
                const int i = i0 + 32 * u;
                const int gg = i / SPAN, pos = base - WAVE_LAG + i % SPAN;
                const int qq = q0 + g0 + gg;
                s[u] = i < qpw * SPAN && qq < n_queries && pos >= 0 &&
                       pos < Lq ? __ldg(queries + (size_t)qq * Lq + pos)
                                : NO_VALID_AMINOACIDS;
            }
#pragma unroll
            for (int u = 0; u < REFMASK_STAGE; ++u) {
                const int i = i0 + 32 * u;
                if (i < qpw * SPAN) {
                    const bool live =
                        (unsigned)s[u] < (unsigned)NO_VALID_AMINOACIDS;
                    win[(g0 + i / SPAN) * REFMASK_WIN + i % SPAN] =
                        live ? (uint8_t)s[u] : ZERO_ROW;
                    if (live) last = max(last, base - WAVE_LAG + i % SPAN);
                }
            }
        }
        last = __reduce_max_sync(FULL, last);
        __syncwarp();
        // past step last - base + nl - 1 every lane that holds words sees
        // a no-op position: the tile ends there (or is skipped), and a
        // no-op step passes a zero carry
        const int end = min(min(REFMASK_TILE, steps - base),
                            last - base + nl);
        if (end <= 0) {
            carry = 0;
            continue;
        }
        // the masks of the next step and the symbol of the one after are
        // loaded before a step's arithmetic: the step's critical path is
        // the carry's shuffle and add, not two dependent shared loads
        unsigned long long mc[WPL];
        {
            const unsigned long long* m = mk + mine[WAVE_LAG - k] * row;
#pragma unroll
            for (int j = 0; j < WPL; ++j)
                if (j < wpl) mc[j] = m[j * wseg];
        }
        int cn = mine[1 + WAVE_LAG - k];
        for (int st = 0; st < end; ++st) {
            unsigned long long mn[WPL];
            const unsigned long long* m = mk + cn * row;
#pragma unroll
            for (int j = 0; j < WPL; ++j)
                if (j < wpl) mn[j] = m[j * wseg];
            cn = mine[st + 2 + WAVE_LAG - k];
            uint32_t cy = __shfl_up_sync(FULL, carry, 1, wseg);
            if (k == 0) cy = 0;
#pragma unroll
            for (int j = 0; j < WPL; ++j) {
                if (j < wpl) {
                    const unsigned long long v = X[j], tb = v & mc[j];
                    const unsigned long long v2 = v + tb + cy;
                    cy = v2 < v;     // FAMSA's test, not the exact one
                    X[j] = v2 | (v - tb);
                    mc[j] = mn[j];
                }
            }
            carry = cy;
        }
        if (end < REFMASK_TILE) carry = 0;
    }
    // words past W64 have zero masks and stay all ones: they count 0
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j)
        if (j < wpl) cnt += __popcll(~X[j]);
    for (int o = wseg >> 1; o > 0; o >>= 1)
        cnt += __shfl_xor_sync(FULL, cnt, o, wseg);
    if (k == 0 && q < n_queries) {
        const size_t o = (size_t)blockIdx.y * N + q;
        if (out16) out16[o] = (uint16_t)cnt;
        else out32[o] = cnt;
    }
}

template <int WPL>
cudaError_t launch_refmask(const WaveGeom& g, const int32_t* refs,
                           const int32_t* queries, int R, int Lr, int N,
                           int Lq, int n_queries, const long long* cur,
                           const uint8_t* flags, uint16_t* out16,
                           int32_t* out32, cudaStream_t stream) {
    const size_t smem = refmask_smem(g);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lcs_refmask_kernel<WPL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const int qpc = REFMASK_THREADS / g.wseg;
    dim3 grid((n_queries + qpc - 1) / qpc, R);
    lcs_refmask_kernel<WPL><<<grid, REFMASK_THREADS, smem, stream>>>(
        refs, queries, Lr, N, Lq, n_queries, g.wseg, g.wpl, g.nl, cur, flags,
        out16, out32);
    return cudaGetLastError();
}

// K9 past REFMASK_W_MAX 64-bit words: a segment across warps (above),
// wpl <= 32 words a lane, the queries' positions streamed; references up
// to REFMASK_SEG_MAX_W words (2,097,152 positions, as K1)
constexpr int REFMASK_WPL_MAX = 32;
constexpr int REFMASK_SEG_MAX_W = SEG_MAX_LANES * REFMASK_WPL_MAX;

// the reference's masks [21][wpl][wseg] into `M` (zeroed), from the
// positions [p0, Lr) of `ref` taken a stride apart: word w = p >> 6 of
// symbol s at M[s][w % wpl][w / wpl]
__device__ __forceinline__ void refmask_build(const int32_t* ref, int Lr,
                                              int p0, int stride, int wseg,
                                              int wpl,
                                              unsigned long long* M) {
    const int row = wpl * wseg;
    for (int p = p0; p < Lr; p += stride) {
        const int s = __ldg(ref + p);
        if ((unsigned)s < (unsigned)NO_VALID_AMINOACIDS) {
            const int w = p >> 6;
            atomicOr(M + s * row + (w % wpl) * wseg + w / wpl,
                     1ull << (p & 63));
        }
    }
}

// the masks of every reference (blockIdx.y) into scratch [R][21][wpl]
// [wseg] u64, zeroed before; in a Prim round, only a flagged one's
__global__ void refmask_build_kernel(const int32_t* __restrict__ refs,
                                     int Lr, int wseg, int wpl,
                                     unsigned long long* gmask,
                                     const long long* __restrict__ cur,
                                     const uint8_t* __restrict__ flags) {
    if (cur != nullptr && flags[*cur] == 0) return;
    const size_t per = (size_t)(NO_VALID_AMINOACIDS + 1) * wpl * wseg;
    refmask_build(refs + (size_t)blockIdx.y * Lr, Lr,
                  blockIdx.x * blockDim.x + threadIdx.x,
                  gridDim.x * blockDim.x, wseg, wpl,
                  gmask + blockIdx.y * per);
}

// query blockIdx.x against reference blockIdx.y; the reference's masks
// built in shared memory (staged) or read from gmask
template <int MAXT>
__global__ void __launch_bounds__(MAXT)
lcs_refmask_seg_kernel(const int32_t* __restrict__ refs,
                       const int32_t* __restrict__ queries, int Lr, int N,
                       int Lq, int wseg, int wpl, int nl, int staged,
                       const unsigned long long* __restrict__ gmask,
                       const long long* __restrict__ cur,
                       const uint8_t* __restrict__ flags,
                       uint16_t* __restrict__ out16,
                       int32_t* __restrict__ out32) {
    constexpr int WPL = REFMASK_WPL_MAX;
    if (cur != nullptr && flags[*cur] == 0) return;     // CTA-uniform
    extern __shared__ __align__(16) unsigned long long sref[];
    const int q = blockIdx.x, r = blockIdx.y;
    const int k = threadIdx.x, nwarps = wseg >> 5;
    const int row = wpl * wseg;
    const int per = staged ? (NO_VALID_AMINOACIDS + 1) * row : 0;
    unsigned* ring = reinterpret_cast<unsigned*>(sref + per);
    unsigned* ctrl = ring + nwarps * SEG_TILE;
    int* last = reinterpret_cast<int*>(ctrl + 3 * SEG_WARPS);
    int* part = last + 2;
    uint8_t* win = reinterpret_cast<uint8_t*>(ctrl + SEG_CTRL);
    SegXch x{ring, ctrl, ctrl + SEG_WARPS, k >> 5, k & 31, nwarps};

    if (staged) {
        for (int idx = k; idx < per; idx += wseg) sref[idx] = 0ull;
        __syncthreads();
        refmask_build(refs + (size_t)r * Lr, Lr, k, wseg, wseg, wpl, sref);
    }
    for (int i = k; i < 3 * SEG_WARPS; i += wseg) ctrl[i] = 0;
    if (k == 0) last[0] = -1;    // the first window's barrier publishes it
    const unsigned long long* mb =
        (staged ? sref : gmask + (size_t)r * (NO_VALID_AMINOACIDS + 1) * row)
        + k;
    const int W64 = (Lr + 63) / 64;
    const int nw = max(0, min(wpl, W64 - k * wpl));  // words of this lane

    unsigned long long X[WPL];
#pragma unroll
    for (int j = 0; j < WPL; ++j) X[j] = ~0ull;
    const int32_t* sq = queries + (size_t)q * Lq;
    const int lag = wseg - 1, steps = Lq + nl - 1;
    uint32_t carry = 0;          // carry out of this lane, previous step
    int par = 0;
    for (int base = 0; base < steps; base += SEG_TILE, par ^= 1) {
        const int end = seg_window(sq, Lq, base, lag, nl, steps, par, win,
                                   x.head, last);
        for (int st = 0; st < end; ++st) {
            const int c = win[st + lag - k];
            uint32_t cy = x.in(carry, st, par);
            carry = 0;
            if (c != NOOP && nw > 0) {
                const unsigned long long* m = mb + c * row;
#pragma unroll
                for (int j = 0; j < WPL; ++j) {
                    if (j < nw) {
                        const unsigned long long v = X[j],
                                                 tb = v & m[j * wseg];
                        const unsigned long long v2 = v + tb + cy;
                        cy = v2 < v;     // FAMSA's test, not the exact one
                        X[j] = v2 | (v - tb);
                    }
                }
                carry = cy;
            }
            x.out(carry, st);
        }
        if (end < SEG_TILE) carry = 0;
        x.end(carry, par ^ 1);
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j)
        if (j < nw) cnt += __popcll(~X[j]);
    cnt = seg_count(cnt, part, nwarps);
    if (k == 0) {
        const size_t o = (size_t)r * N + q;
        if (out16) out16[o] = (uint16_t)cnt;
        else out32[o] = cnt;
    }
}

template <int MAXT>
cudaError_t launch_refmask_seg(const SegGeom& g, const int32_t* refs,
                               const int32_t* queries, int R, int Lr, int N,
                               int Lq, int n_queries, void* scratch,
                               const long long* cur, const uint8_t* flags,
                               uint16_t* out16, int32_t* out32,
                               cudaStream_t stream) {
    unsigned long long* gmask = nullptr;
    if (!g.staged) {
        const size_t per = (size_t)(NO_VALID_AMINOACIDS + 1) * g.wpl * g.wseg;
        gmask = static_cast<unsigned long long*>(scratch);
        cudaError_t e = cudaMemsetAsync(gmask, 0, (size_t)R * per * 8, stream);
        if (e != cudaSuccess) return e;
        refmask_build_kernel<<<dim3((Lr + 255) / 256, R), 256, 0, stream>>>(
            refs, Lr, g.wseg, g.wpl, gmask, cur, flags);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    if (g.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lcs_refmask_seg_kernel<MAXT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
        if (e != cudaSuccess) return e;
    }
    lcs_refmask_seg_kernel<MAXT><<<dim3(n_queries, R), g.wseg, g.smem,
                                   stream>>>(
        refs, queries, Lr, N, Lq, g.wseg, g.wpl, g.nl, (int)g.staged, gmask,
        cur, flags, out16, out32);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// masks: [32][W][N] u32; syms: [R][L] i32; out: [R][N] u16 (out_u16 != 0)
// or i32.  Returns the launch's cudaError_t (0 on success).
int lcs_bitpar(const void* masks, const void* syms, int R, int L, int W,
               int N, int n_queries, void* out, int out_u16, void* stream) {
    if (R <= 0 || n_queries <= 0) return 0;
    if (W < 1 || W > W_LOCAL_MAX || n_queries > N)
        return (int)cudaErrorInvalidValue;
    const uint32_t* m = static_cast<const uint32_t*>(masks);
    const int32_t* s = static_cast<const int32_t*>(syms);
    uint16_t* o16 = out_u16 ? static_cast<uint16_t*>(out) : nullptr;
    int32_t* o32 = out_u16 ? nullptr : static_cast<int32_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (W <= 2) e = launch<2>(m, s, R, L, W, N, n_queries, o16, o32, st);
    else if (W <= 4) e = launch<4>(m, s, R, L, W, N, n_queries, o16, o32, st);
    else if (W <= 8) e = launch<8>(m, s, R, L, W, N, n_queries, o16, o32, st);
    else if (W <= 16) e = launch<16>(m, s, R, L, W, N, n_queries, o16, o32, st);
    else if (W <= 32) e = launch<32>(m, s, R, L, W, N, n_queries, o16, o32, st);
    else if (W <= 64) e = launch<64>(m, s, R, L, W, N, n_queries, o16, o32, st);
    else e = launch<W_LOCAL_MAX>(m, s, R, L, W, N, n_queries, o16, o32, st);
    return (int)e;
}

// The wave variant on the same arguments; R <= 65535 (one grid row per
// reference), W <= WAVE_MAX_W (a segment of one warp to W_LOCAL_MAX, across
// warps past it).
int lcs_wave(const void* masks, const void* syms, int R, int L, int W, int N,
             int n_queries, void* out, int out_u16, void* stream) {
    if (R <= 0 || n_queries <= 0) return 0;
    if (W < 1 || W > WAVE_MAX_W || n_queries > N || R > 65535)
        return (int)cudaErrorInvalidValue;
    const uint32_t* m = static_cast<const uint32_t*>(masks);
    const int32_t* s = static_cast<const int32_t*>(syms);
    uint16_t* o16 = out_u16 ? static_cast<uint16_t*>(out) : nullptr;
    int32_t* o32 = out_u16 ? nullptr : static_cast<int32_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W > W_LOCAL_MAX) {
        const SegGeom sg = seg_geometry(W, WAVE_WPL_MAX, 4,
                                        NO_VALID_AMINOACIDS);
        return (int)(sg.wseg > 512
            ? launch_wave_seg<1024>(sg, m, s, R, L, W, N, n_queries, o16, o32, st)
            : launch_wave_seg<512>(sg, m, s, R, L, W, N, n_queries, o16, o32, st));
    }
    const WaveGeom g = wave_geometry(W);
    switch (g.wpl) {
        case 1: return (int)launch_wave<1>(g, m, s, R, L, W, N, n_queries, o16, o32, st);
        case 2: return (int)launch_wave<2>(g, m, s, R, L, W, N, n_queries, o16, o32, st);
        case 3: case 4:
            return (int)launch_wave<4>(g, m, s, R, L, W, N, n_queries, o16, o32, st);
        default:
            if (g.wpl <= 8) return (int)launch_wave<8>(g, m, s, R, L, W, N, n_queries, o16, o32, st);
            if (g.wpl <= 16) return (int)launch_wave<16>(g, m, s, R, L, W, N, n_queries, o16, o32, st);
            if (g.wpl <= 32) return (int)launch_wave<32>(g, m, s, R, L, W, N, n_queries, o16, o32, st);
            return (int)launch_wave<64>(g, m, s, R, L, W, N, n_queries, o16, o32, st);
    }
}

// K9: refs [R][Lr] i32 reference rows, queries [N][Lq] i32 query rows,
// out [R][N] u16 (out_u16 != 0) or i32; only queries q < n_queries are
// written.  cur: null, or (R = 1, a Prim round) the device int64 id of
// the round's reference, with flags [N] u8: the kernel returns at once
// unless flags[*cur] != 0.  scratch: [R][21][wpl][wseg] u64 for a
// reference past REFMASK_W_MAX words whose masks do not fit shared memory
// (ops/lcs_torch.py:refmask_scratch_words), else null.  Returns the
// launch's cudaError_t.
int lcs_refmask(const void* refs, const void* queries, int R, int Lr, int N,
                int Lq, int n_queries, void* out, int out_u16,
                const void* cur, const void* flags, void* scratch,
                void* stream) {
    if (R <= 0 || n_queries <= 0) return 0;
    const int W64 = (Lr + 63) / 64;
    if (Lr < 1 || Lq < 1 || W64 > REFMASK_SEG_MAX_W || n_queries > N ||
        R > 65535 || (cur != nullptr && (flags == nullptr || R != 1)))
        return (int)cudaErrorInvalidValue;
    const int32_t* rf = static_cast<const int32_t*>(refs);
    const int32_t* qs = static_cast<const int32_t*>(queries);
    const long long* cp = static_cast<const long long*>(cur);
    const uint8_t* fp = static_cast<const uint8_t*>(flags);
    uint16_t* o16 = out_u16 ? static_cast<uint16_t*>(out) : nullptr;
    int32_t* o32 = out_u16 ? nullptr : static_cast<int32_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W64 > REFMASK_W_MAX) {
        const SegGeom sg = seg_geometry(W64, REFMASK_WPL_MAX, 8,
                                        NO_VALID_AMINOACIDS + 1);
        if (!sg.staged && scratch == nullptr)
            return (int)cudaErrorInvalidValue;
        return (int)(sg.wseg > 512
            ? launch_refmask_seg<1024>(sg, rf, qs, R, Lr, N, Lq, n_queries,
                                       scratch, cp, fp, o16, o32, st)
            : launch_refmask_seg<512>(sg, rf, qs, R, Lr, N, Lq, n_queries,
                                      scratch, cp, fp, o16, o32, st));
    }
    const WaveGeom g = wave_geometry(W64);
#define K9(WP) launch_refmask<WP>(g, rf, qs, R, Lr, N, Lq, n_queries, cp, \
                                  fp, o16, o32, st)
    cudaError_t e;
    if (g.wpl <= 1) e = K9(1);
    else if (g.wpl <= 2) e = K9(2);
    else if (g.wpl <= 4) e = K9(4);
    else if (g.wpl <= 8) e = K9(8);
    else if (g.wpl <= 16) e = K9(16);
    else e = K9(32);
#undef K9
    return (int)e;
}

}  // extern "C"
