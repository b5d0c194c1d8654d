// K1: bit-parallel LCS (Hyyro) of R reference rows against N queries, in
// two hand-written variants that compute the same words bit for bit.
//
// Replaces the Pallas kernel famsa_tpu/ops/lcs_pallas.py:_make_kernel
// (launched by _lcs_pallas_impl).  Same arithmetic, same symmetric-LCS
// layout: the per-symbol occupancy masks of ALL queries are precomputed
// once and the reference's symbols are streamed, so each reference
// position needs only masks[sym] (no per-query gather).  For each 32-bit
// word of a query's state V:  V2 = V + (V & M) + carry,
// carry = (V2 < V) unsigned,  V = V2 | (V - (V & M));  LCS = sum popc(~V).
// Symbols >= 20 (pad 22) have all-zero mask rows and are no-ops: V stays
// and the carry out is 0.
//
// Layout: masks [32][W][N] u32 (query fastest), syms [R][L] i32, out
// [R][N] (u16 or i32).  Only queries q < n_queries are computed (the
// triangular-sweep half-work saving of the Pallas kernel's dynamic grid);
// other columns are left untouched.
//
// What bounds it on the H100: the integer-op issue rate in the ideal,
// ~6 dependent 32-bit ops per (reference position, query, word), against
// tiny bytes.  In practice the carry chain's latency, so each variant is
// built to keep enough independent chains in flight:
//
// lcs_bitpar ("rows", many references: TorchDistanceBackend's 256-row
// blocks).  One thread per query keeps its W words in registers (template
// caps 2..64, fully unrolled; past 64 words a local-memory array);
// REFS_PER_CTA references share a CTA so the mask slab of its 128 queries
// is reused from L1; every thread reads the same reference symbol (a
// broadcast, a warp-uniform skip of no-op symbols).  A thread runs L x W
// dependent word updates, which is fine when R x N threads fill the card.
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
//
// Dispatch (ops/lcs_torch.py:lcs_variant): the wave variant while
// R x ceil(n_queries / 128) < 4096, the rows variant from there on.  On
// an H100 the wave variant won up to 32 references x 10,000 queries and
// every R <= 256 at 1000 queries; the rows variant from 64 x 10,000,
// where its R x N threads fill the card and each re-reads no masks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int REFS_PER_CTA = 8;
constexpr int NO_VALID_AMINOACIDS = 20;
constexpr int W_LOCAL_MAX = 2048;   // 65536 positions: the u16 output range
constexpr int WAVE_TILE = 1024;     // steps per staged window of symbols
constexpr int WAVE_LAG = 31;        // the most a lane lags lane 0
constexpr uint8_t NOOP = 0xFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

template <int WMAX>
__global__ void __launch_bounds__(THREADS)
lcs_kernel(const uint32_t* __restrict__ masks, const int32_t* __restrict__ syms,
           int R, int L, int W, int N, int n_queries,
           uint16_t* __restrict__ out16, int32_t* __restrict__ out32) {
    const int r0 = blockIdx.x * REFS_PER_CTA;    // refs fastest: CTAs of one
    const int nr = min(REFS_PER_CTA, R - r0);    // query block run together
    const int q = blockIdx.y * THREADS + threadIdx.x;
    if (q >= n_queries) return;
    const size_t wstride = (size_t)N;
    const size_t sstride = (size_t)W * N;
    const uint32_t* mq = masks + q;

    for (int r = 0; r < nr; ++r) {
        uint32_t V[WMAX];
        if constexpr (WMAX <= 64) {
#pragma unroll
            for (int k = 0; k < WMAX; ++k) V[k] = 0xFFFFFFFFu;
        } else {
            for (int k = 0; k < W; ++k) V[k] = 0xFFFFFFFFu;
        }
        const int32_t* sr = syms + (size_t)(r0 + r) * L;
        for (int t = 0; t < L; ++t) {
            const int s = __ldg(sr + t);       // warp-uniform broadcast
            if ((unsigned)s >= (unsigned)NO_VALID_AMINOACIDS) continue;
            const uint32_t* ms = mq + (size_t)s * sstride;
            uint32_t carry = 0;
            if constexpr (WMAX <= 64) {
#pragma unroll
                for (int k = 0; k < WMAX; ++k) {
                    if (k < W) {
                        const uint32_t v = V[k];
                        const uint32_t tb = v & __ldg(ms + k * wstride);
                        const uint32_t v2 = v + tb + carry;
                        carry = v2 < v;
                        V[k] = v2 | (v - tb);
                    }
                }
            } else {
                for (int k = 0; k < W; ++k) {
                    const uint32_t v = V[k];
                    const uint32_t tb = v & __ldg(ms + k * wstride);
                    const uint32_t v2 = v + tb + carry;
                    carry = v2 < v;
                    V[k] = v2 | (v - tb);
                }
            }
        }
        int cnt = 0;
        if constexpr (WMAX <= 64) {
#pragma unroll
            for (int k = 0; k < WMAX; ++k)
                if (k < W) cnt += __popc(~V[k]);
        } else {
            for (int k = 0; k < W; ++k) cnt += __popc(~V[k]);
        }
        const size_t o = (size_t)(r0 + r) * N + q;
        if (out16) out16[o] = (uint16_t)cnt;
        else out32[o] = cnt;
    }
}

template <int WMAX>
cudaError_t launch(const uint32_t* masks, const int32_t* syms, int R, int L,
                   int W, int N, int n_queries, uint16_t* out16,
                   int32_t* out32, cudaStream_t stream) {
    dim3 grid((R + REFS_PER_CTA - 1) / REFS_PER_CTA,
              (n_queries + THREADS - 1) / THREADS);
    lcs_kernel<WMAX><<<grid, THREADS, 0, stream>>>(
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
                        const uint32_t v = V[j];
                        const uint32_t tb = v & m[j * wseg];
                        const uint32_t v2 = v + tb + cy;
                        cy = v2 < v;
                        V[j] = v2 | (v - tb);
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

}  // namespace

extern "C" {

// masks: [32][W][N] u32; syms: [R][L] i32; out: [R][N] u16 (out_u16 != 0)
// or i32.  Returns the launch's cudaError_t (0 on success).
int lcs_bitpar(const void* masks, const void* syms, int R, int L, int W,
               int N, int n_queries, void* out, int out_u16, void* stream) {
    if (R <= 0 || n_queries <= 0) return 0;
    if (W < 1 || W > W_LOCAL_MAX || n_queries > N || (n_queries + THREADS - 1) / THREADS > 65535)
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
// reference).
int lcs_wave(const void* masks, const void* syms, int R, int L, int W, int N,
             int n_queries, void* out, int out_u16, void* stream) {
    if (R <= 0 || n_queries <= 0) return 0;
    if (W < 1 || W > W_LOCAL_MAX || n_queries > N || R > 65535)
        return (int)cudaErrorInvalidValue;
    const WaveGeom g = wave_geometry(W);
    const uint32_t* m = static_cast<const uint32_t*>(masks);
    const int32_t* s = static_cast<const int32_t*>(syms);
    uint16_t* o16 = out_u16 ? static_cast<uint16_t*>(out) : nullptr;
    int32_t* o32 = out_u16 ? nullptr : static_cast<int32_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
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

}  // extern "C"
