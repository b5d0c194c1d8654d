// K8: the body of one MST-Prim round after its LCS, on the card.
//
// Replaces famsa_tpu/ops/prim_device.py:67 round_step after :69 (the
// round's LCS, which K1 wave computes): the distance, the packed tie keys,
// the conditional update of each active vertex's best (distance, key),
// the lexicographic argmin over the active vertices, the edge unpacking
// and the active-mask update.  A Prim round on the card is K1 wave, then
// K8, on one stream, with no host read.  Plain PyTorch twin:
// ops/prim_torch.py:prim_round_plain.
//
// For every vertex v of n, with c = *cur and lcs the K1 wave row of
// reference c:
//   d_new  = pow_tab[len[c] + len[v] - 2 lcs[v]] / lcs[v], an IEEE float64
//            division; lcs 0 gives nextafter(DBL_MAX, 0), as the host
//            transform (ops/distance.py) does (the JAX round gives
//            DBL_MAX there);
//   packed = ~((min(v, c) << 32) + max(v, c)), a uint64 compared unsigned;
//   upd    = active[v] && (d_new < dist[v] ||
//                          (d_new == dist[v] && packed < tieb[v])).
// Where upd holds, dist[v] and tieb[v] are written IN PLACE (the JAX round
// is pure and returns new arrays).  Then best = the active vertex with the
// smallest (dist, tieb) (keys are unique among active vertices after the
// first round; v breaks a tie all the same, so the result is the plain
// twin's first-index argmin in any reduction order), and K8 writes slot
// `slot` of the chunk's edge buffer edges [3][k] int64: min and max of the
// two ids packed in ~tieb[best], and -dist[best] as float64 bits; clears
// active[best]; sets *cur = best; and copies queries[best, :L] into ref,
// the [1, L] row the next round's K1 wave reads.  tieb holds the uint64
// key bits in an int64 tensor, unflipped: the plain twin compares them
// with the sign bit flipped, which is the unsigned order.
//
// What bounds it: bytes, ~53 a vertex (lcs 4, len 8, pow_tab 8, dist and
// tieb 8 each read and written, active 1): ~0.16 us at 10,000 vertices
// over 3.35 TB/s, below the ~2-4 us a launch takes on its own.  So the
// launch floor and one SM's latency bound it.  Design: one CTA of 1024
// threads, a vertex a thread at a stride of 1024 (coalesced), a
// warp-shuffle then shared-memory lexicographic reduction.  One CTA
// reads and writes *cur with no other CTA in flight, needs no second
// pass, no atomic ticket and no scratch, and at 10,000 vertices gives
// each thread ~10 vertices: a few microseconds, under a tenth of K1
// wave's round at that size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
typedef long long i64;
typedef unsigned long long u64;

struct Best {
    double d;
    u64 t;
    int i;
};

__device__ __forceinline__ bool before(const Best& a, const Best& b) {
    return a.d < b.d || (a.d == b.d && (a.t < b.t || (a.t == b.t && a.i < b.i)));
}

__device__ __forceinline__ Best warp_min(Best b) {
    for (int off = 16; off > 0; off >>= 1) {
        Best o;
        o.d = __shfl_down_sync(FULL, b.d, off);
        o.t = __shfl_down_sync(FULL, b.t, off);
        o.i = __shfl_down_sync(FULL, b.i, off);
        if (before(o, b)) b = o;
    }
    return b;
}

__global__ void __launch_bounds__(THREADS)
prim_round_kernel(const int32_t* __restrict__ lcs, const i64* __restrict__ len,
                  const double* __restrict__ pow_tab,
                  const int32_t* __restrict__ queries, int n, int L,
                  i64* __restrict__ cur, double* __restrict__ dist,
                  u64* __restrict__ tieb, bool* __restrict__ active,
                  int32_t* __restrict__ ref, i64* __restrict__ edges, int k,
                  int slot) {
    __shared__ Best part[WARPS];
    __shared__ int best_s;
    const int tid = threadIdx.x;
    const i64 c = *cur;
    const i64 lc = len[c];
    // nextafter(DBL_MAX, 0): the host transform's distance at lcs 0
    const double big = __longlong_as_double(0x7FEFFFFFFFFFFFFELL);
    Best b = {__longlong_as_double(0x7FF0000000000000LL), ~0ULL, 0x7FFFFFFF};
#pragma unroll 4
    for (int v = tid; v < n; v += THREADS) {
        if (!active[v]) continue;
        const int x = lcs[v];
        const double dn = x > 0 ? pow_tab[lc + len[v] - 2 * (i64)x] / (double)x
                                : big;
        const u64 lo = (u64)(v < c ? v : c), hi = (u64)(v < c ? c : v);
        const u64 packed = ~((lo << 32) + hi);
        double d = dist[v];
        u64 t = tieb[v];
        if (dn < d || (dn == d && packed < t)) {
            d = dn;
            t = packed;
            dist[v] = d;
            tieb[v] = t;
        }
        const Best mine = {d, t, v};
        if (before(mine, b)) b = mine;
    }
    b = warp_min(b);
    if ((tid & 31) == 0) part[tid >> 5] = b;
    __syncthreads();                     // every thread has read *cur
    if (tid < 32) {
        b = part[tid];                   // WARPS == 32
        b = warp_min(b);
        if (tid == 0 && b.i >= n) best_s = n;
        if (tid == 0 && b.i < n) {
            const u64 p = ~b.t;
            const i64 p1 = (i64)(p >> 32), p2 = (i64)(p & 0xFFFFFFFFULL);
            edges[slot] = p1 < p2 ? p1 : p2;
            edges[(i64)k + slot] = p1 < p2 ? p2 : p1;
            edges[2 * (i64)k + slot] = __double_as_longlong(-b.d);
            active[b.i] = false;
            *cur = b.i;
            best_s = b.i;
        }
    }
    __syncthreads();
    if (best_s >= n) return;             // no active vertex: nothing written
    const int32_t* row = queries + (i64)best_s * L;
    for (int j = tid; j < L; j += THREADS) ref[j] = row[j];
}

}  // namespace

extern "C" {

// One round: lcs [n] int32 (K1 wave's row for reference *cur), len [n]
// int64, pow_tab float64 covering every indel count, queries [n][L] int32;
// cur [1] int64, dist [n] float64, tieb [n] uint64 bits, active [n] bool,
// ref [L] int32 and edges [3][k] int64 (slot < k) are written.  Needs at
// least one active vertex.  Returns the launch's cudaError_t.
int prim_round(const void* lcs, const void* len, const void* pow_tab,
               const void* queries, int n, int L, void* cur, void* dist,
               void* tieb, void* active, void* ref, void* edges, int k,
               int slot, void* stream) {
    if (n < 1 || L < 1 || slot < 0 || slot >= k)
        return (int)cudaErrorInvalidValue;
    prim_round_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lcs), static_cast<const i64*>(len),
        static_cast<const double*>(pow_tab),
        static_cast<const int32_t*>(queries), n, L, static_cast<i64*>(cur),
        static_cast<double*>(dist), static_cast<u64*>(tieb),
        static_cast<bool*>(active), static_cast<int32_t*>(ref),
        static_cast<i64*>(edges), k, slot);
    return (int)cudaGetLastError();
}

}  // extern "C"
