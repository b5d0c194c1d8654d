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
// over 3.35 TB/s, far below the ~1.7 us a launch takes in a CUDA graph.
// So the launch floor and the latency of the round's dependent steps
// bound it: a vertex's loads, then its pow_tab gather, then the argmin's
// folds.  The first design (one CTA of 1024 threads, ~10 vertices a
// thread at 10,000, each a chain of dependent loads behind a `continue`)
// paid ~10 such chains a thread.
//
// Design: one round on a cluster of C CTAs of 512 threads (C by
// cluster_size: one CTA up to CTA_VERTICES = 2048 vertices, two load
// batches a thread, and a non-portable cluster of 16 past them: on an
// H100 one CTA was the fastest of 1, 2, 4, 8 and 16 CTAs to 2000
// vertices, 16 within 3 % of the fastest from 3000 and the fastest from
// 6000, PERF.md; mirrored by ops/prim_torch.py:cluster_size).
// CTA `rank` owns the contiguous slice [rank * S, (rank + 1) * S) of the
// vertices, S = ceil(n / C); its threads take the slice's vertices at a
// stride of 512 (coalesced), VB at once: every load of the VB vertices
// (active, lcs, len, dist, tieb) is issued before the dependent pow_tab
// gathers, and an inactive or absent vertex is predicated off, not
// skipped.  Each CTA folds its lexicographic partial (dist, tieb, vertex)
// by warp shuffles and shared memory into its own shared memory; then
//   cluster barrier 1: every partial is visible, and every CTA has read
//     *cur and active;
//   every CTA reads the C partials through distributed shared memory and
//     folds them in rank order (so all find the same best), arrives at
//     cluster barrier 2, and copies its share of queries[best, :L] into
//     ref; rank 0 also writes the edge slot, active[best] and *cur;
//   cluster barrier 2 (waited for at the end): every CTA's shared memory
//     outlives the remote reads of its partial.
// Folding in every CTA, rather than in rank 0 and publishing best, saves
// a third barrier.  No atomics, no scratch and no second launch.  The
// argmin's key (dist, tieb, vertex) is a total order, so any fold order
// gives the plain twin's first-index argmin.  A cluster of one CTA is
// launched as a plain grid of one CTA (an implicit cluster of one): its
// warp 0 keeps the CTA's fold, and it takes no cluster barrier.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int VB = 2;                 // vertices a thread loads at once
constexpr int CTA_VERTICES = 2048;    // the shape rule: one CTA to here,
constexpr int MAX_CLUSTER = 16;       // a non-portable cluster past it
constexpr unsigned FULL = 0xFFFFFFFFu;
typedef long long i64;
typedef unsigned long long u64;

// the shape rule: CTAs of one round's cluster for n vertices
int cluster_size(int n) { return n <= CTA_VERTICES ? 1 : MAX_CLUSTER; }

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

__device__ __forceinline__ Best none() {
    return {__longlong_as_double(0x7FF0000000000000LL), ~0ULL, 0x7FFFFFFF};
}

__global__ void __launch_bounds__(THREADS)
prim_round_kernel(const int32_t* __restrict__ lcs, const i64* __restrict__ len,
                  const double* __restrict__ pow_tab,
                  const int32_t* __restrict__ queries, int n, int L,
                  i64* __restrict__ cur, double* __restrict__ dist,
                  u64* __restrict__ tieb, bool* __restrict__ active,
                  int32_t* __restrict__ ref, i64* __restrict__ edges, int k,
                  int slot) {
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ Best part[WARPS];
    __shared__ Best cta_best;
    __shared__ int best_s;
    const int tid = threadIdx.x;
    const int rank = (int)cluster.block_rank();
    const int C = (int)cluster.num_blocks();
    const int per = (n + C - 1) / C;
    const int v0 = rank * per, v1 = min(n, v0 + per);
    const i64 c = *cur;
    const i64 lc = len[c];
    // nextafter(DBL_MAX, 0): the host transform's distance at lcs 0
    const double big = __longlong_as_double(0x7FEFFFFFFFFFFFFELL);
    Best b = none();
    for (int base = v0 + tid; base < v1; base += THREADS * VB) {
        bool act[VB];
        int x[VB];
        i64 lv[VB];
        double d[VB], p[VB];
        u64 t[VB];
#pragma unroll
        for (int j = 0; j < VB; ++j) {       // every independent load first
            const int v = base + j * THREADS;
            const bool in = v < v1;
            act[j] = in ? active[v] : false;
            x[j] = in ? lcs[v] : 0;
            lv[j] = in ? len[v] : 0;
            d[j] = in ? dist[v] : 0.0;
            t[j] = in ? tieb[v] : 0ULL;
        }
#pragma unroll
        for (int j = 0; j < VB; ++j)          // then the dependent gathers
            p[j] = act[j] && x[j] > 0 ? pow_tab[lc + lv[j] - 2 * (i64)x[j]]
                                      : 0.0;
#pragma unroll
        for (int j = 0; j < VB; ++j) {
            const int v = base + j * THREADS;
            const double dn = x[j] > 0 ? p[j] / (double)x[j] : big;
            const u64 lo = (u64)(v < c ? v : c), hi = (u64)(v < c ? c : v);
            const u64 packed = ~((lo << 32) + hi);
            const bool upd = act[j] && (dn < d[j] ||
                                        (dn == d[j] && packed < t[j]));
            if (upd) {
                d[j] = dn;
                t[j] = packed;
                dist[v] = dn;
                tieb[v] = packed;
            }
            const Best mine = {d[j], t[j], v};
            if (act[j] && before(mine, b)) b = mine;
        }
    }
    b = warp_min(b);
    if ((tid & 31) == 0) part[tid >> 5] = b;
    __syncthreads();
    if (tid < 32) {
        b = warp_min(tid < WARPS ? part[tid] : none());
        if (tid == 0 && C > 1) cta_best = b;
    }
    if (C > 1) {
        // the partials are visible; every CTA has read *cur and active
        cluster.sync();
        if (tid < 32)
            b = warp_min(tid < C ? *cluster.map_shared_rank(&cta_best, tid)
                                 : none());
    }
    if (tid < 32) {
        if (tid == 0) best_s = b.i < n ? b.i : n;
        if (tid == 0 && rank == 0 && b.i < n) {
            const u64 pk = ~b.t;
            const i64 p1 = (i64)(pk >> 32), p2 = (i64)(pk & 0xFFFFFFFFULL);
            edges[slot] = p1 < p2 ? p1 : p2;
            edges[(i64)k + slot] = p1 < p2 ? p2 : p1;
            edges[2 * (i64)k + slot] = __double_as_longlong(-b.d);
            active[b.i] = false;
            *cur = b.i;
        }
    }
    __syncthreads();
    // done with the other CTAs' shared memory: arrive now, wait at the end
    if (C > 1) asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
    const int best = best_s;
    if (best < n) {                      // no active vertex: nothing written
        const int32_t* row = queries + (i64)best * L;
        for (int j = rank * THREADS + tid; j < L; j += C * THREADS)
            ref[j] = row[j];
    }
    if (C > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

cudaError_t cluster_ready() {
    static bool done = false;
    if (!done) {
        const cudaError_t e = cudaFuncSetAttribute(
            prim_round_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
            1);
        if (e != cudaSuccess) return e;
        done = true;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

// The CTAs of the cluster prim_round launches for n vertices.
int prim_cluster_size(int n) { return cluster_size(n); }

// One round: lcs [n] int32 (K1 wave's row for reference *cur), len [n]
// int64, pow_tab float64 covering every indel count, queries [n][L] int32;
// cur [1] int64, dist [n] float64, tieb [n] uint64 bits, active [n] bool,
// ref [L] int32 and edges [3][k] int64 (slot < k) are written.  Needs at
// least one active vertex.  cluster: 0 for the shape rule's cluster, else
// 1, 2, 4, 8 or 16 CTAs (forced).  Returns the launch's cudaError_t.
int prim_round(const void* lcs, const void* len, const void* pow_tab,
               const void* queries, int n, int L, void* cur, void* dist,
               void* tieb, void* active, void* ref, void* edges, int k,
               int slot, int cluster, void* stream) {
    if (n < 1 || L < 1 || slot < 0 || slot >= k || cluster < 0 ||
        cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
        return (int)cudaErrorInvalidValue;
    const int C = cluster ? cluster : cluster_size(n);
    cudaError_t e = cluster_ready();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = C > 1;                // C == 1: an implicit cluster
    e = cudaLaunchKernelEx(
        &cfg, prim_round_kernel, static_cast<const int32_t*>(lcs),
        static_cast<const i64*>(len), static_cast<const double*>(pow_tab),
        static_cast<const int32_t*>(queries), n, L, static_cast<i64*>(cur),
        static_cast<double*>(dist), static_cast<u64*>(tieb),
        static_cast<bool*>(active), static_cast<int32_t*>(ref),
        static_cast<i64*>(edges), k, slot);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // extern "C"
