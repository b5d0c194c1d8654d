// K3: FAMSA profile DP of ONE wide merge over a thread-block cluster of
// column folds (affine gaps, exact int64), with the optional guided band;
// and K2's variants that run a batch of merges, one cluster a merge.
//
// Replaces the Pallas kernel famsa_tpu/ops/dp_giant.py:_make_giant_kernel
// (launched by _run_giant; the B3 kernel).  It computes what K2 computes
// for one merge (the recurrence of dp_common.cuh, the plain twin
// ops/dp_wide.py:dp_wide_plain) and writes K2's output: the packed
// direction bytes in the native (w1+1) x (w2+1) layout and the last-column
// (D, H, V) of every row.
//
// What bounds it on the H100: the integer-op issue rate, as K2; but K2's
// global variant runs one merge on one SM, because rows are serial.  K3
// splits columns 0..w2 into F <= 16 folds of threads * S columns, one CTA
// per fold, all in one cluster, so one merge uses F SMs.  The folds run
// as B3's staggered wavefront: at step s, fold f computes row block s - f
// (blk rows).  Per row, fold f needs fold f-1's last-column D and V of
// that row and the running max of m - bc through that column (the seed
// of its block max-scan; H at its left halo follows from it).  Fold f-1
// produced them one step earlier and stored them straight into fold f's
// shared memory (distributed shared memory); one cluster barrier per step
// publishes them, and the edge buffer is double-buffered by step parity,
// so no fold waits on a flag.  A banded merge computes every row in full
// and masks it, as B3 does.
//
// Two bodies, chosen by w2 (ops/dp_wide.py:k3_variant, fold_geometry):
//
// "staged" (w2 <= 8191: folds of <= 512 columns, one column a thread;
// up to 8 folds, the portable cluster size, while w2 <= 4095, then 9-16
// folds of 512 on a non-portable cluster).  A row is latency-bound, so
// it keeps every operand on chip: at launch the fold's 30 score planes
// are copied once into shared memory by TMA bulk copies (cp.async.bulk,
// completion on an mbarrier; <= 120 KB of dynamic shared memory), and the
// 13 other column factors of the thread's column stay in registers for
// the whole launch.  The next step's block of row factors (blk x 77 i64)
// is prefetched with cp.async into a double-buffered shared tile while the
// current block computes, so passes A-C read no global memory.  Exchange
// (WarpXch): the left neighbour's D/V come by __shfl_up_sync within a
// warp; only lane 31's values cross to the next warp, through shared
// memory and a named barrier between the two warps (bar.arrive /
// bar.sync, ids 1..15); the warp maxima of the scan take the row's one
// CTA barrier and are reduced by a five-step shuffle.
//
// "stripes" (8192 <= w2 <= 32767: 16 folds, S = 2 or 4 columns a thread,
// <= 512 threads).  The staged body already sits at the 128-register cap
// at 512 threads, so S columns cannot keep 13 S factors in registers.
// Instead the 13 non-score column planes (104 bytes a column) of all the
// fold's columns (<= 2048) are copied by TMA into shared memory beside
// the row tile, and the 30 score planes, of which a row reads only its
// nonzero symbols (one for a sequence), are read from global memory (L1
// and L2).  This split and the 512-thread cap were chosen by measurement
// (PERF.md; scripts/torch_kernel_redesign.py --parts split,threads
// builds the rejected ones from scripts/dp_wide_variants.patch).  The
// row tile, WarpXch (carrying a stripe's last column) and the fold edges
// are the staged body's.  This replaces the first design
// (stripes of 1-8 columns on <= 8 folds, every factor read from L2 every
// row, two CTA barriers a row).
//
// Both bodies come in two instantiations: BATCH false, one merge (K3's
// entries, dp_profile_wide and dp_profile_wide_stripes), and BATCH true,
// K2's variants on a batch of merges (dp_profile_batched_staged and
// dp_profile_batched_stripes; the note above dp_staged_kernel).
//
// "spans" (K2 past 32767 columns, dp_profile_batched_spans: w2 32768 -
// 131071).  The stripes body at S = 4 on 512 threads, 2048 columns a
// fold, continued past one cluster: a merge takes ceil((w2 + 1) / 2048)
// folds (up to MAX_SPAN * 16 = 64), as a span of up to MAX_SPAN 16-CTA
// clusters, so one merge runs on up to 64 SMs.  Inside a cluster the
// folds run the staggered wavefront above.  Between clusters the edge
// (D, V and the running max of every row) goes through global memory:
// the last fold of cluster c writes a row block's edges, then releases a
// count of published row blocks (st.release.gpu); the first fold of
// cluster c + 1 spins on it with ld.acquire.gpu before the block and
// copies the block's edges into its shared edge buffer (loads through
// L2).  Every row is kept, so the
// producer never waits for the consumer.  No spin can deadlock, whatever
// the card holds: cluster c of a merge is not bound to a grid position
// but taken as a ticket (an atomic count a merge) when the cluster
// starts, so a cluster only ever waits on one that started before it and
// is resident; a batch whose clusters do not fit the card at once runs
// in waves as clusters finish.  A cluster whose ticket lies past its
// merge's span returns at once.
//
// A chain chunk (ops/dp_chain.py) launches the DP inside a CUDA graph,
// where a step's widths exist only on the card: it launches K2's batched
// entry of the capacity's body with B = 1 (staged up to a capacity of
// 8191, stripes past it), with the fold geometry of the capacity and w1,
// w2 read from the step's meta.  A fold that holds no column of the merge
// does no row work but takes every cluster barrier, and a step with w1 0
// (K7 skipped it) returns at once.
//
// K10 (dp_profile_shard, ops/dp_wide.py:dp_shard; the port of
// famsa_tpu/parallel/dp_sharded.py:40 _sharded_program, a shard_map
// program with no pallas_call): one shard's column slice [cs, c1) of one
// merge, every row, on either body (staged to 8192 columns a slice,
// stripes to 32768), BATCH false, in a third mode beside the cluster's own
// folds and the spans' global edges (SLICE, ShardTable below).  famsa_tpu
// runs every row in lockstep over its shards, a halo exchange and two
// all-gathers a row; K10 runs the shards' slices as one wavefront across
// their clusters, as K2 spans runs its clusters (the pipeline of FAMSA's
// column stripes, profile_par.cpp:214-230): a sharded merge launches K10
// once a shard, each launch one cluster that walks rows 1..w1 with its row
// state in registers from the first row to the last.  Between shards the
// edge (D, V and the running max of m - bc of every row of the slice's
// last column) goes through global memory: after each wavefront step the
// thread of column c1 - 1 has written the step's rows into the next
// shard's edge buffer, and it releases the count of rows published; the
// next shard's first fold spins on that count with an acquire load before
// each step.  Every row is kept, so a producer never waits for a
// consumer.  No spin can deadlock: the shards of one merge on one card
// take tickets from one counter of the merge on that card, in pipeline
// order, and a cluster runs the slice its ticket names (the card's table
// of slice arguments, beside the counter), whichever stream's launch it
// came from; so it only ever waits on a slice whose cluster started before
// it and is resident, and shards on other cards wait on clusters that run
// on their own card's SMs.  A slice on another card than the next one's
// writes that shard's edge buffer and count, which live on the consumer's
// card, through peer access with system-scope release and acquire
// (dp_enable_peer; parallel/mesh.py:cols_mesh refuses a mesh of two cards
// without it).  Every slice of a card runs on the fold geometry of the
// card's widest slice; a narrower one leaves its last folds idle.  The
// column factors are the merge's own, sliced, so the cumulative planes
// and the band stay in global column numbers and the H scan's seed needs
// no offset (famsa_tpu's bc_loc + off and carry_in, dp_sharded.py:
// 140-155).  Every bound is the stripes' and staged bodies', per row; the
// shards of one card add one wavefront step of lag each.  This replaces
// the first design, a launch a block of 256 rows a shard with the row
// state saved to global memory between blocks and each shard a whole
// block behind the one before it, ordered by events from the host.

// A cluster of more than 8 CTAs is non-portable: the launch sets
// cudaFuncAttributeNonPortableClusterSizeAllowed, and a cluster the card
// cannot place fails the launch (the wrapper raises); no other variant
// takes its place.

#include <cooperative_groups.h>

#include "dp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace famsa_dp;

// must match ops/dp_wide.py (MAX_FOLDS, BLK_MAX, STRIPES_SMEM_MAX, NPLANE)
constexpr int MAX_FOLDS = 16;                   // the non-portable cluster
constexpr int BLK_MAX = 32;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int NSCORE = 30;                      // score planes C_S2..
constexpr int NREG = C_CUMT - C_P2O + 1;        // column factors in registers
constexpr int NPLANE = C_CUMT + 1;              // planes a row reads
// the planes the stripes body keeps in shared memory: the 13 after the
// score planes
constexpr int NPLANE_CHIP = NPLANE - NSCORE;
constexpr size_t STAGED_SMEM_MAX =
    (size_t)NSCORE * MAX_THREADS * 8 + 2 * (size_t)BLK_MAX * NROWF * 8;
// dynamic shared memory of the stripes body: the 227 KB a CTA may opt in
// to, less 4 KB for its static buffers (edges, exchange, mbarrier)
constexpr size_t STRIPES_SMEM_MAX = 232448 - 4096;
// the spans variant: clusters a merge at most (64 folds of 2048 columns)
constexpr int MAX_SPAN = 4;
// K10: the columns of a slice's column planes before its first column cs
// (cs - 1 for the left halo's factors, and an even count so that the
// bulk copies from the fold starts stay 16-byte aligned); must match
// ops/dp_wide.py:SHARD_PAD
constexpr long long SHARD_PAD = 2;

// K10's slice of one merge (must match ops/dp_wide.py:ShardTable): its
// column planes (shard_columns: column 0 is cs - SHARD_PAD, ldc apart),
// the merge's row factors, its direction bytes [w1 + 1][c1 - cs] and the
// finals of column c1 - 1 [w1][3]; ein [w1][3]: the edge (D, V, running
// max of m - bc) at column cs - 1 of row i at i - 1, written by the
// previous shard (nullptr when cs is 0), ein_ready the count of its rows
// published; eout, eout_ready the next shard's (nullptr on the last);
// peer: bit 0 the previous shard, bit 1 the next, on another card.
struct ShardSlice {
    const i64* colf;
    const i64* rowf;
    uint8_t* dirs;
    i64* fin;
    const i64* ein;
    const unsigned* ein_ready;
    i64* eout;
    unsigned* eout_ready;
    long long cs, c1, ldc, peer;
};

// The slices of one sharded merge on one card, in pipeline order, and the
// counter their clusters take tickets from (zero before the launches).
struct ShardTable {
    unsigned ticket, pad;
    long long n;
    ShardSlice s[1];
};

// ------------------------------------------------------------ staged
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// One column a thread: planes P2O..CUMT in registers, CUME/CUMT of the
// column to the left for H's halo, the score planes in shared memory.
struct FoldCols {
    i64 f[NREG];
    i64 cumEl, cumTl;
    const i64* s2;          // shared [30][lds], offset to the thread's column
    int lds;
    static constexpr bool SHARED_SCORES = true;
    __device__ __forceinline__ i64 operator()(int p, int) const {
        return f[p - C_P2O];
    }
    __device__ __forceinline__ i64 score(i64 s, int) const {
        return s2[(int)s * lds];
    }
    __device__ __forceinline__ i64 left(int p) const {
        return p == C_CUME ? cumEl : cumTl;
    }
};

// Shuffles within a warp, lane 31 to the next warp through shared memory
// and a named barrier of the two warps, the warp maxima through one CTA
// barrier (double-buffered by row parity, so no second barrier is needed
// before they are overwritten).
struct WarpXch {
    i64* xD;                // [MAX_WARPS]
    i64* xV;
    i64* wmax;              // [2][MAX_WARPS]
    int nwarps;
    __device__ __forceinline__ void edge(i64, int t, i64 dl, i64 vl, i64 eD,
                                         i64 eV, i64& lD, i64& lV) {
        const int lane = t & 31, warp = t >> 5;
        lD = __shfl_up_sync(0xffffffffu, dl, 1);
        lV = __shfl_up_sync(0xffffffffu, vl, 1);
        if (warp + 1 < nwarps) {            // feed the next warp
            if (lane == 31) {
                xD[warp] = dl;
                xV[warp] = vl;
            }
            __threadfence_block();
            asm volatile("bar.arrive %0, 64;" :: "r"(warp + 1) : "memory");
        }
        if (warp > 0) {
            asm volatile("bar.sync %0, 64;" :: "r"(warp) : "memory");
            if (lane == 0) {
                lD = xD[warp - 1];
                lV = xV[warp - 1];
            }
        } else if (lane == 0) {
            lD = eD;
            lV = eV;
        }
    }
    __device__ __forceinline__ i64 warps_left(i64 i, int t, i64 inc) {
        const int lane = t & 31, warp = t >> 5;
        i64* wm = wmax + (i & 1) * MAX_WARPS;
        if (lane == 31) wm[warp] = inc;
        __syncthreads();
        i64 v = lane < warp ? wm[lane] : IMIN;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v = imax(v, __shfl_xor_sync(0xffffffffu, v, o));
        return v;
    }
};

// cp.async (8 bytes a thread) of rows [i0, i0 + n) of rowf into tile.
__device__ __forceinline__ void load_rows(i64* tile, const i64* rowf, i64 i0,
                                          int n, int t, int nt) {
    const i64* src = rowf + (size_t)i0 * NROWF;
    for (int e = t; e < n * NROWF; e += nt)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                     :: "r"(smem_addr(tile + e)), "l"(src + e) : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// n rows of edges (D, V, running max) from global memory into a fold's
// edge buffer (every thread, then a CTA barrier): the spans' previous
// cluster's or K10's previous shard's.
__device__ __forceinline__ void edge_in(i64 (*edge)[3], const i64* src, int n,
                                        int t, int nt) {
    for (int k = t; k < n * 3; k += nt)
        edge[k / 3][k % 3] = __ldcg(src + k);
    __syncthreads();
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// K10's edges in: wait (one thread) until the previous shard published
// row `rows`, at system scope from another card
__device__ __forceinline__ void wait_rows(const unsigned* ready,
                                          unsigned rows, bool peer) {
    if (peer) {
        for (;;) {
            unsigned v;
            asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                         : "=r"(v) : "l"(ready) : "memory");
            if (v >= rows) break;
            __nanosleep(32);
        }
    } else {
        while (ld_acquire(ready) < rows) __nanosleep(32);
    }
}

// K10's edges out: publish rows 1..rows (the thread that wrote them)
__device__ __forceinline__ void publish_rows(unsigned* ready, unsigned rows,
                                             bool peer) {
    if (peer) {
        __threadfence_system();
        asm volatile("st.release.sys.global.u32 [%0], %1;"
                     :: "l"(ready), "r"(rows) : "memory");
    } else {
        __threadfence();
        st_release(ready, rows);
    }
}

// K10: the cluster's ticket (rank 0 takes it, every CTA reads it)
__device__ __forceinline__ unsigned take_ticket(cg::cluster_group& cluster,
                                                unsigned* counter,
                                                unsigned* ticket, int f,
                                                int t) {
    if (f == 0 && t == 0) *ticket = atomicAdd(counter, 1u);
    cluster.sync();
    const unsigned tk = *cluster.map_shared_rank(ticket, 0);
    cluster.sync();             // rank 0's ticket is read before any exit
    return tk;
}

// The staged kernel: K3's staged variant (one merge) and K2's staged
// variant (a batch of merges), one body.
//
// As K2's variant it replaces, for batches whose widest w2 is <= 8191,
// the Pallas kernel famsa_tpu/ops/dp_pallas.py:_make_kernel (launched by
// _run_kernel; the B2 kernel).  What bounds it on the H100: the integer
// issue rate, and rows are serial, so K2's first design (one CTA a
// merge) kept at most one SM a merge busy and walked 2-8 columns a
// thread one after another, re-reading every column factor from L2 each
// row.
// Design: the grid is (F, B) with cluster dimension (F, 1, 1), one
// cluster per merge b = blockIdx.y and one CTA per fold, so one launch
// spreads a batch of B merges over up to 16 B SMs; each fold runs K3's
// staged row (one column a thread, factors on chip, one CTA barrier a
// row).  F and the fold width fw come from the batch's widest w2
// (ops/dp_wide.py:fold_geometry); merge b uses its first
// ceil((w2_b + 1) / fw) folds.  A fold of the cluster holding no column of
// its merge does no row work, but it still runs the step loop and takes
// every cluster barrier: the number of barriers is a function of the
// merge alone, so all CTAs of a cluster take the same number.  Merges of
// one launch never interact.  BATCH false: one merge of w1 x w2 (K3's
// entry, B = 1; meta unused).  BATCH true: meta[b] = (w1, w2, dirs
// offset), and merge b's factors, rows and finals lie at b * NCOLF * ldc,
// b * ldr * NROWF and b * ldf * 3.  Two instantiations of the one body:
// the batched one reassigns the pointers and widths per merge, and a
// body that did so for K3's lone merges too measured 3-10 % slower a row
// there (the kernel sits at the 128-register cap of 512 threads); K3's
// instantiation leaves them kernel parameters.  SLICE (BATCH false):
// K10, the slice of one merge its ticket names in `tab` (the header),
// every row; its pointers, widths and ldc come from the table.
template <bool BATCH, bool SLICE = false>
__global__ void __launch_bounds__(MAX_THREADS)
dp_staged_kernel(const i64* __restrict__ colf, const i64* __restrict__ rowf,
                 const i64* __restrict__ meta, i64 w1, i64 w2, int ldc,
                 int ldr, int ldf, int blk, uint8_t* __restrict__ dirs,
                 i64* __restrict__ fin, ShardTable* tab) {
    extern __shared__ __align__(16) i64 dsm[];
    __shared__ i64 edge[2][BLK_MAX][3];
    __shared__ i64 xD[MAX_WARPS], xV[MAX_WARPS], wmax[2][MAX_WARPS];
    __shared__ __align__(8) uint64_t bar;
    __shared__ unsigned ticket;

    cg::cluster_group cluster = cg::this_cluster();
    const int f = (int)cluster.block_rank();
    const int t = threadIdx.x;
    const int fw = blockDim.x;                   // columns of a fold
    if constexpr (BATCH) {
        const int b = blockIdx.y;
        w1 = meta[4 * b];
        w2 = meta[4 * b + 1];
        if (w1 < 1) return;         // a chain step K7 skipped
        dirs += meta[4 * b + 2];
        colf += (size_t)b * NCOLF * ldc;
        rowf += (size_t)b * ldr * NROWF;
        fin += (size_t)b * ldf * 3;
    }
    // K10: the slice of this cluster's ticket, its columns [cs, w2]
    // (colf's column 0 is cs - SHARD_PAD, dirs' cs); else the whole merge
    const ShardSlice* sl = nullptr;
    i64 cs = 0;
    if constexpr (SLICE) {
        const unsigned tk = take_ticket(cluster, &tab->ticket, &ticket, f, t);
        if (tk >= (unsigned)tab->n) return;      // cluster-uniform
        sl = tab->s + tk;
        cs = sl->cs;
        w2 = sl->c1 - 1;
        ldc = (int)sl->ldc;
        colf = sl->colf - (cs - SHARD_PAD);
        rowf = sl->rowf;
        dirs = sl->dirs - cs;
        fin = sl->fin;
    }
    const i64 ra = 1, rz = w1 + 1;
    // folds holding a column of the merge (or slice): all of the
    // cluster's for K3
    const int F = BATCH || SLICE ? (int)((w2 - cs + fw) / fw)
                                 : (int)cluster.num_blocks();
    const bool live = !(BATCH || SLICE) || f < F;
    const i64 c0 = cs + (i64)f * fw;
    const i64 j = c0 + t;
    const i64 stride = w2 + 1 - cs;
    const i64 nrb = (rz - ra + blk - 1) / blk;
    i64* s2 = dsm;                               // [30][fw]
    i64* rtile = dsm + NSCORE * fw;              // [2][blk][NROWF]

    // the fold's score planes: one bulk copy a plane (ldc even and colf
    // 16-byte aligned, checked by the entry points; a fold's columns are
    // rounded up to an even count, which stays inside the plane's row)
    if (t == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(&bar)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (live && t == 0) {
        const i64 ncol = min((i64)fw, w2 + 1 - c0);
        const uint32_t bytes = (uint32_t)(((ncol + 1) & ~1LL) * 8);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_addr(&bar)), "r"(bytes * NSCORE) : "memory");
        for (int p = 0; p < NSCORE; ++p)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                " [%0], [%1], %2, [%3];"
                :: "r"(smem_addr(s2 + p * fw)),
                   "l"(colf + (size_t)(C_S2 + p) * ldc + c0), "r"(bytes),
                   "r"(smem_addr(&bar))
                : "memory");
    }
    // the column's other factors, for the whole launch
    FoldCols cols;
#pragma unroll
    for (int p = 0; p < NREG; ++p)
        cols.f[p] = j <= w2 ? __ldg(colf + (size_t)(C_P2O + p) * ldc + j) : 0;
    cols.cumEl = cols.cumTl = 0;
    if (j >= 1 && j - 1 <= w2) {
        cols.cumEl = __ldg(colf + (size_t)C_CUME * ldc + j - 1);
        cols.cumTl = __ldg(colf + (size_t)C_CUMT * ldc + j - 1);
    }
    cols.s2 = s2 + t;
    cols.lds = fw;
    if (live) load_rows(rtile, rowf, ra, (int)min((i64)blk, rz - ra), t, fw);

    i64* next = (f + 1 < F && t == fw - 1)
                    ? cluster.map_shared_rank(&edge[0][0][0], f + 1) : nullptr;
    // K10: the previous shard's edges into fold 0, column w2's out
    const bool shard_in = SLICE && f == 0 && sl->ein != nullptr;
    i64* eout = SLICE && j == w2 ? sl->eout : nullptr;
    Stripe<1> st;
    row0<1>(st, colf, ldc, w2, j, 1, dirs);
    WarpXch xch{xD, xV, &wmax[0][0], fw / 32};
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (live) {
        uint32_t done = 0;
        while (!done)
            asm volatile(
                "{ .reg .pred p;\n"
                "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                "  selp.u32 %0, 1, 0, p; }"
                : "=r"(done) : "r"(smem_addr(&bar)) : "memory");
    }
    cluster.sync();     // tiles visible; every fold runs before remote stores
    for (i64 s = 0; s < nrb + F - 1; ++s) {
        const i64 rb = s - f;
        if (live && rb >= 0 && rb < nrb) {
            const int in = (int)((s + 1) & 1), out = (int)(s & 1);
            const i64* cur = rtile + (rb & 1) * blk * NROWF;
            const i64 i0 = ra + rb * blk;         // the block's first row
            if (rb + 1 < nrb)
                load_rows(rtile + ((rb + 1) & 1) * blk * NROWF, rowf,
                          i0 + blk, (int)min((i64)blk, rz - i0 - blk), t,
                          fw);
            const int nr = (int)min((i64)blk, rz - i0);
            if (shard_in) {     // once the previous shard published them
                if (t == 0)
                    wait_rows(sl->ein_ready, (unsigned)(i0 + nr - 1),
                              sl->peer & 1);
                __syncthreads();
                edge_in(edge[in], sl->ein + (i0 - 1) * 3, nr, t, fw);
            }
            for (int r = 0; r < blk; ++r) {
                const i64 i = i0 + r;
                if (i >= rz) break;
                i64 eD = NEG, eV = NEG, seed = IMIN;
                if (f > 0 || shard_in) {
                    eD = edge[in][r][0];
                    eV = edge[in][r][1];
                    seed = edge[in][r][2];
                }
                const i64 run = dp_row<1>(st, xch, cols, cur + r * NROWF, i,
                                          w1, w2, j, 1, t, eD, eV, seed,
                                          dirs + i * stride,
                                          fin + (size_t)(i - 1) * 3);
                if (next != nullptr) {
                    i64* e = next + (out * BLK_MAX + r) * 3;
                    e[0] = st.pD[0];
                    e[1] = st.pV[0];
                    e[2] = run;
                }
                if (eout != nullptr) {
                    i64* e = eout + (size_t)(i - 1) * 3;
                    e[0] = st.pD[0];
                    e[1] = st.pV[0];
                    e[2] = run;
                }
            }
            if (eout != nullptr)    // publish the step's rows
                publish_rows(sl->eout_ready, (unsigned)(i0 + nr - 1),
                             sl->peer & 2);
            asm volatile("cp.async.wait_all;" ::: "memory");
        }
        cluster.sync();
    }
}

// ----------------------------------------------------------- stripes
// A stripe's column planes: score plane s of its column j0 + k at
// sbase[s * sld + k] in global memory (colf, sld = ldc), plane p >= C_P2O
// at fbase[(p - C_P2O) * fld + k] in shared memory (rows of the fold's
// fw columns, fld = fw); CUME/CUMT of the column left of the stripe for
// H's halo, read once.
struct StripeCols {
    const i64* sbase;
    const i64* fbase;
    int sld, fld;
    i64 cumEl, cumTl;
    static constexpr bool SHARED_SCORES = true;
    __device__ __forceinline__ i64 operator()(int p, int k) const {
        return fbase[(p - C_P2O) * fld + k];
    }
    __device__ __forceinline__ i64 score(i64 s, int k) const {
        return sbase[(int)s * sld + k];
    }
    __device__ __forceinline__ i64 left(int p) const {
        return p == C_CUME ? cumEl : cumTl;
    }
};

// The stripes body: S columns a thread, the non-score planes of the
// fold's columns in shared memory.  Arguments, batching and the step
// loop as dp_staged_kernel's.  SPAN (K2's spans variant, BATCH): a merge
// over up to MAX_SPAN clusters (the header); sync [B][1 + MAX_SPAN]
// u32, zeroed before the launch: per merge its ticket count, then the
// row blocks published across each cluster boundary; gedge
// [B][MAX_SPAN - 1][ldf][3] i64, the rows' edges at each boundary.
// SLICE (BATCH false): K10, the slice its ticket names in `tab` (as
// dp_staged_kernel's), its edges in and out through global memory as the
// spans'.
template <int S, bool BATCH, bool SPAN, bool SLICE = false>
__global__ void __launch_bounds__(MAX_THREADS)
dp_stripes_kernel(const i64* __restrict__ colf, const i64* __restrict__ rowf,
                  const i64* __restrict__ meta, i64 w1, i64 w2, int ldc,
                  int ldr, int ldf, int blk, uint8_t* __restrict__ dirs,
                  i64* __restrict__ fin, unsigned* sync, i64* gedge,
                  ShardTable* tab) {
    extern __shared__ __align__(16) i64 dsm[];
    __shared__ i64 edge[2][BLK_MAX][3];
    __shared__ i64 xD[MAX_WARPS], xV[MAX_WARPS], wmax[2][MAX_WARPS];
    __shared__ __align__(8) uint64_t bar;
    __shared__ unsigned ticket;

    cg::cluster_group cluster = cg::this_cluster();
    const int f = (int)cluster.block_rank();
    const int t = threadIdx.x;
    const int nt = blockDim.x;
    const int fw = nt * S;                       // columns of a fold
    const int b = BATCH ? (int)blockIdx.y : 0;
    if constexpr (BATCH) {
        w1 = meta[4 * b];
        w2 = meta[4 * b + 1];
        if (w1 < 1) return;         // a chain step K7 skipped
        dirs += meta[4 * b + 2];
        colf += (size_t)b * NCOLF * ldc;
        rowf += (size_t)b * ldr * NROWF;
        fin += (size_t)b * ldf * 3;
    }
    // the cluster's place in its merge's span: c, of C clusters
    int c = 0, C = 1;
    unsigned* ready = nullptr;      // [MAX_SPAN]: row blocks published
    if constexpr (SPAN) {
        c = (int)take_ticket(cluster, sync + b * (1 + MAX_SPAN), &ticket, f,
                             t);
        C = (int)(((w2 + fw) / fw + MAX_FOLDS - 1) / MAX_FOLDS);
        if (c >= C) return;         // the span is taken
        ready = sync + b * (1 + MAX_SPAN) + 1;
        gedge += (size_t)b * (MAX_SPAN - 1) * ldf * 3;
    }
    // K10: the slice of this cluster's ticket, its columns [cs, w2]
    // (colf's column 0 is cs - SHARD_PAD, dirs' cs); else the whole merge
    const ShardSlice* sl = nullptr;
    i64 cs = 0;
    if constexpr (SLICE) {
        const unsigned tk = take_ticket(cluster, &tab->ticket, &ticket, f, t);
        if (tk >= (unsigned)tab->n) return;      // cluster-uniform
        sl = tab->s + tk;
        cs = sl->cs;
        w2 = sl->c1 - 1;
        ldc = (int)sl->ldc;
        colf = sl->colf - (cs - SHARD_PAD);
        rowf = sl->rowf;
        dirs = sl->dirs - cs;
        fin = sl->fin;
    }
    const i64 ra = 1, rz = w1 + 1;
    const int F = BATCH ? (int)min((i64)MAX_FOLDS,
                                   (w2 + fw) / fw - (i64)c * MAX_FOLDS)
                  : SLICE ? (int)((w2 - cs + fw) / fw)
                          : (int)cluster.num_blocks();
    const bool live = !(BATCH || SLICE) || f < F;
    const i64 c0 = cs + ((i64)c * MAX_FOLDS + f) * fw;
    const i64 j0 = c0 + (i64)t * S;
    // edges through global memory: in from the previous cluster (fold 0
    // of c > 0) or K10's previous shard (fold 0 when cs > 0), out to the
    // next cluster (the last fold of c < C - 1, thread nt - 1, its
    // stripe's last column) or shard (the thread of column w2)
    const bool span_in = SPAN && f == 0 && c > 0;
    const i64* gin = span_in ? gedge + (size_t)(c - 1) * ldf * 3
                     : SLICE && f == 0 ? sl->ein : nullptr;
    i64* gout = (SPAN && f == MAX_FOLDS - 1 && c + 1 < C && t == nt - 1)
                    ? gedge + (size_t)c * ldf * 3
                : (SLICE && j0 <= w2 && w2 < j0 + S) ? sl->eout : nullptr;
    const int kout = SLICE ? (int)(w2 - j0) : S - 1;
    const i64 stride = w2 + 1 - cs;
    const i64 nrb = (rz - ra + blk - 1) / blk;
    i64* planes = dsm;                           // [NPLANE_CHIP][fw]
    i64* rtile = dsm + (size_t)NPLANE_CHIP * fw;   // [2][blk][NROWF]

    // the fold's non-score planes: one bulk copy a plane (ldc even, colf
    // 16-byte aligned and fw even; the count rounded up to an even number
    // stays inside the plane's row)
    if (t == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(&bar)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const i64 ncopy = live ? min((i64)fw, ((w2 + 1 - c0) + 1) & ~1LL) : 0;
    if (ncopy > 0 && t == 0) {
        const uint32_t bytes = (uint32_t)(ncopy * 8);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_addr(&bar)), "r"(bytes * NPLANE_CHIP)
                     : "memory");
        for (int p = NSCORE; p < NPLANE; ++p)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                " [%0], [%1], %2, [%3];"
                :: "r"(smem_addr(planes + (size_t)(p - NSCORE) * fw)),
                   "l"(colf + (size_t)p * ldc + c0), "r"(bytes),
                   "r"(smem_addr(&bar))
                : "memory");
    }
    StripeCols cols;
    cols.sbase = colf + j0;
    cols.sld = ldc;
    cols.fbase = planes + (size_t)(C_P2O - NSCORE) * fw + (j0 - c0);
    cols.fld = fw;
    cols.cumEl = cols.cumTl = 0;
    if (j0 >= 1 && j0 - 1 <= w2) {
        cols.cumEl = __ldg(colf + (size_t)C_CUME * ldc + j0 - 1);
        cols.cumTl = __ldg(colf + (size_t)C_CUMT * ldc + j0 - 1);
    }
    if (live) load_rows(rtile, rowf, ra, (int)min((i64)blk, rz - ra), t, nt);

    i64* next = (f + 1 < F && t == nt - 1)
                    ? cluster.map_shared_rank(&edge[0][0][0], f + 1) : nullptr;
    Stripe<S> st;
    row0<S>(st, colf, ldc, w2, j0, S, dirs);
    WarpXch xch{xD, xV, &wmax[0][0], nt / 32};
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (ncopy > 0) {
        uint32_t done = 0;
        while (!done)
            asm volatile(
                "{ .reg .pred p;\n"
                "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                "  selp.u32 %0, 1, 0, p; }"
                : "=r"(done) : "r"(smem_addr(&bar)) : "memory");
    }
    cluster.sync();     // tiles visible; every fold runs before remote stores
    for (i64 s = 0; s < nrb + F - 1; ++s) {
        const i64 rb = s - f;
        if (live && rb >= 0 && rb < nrb) {
            const int in = (int)((s + 1) & 1), out = (int)(s & 1);
            const i64* cur = rtile + (rb & 1) * blk * NROWF;
            const i64 i0 = ra + rb * blk;         // the block's first row
            if (rb + 1 < nrb)
                load_rows(rtile + ((rb + 1) & 1) * blk * NROWF, rowf,
                          i0 + blk, (int)min((i64)blk, rz - i0 - blk), t,
                          nt);
            const int nr = (int)min((i64)blk, rz - i0);
            if (gin != nullptr) {   // the previous cluster's or shard's edges
                if (t == 0) {       // once it published them
                    if constexpr (SPAN)
                        while (ld_acquire(ready + c - 1) < (unsigned)(rb + 1))
                            __nanosleep(32);
                    if constexpr (SLICE)
                        wait_rows(sl->ein_ready, (unsigned)(i0 + nr - 1),
                                  sl->peer & 1);
                }
                __syncthreads();
                edge_in(edge[in], gin + (i0 - 1) * 3, nr, t, nt);
            }
            for (int r = 0; r < blk; ++r) {
                const i64 i = i0 + r;
                if (i >= rz) break;
                i64 eD = NEG, eV = NEG, seed = IMIN;
                if (f > 0 || gin != nullptr) {
                    eD = edge[in][r][0];
                    eV = edge[in][r][1];
                    seed = edge[in][r][2];
                }
                const i64 run = dp_row<S>(st, xch, cols, cur + r * NROWF, i,
                                          w1, w2, j0, S, t, eD, eV, seed,
                                          dirs + i * stride,
                                          fin + (size_t)(i - 1) * 3);
                if (next != nullptr) {
                    i64* e = next + (out * BLK_MAX + r) * 3;
                    e[0] = st.pD[S - 1];
                    e[1] = st.pV[S - 1];
                    e[2] = run;
                }
                if (gout != nullptr) {
                    i64 eD_out = 0, eV_out = 0;
#pragma unroll
                    for (int k = 0; k < S; ++k)
                        if (k == kout) {
                            eD_out = st.pD[k];
                            eV_out = st.pV[k];
                        }
                    i64* e = gout + (size_t)(i - 1) * 3;
                    e[0] = eD_out;
                    e[1] = eV_out;
                    e[2] = run;
                }
            }
            if constexpr (SPAN) {
                if (gout != nullptr) {  // publish block rb to the next cluster
                    __threadfence();
                    st_release(ready + c, (unsigned)(rb + 1));
                }
            }
            if constexpr (SLICE) {
                if (gout != nullptr)    // publish the step's rows
                    publish_rows(sl->eout_ready, (unsigned)(i0 + nr - 1),
                                 sl->peer & 2);
            }
            asm volatile("cp.async.wait_all;" ::: "memory");
        }
        cluster.sync();
    }
}

// grid (folds, batch), one cluster of the folds per batch index
cudaLaunchConfig_t cluster_config(int folds, int batch, int threads,
                                  size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(folds, batch, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = folds;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// the kernel's dynamic shared memory limit and non-portable clusters, set
// once a kernel and device (`done`: a bit a device; K10 launches on every
// card of a mesh)
template <class Kernel>
cudaError_t kernel_ready(Kernel kernel, size_t smem_max,
                         unsigned long long& done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!(done >> dev & 1)) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_max);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
        done |= 1ull << dev;
    }
    return cudaSuccess;
}

size_t staged_smem(int threads, int blk) {
    return (size_t)NSCORE * threads * 8 + 2 * (size_t)blk * NROWF * 8;
}

// the non-score planes of a fold of fw columns and the row tile
size_t stripes_smem(int fw, int blk) {
    return (size_t)NPLANE_CHIP * fw * 8 + 2 * (size_t)blk * NROWF * 8;
}

template <bool BATCH, bool SLICE = false>
cudaError_t staged_ready() {
    static unsigned long long done = 0;
    return kernel_ready(dp_staged_kernel<BATCH, SLICE>, STAGED_SMEM_MAX, done);
}

template <int S, bool BATCH, bool SPAN = false, bool SLICE = false>
cudaError_t stripes_ready() {
    static unsigned long long done = 0;
    return kernel_ready(dp_stripes_kernel<S, BATCH, SPAN, SLICE>,
                        STRIPES_SMEM_MAX, done);
}

template <bool BATCH, bool SLICE = false>
cudaError_t launch_staged(const i64* colf, const i64* rowf, const i64* meta,
                          i64 w1, i64 w2, int batch, int folds, int threads,
                          int ldc, int ldr, int ldf, int blk, uint8_t* dirs,
                          i64* fin, cudaStream_t stream,
                          ShardTable* tab = nullptr) {
    cudaError_t err = staged_ready<BATCH, SLICE>();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(folds, batch, threads,
                                            staged_smem(threads, blk), stream,
                                            attr);
    err = cudaLaunchKernelEx(&cfg, dp_staged_kernel<BATCH, SLICE>, colf, rowf,
                             meta, w1, w2, ldc, ldr, ldf, blk, dirs, fin, tab);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <int S, bool BATCH, bool SLICE>
cudaError_t launch_stripes_s(const i64* colf, const i64* rowf,
                             const i64* meta, i64 w1, i64 w2, int batch,
                             int folds, int threads, int ldc, int ldr,
                             int ldf, int blk, uint8_t* dirs, i64* fin,
                             cudaStream_t stream, ShardTable* tab) {
    cudaError_t err = stripes_ready<S, BATCH, false, SLICE>();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(folds, batch, threads,
                                            stripes_smem(threads * S, blk),
                                            stream, attr);
    err = cudaLaunchKernelEx(&cfg, dp_stripes_kernel<S, BATCH, false, SLICE>,
                             colf, rowf, meta, w1, w2, ldc, ldr, ldf, blk,
                             dirs, fin, (unsigned*)nullptr, (i64*)nullptr,
                             tab);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <bool BATCH, bool SLICE = false>
cudaError_t launch_stripes(const i64* colf, const i64* rowf, const i64* meta,
                           i64 w1, i64 w2, int batch, int folds, int threads,
                           int stripe, int ldc, int ldr, int ldf, int blk,
                           uint8_t* dirs, i64* fin, cudaStream_t stream,
                           ShardTable* tab = nullptr) {
    if (stripe == 2)
        return launch_stripes_s<2, BATCH, SLICE>(colf, rowf, meta, w1, w2,
                                                 batch, folds, threads, ldc,
                                                 ldr, ldf, blk, dirs, fin,
                                                 stream, tab);
    return launch_stripes_s<4, BATCH, SLICE>(colf, rowf, meta, w1, w2, batch,
                                             folds, threads, ldc, ldr, ldf,
                                             blk, dirs, fin, stream, tab);
}

// a fold geometry the bodies take: folds (1..16) CTAs of threads (32..512,
// whole warps) threads, stripe columns a thread (1 staged; 2 or 4
// stripes), covering w2 + 1 columns with every fold but the last full
bool bad_geometry(long long w2, int folds, int threads, int stripe, int ldc,
                  int blk) {
    const long long fw = (long long)threads * stripe;
    return folds < 1 || folds > MAX_FOLDS || threads < 32 ||
           threads > MAX_THREADS || threads % 32 != 0 || blk < 1 ||
           blk > BLK_MAX || folds * fw < w2 + 1 ||
           (folds - 1) * fw >= w2 + 1 || ldc < w2 + 1 || ldc % 2 != 0;
}

// a stripe and rows a step the stripes body takes: 2 or 4 columns a
// thread, the fold's planes and the row tile within its shared memory
bool bad_stripes(int threads, int stripe, int blk) {
    return (stripe != 2 && stripe != 4) ||
           stripes_smem(threads * stripe, blk) > STRIPES_SMEM_MAX;
}

bool bad_batch(int B, long long max_w2, int folds, int threads, int stripe,
               int ldc, int ldr, int ldf, int blk, const void* colf) {
    return B > 65535 || folds < 1 || folds > MAX_FOLDS || threads < 32 ||
           threads > MAX_THREADS || threads % 32 != 0 || blk < 1 ||
           blk > BLK_MAX || max_w2 < 0 ||
           (long long)folds * threads * stripe < max_w2 + 1 ||
           ldc < max_w2 + 1 || ldc % 2 != 0 || ldr < 1 || ldf < ldr - 1 ||
           reinterpret_cast<uintptr_t>(colf) % 16 != 0;
}

}  // namespace

extern "C" {

// One merge: colf [44][ldc] i64 (ldc even, colf 16-byte aligned: the bulk
// copies), rowf [w1+1][77] i64; dirs: (w1+1)*(w2+1) u8; fin [w1][3] i64.
// The staged body: folds (1..16) CTAs of threads (32..512, whole warps)
// threads, one column each (stripe must be 1); folds * threads must cover
// w2 + 1 and (folds - 1) * threads must not (every fold but the last is
// full).  blk (1..32): rows per wavefront step.  Returns the launch's
// cudaError_t (0 on success).
int dp_profile_wide(const void* colf, const void* rowf, long long w1,
                    long long w2, int folds, int threads, int stripe, int ldc,
                    int blk, void* dirs, void* fin, void* stream) {
    if (w1 < 1 || w2 < 1) return 0;
    if (bad_geometry(w2, folds, threads, stripe, ldc, blk) || stripe != 1 ||
        reinterpret_cast<uintptr_t>(colf) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    return (int)launch_staged<false>(
        static_cast<const i64*>(colf), static_cast<const i64*>(rowf), nullptr,
        (i64)w1, (i64)w2, 1, folds, threads, ldc, 0, 0, blk,
        static_cast<uint8_t*>(dirs), static_cast<i64*>(fin),
        static_cast<cudaStream_t>(stream));
}

// The stripes body on the same arguments, stripe 2 or 4 columns a thread
// (blk at most 12 at 512 threads of 4: the fold's planes and the row tile
// must fit its shared memory).
int dp_profile_wide_stripes(const void* colf, const void* rowf, long long w1,
                            long long w2, int folds, int threads, int stripe,
                            int ldc, int blk, void* dirs, void* fin,
                            void* stream) {
    if (w1 < 1 || w2 < 1) return 0;
    if (bad_geometry(w2, folds, threads, stripe, ldc, blk) ||
        bad_stripes(threads, stripe, blk) ||
        reinterpret_cast<uintptr_t>(colf) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    return (int)launch_stripes<false>(
        static_cast<const i64*>(colf), static_cast<const i64*>(rowf), nullptr,
        (i64)w1, (i64)w2, 1, folds, threads, stripe, ldc, 0, 0, blk,
        static_cast<uint8_t*>(dirs), static_cast<i64*>(fin),
        static_cast<cudaStream_t>(stream));
}

// K2's staged variant: a batch of B merges packed by
// ops/dp_pack.py:pack_batch (colf [B][44][ldc], rowf [B][ldr][77],
// meta [B][4] = (w1, w2, dirs byte offset, unused), fin [B][ldf][3]),
// max_w2 the widest w2 of the batch (w1 0: the merge returns at once, a
// chain step K7 skipped).  folds (1..16) CTAs of threads (32..512, whole
// warps) columns each, one column a thread, must cover max_w2 + 1; ldc
// even and colf 16-byte aligned.  blk (1..32): rows per wavefront step.
// Returns the launch's cudaError_t (0 on success).
int dp_profile_batched_staged(const void* colf, const void* rowf,
                              const void* meta, int B, long long max_w2,
                              int folds, int threads, int ldc, int ldr,
                              int ldf, int blk, void* dirs, void* fin,
                              void* stream) {
    if (B <= 0) return 0;
    if (bad_batch(B, max_w2, folds, threads, 1, ldc, ldr, ldf, blk, colf))
        return (int)cudaErrorInvalidValue;
    return (int)launch_staged<true>(
        static_cast<const i64*>(colf), static_cast<const i64*>(rowf),
        static_cast<const i64*>(meta), 0, 0, B, folds, threads, ldc, ldr, ldf,
        blk, static_cast<uint8_t*>(dirs), static_cast<i64*>(fin),
        static_cast<cudaStream_t>(stream));
}

// K2's stripes variant on the same arguments, stripe (2 or 4) columns a
// thread: folds * threads * stripe must cover max_w2 + 1 (blk as for
// dp_profile_wide_stripes).
int dp_profile_batched_stripes(const void* colf, const void* rowf,
                               const void* meta, int B, long long max_w2,
                               int folds, int threads, int stripe, int ldc,
                               int ldr, int ldf, int blk, void* dirs,
                               void* fin, void* stream) {
    if (B <= 0) return 0;
    if (bad_batch(B, max_w2, folds, threads, stripe, ldc, ldr, ldf, blk,
                  colf) || bad_stripes(threads, stripe, blk))
        return (int)cudaErrorInvalidValue;
    return (int)launch_stripes<true>(
        static_cast<const i64*>(colf), static_cast<const i64*>(rowf),
        static_cast<const i64*>(meta), 0, 0, B, folds, threads, stripe, ldc,
        ldr, ldf, blk, static_cast<uint8_t*>(dirs), static_cast<i64*>(fin),
        static_cast<cudaStream_t>(stream));
}

// K2's spans variant (the header): a batch of B merges packed as for
// dp_profile_batched_stripes, max_w2 its widest w2 (32768..131071), each
// merge over ceil(ceil((w2 + 1) / 2048) / 16) clusters of 16 folds of 512
// threads of 4 columns (blk rows a step, at most 12).  sync: [B][5] u32
// zeroed, gedge: [B][3][ldf][3] i64 scratch.  The grid holds B x
// ceil(max folds / 16) clusters.
int dp_profile_batched_spans(const void* colf, const void* rowf,
                             const void* meta, int B, long long max_w2,
                             int ldc, int ldr, int ldf, int blk, void* dirs,
                             void* fin, void* sync, void* gedge,
                             void* stream) {
    if (B <= 0) return 0;
    constexpr int threads = MAX_THREADS, stripe = 4;
    constexpr long long fw = (long long)threads * stripe;
    const long long folds = (max_w2 + fw) / fw;
    const int span = (int)((folds + MAX_FOLDS - 1) / MAX_FOLDS);
    if (max_w2 < 0 || span > MAX_SPAN || B > 65535 || blk < 1 ||
        blk > BLK_MAX || ldc < max_w2 + 1 || ldc % 2 != 0 || ldr < 1 ||
        ldf < ldr - 1 || reinterpret_cast<uintptr_t>(colf) % 16 != 0 ||
        bad_stripes(threads, stripe, blk) || sync == nullptr ||
        gedge == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = stripes_ready<stripe, true, true>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(
        MAX_FOLDS, B, threads, stripes_smem(threads * stripe, blk),
        static_cast<cudaStream_t>(stream), attr);
    cfg.gridDim.x = MAX_FOLDS * span;
    err = cudaLaunchKernelEx(
        &cfg, dp_stripes_kernel<stripe, true, true>,
        static_cast<const i64*>(colf), static_cast<const i64*>(rowf),
        static_cast<const i64*>(meta), (i64)0, (i64)0, ldc, ldr, ldf, blk,
        static_cast<uint8_t*>(dirs), static_cast<i64*>(fin),
        static_cast<unsigned*>(sync), static_cast<i64*>(gedge),
        (ShardTable*)nullptr);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// K10 (the header): one cluster of `folds` CTAs that takes the next
// ticket of `table` (a ShardTable of n slices on this device, its ticket
// zero before the merge's first launch) and runs that slice over rows
// 1..w1.  folds / threads / stripe: the fold geometry of the table's
// widest slice (ops/dp_wide.py:fold_geometry(c1 - cs - 1)), stripe 1 the
// staged body, 2 or 4 the stripes body; every slice of the table must
// fit it.  blk (1..32): rows per wavefront step.  Returns the launch's
// cudaError_t (0 on success).
int dp_profile_shard(void* table, long long n, long long w1, int folds,
                     int threads, int stripe, int blk, void* stream) {
    if (table == nullptr || n < 1 || w1 < 1 || folds < 1 ||
        folds > MAX_FOLDS || threads < 32 || threads > MAX_THREADS ||
        threads % 32 != 0 || blk < 1 || blk > BLK_MAX ||
        (stripe != 1 && bad_stripes(threads, stripe, blk)))
        return (int)cudaErrorInvalidValue;
    ShardTable* tab = static_cast<ShardTable*>(table);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (stripe == 1)
        return (int)launch_staged<false, true>(nullptr, nullptr, nullptr,
                                               (i64)w1, 0, 1, folds, threads,
                                               0, 0, 0, blk, nullptr, nullptr,
                                               st, tab);
    return (int)launch_stripes<false, true>(nullptr, nullptr, nullptr,
                                            (i64)w1, 0, 1, folds, threads,
                                            stripe, 0, 0, 0, blk, nullptr,
                                            nullptr, st, tab);
}

// Lets `device` read and write `peer`'s memory (K10's edges from one card
// into the next one's); already enabled is success.  Returns a
// cudaError_t.
int dp_enable_peer(int device, int peer) {
    int prev = 0;
    cudaError_t e = cudaGetDevice(&prev);
    if (e != cudaSuccess) return (int)e;
    e = cudaSetDevice(device);
    if (e == cudaSuccess) {
        e = cudaDeviceEnablePeerAccess(peer, 0);
        if (e == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();
            e = cudaSuccess;
        }
    }
    const cudaError_t back = cudaSetDevice(prev);
    return (int)(e != cudaSuccess ? e : back);
}

// How many clusters of `folds` CTAs of `threads` threads (blk rows a
// step) of the batched body of `stripe` (1: staged; 2, 4: stripes) can be
// resident on the device at once (cudaOccupancyMaxActiveClusters); a
// negative cudaError_t on failure.
int dp_wide_max_clusters(int folds, int threads, int stripe, int blk) {
    cudaLaunchAttribute attr[1];
    int n = 0;
    cudaError_t err;
    if (stripe == 1) {
        err = staged_ready<true>();
        if (err != cudaSuccess) return -(int)err;
        cudaLaunchConfig_t cfg = cluster_config(
            folds, 1, threads, staged_smem(threads, blk), 0, attr);
        err = cudaOccupancyMaxActiveClusters(&n, dp_staged_kernel<true>, &cfg);
    } else if (stripe == 2 || stripe == 4) {
        err = stripe == 2 ? stripes_ready<2, true>() : stripes_ready<4, true>();
        if (err != cudaSuccess) return -(int)err;
        cudaLaunchConfig_t cfg = cluster_config(
            folds, 1, threads, stripes_smem(threads * stripe, blk), 0, attr);
        err = stripe == 2
                  ? cudaOccupancyMaxActiveClusters(
                        &n, dp_stripes_kernel<2, true, false>, &cfg)
                  : cudaOccupancyMaxActiveClusters(
                        &n, dp_stripes_kernel<4, true, false>, &cfg);
    } else {
        return -(int)cudaErrorInvalidValue;
    }
    return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
