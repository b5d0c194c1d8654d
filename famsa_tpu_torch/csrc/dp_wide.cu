// K3: FAMSA profile DP of ONE wide merge over a thread-block cluster of
// column folds (affine gaps, exact int64), with the optional guided band.
//
// Replaces the Pallas kernel famsa_tpu/ops/dp_giant.py:_make_giant_kernel
// (launched by _run_giant; the B3 kernel).  It computes what K2 computes
// for one merge (the recurrence of dp_common.cuh, the plain twin
// ops/dp_wide.py:dp_wide_plain) and writes K2's output: the packed
// direction bytes in the native (w1+1) x (w2+1) layout and the last-column
// (D, H, V) of every row.
//
// What bounds it on the H100: the integer-op issue rate, as K2; but K2
// runs one merge on one SM, because rows are serial.  K3 splits columns
// 0..w2 into F <= 8 folds of threads * S columns, one CTA per fold, all
// in one cluster (8 is the portable cluster size), so one merge uses F
// SMs.  The folds run as B3's staggered wavefront: at step s, fold f
// computes row block s - f (blk rows).  Per row, fold f needs fold f-1's
// last-column D and V of that row and the running max of m - bc through
// that column (the seed of its block max-scan; H at its left halo follows
// from it).  Fold f-1 produced them one step earlier and stored them
// straight into fold f's shared memory (distributed shared memory); one
// cluster barrier per step publishes them, and the edge buffer is
// double-buffered by step parity, so no fold waits on a flag.  A banded
// merge computes every row in full and masks it, as B3 does.

#include <cooperative_groups.h>

#include "dp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace famsa_dp;

constexpr int MAX_FOLDS = 8;
constexpr int BLK_MAX = 32;

template <int S>
__global__ void __launch_bounds__(MAX_THREADS)
dp_wide_kernel(const i64* __restrict__ colf, const i64* __restrict__ rowf,
               i64 w1, i64 w2, int ldc, int blk, uint8_t* __restrict__ dirs,
               i64* __restrict__ fin) {
    __shared__ RowShared sh;
    // edges of the fold to the left, per row of a block: D, V, run
    __shared__ i64 edge[2][BLK_MAX][3];

    cg::cluster_group cluster = cg::this_cluster();
    const int f = (int)cluster.block_rank();
    const int F = (int)cluster.num_blocks();
    const int t = threadIdx.x;
    const i64 j0 = ((i64)f * blockDim.x + t) * S;
    const i64 stride = w2 + 1;
    const i64 nrb = (w1 + blk - 1) / blk;
    // the thread owning the fold's last column feeds the next fold
    i64* next = (f + 1 < F && t == (int)blockDim.x - 1)
                    ? cluster.map_shared_rank(&edge[0][0][0], f + 1) : nullptr;

    Stripe<S> st;
    row0<S>(st, colf, ldc, w2, j0, S, dirs);
    cluster.sync();     // every fold runs before the first remote store
    for (i64 s = 0; s < nrb + F - 1; ++s) {
        const i64 b = s - f;
        if (b >= 0 && b < nrb) {
            const int in = (int)((s + 1) & 1), out = (int)(s & 1);
            for (int r = 0; r < blk; ++r) {
                const i64 i = b * blk + r + 1;
                if (i > w1) break;
                i64 eD = NEG, eV = NEG, seed = IMIN;
                if (f > 0) {
                    eD = edge[in][r][0];
                    eV = edge[in][r][1];
                    seed = edge[in][r][2];
                }
                const i64 run = dp_row<S>(st, sh, colf, ldc,
                                          rowf + (size_t)i * NROWF, i, w1, w2,
                                          j0, S, t, eD, eV, seed,
                                          dirs + i * stride,
                                          fin + (size_t)(i - 1) * 3);
                if (next != nullptr) {
                    i64* e = next + (out * BLK_MAX + r) * 3;
                    e[0] = st.pD[S - 1];
                    e[1] = st.pV[S - 1];
                    e[2] = run;
                }
            }
        }
        cluster.sync();
    }
}

template <int S>
cudaError_t launch(const i64* colf, const i64* rowf, i64 w1, i64 w2,
                   int folds, int threads, int ldc, int blk, uint8_t* dirs,
                   i64* fin, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(folds, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = folds;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, dp_wide_kernel<S>, colf, rowf,
                                         w1, w2, ldc, blk, dirs, fin);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// One merge: colf [44][ldc] i64, rowf [w1+1][77] i64; dirs: (w1+1)*(w2+1)
// u8; fin [w1][3] i64.  folds (1..8) CTAs of threads (32..512, whole
// warps) threads, each thread a stripe of stripe in {1, 2, 4, 8} columns;
// folds * threads * stripe must cover w2 + 1 and (folds - 1) * threads *
// stripe must not (every fold but the last is full).  blk (1..32): rows
// per wavefront step.  Returns the launch's cudaError_t (0 on success).
int dp_profile_wide(const void* colf, const void* rowf, long long w1,
                    long long w2, int folds, int threads, int stripe, int ldc,
                    int blk, void* dirs, void* fin, void* stream) {
    if (w1 < 1 || w2 < 1) return 0;
    const long long fw = (long long)threads * stripe;
    if (folds < 1 || folds > MAX_FOLDS || threads < 32 ||
        threads > MAX_THREADS || threads % 32 != 0 || blk < 1 ||
        blk > BLK_MAX || folds * fw < w2 + 1 || (folds - 1) * fw >= w2 + 1 ||
        ldc < w2 + 1)
        return (int)cudaErrorInvalidValue;
    const i64* c = static_cast<const i64*>(colf);
    const i64* r = static_cast<const i64*>(rowf);
    uint8_t* d = static_cast<uint8_t*>(dirs);
    i64* f = static_cast<i64*>(fin);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (stripe) {
        case 1: return (int)launch<1>(c, r, w1, w2, folds, threads, ldc, blk, d, f, st);
        case 2: return (int)launch<2>(c, r, w1, w2, folds, threads, ldc, blk, d, f, st);
        case 4: return (int)launch<4>(c, r, w1, w2, folds, threads, ldc, blk, d, f, st);
        case 8: return (int)launch<8>(c, r, w1, w2, folds, threads, ldc, blk, d, f, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
