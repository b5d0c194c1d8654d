// K2: batched FAMSA profile-profile DP (affine gaps, exact int64), with
// the optional guided band.  This is K2's "global" variant, which takes
// any batch up to w2 = 131071; batches whose widest w2 is <= 4095 take the
// staged variant, dp_profile_batched_staged in csrc/dp_wide.cu (one
// cluster of column folds a merge; ops/dp_torch.py:k2_variant).
//
// Replaces the Pallas kernel famsa_tpu/ops/dp_pallas.py:_make_kernel
// (launched by _run_kernel; the B2 kernel).  Semantics are those of
// famsa_tpu/ops/dp_pallas.py (cells outside [lo, hi] read -inf, column 0
// keeps its boundary V) and of the plain PyTorch twin in
// ops/dp_torch.py:dp_plain; the row recurrence itself is the one in
// dp_common.cuh, shared with K3 (csrc/dp_wide.cu).
// Output: one packed byte per cell, D | H << 2 | V << 4, in the native
// (w1+1) x (w2+1) layout of each merge (row 0 and column 0 included), and
// the last-column (D, H, V) of every row.
//
// What bounds it on the H100: the integer-op issue rate.  A cell needs
// 17 64-bit multiplies (this kernel does 19: bc is formed in pass B and
// again in pass C) and ~50 64-bit adds / compares / selects, each
// several 32-bit instructions, against ~1 byte written; and the rows are
// serial, so one merge can only use one SM.  Design against that: one CTA
// per merge (a batch of up to 16 merges fills 16 SMs), the row loop inside
// the CTA, each thread owning a contiguous stripe of S columns whose
// previous-row D/H/V stay in registers (S = 1..8 unrolled; wider rows use
// a local-memory stripe).  Per row there are two barriers: one to pass the
// stripe's last D/V to the right neighbour, one for the block-wide
// exclusive max-scan of the stripe maxima (warp shuffles + one shared
// word per warp); H at the stripe's left halo is rebuilt from that prefix
// instead of being exchanged.  Column factors (44 int64 planes) are read
// from global memory and stay L2-resident; row factors are warp-uniform
// broadcast reads.  Widths are bounded by device memory (the direction
// bytes), not by shared memory.

#include "dp_common.cuh"

namespace {

using namespace famsa_dp;

template <int S>
__global__ void __launch_bounds__(MAX_THREADS)
dp_kernel(const i64* __restrict__ colf, const i64* __restrict__ rowf,
          const i64* __restrict__ meta, int ldc, int ldr, int ldf,
          int s_dyn, uint8_t* __restrict__ dirs, i64* __restrict__ fin) {
    __shared__ RowShared sh;

    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int SS = S > 0 ? S : s_dyn;             // stripe width
    const i64 w1 = meta[4 * b], w2 = meta[4 * b + 1];
    const i64 stride = w2 + 1;
    uint8_t* dr = dirs + meta[4 * b + 2];
    i64* fb = fin + (size_t)b * ldf * 3;
    const i64* cf = colf + (size_t)b * NCOLF * ldc;
    const i64* rf = rowf + (size_t)b * ldr * NROWF;
    const i64 j0 = (i64)t * SS;

    Stripe<S> st;
    row0<S>(st, cf, ldc, w2, j0, SS, dr);
    BlockXch xch{sh};
    const GlobalCols cols{cf, ldc, j0};
    for (i64 i = 1; i <= w1; ++i)
        dp_row<S>(st, xch, cols, rf + (size_t)i * NROWF, i, w1, w2, j0, SS,
                  t, NEG, NEG, IMIN, dr + i * stride, fb + (size_t)(i - 1) * 3);
}

template <int S>
cudaError_t launch(const i64* colf, const i64* rowf, const i64* meta, int B,
                   int threads, int ldc, int ldr, int ldf, int s_dyn,
                   uint8_t* dirs, i64* fin, cudaStream_t stream) {
    dp_kernel<S><<<B, threads, 0, stream>>>(colf, rowf, meta, ldc, ldr, ldf,
                                            s_dyn, dirs, fin);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// colf [B][44][ldc] i64, rowf [B][ldr][77] i64, meta [B][4] i64
// (w1, w2, byte offset of the merge's dirs, unused); dirs: flat u8;
// fin [B][ldf][3] i64.  stripe in {1, 2, 4, 8} uses the register kernel,
// otherwise the local-memory one (stripe <= 256).  threads * stripe must
// cover max(w2) + 1.  Returns the launch's cudaError_t (0 on success).
int dp_profile_batched(const void* colf, const void* rowf, const void* meta,
                       int B, int threads, int stripe, int ldc, int ldr,
                       int ldf, void* dirs, void* fin, void* stream) {
    if (B <= 0) return 0;
    if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
        stripe < 1 || stripe > S_LOCAL_MAX)
        return (int)cudaErrorInvalidValue;
    const i64* c = static_cast<const i64*>(colf);
    const i64* r = static_cast<const i64*>(rowf);
    const i64* m = static_cast<const i64*>(meta);
    uint8_t* d = static_cast<uint8_t*>(dirs);
    i64* f = static_cast<i64*>(fin);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (stripe) {
        case 1: return (int)launch<1>(c, r, m, B, threads, ldc, ldr, ldf, 1, d, f, st);
        case 2: return (int)launch<2>(c, r, m, B, threads, ldc, ldr, ldf, 2, d, f, st);
        case 4: return (int)launch<4>(c, r, m, B, threads, ldc, ldr, ldf, 4, d, f, st);
        case 8: return (int)launch<8>(c, r, m, B, threads, ldc, ldr, ldf, 8, d, f, st);
        default:
            return (int)launch<0>(c, r, m, B, threads, ldc, ldr, ldf, stripe, d, f, st);
    }
}

}  // extern "C"
