// K7: the fold after a chain chunk's last step, on the card.
//
// A chunk (ops/dp_chain.py) merges up to K leaves, one a step, into the
// chain's profile, all in one CUDA graph: per step K5 (stage 0, whose
// chain entry first folds step k-1 into the chain's state and writes step
// k's header and side descriptors, csrc/chain.cuh), the DP (K2 staged or
// stripes, B = 1), K4 (the traceback) and K6 (the merged counters, into
// the other of two ping-pong carry buffers).  K7 runs once, after the
// last step, and folds that step: the state and the recorded widths the
// host reads after a replay (ChainState.final_ref, PendingChain.resolve)
// and the next chunk starts from.  It also runs the fold before any step
// k (the same device function as K5's chain entry), which is how the
// smoke holds the fold against its plain twin.
//
// Replaces the carry of the scan famsa_tpu/ops/dp_chain.py:_dp_chain_scan
// (:81-101) and the path width of ops/dp_giant.py:_giant_core's
// want_width (:477-479), with K5's chain entry.  Plain PyTorch twin:
// ops/dp_chain.py:chain_carry_plain.
//
// What bounds it: launch latency (it reads and writes ~300 bytes); the
// chunk's graph removes the launch's host cost, and folding the per-step
// carry into K5 leaves one launch a chunk.  One warp: lane 0 the state,
// lanes 0-23 the header's and descriptors' 24 words.

#include <cstdint>
#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

using famsa_chain::ChainArgs;
using famsa_chain::HDR_WORDS;
using famsa_sides::DESC_WORDS;
typedef long long i64;

__global__ void __launch_bounds__(32) chain_kernel(ChainArgs a) {
    famsa_chain::fold(a, threadIdx.x, a.hdr + HDR_WORDS * (i64)a.k,
                      a.desc + 2 * DESC_WORDS * (i64)a.k, true);
}

}  // namespace

extern "C" {

// The fold before step k of a chunk of nk steps (k = nk: after the last
// step, the chunk's one K7 launch).  leaf [nk][w1p] symbol bytes, lw [nk]
// int64 leaf widths (0: an invalid lane), st [2][4] int64 (two slots of
// width, cardinality, poison; chain.cuh), paths: K4's outputs, step j's
// at j * ps (ps a multiple of 16), widths [nk] int32, hdr [nk][8] int64,
// desc [nk][2][8] int64, carry0 and carry1 the two carry buffers (the
// side 2 of even and of odd steps), cap the chunk's capacity; nk even.
// Returns the launch's cudaError_t.
int chain_carry(const void* leaf, const void* lw, void* st, const void* paths,
                long long ps, void* widths, void* hdr, void* desc,
                const void* carry0, const void* carry1, long long cap,
                int w1p, int k, int nk, void* stream) {
    if (k < 0 || k > nk || nk % 2 != 0 || ps % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const ChainArgs a{static_cast<const uint8_t*>(leaf),
                      static_cast<const i64*>(lw), static_cast<i64*>(st),
                      static_cast<const uint8_t*>(paths), ps,
                      static_cast<int*>(widths), static_cast<i64*>(hdr),
                      static_cast<i64*>(desc),
                      static_cast<const int*>(carry0),
                      static_cast<const int*>(carry1), cap, w1p, k, nk};
    chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
