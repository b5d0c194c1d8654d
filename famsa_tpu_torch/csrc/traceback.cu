// K4: the traceback of the profile DP on the card.  Walks each merge's
// packed direction bytes (K2's or K3's output) from (w1, w2) back to
// (0, 0) and writes only the path: one byte a step, D = 0, H = 1, V = 2,
// in forward order, plus the merge's total and its path length.  The
// (w1+1)(w2+1) direction bytes never leave the card.
//
// Replaces the jnp device programs famsa_tpu/ops/dp_pallas.py:
// _traceback_one (:948) and _traceback_runs (:1011), with _tb_impl's
// choice of the first channel and the total (:1185-1196).  Contract: the
// native trace_path (native/famsa_native.cpp), bit for bit:
//  - dir0 and the total come from the last row's finals fin[b][w1-1]:
//    D if D >= H and D >= V; else H if H > V; else V;
//  - at (i, j) the walk reads the cell's channel of the current
//    direction (D bits 0-1, H bits 2-3, V bits 4-5) and steps up-left
//    (D), left (H) or up (V); row 0 and column 0 hold ROW0_PACK and
//    COL0_PACK as K2 and K3 write them.
// Plain PyTorch twin: ops/traceback_torch.py:trace_paths_plain.
//
// Output layout (uint8 out): a 16-byte trailer per merge at 16 b, the
// int64 total then the int32 path length and the int32 first channel
// (length -1: the walk left the matrix, which a DP kernel's bytes never
// make it do); then the paths, merge b's at 16 B + sum_{c<b} (w1_c+w2_c).
//
// What bounds it: not bytes (a path reads ~w1+w2 bytes) but a chain of
// dependent loads, one a step, each a round trip to L2 or HBM.  The
// design's answer is the run jump of _traceback_runs: one warp a merge;
// on a D or V step every lane takes the same broadcast load; on an H step
// lane l reads the cell l columns left of the cursor in the current row
// (32 neighbouring bytes), __ballot_sync finds the nearest cell whose H
// channel leaves H, and the warp emits the whole run at once.  The wide
// merges of the main path are H-dominant (~3850 columns against ~300
// rows), so their dependent loads fall from ~4000 to a few hundred.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
constexpr int D = 0, H = 1, V = 2;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32)
trace_kernel(const uint8_t* __restrict__ dirs, const i64* __restrict__ fin,
             const i64* __restrict__ meta, int nb, int ldf,
             uint8_t* __restrict__ out) {
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    i64 poff = 16 * (i64)nb;
    for (int c = 0; c < b; ++c) poff += meta[4 * c] + meta[4 * c + 1];
    const i64 w1 = meta[4 * b], w2 = meta[4 * b + 1];
    if (w1 < 1) return;              // a chain step K7 skipped
    const i64 stride = w2 + 1;
    const uint8_t* dm = dirs + meta[4 * b + 2];
    const i64* f = fin + ((i64)b * ldf + (w1 - 1)) * 3;
    const i64 d0 = f[0], h0 = f[1], v0 = f[2];
    int dir;
    i64 total;
    if (d0 >= h0 && d0 >= v0) { dir = D; total = d0; }
    else if (h0 > v0) { dir = H; total = h0; }
    else { dir = V; total = v0; }
    const int dir0 = dir;
    uint8_t* path = out + poff;

    // every lane walks the same cursor; lane 0 writes single steps, lane
    // l the l-th step of a run
    i64 i = w1, j = w2, n = 0;
    bool bad = false;
    while (i != 0 || j != 0) {
        if (dir == H && j > 0) {
            const i64 col = j - lane;
            const bool live = col >= 1;
            const int ch = live ? (dm[i * stride + col] >> 2) & 3 : H;
            const unsigned stop = __ballot_sync(FULL, live && ch != H);
            const unsigned end = __ballot_sync(FULL, !live);
            int run;
            if (stop) {                      // the run ends at lane s
                const int s = __ffs(stop) - 1;
                run = s + 1;
                dir = __shfl_sync(FULL, ch, s);
            } else if (end) {                // H through column 1
                run = (int)j;
            } else {                         // H through the whole window
                run = 32;
            }
            if (lane < run) path[n + lane] = (uint8_t)H;
            n += run;
            j -= run;
            continue;
        }
        const uint8_t cell = dm[i * stride + j];
        if (lane == 0) path[n] = (uint8_t)dir;
        ++n;
        if (dir == D) { dir = cell & 3; --i; --j; }
        else if (dir == H) { dir = (cell >> 2) & 3; --j; }
        else { dir = (cell >> 4) & 3; --i; }
        if (i < 0 || j < 0) { bad = true; break; }
    }
    __syncwarp();
    for (i64 a = lane; a < n / 2; a += 32) {
        const uint8_t x = path[a];
        path[a] = path[n - 1 - a];
        path[n - 1 - a] = x;
    }
    if (lane == 0) {
        i64* tr = reinterpret_cast<i64*>(out + 16 * (i64)b);
        tr[0] = total;
        tr[1] = (i64)(unsigned)(bad ? -1 : (int)n)
                | ((i64)dir0 << 32);
    }
}

}  // namespace

extern "C" {

// dirs: the packed direction bytes of nb merges; fin [nb][ldf][3] int64:
// per-row last-column (D, H, V); meta [nb][4] int64: (w1, w2, dirs byte
// offset, unused), w1, w2 >= 1 (a merge of w1 0 is skipped: its trailer
// and path are not written); out: 16 nb + sum (w1 + w2) bytes.  Returns
// the launch's cudaError_t.
int trace_paths(const void* dirs, const void* fin, const void* meta, int nb,
                int ldf, void* out, void* stream) {
    if (nb <= 0) return 0;
    trace_kernel<<<nb, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs), static_cast<const i64*>(fin),
        static_cast<const i64*>(meta), nb, ldf,
        static_cast<uint8_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
