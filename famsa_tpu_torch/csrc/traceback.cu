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
// dependent steps, each a load of the byte the step before picked: from
// global memory a round trip to L2 (~0.2 us) a step, from shared memory
// ~30 cycles.
//
// Design: one CTA of TB_THREADS threads a merge, and a window of the
// merge's direction bytes in shared memory (TB_WINDOW_BYTES of dynamic
// shared memory): rows [i-R+1, i] x columns [j-C+1, j], anchored at the
// walk's cursor (i, j), clamped to the matrix.  The shape follows the
// merge's own w1 : w2 (window_shape, computed here from meta, since a
// chain step's widths exist only on the card), so a path crosses few
// windows; a matrix that fits is staged whole.  All threads load a
// window with 16-byte cp.async copies from the aligned-down start of
// each row's span (rows are w2 + 1 bytes, so their starts are not
// aligned; each copied chunk holds a byte of the row, so no copy leaves
// the row's memory pages), shared row stride an odd multiple of 16 bytes
// (column reads of a V or D run spread over 8 banks).  Then warp 0 walks
// the window: every lane keeps the same cursor; lane l reads the cell l
// steps ahead along the current direction (32 neighbouring bytes of a
// row for H, of a column for V, of a diagonal for D, as far as the
// window and the matrix allow), __ballot_sync finds the first cell whose
// channel leaves the direction, and the warp emits the whole run at once
// (the run jump of _traceback_runs, for all three directions).  When the
// cursor leaves the window, the CTA loads the window anchored at the new
// cursor.  At the end all threads reverse the path in place.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned int u32;
constexpr int D = 0, H = 1, V = 2;
constexpr unsigned FULL = 0xffffffffu;
// the window's bytes of dynamic shared memory (mirrored in
// ops/traceback_torch.py) and the CTA's threads
constexpr int TB_WINDOW_BYTES = 196608;
constexpr int TB_THREADS = 512;

struct Window {
    int rows, cols, stride;   // stride: bytes a row in shared memory
};

// bytes a window row of `cols` columns takes: its span from the aligned-
// down start (<= round16(cols) + 16), made an odd multiple of 16
__host__ __device__ __forceinline__ int row_stride(int cols) {
    int s = (cols + 15) / 16 * 16 + 16;
    if ((s / 16) % 2 == 0) s += 16;
    return s;
}

__device__ i64 isqrt(i64 v) {
    i64 x = (i64)sqrt((double)v);
    while (x * x > v) --x;
    while ((x + 1) * (x + 1) <= v) ++x;
    return x;
}

// the window of a merge of w1 x w2 (ops/traceback_torch.py:window_shape):
// the whole matrix when it fits; else ~sqrt(budget (w2+1) / (w1+1))
// columns and the rows that fit beside them, widened when every row fits
__device__ Window window_shape(i64 w1, i64 w2) {
    const i64 rows_all = w1 + 1, cols_all = w2 + 1;
    Window w;
    if (cols_all <= TB_WINDOW_BYTES &&
        rows_all * row_stride((int)cols_all) <= TB_WINDOW_BYTES) {
        w.rows = (int)rows_all;
        w.cols = (int)cols_all;
    } else {
        i64 c = isqrt((i64)TB_WINDOW_BYTES * cols_all / rows_all);
        c = c < 1 ? 1 : (c > cols_all ? cols_all : c);
        i64 r = TB_WINDOW_BYTES / row_stride((int)c);
        if (r >= rows_all) {
            r = rows_all;
            int s = (int)(TB_WINDOW_BYTES / rows_all) / 16 * 16;
            if ((s / 16) % 2 == 0) s -= 16;
            c = s - 16 < cols_all ? s - 16 : cols_all;
        }
        w.rows = (int)r;
        w.cols = (int)c;
    }
    w.stride = row_stride(w.cols);
    return w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__global__ void __launch_bounds__(TB_THREADS)
trace_kernel(const uint8_t* __restrict__ dirs, const i64* __restrict__ fin,
             const i64* __restrict__ meta, int nb, int ldf,
             uint8_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t win[];
    __shared__ int cur_i, cur_j, cur_n, cur_done;
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const i64 w1 = meta[4 * b], w2 = meta[4 * b + 1];
    if (w1 < 1) return;              // a chain step K7 skipped
    i64 poff = 16 * (i64)nb;
    for (int c = 0; c < b; ++c) poff += meta[4 * c] + meta[4 * c + 1];
    const i64 stride = w2 + 1;
    const uint8_t* dm = dirs + meta[4 * b + 2];
    uint8_t* path = out + poff;
    const Window w = window_shape(w1, w2);
    const int nch = w.stride / 16;   // 16-byte chunks a window row

    // the walk's state, kept by warp 0 (every lane the same)
    int i = (int)w1, j = (int)w2, n = 0, dir = D, dir0 = D;
    bool bad = false;
    i64 total = 0;
    if (tid < 32) {
        const i64* f = fin + ((i64)b * ldf + (w1 - 1)) * 3;
        const i64 d0 = f[0], h0 = f[1], v0 = f[2];
        if (d0 >= h0 && d0 >= v0) { dir = D; total = d0; }
        else if (h0 > v0) { dir = H; total = h0; }
        else { dir = V; total = v0; }
        dir0 = dir;
    }
    if (tid == 0) {
        cur_i = i;
        cur_j = j;
        cur_done = 0;
    }
    __syncthreads();
    while (!cur_done) {
        const int ci = cur_i, cj = cur_j;
        const int r0 = ci - w.rows + 1 > 0 ? ci - w.rows + 1 : 0;
        const int c0 = cj - w.cols + 1 > 0 ? cj - w.cols + 1 : 0;
        const int ncols = cj - c0 + 1;
        // window row r holds the bytes from the aligned-down address of
        // cell (r0 + r, c0) on
        const uintptr_t g0 = reinterpret_cast<uintptr_t>(dm) +
                             (uintptr_t)((i64)r0 * stride + c0);
        for (int k = tid; k < (ci - r0 + 1) * nch; k += TB_THREADS) {
            const int r = k / nch, q = k - r * nch;
            const uintptr_t ga = g0 + (uintptr_t)((i64)r * stride);
            const uintptr_t src = (ga & ~(uintptr_t)15) + 16 * (uintptr_t)q;
            if (src < ga + ncols)
                cp_async16(win + r * w.stride + 16 * q,
                           reinterpret_cast<const void*>(src));
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        if (tid < 32) {
            const u32 a0 = (u32)g0, st = (u32)stride;
            const int ilo = r0 > 1 ? r0 : 1, jlo = c0 > 1 ? c0 : 1;
            bool done = (i | j) == 0;
            bool in = !done && i >= r0 && j >= c0;
            while (in) {
                const int di = dir != H, dj = dir != V;
                // cells of the run that lie in the window and whose step
                // stays in the matrix
                const int ri = di ? i - ilo + 1 : 32;
                const int rj = dj ? j - jlo + 1 : 32;
                int room = ri < rj ? ri : rj;
                room = room < 32 ? room : 32;
                // every lane loads (a lane past the window reads a clamped
                // address, and does not count), so no branch waits on room
                const int r = i - di * lane - r0;
                int at = r * w.stride + (int)((a0 + (u32)r * st) & 15u) +
                         (j - dj * lane - c0);
                at = at > 0 ? at : 0;
                const int ch = (win[at] >> (2 * dir)) & 3;
                if (room < 1) {                   // a step out of it
                    if (lane == 0) path[n] = (uint8_t)dir;
                    ++n;
                    bad = done = true;
                    break;
                }
                // the run ends at the first lane whose channel leaves the
                // direction, or at the last lane of the room; that lane's
                // channel is the next direction
                const unsigned stop =
                    __ballot_sync(FULL, lane < room && ch != dir);
                const int s = __ffs(stop | (1u << (room - 1))) - 1;
                const int next = __shfl_sync(FULL, ch, s);
                if (lane <= s) path[n + lane] = (uint8_t)dir;
                n += s + 1;
                i -= di * (s + 1);
                j -= dj * (s + 1);
                dir = next;
                done = (i | j) == 0;
                in = !done && i >= r0 && j >= c0;  // else: left the window
            }
            if (lane == 0) {
                cur_i = i;
                cur_j = j;
                cur_n = n;
                cur_done = done;
            }
        }
        __syncthreads();
    }
    const int len = cur_n;
    for (int a = tid; a < len / 2; a += TB_THREADS) {
        const uint8_t x = path[a];
        path[a] = path[len - 1 - a];
        path[len - 1 - a] = x;
    }
    if (tid == 0) {
        i64* tr = reinterpret_cast<i64*>(out + 16 * (i64)b);
        tr[0] = total;
        tr[1] = (i64)(unsigned)(bad ? -1 : len) | ((i64)dir0 << 32);
    }
}

cudaError_t smem_ready() {
    static bool done = false;
    if (!done) {
        const cudaError_t e = cudaFuncSetAttribute(
            trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            TB_WINDOW_BYTES);
        if (e != cudaSuccess) return e;
        done = true;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

// dirs: the packed direction bytes of nb merges; fin [nb][ldf][3] int64:
// per-row last-column (D, H, V); meta [nb][4] int64: (w1, w2, dirs byte
// offset, unused), w1, w2 >= 1 (a merge of w1 0 is skipped: its trailer
// and path are not written); out: 16 nb + sum (w1 + w2) bytes.  Returns
// the launch's cudaError_t.  The first call sets the kernel's shared
// memory limit (before any CUDA-graph capture: a chain's warm-up launch).
int trace_paths(const void* dirs, const void* fin, const void* meta, int nb,
                int ldf, void* out, void* stream) {
    if (nb <= 0) return 0;
    const cudaError_t e = smem_ready();
    if (e != cudaSuccess) return (int)e;
    trace_kernel<<<nb, TB_THREADS, TB_WINDOW_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs), static_cast<const i64*>(fin),
        static_cast<const i64*>(meta), nb, ldf,
        static_cast<uint8_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
