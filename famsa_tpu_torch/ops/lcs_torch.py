"""Bit-parallel LCS on torch: the query mask table, the plain PyTorch
versions, the wrapper of the CUDA kernel K1 (csrc/lcs.cu, a rows variant
for many references and a wave variant for few) and the distance backend
built on them.

Symmetric-LCS layout (as the JAX package's ops/lcs_jax.py): the
per-symbol occupancy masks of ALL queries are built once, and each
reference's symbols are streamed, so a reference position needs only
masks[sym].  K1 computes the exact LCS, which is symmetric.

FAMSA's own LCS (src/lcs/lcsbp_classic.h:49-221; the host reference
ops/lcs.py) builds 64-bit masks of the REFERENCE and takes a word's carry
out as V2 < V, which drops the carry where V & M is all ones and a carry
comes in.  That happens only for a reference with a word k >= 1 of 64
positions holding one valid symbol (famsa_flags): for every other
reference FAMSA's value is the exact LCS.  A flagged reference's row goes
to kernel K9 (csrc/lcs.cu:lcs_refmask, plain twin lcs_refmask_plain),
which computes FAMSA's layout and carry.
"""

import numpy as np
import torch

from .. import kernels
from ..core.defs import NO_SYMBOLS, NO_VALID_AMINOACIDS

BV32 = 32
PAD_SYMBOL = 22                  # UNKNOWN: a no-op symbol


def build_query_mask_table(padded: np.ndarray) -> np.ndarray:
    """[NO_SYMBOLS, W, N] uint32 per-symbol occupancy masks of all rows of
    `padded` ([N, L] int8, pad symbol >= 20); rows >= 20 stay zero.  The
    query index is fastest so that K1's warps read coalesced words."""
    n, lmax = padded.shape
    w = max(1, (lmax + BV32 - 1) // BV32)
    table = np.zeros((NO_SYMBOLS, w, n), dtype=np.uint32)
    sym = padded.astype(np.int64)
    t = np.arange(lmax)
    words = t // BV32
    bits = (np.uint32(1) << (t % BV32).astype(np.uint32))
    rows, cols = np.nonzero((sym >= 0) & (sym < NO_VALID_AMINOACIDS))
    np.bitwise_or.at(table, (sym[rows, cols], words[cols], rows), bits[cols])
    return table


def famsa_flags(padded: np.ndarray) -> np.ndarray:
    """[N] bool: row k of `padded` ([N, L] int8 symbols) is flagged when
    some word k >= 1 of it, positions 64k .. 64k+63, is a single symbol
    < 20: as a reference, FAMSA's carry test then departs from the exact
    LCS (word 0 never has a carry in; a partial word is never all
    ones)."""
    n, lmax = padded.shape
    nw = lmax // 64
    if nw < 2:
        return np.zeros(n, dtype=bool)
    words = padded[:, 64:nw * 64].reshape(n, nw - 1, 64)
    first = words[:, :, :1]
    one = ((words == first).all(axis=2) & (first[:, :, 0] >= 0)
           & (first[:, :, 0] < NO_VALID_AMINOACIDS))
    return one.any(axis=1)


def lcs_plain(table, syms, n_queries):
    """Plain PyTorch version of K1 (both variants compute it): LCS of each
    of the R symbol rows `syms` ([R, L] int32) against the first
    n_queries queries of `table` ([32, W, N] int32 holding the uint32 mask
    bits).  Returns [R, N] int32; columns >= n_queries are 0.  Words are
    held in int64 so that the unsigned 32-bit add and its carry are
    exact."""
    r, length = syms.shape
    _, w, n = table.shape
    tab = table[:, :, :n_queries].to(torch.int64) & 0xFFFFFFFF
    x = torch.full((r, w, n_queries), 0xFFFFFFFF, dtype=torch.int64,
                   device=table.device)
    syms64 = syms.to(torch.int64)
    for t in range(length):
        sb = tab[syms64[:, t]]                  # [R, W, nq]
        carry = torch.zeros((r, n_queries), dtype=torch.int64,
                            device=table.device)
        cols = []
        for k in range(w):
            v = x[:, k]
            tb = v & sb[:, k]
            s = v + tb + carry
            carry = s >> 32
            # tb is a subset of v's bits, so v - tb never borrows
            cols.append((s & 0xFFFFFFFF) | (v - tb))
        x = torch.stack(cols, dim=1)
    return _counts(x, n, n_queries)


def _counts(x, n, n_queries):
    """[R, N] int32 LCS from final words x [R, ..., nq] (popcount of ~x
    over every axis but the first and the last); columns >= n_queries 0."""
    ones = (~x & 0xFFFFFFFF).reshape(x.shape[0], -1, n_queries)
    cnt = torch.zeros((x.shape[0], n_queries), dtype=torch.int64,
                      device=x.device)
    for b in range(32):
        cnt += (ones >> b & 1).sum(dim=1)
    out = torch.zeros((x.shape[0], n), dtype=torch.int32, device=x.device)
    out[:, :n_queries] = cnt.to(torch.int32)
    return out


SIGN = -(1 << 63)                # int64 sign bit


def _popcount64(x):
    """[...] int64 popcount of int64 words x, summed over the last axis."""
    cnt = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for b in range(64):
        cnt += (x >> b & 1).sum(dim=-1)
    return cnt


def lcs_refmask_plain(refs, queries, n_queries):
    """Plain PyTorch version of K9 (csrc/lcs.cu:lcs_refmask), a torch port
    of the host reference famsa_tpu/ops/lcs.py:lcs_ref_vs_queries: LCS of
    each reference row `refs` ([R, Lr] int32) against the first n_queries
    rows of `queries` ([N, Lq] int32) in FAMSA's layout: the reference's
    64-bit masks, the query streamed, a word's carry out taken as
    V2 < V.  Words are int64: the add wraps, and the unsigned compare
    flips the sign bit.  Returns [R, N] int32; columns >= n_queries are
    0."""
    r, lr = refs.shape
    n = queries.shape[0]
    dev = refs.device
    w = max(1, -(-lr // 64))
    masks = torch.zeros((r, NO_VALID_AMINOACIDS + 1, w), dtype=torch.int64,
                        device=dev)             # row 20: the no-op symbols
    ref64 = refs.to(torch.int64)
    rr, pp = torch.nonzero((ref64 >= 0) & (ref64 < NO_VALID_AMINOACIDS),
                           as_tuple=True)
    # distinct bits of one word: their sum is their OR
    masks.index_put_((rr, ref64[rr, pp], pp // 64),
                     torch.ones_like(pp) << (pp % 64), accumulate=True)
    q = queries[:n_queries].to(torch.int64)
    q = torch.where((q >= 0) & (q < NO_VALID_AMINOACIDS), q,
                    NO_VALID_AMINOACIDS)
    x = torch.full((r, n_queries, w), -1, dtype=torch.int64, device=dev)
    for t in range(q.shape[1]):
        sb = masks[:, q[:, t]]                   # [R, nq, W]
        carry = torch.zeros((r, n_queries), dtype=torch.int64, device=dev)
        for k in range(w):
            v = x[..., k]
            tb = v & sb[..., k]
            v2 = v + tb + carry
            carry = ((v2 ^ SIGN) < (v ^ SIGN)).to(torch.int64)
            x[..., k] = v2 | (v & ~tb)
    out = torch.zeros((r, n), dtype=torch.int32, device=dev)
    out[:, :n_queries] = _popcount64(~x).to(torch.int32)
    return out


# K9's wavefront (csrc/lcs.cu:lcs_refmask_kernel): K1 wave's geometry
# (wave_geometry, at most REFMASK_WPL_MAX 64-bit words a lane) over the
# reference's W64 64-bit words; a CTA of REFMASK_THREADS threads,
# REFMASK_THREADS / wseg queries; each warp stages its queries' symbols in
# windows of REFMASK_TILE steps; to REFMASK_W_MAX words (65536 positions)
# a segment of one warp, past it (lcs_refmask_seg_kernel) a segment across
# warps to REFMASK_SEG_MAX_W words (2,097,152 positions)
REFMASK_THREADS = 128
REFMASK_TILE = 256
REFMASK_W_MAX = 1024
REFMASK_WPL_MAX = 32


def lcs_refmask_wave_plain(refs, queries, n_queries, trim=True):
    """Plain PyTorch emulation of K9's order, on lcs_refmask_plain's
    arguments and with its result: the reference's 64-bit masks laid out
    [symbol][lane][word-in-lane] with an all-zero row for the no-op
    symbols; each query a segment of wseg lanes, lane k owning words
    [k*wpl, (k+1)*wpl) (words past W64 zero-masked, lanes past nl holding
    only such words); at step s lane k takes query position s - k with
    the carry lane k-1 produced one step earlier (lane 0: none), and
    every lane takes every step, no-op positions through the zero row.
    A query runs Lq + nl - 1 steps; with `trim`, as the kernel, the
    queries of one warp (32 // wseg consecutive ones; one query, a CTA,
    for a segment across warps) stop after their last live position p at
    step p + nl - 1 and pass no carry after it (the kernel ends each
    staged window there, and skips a window with no live symbol: steps
    where every lane that holds words sees a no-op change nothing, which
    trim=False shows).  Past 32 lanes the carry from lane 31 of a warp to
    lane 0 of the next goes through shared memory, still one step late:
    the same order."""
    r, lr = refs.shape
    lq = queries.shape[1]
    n = queries.shape[0]
    dev = refs.device
    w64 = max(1, -(-lr // 64))
    wseg, wpl, nl = wave_geometry(w64, REFMASK_WPL_MAX)
    masks = torch.zeros((r, NO_VALID_AMINOACIDS + 1, wseg * wpl),
                        dtype=torch.int64, device=dev)
    ref64 = refs.to(torch.int64)
    rr, pp = torch.nonzero((ref64 >= 0) & (ref64 < NO_VALID_AMINOACIDS),
                           as_tuple=True)
    masks.index_put_((rr, ref64[rr, pp], pp // 64),
                     torch.ones_like(pp) << (pp % 64), accumulate=True)
    masks = masks.view(r, NO_VALID_AMINOACIDS + 1, wseg, wpl)
    q = queries[:n_queries].to(torch.int64)
    live = (q >= 0) & (q < NO_VALID_AMINOACIDS)
    q = torch.where(live, q, NO_VALID_AMINOACIDS)
    steps = lq + nl - 1
    stop = torch.full((n_queries,), steps, dtype=torch.int64, device=dev)
    if trim:
        pos = torch.arange(lq, device=dev)
        last = torch.where(live, pos, -1).amax(dim=1)
        qpw = max(1, 32 // wseg)
        pad = -n_queries % qpw
        warp = torch.cat([last, last.new_full((pad,), -1)]).view(-1, qpw)
        stop = (warp.amax(dim=1) + nl).repeat_interleave(qpw)[:n_queries]
    lanes = torch.arange(wseg, device=dev)
    x = torch.full((r, n_queries, wseg, wpl), -1, dtype=torch.int64,
                   device=dev)
    carry = torch.zeros((r, n_queries, wseg), dtype=torch.int64, device=dev)
    zero = torch.zeros((r, n_queries, 1), dtype=torch.int64, device=dev)
    for s in range(steps):
        cy = torch.cat([zero, carry[..., :-1]], dim=-1)    # one step late
        p = s - lanes
        sym = torch.where((p >= 0) & (p < lq), q[:, p.clamp(0, lq - 1)],
                          NO_VALID_AMINOACIDS)              # [nq, wseg]
        m = masks[:, sym, lanes[None, :]]                   # [R, nq, wseg, wpl]
        run = (s < stop)[None, :, None]
        for j in range(wpl):
            v = x[..., j]
            tb = v & m[..., j]
            v2 = v + tb + cy
            cy = ((v2 ^ SIGN) < (v ^ SIGN)).to(torch.int64)
            x[..., j] = torch.where(run, v2 | (v & ~tb), v)
        carry = torch.where(run, cy, 0)
    out = torch.zeros((r, n), dtype=torch.int32, device=dev)
    out[:, :n_queries] = _popcount64(~x.view(r, n_queries, -1)).to(
        torch.int32)
    return out


def lcs_refmask(refs, queries, n_queries=None, out_dtype=torch.int32,
                out=None, cur=None, flags=None):
    """LCS of each reference row `refs` ([R, Lr] int32, pad symbols >= 20
    are no-ops) against the query rows `queries` ([N, Lq] int32) in
    FAMSA's layout (see lcs_refmask_plain).  Returns [R, N] of out_dtype
    (int32, or uint16 when Lr < 65536); only the first n_queries columns
    are computed.  out: write into this [R, N] tensor instead.  cur, flags
    (a Prim round, R = 1): the round's reference id ([1] int64) and the
    per-sequence flags ([M] bool, famsa_flags) on the same device; out
    (the round's LCS row) is then overwritten only when flags[cur].  The
    flags are indexed by cur alone, so a shard of a sharded round
    (parallel/mesh.py) passes all M flags and a global cur with its own
    N queries.

    CUDA tensors launch kernel K9, a word wavefront over FAMSA's layout
    (lcs_refmask_wave_plain emulates its order; in a Prim round it reads
    cur and flags on the card, so nothing waits for the device); CPU
    tensors run lcs_refmask_plain.  References of more than
    64 * REFMASK_SEG_MAX_W positions raise on every device."""
    if refs.dim() != 2 or queries.dim() != 2:
        raise ValueError("refs must be [R, Lr] and queries [N, Lq]")
    if refs.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError("refs and queries must be int32")
    r, lr = refs.shape
    n = queries.shape[0]
    nq = n if n_queries is None else int(min(n, n_queries))
    if out is None:
        if out_dtype not in (torch.int32, torch.uint16):
            raise TypeError("out_dtype must be int32 or uint16")
        out = torch.empty((r, n), dtype=out_dtype, device=refs.device)
    elif out.shape != (r, n) or out.dtype not in (torch.int32, torch.uint16):
        raise ValueError("out must be [R, N] int32 or uint16")
    if out.dtype == torch.uint16 and lr >= 65536:
        raise ValueError("uint16 LCS output needs Lr < 65536")
    if -(-lr // 64) > REFMASK_SEG_MAX_W:
        raise ValueError(f"K9 takes references up to {64 * REFMASK_SEG_MAX_W}"
                         f" positions, not {lr}")
    if (cur is None) != (flags is None):
        raise ValueError("cur and flags come together")
    if cur is not None and (r != 1 or cur.shape != (1,)
                            or cur.dtype != torch.int64
                            or flags.dim() != 1
                            or flags.dtype != torch.bool):
        raise ValueError("a Prim round takes R = 1, cur [1] int64 and "
                         "flags [M] bool")
    tensors = [refs, queries, out] + ([cur, flags] if cur is not None else [])
    if any(t.device != refs.device for t in tensors):
        raise ValueError("every tensor must be on one device")
    if refs.device.type == "cpu":
        if cur is None or bool(flags[int(cur[0])]):
            out[:, :nq] = lcs_refmask_plain(refs, queries, nq)[:, :nq].to(
                out.dtype)
        return out
    if refs.device.type != "cuda":
        raise ValueError(f"unsupported device {refs.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous")
    if r == 0 or nq == 0:
        return out
    lib = kernels.get("lcs")
    words = refmask_scratch_words(r, lr)
    scratch = (torch.empty(words, dtype=torch.int64, device=refs.device)
               if words else None)
    stream = torch.cuda.current_stream(refs.device).cuda_stream
    kernels.LAUNCHES["lcs_refmask"] += 1
    err = lib.lcs_refmask(refs.data_ptr(), queries.data_ptr(), r, lr, n,
                          queries.shape[1], nq, out.data_ptr(),
                          int(out.dtype == torch.uint16),
                          None if cur is None else cur.data_ptr(),
                          None if flags is None else flags.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          stream)
    kernels.check(err, "lcs_refmask")
    return out


# K1 rows' P-by-W template (csrc/lcs.cu:refs_in_flight): a thread
# carries ROWS_P_NARROW references' states at once up to
# ROWS_P_NARROW_MAX_W words, ROWS_P_WIDE past it; a CTA of ROWS_WARPS
# warps takes 32 queries and ROWS_WARPS x P references, its masks staged
# in shared memory up to ROWS_STAGED_MAX_W words
ROWS_WARPS = 8
ROWS_P_NARROW, ROWS_P_NARROW_MAX_W, ROWS_P_WIDE = 4, 16, 2
ROWS_STAGED_MAX_W = 64
ROWS_CAPS = (2, 4, 8, 16, 32, 64, 2048)     # the W template's caps
ROWS_MAX_W = ROWS_CAPS[-1]


def rows_geometry(w):
    """(template cap, references a thread carries, references a CTA,
    masks staged) of K1's rows variant for W words a query (W <=
    ROWS_MAX_W; lcs_variant sends wider queries to the wave variant)."""
    if not 1 <= w <= ROWS_MAX_W:
        raise ValueError(f"K1 rows takes 1 to {ROWS_MAX_W} words, not {w}")
    cap = next(c for c in ROWS_CAPS if w <= c)
    p = ROWS_P_NARROW if cap <= ROWS_P_NARROW_MAX_W else ROWS_P_WIDE
    return cap, p, ROWS_WARPS * p, cap <= ROWS_STAGED_MAX_W


# K1 wave (csrc/lcs.cu): at most WAVE_WPL_MAX words a lane; a segment of
# one warp to ROWS_MAX_W words, past it a segment across the warps of a
# CTA (lcs_wave_seg_kernel) of up to SEG_MAX_LANES lanes, so up to
# WAVE_MAX_W words (2,097,152 positions); K9's segments across warps to
# REFMASK_SEG_MAX_W 64-bit words.  Such a CTA stages SEG_TILE steps of
# symbols a window, and its masks too while everything fits SEG_SMEM_MAX
# bytes of shared memory (seg_geometry)
WAVE_WPL_MAX = 64
SEG_TILE = 256
SEG_MAX_LANES = 1024
WAVE_MAX_W = SEG_MAX_LANES * WAVE_WPL_MAX
REFMASK_SEG_MAX_W = SEG_MAX_LANES * REFMASK_WPL_MAX
SEG_SMEM_MAX = 232448
SEG_CTRL = 4 * (SEG_MAX_LANES // 32) + 2     # control words of a CTA


def wave_geometry(w, wpl_max=None):
    """(wseg, wpl, nl) of K1's wave variant for W words a query (K9's with
    wpl_max REFMASK_WPL_MAX; default WAVE_WPL_MAX): wseg lanes a query,
    the least power of two >= min(W, 32) whose wseg * wpl_max words hold
    W; wpl consecutive words a lane; nl lanes that hold words
    (csrc/lcs.cu:wave_geometry and, past 32 lanes, seg_geometry)."""
    wpl_max = WAVE_WPL_MAX if wpl_max is None else wpl_max
    wseg = 1
    while wseg < min(w, 32) or wseg * wpl_max < w:
        wseg <<= 1
    wpl = -(-w // wseg)
    return wseg, wpl, -(-w // wpl)


def seg_geometry(w, kernel="wave"):
    """(wseg, wpl, nl, staged, smem) of a segment across warps
    (csrc/lcs.cu:seg_geometry): K1 wave's ("wave", 32-bit words, 20 mask
    rows) or K9's ("refmask", 64-bit words, 21 rows) for a query or
    reference of W words, past one warp's; staged: the masks in shared
    memory; smem: the CTA's dynamic shared memory in bytes."""
    wpl_max, nbytes, rows = ((WAVE_WPL_MAX, 4, NO_VALID_AMINOACIDS)
                             if kernel == "wave" else
                             (REFMASK_WPL_MAX, 8, NO_VALID_AMINOACIDS + 1))
    wseg, wpl, nl = wave_geometry(w, wpl_max)
    if wseg <= 32:
        raise ValueError(f"W {w} fits a segment of one warp")
    common = ((wseg // 32) * SEG_TILE * 4 + SEG_CTRL * 4
              + ((SEG_TILE + wseg + 7) & ~7))
    masks = rows * wpl * wseg * nbytes
    staged = masks + common <= SEG_SMEM_MAX
    return wseg, wpl, nl, staged, common + (masks if staged else 0)


def refmask_scratch_words(r, lr):
    """int64 words of the scratch K9 takes for R references of Lr
    positions: their masks [R, 21, wpl, wseg] where a segment across warps
    cannot stage them in shared memory, else 0."""
    w64 = max(1, -(-lr // 64))
    if w64 <= REFMASK_W_MAX:
        return 0
    wseg, wpl, _, staged, _ = seg_geometry(w64, "refmask")
    return 0 if staged else r * (NO_VALID_AMINOACIDS + 1) * wpl * wseg


def lcs_wave_plain(table, syms, n_queries):
    """Plain PyTorch twin of K1's wave variant, on lcs_plain's arguments
    and with its result: each query a segment of wseg lanes, lane k owning
    words [k*wpl, (k+1)*wpl); at step s lane k processes reference
    position s - k with the carry lane k-1 produced one step earlier (past
    32 lanes, from lane 31 of a warp to lane 0 of the next through shared
    memory, the same order).  Positions outside [0, L), no-op symbols
    (>= 20) and lanes without words leave their words alone and pass a
    carry of 0."""
    r, length = syms.shape
    _, w, n = table.shape
    dev = table.device
    wseg, wpl, nl = wave_geometry(w)
    tab = torch.zeros((NO_SYMBOLS, wseg * wpl, n_queries), dtype=torch.int64,
                      device=dev)
    tab[:, :w] = table[:, :, :n_queries].to(torch.int64) & 0xFFFFFFFF
    tab = tab.view(NO_SYMBOLS, wseg, wpl, n_queries)
    lanes = torch.arange(wseg, device=dev)
    owned = (lanes[:, None] * wpl + torch.arange(wpl, device=dev)) < w
    x = torch.full((r, wseg, wpl, n_queries), 0xFFFFFFFF, dtype=torch.int64,
                   device=dev)
    zero = torch.zeros((r, 1, n_queries), dtype=torch.int64, device=dev)
    carry = torch.zeros((r, wseg, n_queries), dtype=torch.int64, device=dev)
    syms64 = syms.to(torch.int64)
    for s in range(length + nl - 1):
        cy = torch.cat([zero, carry[:, :-1]], dim=1)     # one step late
        pos = s - lanes
        sym = syms64[:, pos.clamp(0, length - 1)]        # [R, wseg]
        live = ((pos >= 0) & (pos < length) & (lanes < nl))[None] \
            & (sym >= 0) & (sym < NO_VALID_AMINOACIDS)
        m = tab[sym.clamp(0, NO_SYMBOLS - 1), lanes[None, :]]   # [R, wseg, wpl, nq]
        for j in range(wpl):
            v = x[:, :, j].clone()
            tb = v & m[:, :, j]
            v2 = v + tb + cy
            upd = (live & owned[None, :, j])[..., None]
            x[:, :, j] = torch.where(upd, (v2 & 0xFFFFFFFF) | (v - tb), v)
            cy = torch.where(upd, v2 >> 32, cy)
        carry = torch.where(live[..., None], cy, 0)
    x = torch.where(owned[None, :, :, None], x, 0xFFFFFFFF)
    return _counts(x, n, n_queries)


# K1's dispatch: the wave variant while R x ceil(n_queries / 128), the
# rows variant's grid counted per reference, stays below this.  Measured
# on an H100 by scripts/torch_kernel_redesign.py (PERF.md; the rows
# variant with P chains a thread): the wave variant won up to 316 (4
# references x 10,000 queries; 16 x 2000, 32 x 1000), the rows variant
# from 512 (64 x 1000, 32 x 2000; 8 x 10,000 at 632).  A Prim round asks
# for the wave variant itself (ops/prim_torch.py:prim_chunk).
WAVE_MAX_GRID = 512
WAVE_MAX_ROWS = 65535            # references of one wave launch
PLAIN = {"rows": lcs_plain, "wave": lcs_wave_plain}


def lcs_variant(r, n_queries, w=1):
    """"wave" or "rows": the K1 variant lcs_rows launches for R references
    against n_queries queries of W words (past ROWS_MAX_W only the wave
    variant takes them)."""
    if w > ROWS_MAX_W:
        return "wave"
    return "wave" if r * -(-n_queries // 128) < WAVE_MAX_GRID else "rows"


def lcs_rows(table, syms, n_queries=None, out_dtype=torch.int32,
             variant=None):
    """LCS of each of the R symbol rows `syms` ([R, L] int32, pad symbols
    >= 20 are no-ops) against the queries of `table` ([32, W, N] int32,
    see build_query_mask_table).  Returns [R, N] of out_dtype (int32, or
    uint16 when L < 65536).  Only the first n_queries columns are computed
    (the triangular-sweep half-work saving); later columns are garbage.
    variant: "rows" or "wave" (default: lcs_variant's choice); rows takes
    W <= ROWS_MAX_W words, wave W <= WAVE_MAX_W, and past them this raises
    on every device.

    CUDA tensors launch that variant of kernel K1 (the wave variant in
    launches of at most 65535 references, one a grid row); CPU tensors
    run its plain twin (lcs_plain or lcs_wave_plain)."""
    if table.dim() != 3 or table.shape[0] != NO_SYMBOLS:
        raise ValueError("table must be [32, W, N]")
    if syms.dim() != 2:
        raise ValueError("syms must be [R, L]")
    if table.dtype != torch.int32 or syms.dtype != torch.int32:
        raise TypeError("table and syms must be int32")
    if table.device != syms.device:
        raise ValueError("table and syms must be on one device")
    _, w, n = table.shape
    r, length = syms.shape
    nq = n if n_queries is None else int(min(n, n_queries))
    if out_dtype not in (torch.int32, torch.uint16):
        raise TypeError("out_dtype must be int32 or uint16")
    if out_dtype == torch.uint16 and length >= 65536:
        raise ValueError("uint16 LCS output needs L < 65536")
    variant = variant or lcs_variant(r, nq, w)
    if variant not in PLAIN:
        raise ValueError(f"unknown K1 variant {variant!r}")
    if w > (WAVE_MAX_W if variant == "wave" else ROWS_MAX_W):
        raise ValueError(f"K1 {variant} takes up to "
                         f"{WAVE_MAX_W if variant == 'wave' else ROWS_MAX_W}"
                         f" words a query, not {w}")
    if table.device.type == "cpu":
        return PLAIN[variant](table, syms, nq).to(out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if not (table.is_contiguous() and syms.is_contiguous()):
        raise ValueError("table and syms must be contiguous")
    out = torch.empty((r, n), dtype=out_dtype, device=table.device)
    if r == 0 or nq == 0:
        return out
    lib = kernels.get("lcs")
    fn, key = ((lib.lcs_wave, "lcs_wave") if variant == "wave"
               else (lib.lcs_bitpar, "lcs"))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    step = WAVE_MAX_ROWS if variant == "wave" else r
    for r0 in range(0, r, step):
        rows = min(step, r - r0)
        kernels.LAUNCHES[key] += 1
        err = fn(table.data_ptr(), syms[r0].data_ptr(), rows, length, w, n,
                 nq, out[r0].data_ptr(), int(out_dtype == torch.uint16),
                 stream)
        kernels.check(err, key)
    return out


def pad_sequences(sequences, align=1):
    """[N, L] int8 symbols of `sequences` padded with the no-op symbol to a
    common length L (rounded up to a multiple of `align`)."""
    n = len(sequences)
    lmax = max(s.data_size for s in sequences)
    lmax = max(align, ((lmax + align - 1) // align) * align)
    padded = np.full((n, lmax), PAD_SYMBOL, dtype=np.int8)
    for k, s in enumerate(sequences):
        padded[k, :len(s.data)] = s.data
    return padded


class TorchDistanceBackend:
    """Device distance backend (the counterpart of the JAX package's
    PallasDistanceBackend): LCS row blocks per launch on `device`, exact
    float64/float32 distance transforms on the host.  mesh (a
    parallel/mesh.py Mesh; ShardedDistanceBackend): each shard holds the
    query columns Mesh.bounds gives it and computes its columns of every
    block on its own stream; without one, one part holds every column on
    `device`'s current stream."""

    def __init__(self, sequences, measure, dtype, device="cuda",
                 block_rows=256, mesh=None):
        from ..parallel.mesh import Shard
        from .distance import transform_distances
        self._transform = transform_distances
        self.sequences = sequences
        self.measure = measure
        self.dtype = dtype
        self.device = torch.device(device)
        self.block_rows = block_rows
        n = len(sequences)
        self.n = n
        self._cache_base = -1
        self._cache = None
        self._cache_cols = 0
        if n:
            self.padded = pad_sequences(sequences)
            self.lengths = np.array([s.length for s in sequences],
                                    dtype=np.int64)
            self.flags = famsa_flags(self.padded)
            parts = ([(Shard(self.device, stream=False), (0, n))]
                     if mesh is None else zip(mesh.shards, mesh.bounds(n)))
            self.parts = [self._part(shard, s0, s1)
                          for shard, (s0, s1) in parts]

    def _part(self, shard, s0, s1):
        """(shard, s0, s1, table, queries): what _lcs_block reads of the
        query columns [s0, s1) on the shard's device, their query mask
        table and, for a family with a flagged sequence (K9), their padded
        rows."""
        rows = self.padded[s0:s1]
        with shard.use():
            table = torch.from_numpy(build_query_mask_table(rows).view(
                np.int32)).to(shard.device)
            queries = (torch.from_numpy(rows.astype(np.int32)).to(
                shard.device) if self.flags.any() else None)
        return shard, s0, s1, table, queries

    def _lcs_block(self, ref_ids, n_queries=None):
        """[R, N] int64 LCS rows of the references ref_ids, each in the
        host reference's role (ops/distance.py:DistanceBackend.row): K1 for
        unflagged references, K9 for flagged ones, on every part; only the
        first n_queries columns are computed (the rest are 0), and a part
        whose columns all lie past them is idle.  Every part's launches and
        copies are issued before the host waits for any of them."""
        ref_ids = np.asarray(ref_ids, dtype=np.int64)
        nq = self.n if n_queries is None else min(self.n, int(n_queries))
        dt = torch.uint16 if self.padded.shape[1] < 65536 else torch.int32
        fl = self.flags[ref_ids]
        out = np.zeros((len(ref_ids), self.n), dtype=np.int64)
        pending = []
        for shard, s0, s1, table, queries in self.parts:
            cols = min(max(nq - s0, 0), s1 - s0)
            if cols == 0:
                continue
            with shard.use():
                for sel, flagged in ((~fl, False), (fl, True)):
                    if not sel.any():
                        continue
                    syms = torch.from_numpy(self.padded[ref_ids[sel]].astype(
                        np.int32)).to(shard.device)
                    got = (lcs_refmask(syms, queries, n_queries=cols,
                                       out_dtype=dt) if flagged
                           else lcs_rows(table, syms, n_queries=cols,
                                         out_dtype=dt))
                    host = torch.empty(got.shape, dtype=dt, pin_memory=(
                        shard.device.type == "cuda"))
                    host.copy_(got, non_blocking=True)
                    pending.append((sel, s0, cols, host, shard.record()))
        for sel, s0, cols, host, done in pending:
            if done is not None:
                done.synchronize()
            out[sel, s0:s0 + cols] = host[:, :cols].numpy()
        return out

    def _lcs_all(self, ref_idx, need_cols=None):
        need = self.n if need_cols is None else need_cols
        if self._cache is not None and \
                self._cache_base <= ref_idx < self._cache_base + len(self._cache) \
                and self._cache_cols >= need:
            return self._cache[ref_idx - self._cache_base]
        sequential = self._cache is None or \
            ref_idx == self._cache_base + len(self._cache)
        if sequential:
            # forward sweep: prefetch a whole row block.  A prefix sweep
            # (row_prefix: row i reads cols < i) needs only cols < base +
            # block_rows, so later query blocks are skipped.
            ids = np.arange(ref_idx, min(ref_idx + self.block_rows, self.n))
            # the prefetched block must cover the CALLER's need too: row()
            # passes need_cols = max(query_ids)+1 for arbitrary query sets
            # (Prim queries all remaining ids from the first node), which
            # can exceed ref_idx + block_rows - truncating there would
            # return uninitialized columns from skipped query blocks
            ncq = self.n if need_cols is None \
                else min(self.n, max(need, ref_idx + self.block_rows))
            self._cache = self._lcs_block(ids, n_queries=ncq)
            self._cache_base = ref_idx
            self._cache_cols = ncq
            return self._cache[0]
        # random access: one row
        return self._lcs_block(np.array([ref_idx]))[0]

    def row(self, ref_idx, query_ids=None):
        if query_ids is None:
            lcs = self._lcs_all(ref_idx)
        else:
            need = int(np.max(query_ids)) + 1 if len(query_ids) else 0
            lcs = self._lcs_all(ref_idx, need_cols=need)
        ref_len = int(self.sequences[ref_idx].length)
        if query_ids is None:
            return self._transform(self.measure, lcs, ref_len, self.lengths,
                                   self.dtype)
        return self._transform(self.measure, lcs[query_ids], ref_len,
                               self.lengths[query_ids], self.dtype)

    def row_prefix(self, ref_idx, count):
        if count == 0:
            return np.zeros(0, dtype=self.dtype)
        return self.row(ref_idx, np.arange(count))

    def rows_batch(self, ref_ids, query_ids=None):
        """[R, N] (or [R, len(query_ids)]) distance rows in block_rows-row
        launches."""
        ref_ids = np.asarray(ref_ids, dtype=np.int64)
        ncol = self.n if query_ids is None else len(query_ids)
        out = np.empty((len(ref_ids), ncol), dtype=self.dtype)
        ql = self.lengths if query_ids is None else self.lengths[query_ids]
        for k0 in range(0, len(ref_ids), self.block_rows):
            ids = ref_ids[k0:k0 + self.block_rows]
            lcs = self._lcs_block(ids)
            for j, rid in enumerate(ids):
                lj = lcs[j] if query_ids is None else lcs[j][query_ids]
                out[k0 + j] = self._transform(
                    self.measure, lj, int(self.sequences[rid].length), ql,
                    self.dtype)
        return out
