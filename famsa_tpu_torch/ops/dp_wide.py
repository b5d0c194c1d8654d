"""Profile DP over column folds: the fold geometry, the wrapper of the
CUDA kernel K3 (one wide merge; csrc/dp_wide.cu: the staged body up to
w2 = 8191 and the stripes body past it), its plain PyTorch version, the
plain version of K2's fold-walking variants (a batch of merges, each
walked over the launch's folds; their wrapper is ops/dp_torch.py:dp_dirs),
the wrapper of K10 (dp_shard: one launch, a cluster that takes the next
ticket of a ShardTable and runs that shard's column slice of a merge
over every row; parallel/dp_sharded.py) with its plain version
dp_shard_plain, and the single-merge entry points: the device-resident
path route of the scheduler and the aligner
(dp_profile_torch_wide_paths_async) and the host-prep route
(dp_profile_torch_wide).

K3 computes what K2 (ops/dp_torch.py) computes for one merge, on the
same packed inputs (prepare_merge / pack_batch, or stage 0 on the device,
with B = 1) and with the same output (native (w1+1) x (w2+1) direction
bytes and the per-row last-column finals), so the traceback K4
(ops/traceback_torch.py) and core/dp_native.finish_path serve both.  It
splits columns 0..w2 into F <= 16 folds of `threads * stripe` columns,
one CTA each, all in one thread-block cluster, run as a staggered
wavefront: at step s fold f computes row block s - f.  Per row, fold f
takes from fold f-1 its last-column D and V and the running max of m - bc
through that column (the seed of its H scan).  dp_wide_plain walks the
same folds, steps and edges, so the decomposition itself is tested on
the CPU against dp_plain.
"""

import collections

import torch

from .. import kernels
from .dp_pack import (C_CUME, C_CUMT, C_G2CE, C_G2CHG, C_G2CTE, C_G2SE,
                      C_G2SO, C_G2STE, C_G2STO, C_H0, C_P2E, C_P2O, C_P2TE,
                      C_P2TO, C_S2, COL0_PACK, IMIN, MAX_THREADS, NCOLF, NEG,
                      NROWF, R_CNT, R_G1CE, R_G1CTE, R_G1SE, R_G1SO, R_G1STE,
                      R_G1STO, R_HI, R_LO, R_N1C, R_N1TC, R_NNG, R_S1GE,
                      R_S1GO, R_S1GTE, R_S1GTO, R_SYM, R_V0COST, ROW0_PACK,
                      host_meta, run_batch)
from .dp_resident import dispatch_paths

# mirrored in csrc/dp_wide.cu (MAX_FOLDS, BLK_MAX, STRIPES_SMEM_MAX,
# NPLANE)
MAX_FOLDS = 16                     # Hopper's non-portable cluster size
PORTABLE_FOLDS = 8                 # the portable one: the folds to w2 4095
BLK_MAX = 32
STRIPES_SMEM_MAX = 232448 - 4096   # the stripes body's dynamic shared memory
NPLANE = C_CUMT + 1                # column planes a DP row reads
# threads of a fold (one CTA) at most: one column each in the staged body
FOLD_THREADS = MAX_THREADS
STRIPES = (2, 4)                   # columns a thread of the stripes body
# widest profile2 K3 takes; core/aligner.py:wide_dp_ok reads it, so it is
# pinned (MAX_FOLDS * FOLD_THREADS * STRIPES[-1] - 1, the stripes body's
# reach, equals it)
MAX_W2 = 32767
# widest profile2 of the staged body: one column a thread on up to
# MAX_FOLDS folds, the score planes in shared memory; wider merges take
# the stripes body
STAGED_MAX_W2 = MAX_FOLDS * FOLD_THREADS - 1
MIN_FOLD_COLS = 256                # narrower folds add wavefront steps, not speed
BLK = 8                            # rows per wavefront step
# K2's spans variant (csrc/dp_wide.cu:dp_profile_batched_spans): the
# stripes body's folds of SPAN_FOLD_COLS columns (512 threads of 4), a
# merge over up to MAX_SPAN clusters of MAX_FOLDS folds, edges between
# clusters through global memory; it takes batches whose widest w2 lies
# past MAX_W2, up to SPANS_MAX_W2
MAX_SPAN = 4
SPAN_FOLD_COLS = FOLD_THREADS * STRIPES[-1]
SPANS_MAX_W2 = MAX_SPAN * MAX_FOLDS * SPAN_FOLD_COLS - 1


def fold_geometry(w2):
    """(folds, threads, stripe) of K3 for a merge of w2 + 1 DP columns,
    each fold one CTA of `threads` threads (whole warps) owning `stripe`
    columns apiece, every fold but the last full.  Up to STAGED_MAX_W2
    one column a thread: at most PORTABLE_FOLDS folds of at least
    MIN_FOLD_COLS columns, and past PORTABLE_FOLDS * FOLD_THREADS columns
    as many folds of FOLD_THREADS as cover them.  Wider: MAX_FOLDS folds
    of the smallest stripe in STRIPES that covers them.  Raises past
    MAX_W2."""
    if w2 > MAX_W2:
        raise ValueError(f"profile width {w2} exceeds the K3 limit {MAX_W2}")
    cols = w2 + 1
    if w2 <= STAGED_MAX_W2:
        folds = max(min(PORTABLE_FOLDS, -(-cols // MIN_FOLD_COLS)),
                    -(-cols // FOLD_THREADS))
        stripe = 1
    else:
        folds = MAX_FOLDS
        per = -(-cols // folds)
        stripe = next((s for s in STRIPES if s * FOLD_THREADS >= per), None)
        if stripe is None:
            raise ValueError(f"profile width {w2} exceeds the K3 limit "
                             f"{MAX_FOLDS * FOLD_THREADS * STRIPES[-1] - 1}")
    per = -(-cols // folds)
    threads = -(-per // stripe)
    threads = -(-threads // 32) * 32
    return -(-cols // (threads * stripe)), threads, stripe


def k3_variant(w2):
    """"staged" (w2 <= STAGED_MAX_W2: one column a thread, the fold's
    score planes in shared memory and its other column factors in
    registers) or "stripes" (2 or 4 columns a thread on MAX_FOLDS folds,
    the 13 non-score planes of the fold's columns in shared memory)."""
    return "staged" if w2 <= STAGED_MAX_W2 else "stripes"


def batch_geometry(w2s):
    """(folds, threads, stripe, merge_folds) of K2's fold-walking launch on
    a batch of merges of widths w2s: the folds of the widest merge
    (fold_geometry), and for each merge the folds that hold one of its
    columns, ceil((w2 + 1) / (threads * stripe))."""
    folds, threads, stripe = fold_geometry(max(w2s))
    fw = threads * stripe
    return folds, threads, stripe, [-(-(w2 + 1) // fw) for w2 in w2s]


def staged_geometry(w2s):
    """(folds, fold_cols, merge_folds) of K2's staged launch on a batch of
    merges of widths w2s (batch_geometry, one column a thread).  Raises
    past STAGED_MAX_W2."""
    widest = max(w2s)
    if widest > STAGED_MAX_W2:
        raise ValueError(f"K2 staged takes batches of w2 <= {STAGED_MAX_W2}, "
                         f"not {widest}")
    folds, threads, _, merge_folds = batch_geometry(w2s)
    return folds, threads, merge_folds


def stripes_geometry(w2s):
    """batch_geometry of K2's stripes launch: raises unless the widest w2
    lies past STAGED_MAX_W2 (and within MAX_W2)."""
    widest = max(w2s)
    if not STAGED_MAX_W2 < widest <= MAX_W2:
        raise ValueError(f"K2 stripes takes batches of {STAGED_MAX_W2} < w2 "
                         f"<= {MAX_W2}, not {widest}")
    return batch_geometry(w2s)


def spans_geometry(w2s):
    """(span, merge_spans) of K2's spans launch on a batch of merges of
    widths w2s: clusters a merge at most (the grid holds span clusters a
    merge) and each merge's clusters, ceil(ceil((w2 + 1) / SPAN_FOLD_COLS)
    / MAX_FOLDS).  Raises unless the widest w2 lies past MAX_W2 (and
    within SPANS_MAX_W2)."""
    widest = max(w2s)
    if not MAX_W2 < widest <= SPANS_MAX_W2:
        raise ValueError(f"K2 spans takes batches of {MAX_W2} < w2 <= "
                         f"{SPANS_MAX_W2}, not {widest}")
    folds = [-(-(w2 + 1) // SPAN_FOLD_COLS) for w2 in w2s]
    spans = [-(-f // MAX_FOLDS) for f in folds]
    return max(spans), spans


def _check_inputs(colf, rowf, meta):
    if colf.dim() != 3 or colf.shape[:2] != (1, NCOLF):
        raise ValueError("colf must be [1, NCOLF, ldc]")
    if rowf.dim() != 3 or rowf.shape[0] != 1 or rowf.shape[2] != NROWF:
        raise ValueError("rowf must be [1, ldr, NROWF]")
    if meta.shape != (1, 4):
        raise ValueError("meta must be [1, 4]")
    if any(x.dtype != torch.int64 for x in (colf, rowf, meta)):
        raise TypeError("colf, rowf and meta must be int64")
    if not (colf.device == rowf.device == meta.device):
        raise ValueError("inputs must be on one device")


def _cat1(head, x):
    """[head, x[0], ..., x[-2]]: column j <- column j-1 within a fold."""
    return torch.cat([head.reshape(1), x[:-1]])


def _fold_walk(cf, cb, rf, w1, cs, c1, r0, r1, fold_cols, blk, rows, fin,
               span=None, gin=None, gout=None, state=None):
    """The fold wavefront of K3 (and K2's fold-walking variants, and
    K10's slice) in plain PyTorch: the recurrence of dp_plain over the
    columns [cs, c1) of one merge, fold_cols a fold, for the rows [r0,
    r1), blk rows a step, the fold edges passed through a buffer
    double-buffered by step parity as the kernel does.

    cf: the merge's column planes, its column k global column cb + k; rf
    [>= r1, NROWF] its row factors; rows [w1 + 1, c1 - cs] uint8: the
    direction bytes of the columns, written in place (row 0 when r0 is
    1); fin [>= w1, 3]: (D, H, V) of column c1 - 1, written for the rows.
    span: folds a cluster (K2's spans variant): the edge into the first
    fold of a cluster comes through a buffer of every row, as the
    kernel's global edges do.  gin / gout [w1, 3]: such buffers into
    column cs and out of column c1 - 1 (K10's shards; None at column 0
    and at the merge's last column).  state [3, c1 - cs + 1]: the last
    row's D, H, V at columns cs - 1 .. c1 - 1, loaded instead of row 0
    when r0 > 1 and stored at the end (K10's plain version on a block of
    rows; None for every row at once)."""
    dev = cf.device
    folds = -(-(c1 - cs) // fold_cols)
    nrb = -(-(r1 - r0) // blk)
    neg = torch.tensor(NEG, dtype=torch.int64, device=dev)
    imin = torch.tensor(IMIN, dtype=torch.int64, device=dev)

    def bc_at(r, j):
        return r[R_G1CE] * cf[C_CUME, j - cb] + r[R_G1CTE] * cf[C_CUMT, j - cb]

    if r0 == 1:
        rows[0] = ROW0_PACK
        if cs == 0:
            rows[0, 0] = 0
    # per fold: its columns and its row state (previous row, and the
    # previous row at the column left of the fold), from DP row 0 or from
    # the saved state
    fst = []
    for f in range(folds):
        c0, ce = cs + f * fold_cols, min(cs + (f + 1) * fold_cols, c1)
        jj = torch.arange(c0, ce, device=dev)
        if r0 == 1:
            pD = torch.where(jj == 0, 0, neg)
            pH = cf[C_H0, c0 - cb:ce - cb].clone()
            pV = neg.expand(ce - c0).clone()
            halo = (neg, neg, neg)
            if c0 > 0:
                halo = (torch.zeros_like(neg) if c0 == 1 else neg,
                        cf[C_H0, c0 - 1 - cb], neg)
        else:
            pD, pH, pV = state[:, c0 - cs + 1:ce - cs + 1].clone()
            halo = tuple(state[:, c0 - cs].clone())
        fst.append([c0, ce, jj, pD, pH, pV, halo])
    # edge[f][parity, r] = (D, V, run) of fold f-1's last column, row r
    # of the block fold f-1 computed at a step of that parity
    edge = [torch.empty((2, blk, 3), dtype=torch.int64, device=dev)
            for _ in range(folds)]
    # gedge[f][i - 1]: the edge into fold f (first of a cluster) at row i
    gedge = {f: torch.empty((w1, 3), dtype=torch.int64, device=dev)
             for f in range(span or folds, folds, span or folds)}
    if gin is not None:
        gedge[0] = gin
    if gout is not None:
        gedge[folds] = gout

    for s in range(nrb + folds - 1):
        for f in range(folds):
            b = s - f
            if not 0 <= b < nrb:
                continue
            st = fst[f]
            c0, ce, jj = st[:3]
            cfs = cf[:, c0 - cb:ce - cb]
            s2 = cfs[C_S2:C_S2 + 30]
            p2o, p2e, p2to, p2te = (cfs[C_P2O], cfs[C_P2E], cfs[C_P2TO],
                                    cfs[C_P2TE])
            dE, dT = p2e - p2o, p2te - p2to
            for r in range(blk):
                i = r0 + b * blk + r
                if i >= r1:
                    break
                pD, pH, pV, (hD, hH, hV) = st[3], st[4], st[5], st[6]
                if f in gedge:
                    eD, eV, seed = gedge[f][i - 1].clone()
                elif f > 0:
                    eD, eV, seed = edge[f][(s + 1) % 2, r].clone()
                else:
                    eD, eV, seed = neg, neg, imin
                row = rf[i]
                t = (s2[row[R_SYM:R_SYM + 30]]
                     * row[R_CNT:R_CNT + 30, None]).sum(dim=0)
                three = (i > 1) & (jj > 1)
                lo, hi = row[R_LO], row[R_HI]
                inb = (jj >= lo) & (jj <= hi)

                # D channel (_choose_D)
                tD = _cat1(hD, pD) + t
                tH = _cat1(hH, pH) + t + (row[R_N1C] * dE + row[R_N1TC] * dT)
                tV = _cat1(hV, pV) + t + cfs[C_G2CHG] * row[R_NNG]
                pickD = (tD > tH) & (tD > tV)
                pickH = ~pickD & (tH > tV)
                D = torch.where(pickD, tD, torch.where(pickH, tH, tV))
                dD = torch.where(pickD, 0, torch.where(pickH, 1, 2))

                # V channel (_choose_V3)
                gvs = (row[R_S1GO] * cfs[C_G2SO] + row[R_S1GE] * cfs[C_G2SE]
                       + row[R_S1GTO] * cfs[C_G2STO]
                       + row[R_S1GTE] * cfs[C_G2STE])
                gvc = row[R_S1GE] * cfs[C_G2CE] + row[R_S1GTE] * cfs[C_G2CTE]
                tD, tH, tV = pD + gvs, pH + gvs, pV + gvc
                pD3 = (tD > tH) & (tD > tV)
                pH3 = ~pD3 & (tH > tV)
                pD2 = tD > tV
                V = torch.where(three, torch.where(pD3, tD,
                                                   torch.where(pH3, tH, tV)),
                                torch.where(pD2, tD, tV))
                dV = torch.where(three, torch.where(pD3, 0,
                                                    torch.where(pH3, 1, 2)),
                                 torch.where(pD2, 0, 2))

                # column 0 and the band
                v0 = (torch.maximum(pD[0], pV[0]) + row[R_V0COST]
                      if i < w1 else neg)
                D = torch.where(inb & (jj > 0), D, neg)
                V = torch.where(jj == 0, v0, torch.where(inb, V, neg))

                # H channel: max-plus prefix scan seeded from the left
                ghs = (p2o * row[R_G1SO] + p2e * row[R_G1SE]
                       + p2to * row[R_G1STO] + p2te * row[R_G1STE])
                ghc = p2e * row[R_G1CE] + p2te * row[R_G1CTE]
                mD = _cat1(eD, D) + ghs
                mV = _cat1(eV, V) + ghs
                m = torch.where(three, torch.maximum(mD, mV), mD)
                bc = row[R_G1CE] * cfs[C_CUME] + row[R_G1CTE] * cfs[C_CUMT]
                x = torch.where(jj > 0, m - bc, imin)
                run = torch.maximum(torch.cummax(x, dim=0).values, seed)
                H = bc + torch.maximum(run, neg)
                H = torch.where(inb & (jj > 0), H, neg)
                # H left of the fold, from the seed (as K3's thread 0)
                jl = c0 - 1
                Hl = neg
                if jl >= 1:
                    Hl = torch.where((jl >= lo) & (jl <= hi),
                                     bc_at(row, jl) + torch.maximum(seed, neg),
                                     neg)
                tHh = _cat1(Hl, H) + ghc
                pD3 = (mD > tHh) & (mD > mV)
                pV3 = ~pD3 & (mV > tHh)
                dH = torch.where(three, torch.where(pD3, 0,
                                                    torch.where(pV3, 2, 1)),
                                 torch.where(mD > tHh, 0, 1))

                packed = (dD | (dH << 2) | (dV << 4)).to(torch.uint8)
                if c0 == 0:
                    packed[0] = COL0_PACK
                rows[i, c0 - cs:ce - cs] = packed
                if ce == c1:
                    fin[i - 1] = torch.stack([D[-1], H[-1], V[-1]])
                if f + 1 in gedge:
                    gedge[f + 1][i - 1] = torch.stack([D[-1], V[-1],
                                                       run[-1]])
                elif f + 1 < folds:
                    edge[f + 1][s % 2, r] = torch.stack([D[-1], V[-1],
                                                         run[-1]])
                st[3:7] = [D, H, V, (eD, Hl, eV)]

    if state is not None:
        for c0, ce, _, pD, pH, pV, _ in fst:
            state[:, c0 - cs + 1:ce - cs + 1] = torch.stack([pD, pH, pV])
        state[:, 0] = torch.stack(list(fst[0][6]))


def dp_wide_plain(colf, rowf, meta, total, fold_cols=None, blk=BLK,
                  meta_host=None, span=None):
    """Plain PyTorch version of K3 on the same inputs (B = 1): the
    recurrence of dp_plain walked fold by fold in K3's wavefront order
    (_fold_walk), fold_cols columns a fold (default: fold_geometry's),
    blk rows a step.  span: folds a cluster (K2's spans variant,
    MAX_FOLDS): the edge into the first fold of a cluster then comes
    through a buffer of every row, as the kernel's global edges do.
    meta_host: meta as a host array (default: read from meta).  Returns
    (dirs [total] uint8, fin [1, ldr-1, 3] int64: the last-column D, H,
    V of every row)."""
    dev = colf.device
    w1, w2, off = (int(v) for v in host_meta(meta, meta_host)[0, :3])
    cols = w2 + 1
    if fold_cols is None:
        _, threads, stripe = fold_geometry(w2)
        fold_cols = threads * stripe
    rows = torch.empty((w1 + 1, cols), dtype=torch.uint8, device=dev)
    fin = torch.zeros((1, rowf.shape[1] - 1, 3), dtype=torch.int64,
                      device=dev)
    _fold_walk(colf[0], 0, rowf[0], w1, 0, cols, 1, w1 + 1, fold_cols, blk,
               rows, fin[0], span=span)
    dirs = torch.zeros(total, dtype=torch.uint8, device=dev)
    dirs[off:off + (w1 + 1) * cols] = rows.reshape(-1)
    return dirs, fin


def dp_staged_plain(colf, rowf, meta, total, fold_cols=None, blk=BLK,
                    meta_host=None, span=None):
    """Plain PyTorch version of K2's fold-walking variants (staged,
    stripes and, with span = MAX_FOLDS, spans) on a packed batch (see
    ops/dp_pack.py:pack_batch): every merge walked by dp_wide_plain over
    the launch's folds of fold_cols columns (default: batch_geometry's
    threads * stripe; SPAN_FOLD_COLS with span), so merge k crosses
    ceil((w2_k + 1) / fold_cols) of them, blk rows a step, span folds a
    cluster.  meta_host: meta as a host array (default: read from meta).
    Returns (dirs [total] uint8, fin [B, ldr-1, 3] int64: the
    last-column D, H, V of every row)."""
    meta_h = host_meta(meta, meta_host).tolist()
    if fold_cols is None and span is not None:
        fold_cols = SPAN_FOLD_COLS
    elif fold_cols is None:
        _, threads, stripe, _ = batch_geometry([m[1] for m in meta_h])
        fold_cols = threads * stripe
    dirs = torch.zeros(total, dtype=torch.uint8, device=colf.device)
    fin = torch.zeros((colf.shape[0], rowf.shape[1] - 1, 3),
                      dtype=torch.int64, device=colf.device)
    for k, (w1, w2, off, _) in enumerate(meta_h):
        n = (w1 + 1) * (w2 + 1)
        one = [[w1, w2, 0, 0]]
        d, f = dp_wide_plain(colf[k:k + 1], rowf[k:k + 1],
                             torch.tensor(one, device=colf.device), n,
                             fold_cols=fold_cols, blk=blk, meta_host=one,
                             span=span)
        dirs[off:off + n] = d
        fin[k] = f[0]
    return dirs, fin


# K10 (csrc/dp_wide.cu:dp_profile_shard): the columns of a slice's column
# planes before its first column (mirrored in csrc/dp_wide.cu)
SHARD_PAD = 2


def shard_columns(colf, cs, c1, device):
    """The column planes K10 takes for the columns [cs, c1) of a merge
    whose planes are colf [NCOLF, L]: [NCOLF, ldc] int64 on `device`, its
    column k the merge's column cs - SHARD_PAD + k (zero outside the
    merge's L columns), ldc >= c1 - cs + SHARD_PAD + 1 and even, copied
    from colf with one copy on the current stream."""
    ldc = -(-(c1 - cs + SHARD_PAD + 1) // 2) * 2
    out = torch.zeros((NCOLF, ldc), dtype=torch.int64, device=device)
    a, b = max(cs - SHARD_PAD, 0), min(c1 + 1, colf.shape[1])
    base = cs - SHARD_PAD
    out[:, a - base:b - base].copy_(colf[:, a:b], non_blocking=True)
    return out


def _check_shard(colf, rowf, w1, cs, c1, r0, r1, dirs, fin, state, ein,
                 eout):
    n = c1 - cs
    if not (0 <= cs < c1 and 1 <= r0 < r1 <= w1 + 1):
        raise ValueError(f"K10 takes columns 0 <= {cs} < {c1} and rows "
                         f"1 <= {r0} < {r1} <= {w1 + 1}")
    if colf.dim() != 2 or colf.shape[0] != NCOLF \
            or colf.shape[1] < n + SHARD_PAD + 1:
        raise ValueError("colf must be [NCOLF, >= c1 - cs + 3] "
                         "(shard_columns)")
    if rowf.dim() != 2 or rowf.shape[1] != NROWF or rowf.shape[0] < r1:
        raise ValueError("rowf must be [>= r1, NROWF]")
    if dirs.shape != (w1 + 1, n) or dirs.dtype != torch.uint8:
        raise ValueError("dirs must be uint8 [w1 + 1, c1 - cs]")
    if state is None and (r0, r1) != (1, w1 + 1):
        raise ValueError("a block of rows carries its state")
    if state is not None and state.shape != (3, n + 1):
        raise ValueError("state must be [3, c1 - cs + 1]")
    if (ein is None) != (cs == 0):
        raise ValueError("ein is given exactly when cs > 0")
    edges = [e for e in (fin, ein, eout) if e is not None]
    if any(e.shape != (w1, 3) for e in edges):
        raise ValueError("fin, ein and eout must be [w1, 3]")
    ts = [colf, rowf] + ([] if state is None else [state]) + edges
    if any(x.dtype != torch.int64 for x in ts):
        raise TypeError("colf, rowf, fin, state and the edges must be int64")
    if any(x.device != colf.device for x in ts + [dirs]):
        raise ValueError("inputs must be on one device")


def dp_shard_plain(colf, rowf, w1, cs, c1, r0, r1, dirs, fin, state=None,
                   ein=None, eout=None, fold_cols=None, blk=BLK):
    """Plain PyTorch version of K10: one shard's column slice [cs, c1) of
    one merge of w1 rows, given its left edge, for its DP rows [r0, r1)
    (every row, or a block of them with the row state carried between
    blocks), writing in place:
      dirs [w1 + 1, c1 - cs] uint8: the slice's packed direction bytes
        (row 0 when r0 is 1, COL0_PACK at column 0);
      fin [w1, 3] int64: the (D, H, V) of column c1 - 1 of each row (the
        merge's finals on the shard of its last column);
      eout [w1, 3] int64 (None on the last shard): the edge into the next
        shard, (D, V, running max of m - bc) at column c1 - 1;
      state [3, c1 - cs + 1] int64: the row state, the last row's D, H, V
        at columns cs - 1 .. c1 - 1, read when r0 > 1 (None for a slice's
        every row at once).
    colf: shard_columns(...) of the merge's column planes; rowf [>= r1,
    NROWF]: its row factors (with the band); ein [w1, 3]: the previous
    shard's eout (None exactly when cs is 0).  The fold walk of K3
    (_fold_walk) over the slice's columns, fold geometry
    fold_geometry(c1 - cs - 1) (or fold_cols columns a fold; the output
    depends on neither the folds nor the blocks)."""
    _check_shard(colf, rowf, w1, cs, c1, r0, r1, dirs, fin, state, ein,
                 eout)
    if fold_cols is None:
        _, threads, stripe = fold_geometry(c1 - cs - 1)
        fold_cols = threads * stripe
    _fold_walk(colf, cs - SHARD_PAD, rowf, w1, cs, c1, r0, r1, fold_cols,
               blk, dirs, fin, gin=ein, gout=eout, state=state)


# One shard's slice of a merge as K10 takes it (dp_shard_plain's arguments
# for every row): its colf (shard_columns), the merge's rowf, its dirs and
# fin, its edge buffer in (None when cs is 0) and the next shard's (eout,
# None on the last), all on the shard's device but eout, which lies on the
# next shard's
ShardSlice = collections.namedtuple("ShardSlice",
                                    "colf rowf dirs fin ein eout cs c1")
# int64 words of a slice in K10's table (csrc/dp_wide.cu:ShardSlice)
SLICE_WORDS = 12


class ShardTable:
    """K10's table of the slices of one sharded merge that lie on one
    device (csrc/dp_wide.cu:ShardTable), in pipeline order: the counter
    its launches take tickets from, the slices' arguments, and each
    slice's count of edge rows published into it.  Every launch on the
    device runs on the fold geometry of its widest slice.  nexts[k]:
    (table, index) of slice k's consumer (None on the merge's last).  On
    a CUDA device alloc() then upload() put the words on the card, zeroed
    counters included, before the first launch; on the CPU the ticket is
    the Python count `ticket` (dp_shard)."""

    def __init__(self, device, slices, w1):
        self.device = torch.device(device)
        self.slices = list(slices)
        self.w1 = w1
        if not self.slices or w1 < 1:
            raise ValueError("a table holds one or more slices of w1 >= 1 "
                             "rows")
        for sl in self.slices:
            _check_shard(sl.colf, sl.rowf, w1, sl.cs, sl.c1, 1, w1 + 1,
                         sl.dirs, sl.fin, None, sl.ein, None)
            if sl.colf.device != self.device:
                raise ValueError("a table's slices lie on its device")
            if sl.eout is not None and (sl.eout.shape != (w1, 3)
                                        or sl.eout.dtype != torch.int64):
                raise ValueError("eout must be [w1, 3] int64")
        self.geometry = fold_geometry(
            max(sl.c1 - sl.cs for sl in self.slices) - 1)
        self.nexts = [None] * len(self.slices)
        self.prev_peer = [False] * len(self.slices)
        self.ticket = 0
        self.words = self.host = None

    def alloc(self):
        """The table's words on its card (current stream)."""
        n = len(self.slices)
        self.words = torch.empty(2 + (SLICE_WORDS + 1) * n,
                                 dtype=torch.int64, device=self.device)

    def ready(self, k):
        """Device address of slice k's count of edge rows published."""
        return self.words.data_ptr() + 8 * (
            2 + SLICE_WORDS * len(self.slices) + k)

    def upload(self):
        """Fill the words (ticket and counts zero) from pinned host memory
        on the current stream; every table of the merge is alloc()ed."""
        n = len(self.slices)
        host = torch.zeros(self.words.numel(), dtype=torch.int64,
                           pin_memory=True)
        host[1] = n

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        for k, sl in enumerate(self.slices):
            nxt = self.nexts[k]
            peer = int(self.prev_peer[k]) | (
                2 if nxt is not None and nxt[0].device != self.device else 0)
            ldc = sl.colf.shape[1]
            host[2 + SLICE_WORDS * k:2 + SLICE_WORDS * (k + 1)] = torch.tensor(
                [ptr(sl.colf), ptr(sl.rowf), ptr(sl.dirs), ptr(sl.fin),
                 ptr(sl.ein), self.ready(k) if sl.ein is not None else 0,
                 ptr(sl.eout), nxt[0].ready(nxt[1]) if nxt else 0,
                 sl.cs, sl.c1, ldc, peer], dtype=torch.int64)
        self.words.copy_(host, non_blocking=True)
        self.host = host            # alive until the copy is done


def shard_tables(slices, w1):
    """The ShardTables of one sharded merge: `slices` (ShardSlice) in
    pipeline order, grouped by device in the order the devices first
    appear; each slice's consumer linked.  Returns (tables, [the table of
    slice k for each k])."""
    by_dev = {}
    for sl in slices:
        by_dev.setdefault(sl.colf.device, []).append(sl)
    tables = {d: ShardTable(d, sls, w1) for d, sls in by_dev.items()}
    where, counts = [], {}
    for sl in slices:
        d = sl.colf.device
        where.append((tables[d], counts.get(d, 0)))
        counts[d] = counts.get(d, 0) + 1
    for (t, i), (u, j) in zip(where, where[1:]):
        t.nexts[i] = (u, j)
        u.prev_peer[j] = u.device != t.device
    return list(tables.values()), [t for t, _ in where]


def dp_shard(table):
    """One launch of kernel K10 on `table` (a ShardTable): a cluster that
    takes the table's next ticket and runs that slice of the merge over
    its every row, its edge rows in from the previous slice as they are
    published and out to the next as it goes (dp_shard_plain documents
    the outputs).  A sharded merge launches it once a slice, in any order
    and on any stream of the device, once the device's inputs and every
    table of the merge are uploaded.  CUDA tables launch K10; CPU tables
    run dp_shard_plain on the ticket's slice, every row at once."""
    dev = table.device
    if dev.type == "cpu":
        k = table.ticket
        table.ticket += 1
        if k < len(table.slices):
            sl = table.slices[k]
            dp_shard_plain(sl.colf, sl.rowf, table.w1, sl.cs, sl.c1, 1,
                           table.w1 + 1, sl.dirs, sl.fin, ein=sl.ein,
                           eout=sl.eout)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if table.words is None or table.host is None:
        raise ValueError("K10's table is not uploaded")
    for sl in table.slices:
        ts = [x for x in sl[:6] if x is not None]
        if not all(x.is_contiguous() for x in ts) or (
                sl.eout is not None and not sl.eout.is_contiguous()):
            raise ValueError("inputs must be contiguous")
        if sl.colf.shape[1] % 2 or sl.colf.data_ptr() % 16:
            raise ValueError("K10 takes an even ldc and 16-byte aligned "
                             "colf (shard_columns)")
    folds, threads, stripe = table.geometry
    lib = kernels.get("dp_wide")
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.LAUNCHES["dp_shard"] += 1
    err = lib.dp_profile_shard(table.words.data_ptr(), len(table.slices),
                               table.w1, folds, threads, stripe, BLK, stream)
    kernels.check(err, "dp_profile_shard")


def enable_peer(device, peer):
    """Let CUDA `device` read and write `peer`'s memory (K10's edges from
    a slice on one card into the next one's); raises where it cannot."""
    lib = kernels.get("dp_wide")
    kernels.check(lib.dp_enable_peer(torch.device(device).index,
                                     torch.device(peer).index),
                  "dp_enable_peer")


def launch_key(kernel, variant, folds):
    """The kernels.LAUNCHES key of a launch of `folds` folds of K3 (kernel
    "K3") or of K2's fold-walking variants ("K2"): the staged body on a
    portable cluster, on a non-portable one (more than PORTABLE_FOLDS
    folds, key suffix 16), the stripes body, or K2's spans variant."""
    if variant in ("stripes", "spans"):
        return ("dp_wide_stripes" if kernel == "K3"
                else "dp_" + variant)
    key = "dp_wide" if kernel == "K3" else "dp_staged"
    return key if folds <= PORTABLE_FOLDS else key + "16"


def dp_dirs_wide(colf, rowf, meta, total, variant=None, meta_host=None):
    """Packed direction bytes and per-row last-column finals of ONE merge
    (pack_batch of one prepared merge).  Returns (dirs [total] uint8,
    fin [1, ldr-1, 3] int64).  variant: "staged" (w2 <= STAGED_MAX_W2)
    or "stripes" (wider; default: k3_variant(w2)); both walk
    fold_geometry's folds.  meta_host: meta as a host array; w1, w2 and
    the offset are then taken from it, and nothing here waits for the
    device (without it they are read from meta, which does).

    CUDA tensors launch that body of kernel K3 (a cluster the card cannot
    place raises); CPU tensors run dp_wide_plain."""
    _check_inputs(colf, rowf, meta)
    meta_h = host_meta(meta, meta_host)
    w1, w2, off = (int(v) for v in meta_h[0, :3])
    variant = variant or k3_variant(w2)
    if variant not in ("staged", "stripes"):
        raise ValueError(f"unknown K3 variant {variant!r}")
    if variant != k3_variant(w2):
        raise ValueError(f"K3 {variant} does not take w2 = {w2} (staged: "
                         f"w2 <= {STAGED_MAX_W2}, stripes: wider)")
    dev = colf.device
    if dev.type == "cpu":
        return dp_wide_plain(colf, rowf, meta, total, meta_host=meta_h)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (colf.is_contiguous() and rowf.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    ldc, ldr = colf.shape[2], rowf.shape[1]
    if off != 0 or total != (w1 + 1) * (w2 + 1) or ldc < w2 + 1 \
            or ldr < w1 + 1:
        raise ValueError("meta does not match the packed merge")
    if ldc % 2 or colf.data_ptr() % 16:
        raise ValueError("K3 takes an even ldc and 16-byte aligned colf "
                         "(pack_batch)")
    folds, threads, stripe = fold_geometry(w2)
    key = launch_key("K3", variant, folds)
    name = "dp_profile_wide" + ("_stripes" if variant == "stripes" else "")
    dirs = torch.empty(total, dtype=torch.uint8, device=dev)
    fin = torch.empty((1, ldr - 1, 3), dtype=torch.int64, device=dev)
    lib = kernels.get("dp_wide")
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.LAUNCHES[key] += 1
    err = getattr(lib, name)(colf.data_ptr(), rowf.data_ptr(), w1, w2, folds,
                             threads, stripe, ldc, BLK, dirs.data_ptr(),
                             fin.data_ptr(), stream)
    kernels.check(err, name)
    return dirs, fin


def dp_profile_torch_wide(params, p1, p2, band=None):
    """DP of one merge on params.device (one K3 launch on CUDA); band:
    optional band rows (core/dp_native.row_ranges).  Returns (dirs
    [w1+1, w2+1] uint8 numpy, last (D, H, V))."""
    return run_batch(params, [(p1, p2)], [band], dp_dirs_wide)[0]


def dp_profile_torch_wide_paths_async(params, p1, p2, dev1=None, dev2=None,
                                      want_merged=False, band=None):
    """DP and traceback of one merge on params.device (one K3 launch on
    CUDA), dispatched without waiting, as
    ops/dp_torch.py:dp_profile_torch_paths_async with B = 1: dev1, dev2
    its sides' resident counters (MergedRef or None), band its optional
    band rows.  Returns a PendingPaths."""
    return dispatch_paths(params, [(p1, p2)], dp_dirs_wide, [(dev1, dev2)],
                          want_merged, [band])
