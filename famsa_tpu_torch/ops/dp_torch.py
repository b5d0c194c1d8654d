"""Batched profile-profile DP on torch: host prep, the plain PyTorch
version, the wrapper of the CUDA kernel K2 (csrc/dp.cu) and the batched
entry point used by the pipeline and the aligner.

One recurrence covers the profile-profile and sequence-profile DP of the
reference (FAMSA src/core/profile_seq.cpp:165-892): for a
single-sequence profile1 the gap-correction factors reduce exactly to the
sequence-profile constants.  The arithmetic is that of the JAX package's
ops/dp_jax.py:_dp_kernel (exact int64 with two's-complement wrap), with
the guided band of ops/dp_pallas.py: cells outside [lo, hi] of their row
read -inf (column 0 keeps its boundary V).  Out-of-band direction bytes
therefore differ from the host DP's (which leaves them 0); the traceback
never reads them, so paths and totals are equal.

Output: the packed direction bytes D | H << 2 | V << 4 in the native
(w1+1) x (w2+1) uint8 layout (core/dp_native.py) plus the last-column
(D, H, V) of the last row; core/dp_native.finish_path turns them into the
path and total that construct_profile_fast consumes.
"""

import numpy as np
import torch

from .. import kernels
from ..core.defs import (GAP_EXT, GAP_OPEN, GAP_TERM_EXT, GAP_TERM_OPEN,
                         INFTY, NO_AMINOACIDS, NO_AMINOACIDS_AND_GAPS)
from ..core.dp import _gap_corrections, _gaps_change

NEG = -int(INFTY)
IMIN = -(1 << 63)
ROW0_PACK = 1 | (1 << 2) | (1 << 4)       # H, H, H
COL0_PACK = 2 | (2 << 2) | (2 << 4)       # V, V, V

# column-factor planes, colf [B, NCOLF, ldc]; must match csrc/dp_common.cuh
C_S2 = 0                                   # 30 planes: scores2[j, s]
(C_P2O, C_P2E, C_P2TO, C_P2TE, C_G2CHG,
 C_G2SO, C_G2SE, C_G2STO, C_G2STE, C_G2CE, C_G2CTE,
 C_CUME, C_CUMT, C_H0) = range(30, 44)
NCOLF = 44
# row-factor planes, rowf [B, ldr, NROWF]; must match csrc/dp_common.cuh
R_NNZ, R_CNT, R_SYM = 0, 1, 31             # compacted nonzero counts
(R_NNG, R_N1C, R_N1TC, R_S1GO, R_S1GE, R_S1GTO, R_S1GTE,
 R_G1SO, R_G1SE, R_G1STO, R_G1STE, R_G1CE, R_G1CTE,
 R_V0COST, R_LO, R_HI) = range(61, 77)
NROWF = 77

MAX_THREADS = 512
MAX_STRIPE = 256
MAX_W2 = MAX_THREADS * MAX_STRIPE - 1      # widest profile2 K2 takes


def _corrections(profile):
    """The six gap-correction count arrays [6, w+1] of a profile
    (DP_SolveGapsProblemWhenStarting/Continuing, profile.cpp:1223-1315)."""
    gc = _gap_corrections(profile)
    return np.stack([gc[k] for k in ("st_open", "st_ext", "st_to", "st_te",
                                     "ct_ext", "ct_te")])


def prepare_merge(params, profile1, profile2, band=None):
    """Host prep of one merge (the numpy counterpart of dp_jax.py
    _prepare_inputs): (colf [NCOLF, w2+1], rowf [w1+1, NROWF]) int64.
    band: optional [>= w1+1, 2] (lo, hi) rows indexed by DP row
    (core/dp_native.row_ranges)."""
    w1, w2 = profile1.width, profile2.width
    card1, card2 = len(profile1.data), len(profile2.data)
    c1 = np.asarray(profile1.counters, dtype=np.int64)
    s1 = np.asarray(profile1.scores, dtype=np.int64)
    s2 = np.asarray(profile2.scores, dtype=np.int64)

    colf = np.empty((NCOLF, w2 + 1), dtype=np.int64)
    colf[C_S2:C_S2 + NO_AMINOACIDS_AND_GAPS] = s2[:, :NO_AMINOACIDS_AND_GAPS].T
    colf[C_P2O] = s2[:, GAP_OPEN]
    colf[C_P2E] = s2[:, GAP_EXT]
    colf[C_P2TO] = s2[:, GAP_TERM_OPEN]
    colf[C_P2TE] = s2[:, GAP_TERM_EXT]
    colf[C_G2CHG] = _gaps_change(profile2, params)
    colf[C_G2SO:C_G2CTE + 1] = _corrections(profile2)
    with np.errstate(over="ignore"):
        colf[C_CUME] = np.concatenate([[0], np.cumsum(s2[1:, GAP_EXT])])
        colf[C_CUMT] = np.concatenate([[0], np.cumsum(s2[1:, GAP_TERM_EXT])])
        # row 0 boundary (profile_seq.cpp:555-579)
        jj = np.arange(w2 + 1)
        h0 = np.where(jj == 1, s2[1 if w2 >= 1 else 0, GAP_TERM_OPEN] * card1,
                      s2[:, GAP_TERM_EXT] * card1)
        h0 = np.concatenate([[0], np.cumsum(h0[1:])])
    colf[C_H0] = np.where((jj == 0) | (jj == w2), NEG, h0)

    rowf = np.zeros((w1 + 1, NROWF), dtype=np.int64)
    cs = c1[:, :NO_AMINOACIDS_AND_GAPS]
    order = np.argsort(cs == 0, axis=1, kind="stable")  # nonzeros first
    rowf[:, R_NNZ] = np.count_nonzero(cs, axis=1)
    rowf[:, R_CNT:R_CNT + 30] = np.take_along_axis(cs, order, axis=1)
    rowf[:, R_SYM:R_SYM + 30] = order
    rowf[:, R_NNG] = c1[:, :NO_AMINOACIDS].sum(axis=1)
    rowf[:, R_N1C] = c1[:, GAP_OPEN]
    rowf[:, R_N1TC] = c1[:, GAP_TERM_OPEN]
    rowf[:, R_S1GO] = s1[:, GAP_OPEN]
    rowf[:, R_S1GE] = s1[:, GAP_EXT]
    rowf[:, R_S1GTO] = s1[:, GAP_TERM_OPEN]
    rowf[:, R_S1GTE] = s1[:, GAP_TERM_EXT]
    rowf[:, R_G1SO:R_G1CTE + 1] = _corrections(profile1).T
    ii = np.arange(w1 + 1)
    rowf[:, R_V0COST] = np.where(ii == 1, s1[:, GAP_TERM_OPEN] * card2,
                                 s1[:, GAP_TERM_EXT] * card2)
    if band is None:
        rowf[:, R_LO] = 0
        rowf[:, R_HI] = w2
    else:
        rowf[:, R_LO] = band[:w1 + 1, 0]
        rowf[:, R_HI] = band[:w1 + 1, 1]
    return colf, rowf


def pack_batch(merges):
    """Stack prepared merges into padded batch arrays.

    merges: list of (colf, rowf).  Returns (colf [B, NCOLF, ldc],
    rowf [B, ldr, NROWF], meta [B, 4] (w1, w2, dirs byte offset, 0),
    total dirs bytes).  ldc is rounded up to even, so that every plane
    starts 16-byte aligned (K3's bulk copies)."""
    b = len(merges)
    w2s = [c.shape[1] - 1 for c, _ in merges]
    w1s = [r.shape[0] - 1 for _, r in merges]
    ldc = -(-(max(w2s) + 1) // 2) * 2
    ldr = max(w1s) + 1
    colf = np.zeros((b, NCOLF, ldc), dtype=np.int64)
    rowf = np.zeros((b, ldr, NROWF), dtype=np.int64)
    meta = np.zeros((b, 4), dtype=np.int64)
    off = 0
    for k, (c, r) in enumerate(merges):
        colf[k, :, :c.shape[1]] = c
        rowf[k, :r.shape[0]] = r
        meta[k] = (w1s[k], w2s[k], off, 0)
        off += (w1s[k] + 1) * (w2s[k] + 1)
    return colf, rowf, meta, off


def _shift(x, fill):
    """Column j <- column j-1; column 0 <- fill."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def dp_plain(colf, rowf, meta, total):
    """Plain PyTorch version of K2 on the same packed inputs: the
    row-serial recurrence of ops/dp_jax.py:_dp_kernel with the band.
    Returns (dirs [total] uint8, fin [B, ldr-1, 3] int64: the last-column
    D, H, V of every row)."""
    dev = colf.device
    b, _, ldc = colf.shape
    ldr = rowf.shape[1]
    meta_h = meta.cpu().numpy()
    w1s, w2s = meta_h[:, 0], meta_h[:, 1]
    jj = torch.arange(ldc, device=dev)[None, :]
    w2t = torch.from_numpy(w2s).to(dev)[:, None]
    valid = jj <= w2t
    neg = torch.full((b, ldc), NEG, dtype=torch.int64, device=dev)
    imin = torch.full((b, ldc), IMIN, dtype=torch.int64, device=dev)

    def cp(p):
        return colf[:, p]

    s2 = colf[:, C_S2:C_S2 + 30]                            # [B, 30, ldc]
    p2o, p2e, p2to, p2te = cp(C_P2O), cp(C_P2E), cp(C_P2TO), cp(C_P2TE)
    dE, dT = p2e - p2o, p2te - p2to
    g2chg = cp(C_G2CHG)
    g2so, g2se, g2sto, g2ste = cp(C_G2SO), cp(C_G2SE), cp(C_G2STO), cp(C_G2STE)
    g2ce, g2cte = cp(C_G2CE), cp(C_G2CTE)
    cumE, cumT = cp(C_CUME), cp(C_CUMT)

    pD = torch.where(jj == 0, 0, neg)
    pH = torch.where(valid, cp(C_H0), neg)
    pV = neg.clone()
    rows = torch.zeros((b, ldr, ldc), dtype=torch.uint8, device=dev)
    rows[:, 0, 1:] = ROW0_PACK
    fin = torch.zeros((b, ldr - 1, 3), dtype=torch.int64, device=dev)
    w2idx = torch.from_numpy(w2s).to(dev)[:, None]

    for i in range(1, ldr):
        r = rowf[:, i]                                       # [B, NROWF]

        def rv(p):
            return r[:, p:p + 1]

        cnt = r[:, R_CNT:R_CNT + 30]
        sym = r[:, R_SYM:R_SYM + 30]
        t = (torch.gather(s2, 1, sym[:, :, None].expand(b, 30, ldc))
             * cnt[:, :, None]).sum(dim=1)
        three = (i > 1) & (jj > 1)
        lo, hi = rv(R_LO), rv(R_HI)
        inb = (jj >= lo) & (jj <= hi)

        # D channel (_choose_D)
        tD = _shift(pD, NEG) + t
        tH = _shift(pH, NEG) + t + (rv(R_N1C) * dE + rv(R_N1TC) * dT)
        tV = _shift(pV, NEG) + t + g2chg * rv(R_NNG)
        pickD = (tD > tH) & (tD > tV)
        pickH = ~pickD & (tH > tV)
        D = torch.where(pickD, tD, torch.where(pickH, tH, tV))
        dD = torch.where(pickD, 0, torch.where(pickH, 1, 2))

        # V channel (_choose_V3)
        gvs = (rv(R_S1GO) * g2so + rv(R_S1GE) * g2se
               + rv(R_S1GTO) * g2sto + rv(R_S1GTE) * g2ste)
        gvc = rv(R_S1GE) * g2ce + rv(R_S1GTE) * g2cte
        tD = pD + gvs
        tH = pH + gvs
        tV = pV + gvc
        pD3 = (tD > tH) & (tD > tV)
        pH3 = ~pD3 & (tH > tV)
        pD2 = tD > tV
        V = torch.where(three, torch.where(pD3, tD, torch.where(pH3, tH, tV)),
                        torch.where(pD2, tD, tV))
        dV = torch.where(three, torch.where(pD3, 0, torch.where(pH3, 1, 2)),
                         torch.where(pD2, 0, 2))

        # column 0 and the band
        von = torch.from_numpy(i < w1s).to(dev)[:, None]
        v0 = torch.where(von, torch.maximum(pD[:, :1], pV[:, :1])
                         + rv(R_V0COST), NEG)
        D = torch.where(inb & valid & (jj > 0), D, neg)
        V = torch.where(jj == 0, v0, torch.where(inb & valid, V, neg))

        # H channel: max-plus prefix scan
        ghs = (p2o * rv(R_G1SO) + p2e * rv(R_G1SE)
               + p2to * rv(R_G1STO) + p2te * rv(R_G1STE))
        ghc = p2e * rv(R_G1CE) + p2te * rv(R_G1CTE)
        mD = _shift(D, NEG) + ghs
        mV = _shift(V, NEG) + ghs
        m = torch.where(three, torch.maximum(mD, mV), mD)
        bc = rv(R_G1CE) * cumE + rv(R_G1CTE) * cumT
        x = torch.where((jj > 0) & valid, m - bc, imin)
        run = torch.cummax(x, dim=1).values
        H = bc + torch.maximum(run, neg)
        H = torch.where(inb & valid & (jj > 0), H, neg)
        tHh = _shift(H, NEG) + ghc
        pD3 = (mD > tHh) & (mD > mV)
        pV3 = ~pD3 & (mV > tHh)
        dH = torch.where(three, torch.where(pD3, 0, torch.where(pV3, 2, 1)),
                         torch.where(mD > tHh, 0, 1))

        packed = (dD | (dH << 2) | (dV << 4)).to(torch.uint8)
        packed[:, 0] = COL0_PACK
        rows[:, i] = packed
        fin[:, i - 1, 0] = D.gather(1, w2idx)[:, 0]
        fin[:, i - 1, 1] = H.gather(1, w2idx)[:, 0]
        fin[:, i - 1, 2] = V.gather(1, w2idx)[:, 0]
        pD, pH, pV = D, H, V

    dirs = torch.empty(total, dtype=torch.uint8, device=dev)
    for k in range(b):
        w1, w2, off = int(w1s[k]), int(w2s[k]), int(meta_h[k, 2])
        dirs[off:off + (w1 + 1) * (w2 + 1)] = \
            rows[k, :w1 + 1, :w2 + 1].reshape(-1)
    return dirs, fin


def launch_geometry(max_w2):
    """(threads, stripe) for K2: the smallest register stripe (1, 2, 4, 8)
    whose 512 threads cover max_w2 + 1 columns, else a local-memory
    stripe; threads rounded up to whole warps."""
    cols = max_w2 + 1
    for s in (1, 2, 4, 8):
        if s * MAX_THREADS >= cols:
            break
    else:
        s = -(-cols // MAX_THREADS)
    if s > MAX_STRIPE:
        raise ValueError(f"profile width {max_w2} exceeds the K2 limit "
                         f"{MAX_W2}")
    threads = -(-cols // s)
    return ((threads + 31) // 32) * 32, s


def dp_dirs(colf, rowf, meta, total):
    """Packed direction bytes and per-row last-column finals of a batch of
    merges (see pack_batch for the inputs).  Returns (dirs [total] uint8,
    fin [B, ldr-1, 3] int64).

    CUDA tensors launch kernel K2; CPU tensors run dp_plain."""
    if colf.dim() != 3 or colf.shape[1] != NCOLF:
        raise ValueError("colf must be [B, NCOLF, ldc]")
    if rowf.dim() != 3 or rowf.shape[2] != NROWF or rowf.shape[0] != colf.shape[0]:
        raise ValueError("rowf must be [B, ldr, NROWF]")
    if meta.shape != (colf.shape[0], 4):
        raise ValueError("meta must be [B, 4]")
    if any(x.dtype != torch.int64 for x in (colf, rowf, meta)):
        raise TypeError("colf, rowf and meta must be int64")
    if not (colf.device == rowf.device == meta.device):
        raise ValueError("inputs must be on one device")
    dev = colf.device
    if dev.type == "cpu":
        return dp_plain(colf, rowf, meta, total)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (colf.is_contiguous() and rowf.is_contiguous()
            and meta.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    b, _, ldc = colf.shape
    ldr = rowf.shape[1]
    threads, stripe = launch_geometry(ldc - 1)
    dirs = torch.empty(total, dtype=torch.uint8, device=dev)
    fin = torch.empty((b, ldr - 1, 3), dtype=torch.int64, device=dev)
    if b == 0:
        return dirs, fin
    lib = kernels.get("dp")
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.LAUNCHES["dp"] += 1
    err = lib.dp_profile_batched(colf.data_ptr(), rowf.data_ptr(),
                                 meta.data_ptr(), b, threads, stripe, ldc,
                                 ldr, ldr - 1, dirs.data_ptr(),
                                 fin.data_ptr(), stream)
    kernels.check(err, "dp_profile_batched")
    return dirs, fin


def dp_profile_torch_batched(params, pairs, bands=None, dirs_fn=None):
    """DP of a batch of merges on params.device (one K2 launch on CUDA).

    pairs: list of (profile1, profile2) with counters/scores computed;
    bands: optional list aligned with pairs of band rows
    (core/dp_native.row_ranges) or None; dirs_fn: the DP on the packed
    batch (default dp_dirs; ops/dp_wide.py passes K3's wrapper).
    Returns a list of (dirs [w1+1, w2+1] uint8 numpy, last (D, H, V))."""
    if bands is None:
        bands = [None] * len(pairs)
    merges = [prepare_merge(params, p1, p2, bd)
              for (p1, p2), bd in zip(pairs, bands)]
    colf, rowf, meta, total = pack_batch(merges)
    dev = torch.device(params.device)
    dirs, fin = (dirs_fn or dp_dirs)(torch.from_numpy(colf).to(dev),
                                     torch.from_numpy(rowf).to(dev),
                                     torch.from_numpy(meta).to(dev), total)
    dirs = dirs.cpu().numpy()
    fin = fin.cpu().numpy()
    out = []
    for k, (w1, w2, off, _) in enumerate(meta):
        d = dirs[off:off + (w1 + 1) * (w2 + 1)].reshape(w1 + 1, w2 + 1)
        out.append((d, tuple(int(v) for v in fin[k, w1 - 1])))
    return out
