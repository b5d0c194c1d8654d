"""The packed inputs of the profile DP kernels K2 (ops/dp_torch.py) and
K3 (ops/dp_wide.py): the plane layout shared with csrc/dp_common.cuh,
the host prep of one merge, the padding of a batch, and the batch runner
that hands a packed batch to one of the kernels' wrappers and unpacks
what it returns.

Both kernel modules import this one and neither imports the other's
runner, so dp_torch.py may import dp_wide.py (K2's staged variant walks
K3's column folds) without an import cycle.
"""

import numpy as np
import torch

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

MAX_THREADS = 512                          # threads of a CTA in K2 and K3


def host_meta(meta, meta_host=None):
    """A batch's meta [B, 4] (w1, w2, dirs byte offset, 0) as a host
    array: meta_host, checked against meta's shape, or else read from
    meta (which waits for its device)."""
    if meta_host is None:
        return meta.cpu().numpy()
    meta_h = np.asarray(meta_host, dtype=np.int64)
    if meta_h.shape != tuple(meta.shape):
        raise ValueError("meta_host does not match meta")
    return meta_h


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
    starts 16-byte aligned (the staged kernel's bulk copies)."""
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


def run_batch(params, pairs, bands, dirs_fn):
    """Prepare and pack the merges `pairs` [(profile1, profile2)] (with
    their optional band rows), run dirs_fn (a kernel wrapper taking
    (colf, rowf, meta, total)) on params.device, and unpack: a list of
    (dirs [w1+1, w2+1] uint8 numpy, last (D, H, V))."""
    merges = [prepare_merge(params, p1, p2, bd)
              for (p1, p2), bd in zip(pairs, bands)]
    colf, rowf, meta, total = pack_batch(merges)
    dev = torch.device(params.device)
    dirs, fin = dirs_fn(torch.from_numpy(colf).to(dev),
                        torch.from_numpy(rowf).to(dev),
                        torch.from_numpy(meta).to(dev), total)
    dirs = dirs.cpu().numpy()
    fin = fin.cpu().numpy()
    out = []
    for k, (w1, w2, off, _) in enumerate(meta):
        d = dirs[off:off + (w1 + 1) * (w2 + 1)].reshape(w1 + 1, w2 + 1)
        out.append((d, tuple(int(v) for v in fin[k, w1 - 1])))
    return out
