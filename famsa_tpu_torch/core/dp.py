"""Affine-gap profile alignment DP + profile construction.

Row-vectorized NumPy implementation of the reference recurrences
(FAMSA src/core/profile_seq.cpp).  Per DP row, the D and V
channels depend only on the previous row and are computed as full-width
vector ops; the H channel's intra-row dependency is resolved with a
max-plus prefix scan (H[j] = B[j] + cummax(m[k]-B[k])), which produces
bit-identical values to the sequential recurrence in exact int64
arithmetic.  Direction choices (incl. the reference's deliberate
asymmetric tie-breaks, e.g. profile_seq.cpp:387,788) are recomputed
elementwise from the stored channel rows.

The same decomposition (per-row cost terms + a max-plus scan) is what the
CUDA profile-DP kernels run per row; see ops/dp_torch.py and csrc/dp_wide.cu.
"""

import numpy as np

from .defs import (GAP, GAP_EXT, GAP_OPEN, GAP_TERM_EXT, GAP_TERM_OPEN,
                   INFTY, NO_AMINOACIDS, NO_AMINOACIDS_AND_GAPS, SCORE_DTYPE)
from .profile import Profile

NEG_INF = -INFTY
D, H, V = 0, 1, 2


# ----------------------------------------------------------------------
def find_row_ranges(column_mapping1, column_mapping2, radius):
    """Guided-alignment band (reference FindRowRanges, profile.cpp:1320-1365).

    column_mapping1/2 are lists; mutated (an extra element is appended),
    like the reference."""
    size = len(column_mapping1)
    width = len(column_mapping2)

    row_ranges = [(0, 0)] * (size + 2)
    for i in range(size + 1):
        row_ranges[i] = (width + 1, 0)

    i1 = 0
    i2 = 0
    i_res_max = max(column_mapping1[-1], column_mapping2[-1])
    column_mapping1.append(i_res_max + 1)
    column_mapping2.append(i_res_max + 1)

    for i_res in range(i_res_max + 1):
        if column_mapping1[i1] == i_res:
            i1 += 1
        if column_mapping2[i2] == i_res:
            i2 += 1

        lo, hi = row_ranges[i1]
        if i2 - radius < 0:
            lo = 0
        else:
            lo = min(lo, i2 - radius)
        if i2 + radius > width:
            hi = width
        else:
            hi = max(hi, i2 + radius)
        row_ranges[i1] = (lo, hi)

        if i1 - radius > 0:
            l2, h2 = row_ranges[i1 - radius]
            row_ranges[i1 - radius] = (l2, max(h2, i2))
        if i1 + radius <= size:
            l2, h2 = row_ranges[i1 + radius]
            row_ranges[i1 + radius] = (min(l2, i2), h2)

    for i in range(max(0, i1 - radius), size + 1):
        row_ranges[i] = (row_ranges[i][0], width)
    for i in range(min(size, radius) + 1):
        row_ranges[i] = (1, row_ranges[i][1])

    return row_ranges


# ----------------------------------------------------------------------
def _gap_corrections(profile: Profile):
    """Per-column DP gap corrections for a profile (the 'second' profile of
    the DP): DP_SolveGapsProblemWhenStarting/Continuing vectorized
    (profile.cpp:1223-1315). Returns dict of [W+1] int64 arrays (index 0
    unused)."""
    w = profile.width
    card = len(profile.data)
    c = profile.counters
    st_open = np.zeros(w + 1, dtype=np.int64)
    st_ext = np.zeros(w + 1, dtype=np.int64)
    st_to = np.zeros(w + 1, dtype=np.int64)
    st_te = np.zeros(w + 1, dtype=np.int64)
    ct_ext = np.zeros(w + 1, dtype=np.int64)
    ct_te = np.zeros(w + 1, dtype=np.int64)

    if w >= 1:
        # internal columns 1..w-1
        j = np.arange(1, w)
        st_to[j] = c[j + 1, GAP_TERM_OPEN]
        st_te[j] = c[j, GAP_TERM_OPEN] + c[j, GAP_TERM_EXT]
        st_ext[j] = c[j, GAP_OPEN] + c[j, GAP_EXT]
        st_open[j] = card - st_ext[j] - st_to[j] - st_te[j]
        ct_te[j] = c[j + 1, GAP_TERM_OPEN] + c[j, GAP_TERM_OPEN] + c[j, GAP_TERM_EXT]
        ct_ext[j] = card - ct_te[j]
        # boundary column w
        cnt = int(c[w, GAP_TERM_OPEN] + c[w, GAP_TERM_EXT])
        st_te[w] = cnt
        st_to[w] = card - cnt
        ct_te[w] = card
        ct_ext[w] = 0
    return dict(st_open=st_open, st_ext=st_ext, st_to=st_to, st_te=st_te,
                ct_ext=ct_ext, ct_te=ct_te)


def _gaps_change(profile: Profile, params):
    """gaps_profX_change[j] (profile_seq.cpp:594-604)."""
    c = profile.counters
    return (c[:, GAP_OPEN] * (params.gap_ext - params.gap_open)
            + c[:, GAP_TERM_OPEN] * (params.gap_term_ext - params.gap_term_open))


def _choose_D(t_D, t_H, t_V):
    """Direction for the D channel: strict-D, then t_H > t_V -> H else V
    (profile_seq.cpp:746-760). Vectorized; returns (val, dir)."""
    pick_D = (t_D > t_H) & (t_D > t_V)
    pick_H = ~pick_D & (t_H > t_V)
    val = np.where(pick_D, t_D, np.where(pick_H, t_H, t_V))
    drc = np.where(pick_D, D, np.where(pick_H, H, V)).astype(np.uint8)
    return val, drc


def _choose_H3(t_D, t_H, t_V, three_dirs_mask):
    """H channel with the reference's swapped tie order in the 3-dir case:
    strict-D, then t_V > t_H -> V else H (profile_seq.cpp:777-823)."""
    pick_D3 = (t_D > t_H) & (t_D > t_V)
    pick_V3 = ~pick_D3 & (t_V > t_H)
    val3 = np.where(pick_D3, t_D, np.where(pick_V3, t_V, t_H))
    drc3 = np.where(pick_D3, D, np.where(pick_V3, V, H)).astype(np.uint8)
    # 2-dir variant: t_D > t_H -> D else H
    pick_D2 = t_D > t_H
    val2 = np.where(pick_D2, t_D, t_H)
    drc2 = np.where(pick_D2, D, H).astype(np.uint8)
    return (np.where(three_dirs_mask, val3, val2),
            np.where(three_dirs_mask, drc3, drc2).astype(np.uint8))


def _choose_V3(t_D, t_H, t_V, three_dirs_mask):
    """V channel: strict-D, then t_H > t_V -> H else V (3-dir);
    2-dir: t_D > t_V -> D else V (profile_seq.cpp:838-883)."""
    pick_D3 = (t_D > t_H) & (t_D > t_V)
    pick_H3 = ~pick_D3 & (t_H > t_V)
    val3 = np.where(pick_D3, t_D, np.where(pick_H3, t_H, t_V))
    drc3 = np.where(pick_D3, D, np.where(pick_H3, H, V)).astype(np.uint8)
    pick_D2 = t_D > t_V
    val2 = np.where(pick_D2, t_D, t_V)
    drc2 = np.where(pick_D2, D, V).astype(np.uint8)
    return (np.where(three_dirs_mask, val3, val2),
            np.where(three_dirs_mask, drc3, drc2).astype(np.uint8))


def _h_scan_exact(m, b, h0):
    """H[j] = max(m[j], H[j-1]+b[j]) for j=1..n; returns array len n."""
    n = len(m)
    bc = np.concatenate(([0], np.cumsum(b)))        # bc[j] = sum b[1..j]
    # H[j] = max( h0 + bc[j], max_{1<=k<=j} (m[k] + bc[j] - bc[k]) )
    #      = bc[j] + max( h0, cummax(m[k] - bc[k]) )
    mk = m - bc[1:]
    run = np.maximum.accumulate(mk)
    return bc[1:] + np.maximum(run, h0)


# ----------------------------------------------------------------------
class DPResult:
    __slots__ = ("dirs_D", "dirs_H", "dirs_V", "last")

    def __init__(self, w1, w2):
        self.dirs_D = np.zeros((w1 + 1, w2 + 1), dtype=np.uint8)
        self.dirs_H = np.zeros((w1 + 1, w2 + 1), dtype=np.uint8)
        self.dirs_V = np.zeros((w1 + 1, w2 + 1), dtype=np.uint8)
        self.last = (0, 0, 0)


def _set_dir_all(res, i, j, d):
    res.dirs_D[i, j] = d
    res.dirs_H[i, j] = d
    res.dirs_V[i, j] = d


# ----------------------------------------------------------------------
def dp_seq_seq(params, profile1, profile2):
    """Sequence-sequence DP (profile_seq.cpp:24-162)."""
    w1, w2 = profile1.width, profile2.width
    seq1 = profile1.data[0].symbols.astype(np.int64)   # [w1]
    seq2 = profile2.data[0].symbols.astype(np.int64)
    go, ge = params.gap_open, params.gap_ext
    gto, gte = params.gap_term_open, params.gap_term_ext
    sm = params.score_matrix

    res = DPResult(w1, w2)
    prevD = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevH = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevV = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevD[0] = 0
    if w2 >= 1:
        prevH[1] = gto
        _set_dir_all(res, 0, 1, H)
    for j in range(2, w2 + 1):
        prevH[j] = max(prevH[j - 1], prevD[j - 1]) + gte
        _set_dir_all(res, 0, j, H)
    # replicate reference row-0 H chain exactly (prevD[j-1] = -inf for j>=2)
    prevH[w2] = NEG_INF

    currD = np.empty(w2 + 1, dtype=SCORE_DTYPE)
    currH = np.empty(w2 + 1, dtype=SCORE_DTYPE)
    currV = np.empty(w2 + 1, dtype=SCORE_DTYPE)

    for i in range(1, w1 + 1):
        currD[0] = NEG_INF
        currH[0] = NEG_INF
        _set_dir_all(res, i, 0, V)
        if i < w1:
            g = gto if i == 1 else gte
            currV[0] = max(prevV[0], prevD[0]) + g
        else:
            currV[0] = NEG_INF

        score_row = sm[seq1[i - 1]]
        t = score_row[seq2]                      # [w2]

        # D channel (tie: t_H >= t_V -> H)
        t_D = prevD[:-1]
        t_H = prevH[:-1]
        t_V = prevV[:-1]
        pick_D = (t_D > t_H) & (t_D > t_V)
        pick_H = ~pick_D & (t_H >= t_V)
        currD[1:] = np.where(pick_D, t_D, np.where(pick_H, t_H, t_V)) + t
        res.dirs_D[i, 1:] = np.where(pick_D, D, np.where(pick_H, H, V))

        # V channel (2-dir): t_D = prevD[j] + (j<w2 ? go : gto)
        v_open = np.full(w2, go, dtype=SCORE_DTYPE)
        v_ext = np.full(w2, ge, dtype=SCORE_DTYPE)
        if w2 >= 1:
            v_open[-1] = gto
            v_ext[-1] = gte
        t_D = prevD[1:] + v_open
        t_V = prevV[1:] + v_ext
        pick = t_D > t_V
        currV[1:] = np.where(pick, t_D, t_V)
        res.dirs_V[i, 1:] = np.where(pick, D, V)

        # H channel (2-dir, intra-row scan)
        h_open_c = go if i < w1 else gto
        h_ext_c = ge if i < w1 else gte
        m = currD[:-1] + h_open_c                # from D at j-1
        currH[1:] = _h_scan_exact(m, np.full(w2, h_ext_c, dtype=SCORE_DTYPE), currH[0])
        t_D = currD[:-1] + h_open_c
        t_H = currH[:-1] + h_ext_c
        pick = t_D > t_H
        res.dirs_H[i, 1:] = np.where(pick, D, H)

        prevD, currD = currD, prevD
        prevH, currH = currH, prevH
        prevV, currV = currV, prevV

    res.last = (int(prevD[w2]), int(prevH[w2]), int(prevV[w2]))
    return res


# ----------------------------------------------------------------------
def dp_seq_prof(params, profile1, profile2, column_mapping1=None, column_mapping2=None):
    """Sequence-profile DP (profile_seq.cpp:165-491). profile1 holds one seq."""
    w1, w2 = profile1.width, profile2.width
    card2 = len(profile2.data)
    seq1 = profile1.data[0].symbols.astype(np.int64)
    go, ge = params.gap_open, params.gap_ext
    gto, gte = params.gap_term_open, params.gap_term_ext
    scores2 = profile2.scores

    guided = column_mapping1 is not None and column_mapping2 is not None
    if guided:
        row_ranges = find_row_ranges(column_mapping1, column_mapping2,
                                     params.guided_alignment_radius)
    else:
        row_ranges = [(0, w2)] * (w1 + 1)

    p2o = scores2[:, GAP_OPEN]
    p2e = scores2[:, GAP_EXT]
    p2to = scores2[:, GAP_TERM_OPEN]
    p2te = scores2[:, GAP_TERM_EXT]

    gc2 = _gap_corrections(profile2)
    gaps2_change = _gaps_change(profile2, params)
    # v_gap_corr (profile_seq.cpp:274-281): scalar gap costs x correction counts
    v_corr_start = (go * gc2["st_open"] + ge * gc2["st_ext"]
                    + gto * gc2["st_to"] + gte * gc2["st_te"])
    v_corr_cont = ge * gc2["ct_ext"] + gte * gc2["ct_te"]

    res = DPResult(w1, w2)
    prevD = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevH = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevV = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevD[0] = 0
    if w2 >= 1:
        prevH[1] = prevD[0] + p2to[1]
        _set_dir_all(res, 0, 1, H)
    for j in range(2, w2 + 1):
        prevH[j] = prevH[j - 1] + p2te[j]
        _set_dir_all(res, 0, j, H)
    prevH[w2] = NEG_INF

    currD = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    currH = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    currV = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)

    gto_card = gto * card2
    gte_card = gte * card2

    for i in range(1, w1 + 1):
        currD[0] = NEG_INF
        currH[0] = NEG_INF
        _set_dir_all(res, i, 0, V)
        lo_i, hi_i = row_ranges[i]
        if lo_i:
            currD[lo_i - 1] = currH[lo_i - 1] = currV[lo_i - 1] = NEG_INF
        if i < w1:
            currV[0] = max(prevD[0], prevV[0]) + (gto_card if i == 1 else gte_card)
            hi_clear = min(row_ranges[i + 1][1], w2)
            if hi_clear >= hi_i + 1:
                currD[hi_i + 1:hi_clear + 1] = NEG_INF
                currH[hi_i + 1:hi_clear + 1] = NEG_INF
                currV[hi_i + 1:hi_clear + 1] = NEG_INF
        else:
            currV[0] = NEG_INF

        min_j = max(1, lo_i)
        max_j = min(hi_i, w2)
        if max_j < min_j:
            prevD, currD = currD, prevD
            prevH, currH = currH, prevH
            prevV, currV = currV, prevV
            continue
        sl = slice(min_j, max_j + 1)
        slm = slice(min_j - 1, max_j)           # j-1 positions

        t = scores2[sl, seq1[i - 1]]

        # D channel (tie: t_H > t_V -> H else V)
        t_D = prevD[slm]
        t_H = prevH[slm]
        t_V = prevV[slm] + gaps2_change[sl]
        val, drc = _choose_D(t_D, t_H, t_V)
        currD[sl] = val + t
        res.dirs_D[i, sl] = drc

        # V channel
        t_D = prevD[sl] + v_corr_start[sl]
        t_V = prevV[sl] + v_corr_cont[sl]
        t_H = prevH[sl] + v_corr_start[sl]
        three = np.zeros(max_j - min_j + 1, dtype=bool)
        if i > 1:
            three[:] = np.arange(min_j, max_j + 1) > 1
        val, drc = _choose_V3(t_D, t_H, t_V, three)
        currV[sl] = val
        res.dirs_V[i, sl] = drc

        # H channel: gap corr = p2_gaps[j].open/term_open by row position
        a = (p2o[sl] if i < w1 else p2to[sl])
        b = (p2e[sl] if i < w1 else p2te[sl])
        m = currD[slm] + a
        if i > 1:
            mv = currV[slm] + a
            jj = np.arange(min_j, max_j + 1)
            m = np.where(jj > 1, np.maximum(m, mv), m)
        currH[sl] = _h_scan_exact(m, b, currH[min_j - 1])
        t_D = currD[slm] + a
        t_H = currH[slm] + b
        t_V = currV[slm] + a
        val, drc = _choose_H3(t_D, t_H, t_V, three)
        res.dirs_H[i, sl] = drc

        prevD, currD = currD, prevD
        prevH, currH = currH, prevH
        prevV, currV = currV, prevV

    res.last = (int(prevD[w2]), int(prevH[w2]), int(prevV[w2]))
    return res


# ----------------------------------------------------------------------
def dp_prof_prof(params, profile1, profile2, column_mapping1=None, column_mapping2=None):
    """Profile-profile DP (profile_seq.cpp:495-892)."""
    w1, w2 = profile1.width, profile2.width
    card1, card2 = len(profile1.data), len(profile2.data)
    go, ge = params.gap_open, params.gap_ext
    gto, gte = params.gap_term_open, params.gap_term_ext
    scores1, scores2 = profile1.scores, profile2.scores
    counters1 = profile1.counters

    guided = column_mapping1 is not None and column_mapping2 is not None
    if guided:
        row_ranges = find_row_ranges(column_mapping1, column_mapping2,
                                     params.guided_alignment_radius)
    else:
        row_ranges = [(0, w2)] * (w1 + 1)

    p2o = scores2[:, GAP_OPEN]
    p2e = scores2[:, GAP_EXT]
    p2to = scores2[:, GAP_TERM_OPEN]
    p2te = scores2[:, GAP_TERM_EXT]

    gc2 = _gap_corrections(profile2)
    gaps2_change = _gaps_change(profile2, params)
    gc1 = _gap_corrections(profile1)      # row-wise scalars, vector over i

    res = DPResult(w1, w2)
    prevD = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevH = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevV = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    prevD[0] = 0
    if w2 >= 1:
        prevH[1] = prevD[0] + p2to[1] * card1
        _set_dir_all(res, 0, 1, H)
    for j in range(2, w2 + 1):
        prevH[j] = prevH[j - 1] + p2te[j] * card1
        _set_dir_all(res, 0, j, H)
    prevH[w2] = NEG_INF

    currD = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    currH = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)
    currV = np.full(w2 + 1, NEG_INF, dtype=SCORE_DTYPE)

    # delta for H-predecessor of the D channel (profile_seq.cpp:729-738)
    dge_go = scores2[:, GAP_EXT] - scores2[:, GAP_OPEN]
    dgte_gto = scores2[:, GAP_TERM_EXT] - scores2[:, GAP_TERM_OPEN]

    c1_sym = counters1[:, :NO_AMINOACIDS_AND_GAPS]
    s2_sym_T = scores2[:, :NO_AMINOACIDS_AND_GAPS]
    col1_n_non_gaps = counters1[:, :NO_AMINOACIDS].sum(axis=1)

    for i in range(1, w1 + 1):
        s1go = scores1[i, GAP_OPEN]
        s1gto = scores1[i, GAP_TERM_OPEN]
        s1ge = scores1[i, GAP_EXT]
        s1gte = scores1[i, GAP_TERM_EXT]

        currD[0] = NEG_INF
        currH[0] = NEG_INF
        _set_dir_all(res, i, 0, V)
        lo_i, hi_i = row_ranges[i]
        if lo_i:
            currD[lo_i - 1] = currH[lo_i - 1] = currV[lo_i - 1] = NEG_INF
        if i < w1:
            currV[0] = max(prevD[0], prevV[0]) + (s1gto if i == 1 else s1gte) * card2
            hi_clear = min(row_ranges[i + 1][1], w2)
            if hi_clear >= hi_i + 1:
                currD[hi_i + 1:hi_clear + 1] = NEG_INF
                currH[hi_i + 1:hi_clear + 1] = NEG_INF
                currV[hi_i + 1:hi_clear + 1] = NEG_INF
        else:
            currV[0] = NEG_INF

        min_j = max(1, lo_i)
        max_j = min(hi_i, w2)
        if max_j < min_j:
            prevD, currD = currD, prevD
            prevH, currH = currH, prevH
            prevV, currV = currV, prevV
            continue
        sl = slice(min_j, max_j + 1)
        slm = slice(min_j - 1, max_j)

        # profile1 row gap corrections (scalars)
        n1so = int(gc1["st_open"][i]); n1se = int(gc1["st_ext"][i])
        n1sto = int(gc1["st_to"][i]); n1ste = int(gc1["st_te"][i])
        n1ce = int(gc1["ct_ext"][i]); n1cte = int(gc1["ct_te"][i])
        n1_change = int(counters1[i, GAP_OPEN])
        n1_term_change = int(counters1[i, GAP_TERM_OPEN])

        # match score row: counters1[i,:30] . scores2[j,:30]
        t = s2_sym_T[sl] @ c1_sym[i]

        # D channel
        t_D = prevD[slm] + t
        delta = n1_change * dge_go[sl] + n1_term_change * dgte_gto[sl]
        t_H = prevH[slm] + t + delta
        t_V = prevV[slm] + t + gaps2_change[sl] * col1_n_non_gaps[i]
        pick_D = (t_D > t_H) & (t_D > t_V)
        pick_H = ~pick_D & (t_H > t_V)
        currD[sl] = np.where(pick_D, t_D, np.where(pick_H, t_H, t_V))
        res.dirs_D[i, sl] = np.where(pick_D, D, np.where(pick_H, H, V))

        three = np.zeros(max_j - min_j + 1, dtype=bool)
        if i > 1:
            three[:] = np.arange(min_j, max_j + 1) > 1

        # V channel
        gv_start = (s1go * gc2["st_open"][sl] + s1ge * gc2["st_ext"][sl]
                    + s1gto * gc2["st_to"][sl] + s1gte * gc2["st_te"][sl])
        gv_cont = s1ge * gc2["ct_ext"][sl] + s1gte * gc2["ct_te"][sl]
        t_D = prevD[sl] + gv_start
        t_V = prevV[sl] + gv_cont
        t_H = prevH[sl] + gv_start
        val, drc = _choose_V3(t_D, t_H, t_V, three)
        currV[sl] = val
        res.dirs_V[i, sl] = drc

        # H channel
        gh_start = p2o[sl] * n1so + p2e[sl] * n1se + p2to[sl] * n1sto + p2te[sl] * n1ste
        gh_cont = p2e[sl] * n1ce + p2te[sl] * n1cte
        m = currD[slm] + gh_start
        if i > 1:
            mv = currV[slm] + gh_start
            jj = np.arange(min_j, max_j + 1)
            m = np.where(jj > 1, np.maximum(m, mv), m)
        currH[sl] = _h_scan_exact(m, gh_cont, currH[min_j - 1])
        t_D = currD[slm] + gh_start
        t_H = currH[slm] + gh_cont
        t_V = currV[slm] + gh_start
        val, drc = _choose_H3(t_D, t_H, t_V, three)
        res.dirs_H[i, sl] = drc

        prevD, currD = currD, prevD
        prevH, currH = currH, prevH
        prevV, currV = currV, prevV

    res.last = (int(prevD[w2]), int(prevH[w2]), int(prevV[w2]))
    return res
