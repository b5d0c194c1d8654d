"""Stage 0 of the profile DP on the device: the packed inputs of K2 and
K3 (the plane layout of ops/dp_pack.py and csrc/dp_common.cuh) built
from the two sides' counters where they lie, so that a merge whose
counters are already on the card uploads nothing but its widths.

stage0 is the wrapper of the CUDA kernel K5 (csrc/stage0.cu), which
reads the sides through the launch's descriptors (ops/sides.py);
stage0_plain is its plain PyTorch twin, on sides already read into
tensors.  Both port famsa_tpu/ops/dp_pallas.py:_scores_from_counters
(:791), _gap_corrections_device (:819) and _stage0_one (:844), batched
over a launch's merges.  The result equals ops/dp_pack.py:prepare_merge
+ pack_batch in every int64, padding included: the arithmetic is the
host's (exact int64 with two's-complement wrap, the wrap of its
np.errstate(over="ignore") cumsums included), the symbol scores
counters[:, :24] @ SM a broadcast multiply and sum in the plain twin
(torch has no int64 matmul on CUDA, and a float product would not be
exact), and the nonzero compaction of R_CNT / R_SYM a stable sort on int
keys there.
"""

import numpy as np
import torch

from .. import kernels
from ..core.defs import (GAP_EXT, GAP_OPEN, GAP_TERM_EXT, GAP_TERM_OPEN,
                         NO_AMINOACIDS, NO_AMINOACIDS_AND_GAPS)
from .dp_pack import (C_H0, C_S2, NCOLF, NEG, NROWF, R_HI, R_NNZ)
from .sides import read_sides_plain

# the planes are concatenated in their layout order
assert C_S2 == 0 and C_H0 == NCOLF - 1 and R_NNZ == 0 and R_HI == NROWF - 1

# the four gap columns of a score row in the order of colf's P2 planes and
# rowf's S1G planes (open, ext, term open, term ext)
_GAPS = (GAP_OPEN, GAP_EXT, GAP_TERM_OPEN, GAP_TERM_EXT)
TABLE_ROWS = NO_AMINOACIDS + 1


def score_table(params):
    """[25, 32] int64 host table of the score derivation: rows 0..23 the
    substitution matrix in columns 0..23, row 24 the gap costs in the
    gap columns (its other columns zero)."""
    t = np.zeros((TABLE_ROWS, 32), dtype=np.int64)
    t[:NO_AMINOACIDS, :NO_AMINOACIDS] = np.asarray(params.score_matrix,
                                                   dtype=np.int64)
    for col, cost in zip(_GAPS, (params.gap_open, params.gap_ext,
                                 params.gap_term_open, params.gap_term_ext)):
        t[NO_AMINOACIDS, col] = int(cost)
    return t


def scores_from_counters(c, card, table):
    """Profile scores [N, W+1, 32] int64 from counters c [N, W+1, 32]
    int64 (rows past a profile's width zero), cardinalities card [N] and
    the score table [25, 32] on c's device (core/profile.py:
    _calculate_scores; dp_pallas.py:_scores_from_counters): row r > 0 is
    sum_s c[r, s] table[s] over the 24 symbols and the row's symbol count
    (the last table row), plus the row's gap cost in columns 0..23; row
    0 is card times the gap costs."""
    x = c[:, 1:, :TABLE_ROWS].clone()
    x[..., NO_AMINOACIDS] = x[..., :NO_AMINOACIDS].sum(dim=-1)
    body = (x[..., None] * table).sum(dim=-2)
    gap_cost = (c[:, 1:, GAP_OPEN:GAP_TERM_OPEN + 1]
                * table[NO_AMINOACIDS, GAP_OPEN:GAP_TERM_OPEN + 1]).sum(-1)
    body[..., :NO_AMINOACIDS] += gap_cost[..., None]
    return torch.cat([(card[:, None] * table[NO_AMINOACIDS])[:, None], body],
                     dim=1)


def gap_corrections(c, w, card):
    """The six gap-correction planes [N, W+1, 6] (st_open, st_ext, st_to,
    st_te, ct_ext, ct_te) of core/dp.py:_gap_corrections, for counters c
    [N, W+1, 32] int64 (rows past w zero), widths w and cardinalities
    card [N] (dp_pallas.py:_gap_corrections_device)."""
    w, card = w[:, None, None], card[:, None, None]
    j = torch.arange(c.shape[1], device=c.device)[None, :, None]
    internal = (j >= 1) & (j < w)
    at_end = (j == w) & (w >= 1)
    cn = torch.nn.functional.pad(c[:, 1:, GAP_TERM_OPEN:GAP_TERM_OPEN + 1],
                                 (0, 0, 0, 1))        # c[j+1, GTO]
    cnt = c[..., GAP_TERM_OPEN:GAP_TERM_OPEN + 1] \
        + c[..., GAP_TERM_EXT:GAP_TERM_EXT + 1]
    ext = c[..., GAP_OPEN:GAP_OPEN + 1] + c[..., GAP_EXT:GAP_EXT + 1]
    ct_te = cn + cnt
    inner = torch.cat([card - ext - ct_te, ext, cn, cnt, card - ct_te, ct_te],
                      dim=-1)
    end = torch.cat([card - cnt, cnt, card.expand_as(cnt)], dim=-1)
    end = torch.nn.functional.pad(end, (2, 0))[..., (0, 1, 2, 3, 0, 4)]
    return torch.where(internal, inner, torch.where(at_end, end, 0))


def both_sides(c1, c2, hdr):
    """The two sides of a batch as one int64 tensor [2B, W+1, 32] (side 1
    of every merge, then side 2; W the wider side), every row past a
    profile's width zero, and (widths, cardinalities) [2B] to match.
    c1 [B, W1+1, 32], c2 [B, W2+1, 32] any integer dtype; hdr as in
    stage0."""
    b = c1.shape[0]
    wp = max(c1.shape[1], c2.shape[1]) - 1
    c = c1.new_zeros((2 * b, wp + 1, 32), dtype=torch.int64)
    c[:b, :c1.shape[1]] = c1
    c[b:, :c2.shape[1]] = c2
    w = torch.cat([hdr[:, 0], hdr[:, 1]])
    card = torch.cat([hdr[:, 4], hdr[:, 5]])
    rows = torch.arange(wp + 1, device=c.device)[None, :]
    live = rows <= w[:, None]
    return torch.where(live[..., None], c, 0), w, card, live


def stage0_plain(params, c1, c2, hdr, table, band=None):
    """Plain PyTorch twin of K5: the packed DP inputs of a batch of merges
    from their sides' counters.

    c1 [B, W1+1, 32], c2 [B, W2+1, 32]: any integer dtype, on the DP's
    device (W1, W2 the batch's widest profiles; rows past a profile's
    width are ignored); hdr [B, 8] int64 on that device: (w1, w2, dirs
    byte offset, 0, card1, card2, 0, 0) per merge; table: score_table's
    [25, 32] on that device; band: None, or [B, W1+1, 2] int64 (lo, hi)
    per DP row on that device (rows past w1 ignored).  Returns (colf
    [B, NCOLF, ldc], rowf [B, W1+1, NROWF], meta [B, 4]) int64, equal to
    pack_batch of prepare_merge's."""
    b, w1p, w2p = c1.shape[0], c1.shape[1] - 1, c2.shape[1] - 1
    c, w, card, live = both_sides(c1, c2, hdr)
    s = scores_from_counters(c, card, table)
    g = gap_corrections(c, w, card)
    gap_col = list(_GAPS)

    # side 2: the column planes
    c2, s2, w2, card1 = c[b:, :w2p + 1], s[b:, :w2p + 1], w[b:], card[:b]
    chg = (c2[..., GAP_OPEN] * (int(params.gap_ext) - int(params.gap_open))
           + c2[..., GAP_TERM_OPEN] * (int(params.gap_term_ext)
                                       - int(params.gap_term_open)))
    cum = torch.cumsum(s2[..., (GAP_EXT, GAP_TERM_EXT)], dim=1)
    cum -= cum[:, :1].clone()                        # rows 1..j
    # row 0 boundary (profile_seq.cpp:555-579)
    jj = torch.arange(w2p + 1, device=c.device)[None, :]
    inc = s2[..., GAP_TERM_EXT].clone()
    inc[:, 1] = s2[:, 1, GAP_TERM_OPEN]
    h0 = torch.cumsum(inc * card1[:, None], dim=1)
    h0 -= h0[:, :1].clone()
    h0 = torch.where((jj == 0) | (jj == w2[:, None]), NEG, h0)
    planes = torch.cat([s2[..., :NO_AMINOACIDS_AND_GAPS], s2[..., gap_col],
                        chg[..., None], g[b:, :w2p + 1], cum, h0[..., None]],
                       dim=-1)
    ldc = -(-(w2p + 1) // 2) * 2
    colf = planes.new_zeros((b, NCOLF, ldc))
    colf[..., :w2p + 1] = torch.where(live[b:, :w2p + 1, None], planes,
                                      0).transpose(1, 2)

    # side 1: the row planes
    c1, s1, card2 = c[:b, :w1p + 1], s[:b, :w1p + 1], card[b:]
    zero = (c1[..., :NO_AMINOACIDS_AND_GAPS] == 0).to(torch.int32)
    order = torch.sort(zero, dim=-1, stable=True)[1]
    v0 = s1[..., GAP_TERM_EXT].clone()
    v0[:, 1] = s1[:, 1, GAP_TERM_OPEN]
    if band is None:
        band = torch.stack([torch.zeros_like(v0),
                            w2[:, None].expand_as(v0)], dim=-1)
    rowf = torch.cat([NO_AMINOACIDS_AND_GAPS - zero.sum(-1, keepdim=True),
                      torch.gather(c1, -1, order), order,
                      c1[..., :NO_AMINOACIDS].sum(dim=-1, keepdim=True),
                      c1[..., (GAP_OPEN, GAP_TERM_OPEN)], s1[..., gap_col],
                      g[:b, :w1p + 1], (v0 * card2[:, None])[..., None],
                      band], dim=-1)
    rowf = torch.where(live[:b, :w1p + 1, None], rowf, 0)
    return colf, rowf, hdr[:, :4].contiguous()


def stage0(params, sides, hdr, table, band=None):
    """Packed DP inputs of a launch's merges from its sides where they lie.

    sides: the launch's side descriptors (ops/sides.py:LaunchSides); hdr
    [B, 8] int64: (w1, w2, dirs byte offset, 0, card1, card2, 0, 0) per
    merge; table: score_table's [25, 32] int64; band: None, or [B, W1+1,
    2] int64 (lo, hi) per DP row (W1 the widest side 1; rows past w1
    ignored); all on the launch's device.  Returns (colf [B, NCOLF, ldc],
    rowf [B, W1+1, NROWF], meta [B, 4]) int64, equal to pack_batch of
    prepare_merge's in every int64, ldc = W2 + 1 rounded up to even.

    CUDA tensors launch kernel K5 (csrc/stage0.cu); CPU tensors read the
    sides with read_sides_plain and run stage0_plain."""
    b = sides.b
    w1, w2 = sides.widths()
    w1p, w2p = int(w1.max()), int(w2.max())
    if hdr.dtype != torch.int64 or tuple(hdr.shape) != (b, 8):
        raise ValueError("hdr must be [B, 8] int64")
    if table.dtype != torch.int64 or tuple(table.shape) != (TABLE_ROWS, 32):
        raise ValueError(f"table must be [{TABLE_ROWS}, 32] int64")
    if band is not None and (band.dtype != torch.int64
                             or tuple(band.shape) != (b, w1p + 1, 2)):
        raise ValueError("band must be [B, W1+1, 2] int64")
    dev = hdr.device
    if sides.desc.device != dev or table.device != dev or \
            (band is not None and band.device != dev):
        raise ValueError("inputs must be on one device")
    if dev.type == "cpu":
        c1, c2 = read_sides_plain(sides)
        return stage0_plain(params, c1, c2, hdr, table, band)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(x.is_contiguous() for x in (sides.desc, hdr, table)) or \
            (band is not None and not band.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    ldc = -(-(w2p + 1) // 2) * 2
    colf = torch.empty((b, NCOLF, ldc), dtype=torch.int64, device=dev)
    rowf = torch.empty((b, w1p + 1, NROWF), dtype=torch.int64, device=dev)
    meta = torch.empty((b, 4), dtype=torch.int64, device=dev)
    lib = kernels.get("stage0")
    kernels.LAUNCHES["stage0"] += 1
    err = lib.stage0(sides.desc.data_ptr(), hdr.data_ptr(), table.data_ptr(),
                     None if band is None else band.data_ptr(), b, w1p, ldc,
                     colf.data_ptr(), rowf.data_ptr(), meta.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "stage0")
    return colf, rowf, meta
