"""Batched profile-profile DP on torch: the plain PyTorch version, the
wrapper of the CUDA kernel K2 and the batched entry points: the
device-resident path route used by the pipeline and the aligner
(dp_profile_torch_paths_async: stage 0, K2, the traceback K4 and the
merged counters on the device, ops/dp_resident.py) and the host-prep
route (dp_profile_torch_batched: ops/dp_pack.py), which the kernel checks
and scripts/torch_dp_crossover.py use.

K2 has three variants, chosen by the batch's widest w2 (k2_variant):
"staged" (csrc/dp_wide.cu:dp_profile_batched_staged, w2 <= 8191) and
"stripes" (dp_profile_batched_stripes, w2 <= 32767) run every merge of
the batch as one thread-block cluster of K3's column folds, of the
staged or the stripes body (ops/dp_wide.py), all merges in one launch;
"spans" (dp_profile_batched_spans, wider batches up to MAX_W2) runs
every merge on up to four clusters of the stripes body's folds, the edge
between clusters through global memory.

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

import torch

from .. import kernels
from . import dp_wide
from .dp_resident import dispatch_paths
from .dp_pack import (  # noqa: F401  (prepare_merge, pack_batch: public here)
    C_CUME, C_CUMT, C_G2CE, C_G2CHG, C_G2CTE, C_G2SE, C_G2SO, C_G2STE,
    C_G2STO, C_H0, C_P2E, C_P2O, C_P2TE, C_P2TO, C_S2, COL0_PACK, IMIN,
    MAX_THREADS, NCOLF, NEG, NROWF, R_CNT, R_G1CE, R_G1CTE, R_G1SE, R_G1SO,
    R_G1STE, R_G1STO, R_HI, R_LO, R_N1C, R_N1TC, R_NNG, R_S1GE, R_S1GO,
    R_S1GTE, R_S1GTO, R_SYM, R_V0COST, ROW0_PACK, host_meta, pack_batch,
    prepare_merge, run_batch)

MAX_W2 = dp_wide.SPANS_MAX_W2             # widest profile2 K2 takes


def _shift(x, fill):
    """Column j <- column j-1; column 0 <- fill."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def dp_plain(colf, rowf, meta, total, meta_host=None):
    """Plain PyTorch version of K2 on the same packed inputs: the
    row-serial recurrence of ops/dp_jax.py:_dp_kernel with the band.
    meta_host: meta as a host array (default: read from meta).  Returns
    (dirs [total] uint8, fin [B, ldr-1, 3] int64: the last-column D, H,
    V of every row)."""
    dev = colf.device
    b, _, ldc = colf.shape
    ldr = rowf.shape[1]
    meta_h = host_meta(meta, meta_host)
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


def k2_variant(max_w2):
    """"staged" (max_w2 <= dp_wide.STAGED_MAX_W2: every merge a cluster of
    K3's staged folds, one column a thread), "stripes" (max_w2 <=
    dp_wide.MAX_W2: a cluster of K3's stripes folds) or "spans" (max_w2
    <= MAX_W2: up to four clusters of the stripes body's folds a merge).
    Raises past MAX_W2."""
    if max_w2 <= dp_wide.STAGED_MAX_W2:
        return "staged"
    if max_w2 <= dp_wide.MAX_W2:
        return "stripes"
    if max_w2 <= MAX_W2:
        return "spans"
    raise ValueError(f"profile width {max_w2} exceeds the K2 limit {MAX_W2}")


def dp_dirs(colf, rowf, meta, total, variant=None, meta_host=None):
    """Packed direction bytes and per-row last-column finals of a batch of
    merges (see pack_batch for the inputs).  Returns (dirs [total] uint8,
    fin [B, ldr-1, 3] int64).  variant: "staged", "stripes" or "spans"
    (default: k2_variant of the batch's widest w2); each takes only the
    batches k2_variant gives it.  meta_host:
    meta as a host array; the widths are then taken from it, and nothing
    here waits for the device (without it they are read from meta, which
    does).

    CUDA tensors launch that variant of kernel K2 (a cluster the card
    cannot place raises).  CPU tensors run dp_plain, or with a variant
    named its fold walk, dp_wide.dp_staged_plain (with span MAX_FOLDS for
    "spans")."""
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
    if variant not in (None, "staged", "stripes", "spans"):
        raise ValueError(f"unknown K2 variant {variant!r}")
    b, _, ldc = colf.shape
    ldr = rowf.shape[1]
    meta_h = host_meta(meta, meta_host)
    w2s = meta_h[:, 1].tolist()
    if variant == "staged":
        dp_wide.staged_geometry(w2s)        # raises past STAGED_MAX_W2
    elif variant == "stripes":
        dp_wide.stripes_geometry(w2s)       # raises outside its widths
    elif variant == "spans":
        dp_wide.spans_geometry(w2s)         # raises outside its widths
    elif w2s:
        k2_variant(max(w2s))                # raises past MAX_W2
    dev = colf.device
    if dev.type == "cpu":
        if variant is not None:
            return dp_wide.dp_staged_plain(
                colf, rowf, meta, total, meta_host=meta_h,
                span=dp_wide.MAX_FOLDS if variant == "spans" else None)
        return dp_plain(colf, rowf, meta, total, meta_host=meta_h)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (colf.is_contiguous() and rowf.is_contiguous()
            and meta.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    dirs = torch.empty(total, dtype=torch.uint8, device=dev)
    fin = torch.empty((b, ldr - 1, 3), dtype=torch.int64, device=dev)
    if b == 0:
        return dirs, fin
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = variant or k2_variant(max(w2s))
    if ldc % 2 or colf.data_ptr() % 16:
        raise ValueError(f"K2 {variant} takes an even ldc and 16-byte "
                         "aligned colf (pack_batch)")
    lib = kernels.get("dp_wide")
    if variant in ("staged", "stripes"):
        folds, threads, stripe, _ = dp_wide.batch_geometry(w2s)
        kernels.LAUNCHES[dp_wide.launch_key("K2", variant, folds)] += 1
        if variant == "staged":
            err = lib.dp_profile_batched_staged(
                colf.data_ptr(), rowf.data_ptr(), meta.data_ptr(), b,
                max(w2s), folds, threads, ldc, ldr, ldr - 1, dp_wide.BLK,
                dirs.data_ptr(), fin.data_ptr(), stream)
        else:
            err = lib.dp_profile_batched_stripes(
                colf.data_ptr(), rowf.data_ptr(), meta.data_ptr(), b,
                max(w2s), folds, threads, stripe, ldc, ldr, ldr - 1,
                dp_wide.BLK, dirs.data_ptr(), fin.data_ptr(), stream)
        kernels.check(err, f"dp_profile_batched_{variant}")
        return dirs, fin
    # spans: per merge its ticket count and the row blocks published
    # across each cluster boundary (zeroed), and the boundaries' edges
    sync = torch.zeros((b, 1 + dp_wide.MAX_SPAN), dtype=torch.int32,
                       device=dev)
    gedge = torch.empty((b, dp_wide.MAX_SPAN - 1, ldr - 1, 3),
                        dtype=torch.int64, device=dev)
    kernels.LAUNCHES["dp_spans"] += 1
    err = lib.dp_profile_batched_spans(
        colf.data_ptr(), rowf.data_ptr(), meta.data_ptr(), b, max(w2s), ldc,
        ldr, ldr - 1, dp_wide.BLK, dirs.data_ptr(), fin.data_ptr(),
        sync.data_ptr(), gedge.data_ptr(), stream)
    kernels.check(err, "dp_profile_batched_spans")
    return dirs, fin


def dp_profile_torch_batched(params, pairs, bands=None, dirs_fn=None):
    """DP of a batch of merges on params.device (one K2 launch on CUDA).

    pairs: list of (profile1, profile2) with counters/scores computed;
    bands: optional list aligned with pairs of band rows
    (core/dp_native.row_ranges) or None; dirs_fn: the DP on the packed
    batch (default dp_dirs; the scheduler passes K3's wrapper for a lone
    wide merge).  Returns a list of (dirs [w1+1, w2+1] uint8 numpy, last
    (D, H, V))."""
    if bands is None:
        bands = [None] * len(pairs)
    return run_batch(params, pairs, bands, dirs_fn or dp_dirs)


def dp_profile_torch_paths_async(params, pairs, dev_pairs=None,
                                 want_merged=False, bands=None,
                                 dirs_fn=None):
    """DP and traceback of a batch of merges on params.device, dispatched
    without waiting: one upload of the sides' descriptors, stage 0 (K5),
    K2 (dirs_fn, default dp_dirs, given the widths from the host), K4 and,
    when want_merged, the merged counters (K6), with only the paths copied
    back (ops/dp_resident.py:dispatch_paths).  Returns a PendingPaths
    whose resolve() gives one PathResult per merge."""
    return dispatch_paths(params, pairs, dirs_fn or dp_dirs, dev_pairs,
                          want_merged, bands)
