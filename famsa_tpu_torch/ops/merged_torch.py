"""Merged profile counters on the device: the counters of each merge of
a launch, built from its two sides' counters (read where they lie, on
the card) and its forward path (K4's output), so that the parent's merge
reads them without an upload.

merged_from_paths is the wrapper of the CUDA kernel K6 (csrc/merged.cu,
one CTA a tile of MERGED_TILE steps of a merge's path);
merged_from_paths_plain is its plain PyTorch twin behind the same
interface: the sides read with ops/sides.py:read_sides_plain, the paths
with ops/traceback_torch.py:forward_paths, and merged_counters.

merged_counters ports famsa_tpu/ops/dp_pallas.py:merged_counters_device
(:1919; its _forward_paths, :1219, is forward_paths) as torch ops batched
over a launch's merges, with direct row gathers where the TPU needed
one-hot limb matmuls.  The identities that make it vectorisable
(dp_pallas.py:1933-1943):
  - scores are a fixed linear function of counters, so only counters
    stay on the card (stage 0 re-derives scores);
  - the open->ext transfer (profile.cpp:840-975) reads only transfer-
    invariant sums of the parents' counters, each parent column receives
    at most one, and it lands on the advance step right after its run;
  - within a gap run the start / continue category counts reach a fixed
    point after two columns (core/construct_fast.py's closed form);
  - a parent's position is constant across a gap run in it.
The result equals the counters core/construct_fast.py:_merge_columns
builds on the host for the same path.
"""

import torch

from .. import kernels
from ..core.defs import (GAP, GAP_EXT, GAP_OPEN, GAP_TERM_EXT,
                         GAP_TERM_OPEN)
from .dp_stage0 import both_sides
from .sides import read_sides_plain
from .traceback_torch import forward_paths

_H, _V = 1, 2                      # path codes of a gap in parent 1, 2
# csrc/merged.cu: K6 spreads a merge over CTAs of MERGED_TILE path steps
# each (a grid of (merges, ceil(smax / MERGED_TILE))); tests and
# chip_smoke.py place cases on its tile edges
MERGED_TILE = 512


def merged_counters(sides, fwd):
    """Merged counters [B, S+1, 32] int32 of a batch of merges.

    sides: ops/dp_stage0.py:both_sides of the batch (counters [2B, W+1,
    32] int64, side 1 of every merge then side 2, rows past a profile's
    width zero; widths and cardinalities [2B]); fwd [B, S]: forward path
    codes (0 D, 1 H, 2 V; 3 past the path), on the same device.  Row 0
    and the rows past each path are zero."""
    c, w, size, _ = sides
    b, s = fwd.shape
    run = torch.stack([fwd == _H, fwd == _V])    # a gap run in the parent
    adv = (fwd != 3) & ~run                      # the parent advances
    pos = torch.cumsum(adv, dim=-1)              # its column after step k
    prev_run = torch.cat([torch.zeros_like(run[..., :1]), run[..., :-1]], -1)
    start = run & ~prev_run
    hit = adv & prev_run                 # the advance right after a run
    w, size = w.view(2, b, 1), size.view(2, b, 1)

    # rows c[pos] and c[pos + 1] (zero past the last row) of each parent
    cpad = torch.nn.functional.pad(c, (0, 0, 0, 1))
    idx = torch.cat([pos, pos + 1], dim=-1).view(2 * b, 2 * s, 1)
    got = cpad.gather(1, idx.expand(-1, -1, 32)).view(2, b, 2, s, 32)
    cur, nxt = got[:, :, 0], got[:, :, 1]

    # gap-run category counts (SolveGapsProblemWhenStarting / Continuing,
    # profile.cpp:1116-1220) from the parents' counters: the first column
    # of a run, the second, then the fixed point; boundary runs (a parent
    # at column 0 or past its last) are pure terminal ext after the first
    cnt_end = cur[..., GAP_TERM_OPEN] + cur[..., GAP_TERM_EXT]
    at0, atw = pos == 0, pos >= w
    bnd = at0 | atw
    e1 = torch.where(bnd, 0, cur[..., GAP_OPEN] + cur[..., GAP_EXT])
    to1 = torch.where(at0, size, torch.where(atw, size - cnt_end,
                                             nxt[..., GAP_TERM_OPEN]))
    te1 = torch.where(at0, 0, cnt_end)
    o1 = torch.where(bnd, 0, size - e1 - to1 - te1)
    k = torch.arange(s, device=fwd.device)
    p = k - torch.cummax(torch.where(start, k, 0), dim=-1).values + 1
    e2, te2 = o1 + e1, to1 + te1
    first = p == 1
    later = torch.stack([size - e2 - te2, e2, torch.zeros_like(e2), te2], -1)
    later = torch.where((p == 2)[..., None], later,
                        torch.stack([torch.zeros_like(e2), size - te2,
                                     torch.zeros_like(e2), te2], -1))
    later = torch.where((bnd & ~first)[..., None],
                        torch.nn.functional.pad(size[..., None], (3, 0))
                        .expand_as(later), later)
    gaps = torch.where(first[..., None], torch.stack([o1, e1, to1, te1], -1),
                       later)
    # open->ext transfers (profile.cpp:840-975) land on the advance right
    # after a run: its own row c[pos] gives them
    dg_t = torch.where(hit & (pos > 1), cur[..., GAP_OPEN], 0)
    dg_tt = torch.where(hit, cur[..., GAP_TERM_OPEN], 0)
    gaps = torch.where(run[..., None], gaps, 0) \
        + torch.stack([-dg_t, dg_t, -dg_tt, dg_tt], -1)

    rows = torch.where(adv[..., None], cur, 0).sum(dim=0)
    rows[..., (GAP_OPEN, GAP_EXT, GAP_TERM_OPEN, GAP_TERM_EXT)] += \
        gaps.sum(dim=0)
    rows[..., GAP] += torch.where(run, size, 0).sum(dim=0)
    return torch.nn.functional.pad(rows, (0, 0, 1, 0)).to(torch.int32)


def merged_from_paths_plain(sides, paths, hdr, smax):
    """Plain PyTorch twin of K6 on the same inputs (see
    merged_from_paths)."""
    c1, c2 = read_sides_plain(sides)
    return merged_counters(both_sides(c1, c2, hdr),
                           forward_paths(paths, hdr, smax))


def merged_from_paths(sides, paths, hdr, smax):
    """Merged counters [B, smax+1, 32] int32 of a launch's merges.

    sides: the launch's side descriptors (ops/sides.py:LaunchSides);
    paths: K4's output buffer (ops/traceback_torch.py) as it lies on the
    device; hdr [B, 8] int64 (w1, w2, ..., card1, card2, ...) on that
    device; smax >= every merge's w1 + w2.  Row 0 and the rows past each
    path are zero.  CUDA tensors launch kernel K6 (csrc/merged.cu); CPU
    tensors run merged_from_paths_plain."""
    b = sides.b
    if paths.dtype != torch.uint8 or paths.dim() != 1:
        raise TypeError("paths must be a 1-D uint8 tensor")
    if hdr.dtype != torch.int64 or tuple(hdr.shape) != (b, 8):
        raise ValueError("hdr must be [B, 8] int64")
    w1, w2 = sides.widths()
    if smax < int((w1 + w2).max()):
        raise ValueError("smax is shorter than a merge's path")
    dev = paths.device
    if hdr.device != dev or sides.desc.device != dev:
        raise ValueError("inputs must be on one device")
    if dev.type == "cpu":
        return merged_from_paths_plain(sides, paths, hdr, smax)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (paths.is_contiguous() and hdr.is_contiguous()
            and sides.desc.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((b, smax + 1, 32), dtype=torch.int32, device=dev)
    lib = kernels.get("merged")
    kernels.LAUNCHES["merged"] += 1
    err = lib.merged_counters(sides.desc.data_ptr(), hdr.data_ptr(),
                              paths.data_ptr(), b, smax, out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "merged_counters")
    return out
