"""The column axis of multi-device sharding: one profile merge's DP with
its columns split across the shards of a mesh (parallel/mesh.py).

The counterpart of famsa_tpu/parallel/dp_sharded.py (`:40
_sharded_program`, `:197 dp_profile_sharded`, `:255
dp_profile_sharded_paths`).  famsa_tpu runs the whole row loop as one
shard_map program, every row in lockstep over its shards: a halo of one
column a row (ppermute), the H channel's max-plus scan in two phases (a
local cummax and a carry all-gathered across shards) and the bc
cumsum's offsets.  Here the merge's DP is cut into blocks of ROW_BLOCK
rows and run as a pipeline of kernel K10 (ops/dp_wide.py:dp_shard), the
design of FAMSA's own parallel engine, column stripes in a wavefront
(profile_par.cpp:214-230):

 - the lead builds the merge's column and row factors once, with K5 on
   its resident sides (ops/dp_resident.py:stage0_launch); each shard
   copies its slice [cs, c1) of the column planes (Mesh.bounds: the
   merge's w2 + 1 columns in contiguous slices, no pad column) and the
   whole of the row factors, band included, to its own device;
 - for each block b, and for each shard s in order, on shard s's
   stream: wait for the event of shard s - 1's block b, launch K10 on
   the block, copy the block's edges (D, V and the running max of m - bc
   at column c1 - 1, every row) into shard s + 1's edge buffer, record an
   event; so shard s's block b + 1 overlaps shard s + 1's block b.  The
   slice's row state stays on its shard between blocks;
 - every shard's slice of the direction bytes is gathered into one
   native (w1 + 1) x (w2 + 1) buffer on the lead (strided copies), and
   K4 walks it unchanged from the finals of the shard of column w2; only
   the path comes to the host.

Columns are global: a slice's planes are the merge's own, so the
cumulative planes and the band keep their global column numbers, where
famsa_tpu adds each shard's bc offset and scan carry.  The traceback
needs no tiny-merge branch (famsa_tpu's `:279-284` works around its
32 x 32 window; K4 has none).  Every stream order is an event, never a
device-wide synchronize, and every shard has its own stream even on one
card (parallel/mesh.py).  On a mesh of "cpu" shards the same loop runs
dp_shard_plain for each (shard, block).  A shard whose launch or copy
fails raises; nothing retries the merge on one card or on the host.
"""

import torch

from .. import kernels
from ..ops.dp_resident import paths_down, stage0_launch
from ..ops.dp_wide import dp_shard, shard_columns
from ..ops.traceback_torch import trace_paths

# rows of one K10 launch, a block of the pipeline (measured on the H100:
# PERF.md, chip_smoke.py phase 5e)
ROW_BLOCK = 256


def take_resident(profile, device):
    """A side's resident counters (Profile.dev_counters) moved into a
    sharded merge when they lie on `device` (K5 reads them there), else
    None and the host counters are uploaded."""
    ref = profile.dev_counters
    if ref is None or ref.batch.device != torch.device(device):
        return None
    profile.dev_counters = None
    return ref


class _Part:
    """A shard's part of a merge: its columns [cs, c1), its copies of the
    column planes (shard_columns) and row factors, and its outputs and
    scratch (ops/dp_wide.py:dp_shard): the direction bytes of its
    columns, the finals of its last column, its row state and its edge
    buffers in (ein, from the previous shard) and out (eout)."""

    def __init__(self, shard, cs, c1, colf, rowf, w1):
        self.shard, self.cs, self.c1 = shard, cs, c1
        self.done = None
        dev, n = shard.device, c1 - cs
        self.colf = shard_columns(colf, cs, c1, dev)
        self.rowf = torch.empty(rowf.shape, dtype=torch.int64, device=dev)
        self.rowf.copy_(rowf, non_blocking=True)
        self.dirs = torch.empty((w1 + 1, n), dtype=torch.uint8, device=dev)
        self.fin = torch.empty((w1, 3), dtype=torch.int64, device=dev)
        self.state = torch.empty((3, n + 1), dtype=torch.int64, device=dev)
        self.ein = self.eout = None
        kernels.TRAFFIC["bytes_shard"] += (self.colf.numel()
                                           + self.rowf.numel()) * 8


def _sharded(params, p1, p2, mesh, band, block, step):
    """The merge's DP on `mesh` (the module docstring), dispatched without
    waiting.  Returns (parts, full [(w1 + 1) * (w2 + 1)] uint8 and fin
    [1, w1, 3] int64 on the lead, Stage0).  The buffers are used on
    other streams than the ones they were allocated on, so the caller
    keeps them all (parts included) until it has waited for the lead's
    stream, which waits for every shard."""
    w1, w2 = p1.width, p2.width
    if w2 + 1 < mesh.size:
        raise ValueError(f"{w2 + 1} columns cannot fill {mesh.size} shards")
    if block < 1:
        raise ValueError("a row block holds at least one row")
    lead = mesh.lead
    with lead.use():
        dev_pair = (take_resident(p1, lead.device),
                    take_resident(p2, lead.device))
        s0 = stage0_launch(params, [(p1, p2)], [dev_pair], [band])
        full = torch.empty((w1 + 1) * (w2 + 1), dtype=torch.uint8,
                           device=lead.device)
        fin = torch.empty((1, w1, 3), dtype=torch.int64, device=lead.device)
        ready = lead.record()
    parts = []
    for shard, (cs, c1) in zip(mesh.shards, mesh.bounds(w2 + 1)):
        with shard.use():
            shard.wait(ready)
            parts.append(_Part(shard, cs, c1, s0.colf[0],
                               s0.rowf[0, :w1 + 1], w1))
    for a, b in zip(parts, parts[1:]):
        with a.shard.use():
            a.eout = torch.empty((w1, 3), dtype=torch.int64,
                                 device=a.shard.device)
        with b.shard.use():
            b.ein = torch.empty((w1, 3), dtype=torch.int64,
                                device=b.shard.device)
    for r0 in range(1, w1 + 1, block):
        r1 = min(r0 + block, w1 + 1)
        for s, part in enumerate(parts):
            with part.shard.use():
                if s > 0:
                    part.shard.wait(parts[s - 1].done)
                step(part.colf, part.rowf, w1, part.cs, part.c1, r0, r1,
                     part.dirs, part.fin, part.state, ein=part.ein,
                     eout=part.eout)
                if part.eout is not None:
                    parts[s + 1].ein[r0 - 1:r1 - 1].copy_(
                        part.eout[r0 - 1:r1 - 1], non_blocking=True)
                    kernels.TRAFFIC["bytes_shard"] += (r1 - r0) * 24
                part.done = part.shard.record()
    # the gather, on each shard's stream after its last block (and after
    # the lead allocated the buffers); the last shard's finals too
    rows = full.view(w1 + 1, w2 + 1)
    for part in parts:
        with part.shard.use():
            rows[:, part.cs:part.c1].copy_(part.dirs, non_blocking=True)
            kernels.TRAFFIC["bytes_gather"] += part.dirs.numel()
            if part is parts[-1]:
                fin[0].copy_(part.fin, non_blocking=True)
                kernels.TRAFFIC["bytes_gather"] += part.fin.numel() * 8
            part.done = part.shard.record()
    with lead.use():
        for part in parts:
            lead.wait(part.done)
    return parts, full, fin, s0


def dp_profile_sharded(params, p1, p2, mesh, band=None, block=ROW_BLOCK,
                       step=dp_shard):
    """Column-sharded DP of one seq-prof or prof-prof merge of p1 (rows) x
    p2 (columns) on `mesh`, guided when band (core/dp_native.row_ranges)
    is given: the counterpart of famsa_tpu's dp_profile_sharded.  block:
    rows of one K10 launch; step: the per-(shard, block) function (K10's
    wrapper dp_shard, or a function of its arguments such as
    dp_shard_plain).  Returns (dirs [w1 + 1, w2 + 1] uint8 numpy in the
    native layout, fin [w1, 3] int64 numpy: the (D, H, V) of column w2
    of every row; the last row's are the merge's finals)."""
    parts, full, fin, _ = _sharded(params, p1, p2, mesh, band, block, step)
    with mesh.lead.use():
        return (full.view(p1.width + 1, p2.width + 1).cpu().numpy(),
                fin[0].cpu().numpy())


def dp_profile_sharded_paths(params, p1, p2, mesh, band=None,
                             block=ROW_BLOCK, step=dp_shard):
    """Column-sharded DP and the device traceback (K4 on the gathered
    direction bytes) of one merge, as dp_profile_sharded (the counterpart
    of famsa_tpu's dp_profile_sharded_paths): only the path and total
    come to the host.  A side's resident counters are moved into the
    merge (take_resident).  Returns a PathResult (no merged counters:
    the caller constructs the profile on the host)."""
    parts, full, fin, s0 = _sharded(params, p1, p2, mesh, band, block,
                                    step)
    with mesh.lead.use():
        out = trace_paths(full, fin, s0.meta, meta_host=s0.meta_h)
        return paths_down(out, s0.meta_h).resolve()[0]

