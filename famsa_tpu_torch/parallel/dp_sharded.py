"""The column axis of multi-device sharding: one profile merge's DP with
its columns split across the shards of a mesh (parallel/mesh.py).

The counterpart of famsa_tpu/parallel/dp_sharded.py (`:40
_sharded_program`, `:197 dp_profile_sharded`, `:255
dp_profile_sharded_paths`).  famsa_tpu runs the whole row loop as one
shard_map program, every row in lockstep over its shards: a halo of one
column a row (ppermute), the H channel's max-plus scan in two phases (a
local cummax and a carry all-gathered across shards) and the bc
cumsum's offsets.  Here the merge's DP is one wavefront across the
shards' slices, the design of FAMSA's own parallel engine, column stripes
in a wavefront (profile_par.cpp:214-230), run by kernel K10
(ops/dp_wide.py:dp_shard, csrc/dp_wide.cu):

 - the lead builds the merge's column and row factors once, with K5 on
   its resident sides (ops/dp_resident.py:stage0_launch); each shard
   copies its slice [cs, c1) of the column planes (Mesh.bounds: the
   merge's w2 + 1 columns in contiguous slices, no pad column) and the
   whole of the row factors, band included, to its own device;
 - the slices of each device form one ShardTable (ops/dp_wide.py): a
   ticket counter, the slices' arguments and their counts of edge rows
   published, uploaded once the shards allocated their buffers; then one
   K10 launch a shard, in pipeline order (or `order`), each on its
   shard's stream after its device's copies and every table's upload.  A
   launch is one cluster that takes the next ticket of its device's table
   and runs that slice over every row, its row state in registers: after
   each wavefront step it writes the step's edge rows (D, V and the
   running max of m - bc at column c1 - 1) into the next slice's edge
   buffer, on that slice's device, and releases their count; the next
   slice spins on the count before each step.  Tickets are taken in
   pipeline order, so a cluster only waits on one that started before
   it: no launch order and no number of clusters the card can hold at
   once makes a spin deadlock.  A slice on another card than the next one
   writes through peer access (enable_peer; mesh.py:cols_mesh refuses a
   mesh of two cards without it);
 - every shard's slice of the direction bytes is gathered into one
   native (w1 + 1) x (w2 + 1) buffer on the lead (strided copies, each
   after every launch of its device: any of them may have run the
   slice), and K4 walks it unchanged from the finals of the shard of
   column w2; only the path comes to the host.

Columns are global: a slice's planes are the merge's own, so the
cumulative planes and the band keep their global column numbers, where
famsa_tpu adds each shard's bc offset and scan carry.  The traceback
needs no tiny-merge branch (famsa_tpu's `:279-284` works around its
32 x 32 window; K4 has none).  Every stream order is an event, never a
device-wide synchronize, and every shard has its own stream even on one
card (parallel/mesh.py).  On a mesh of "cpu" shards the same tickets run
K10's plain version dp_shard_plain, a slice at a time; given `block`, a
mesh of "cpu" shards runs instead the (shard, block) pipeline of
`step` (dp_shard_plain by default) over blocks of `block` rows, each
slice's row state carried between its blocks: the oracle the card's
route is held to.  A shard whose launch or copy fails raises; nothing
retries the merge on one card or on the host.
"""

import torch

from .. import kernels
from ..ops.dp_resident import paths_down, stage0_launch
from ..ops.dp_wide import (ShardSlice, dp_shard, dp_shard_plain,
                           enable_peer, shard_columns, shard_tables)
from ..ops.traceback_torch import trace_paths
from .mesh import check_peers


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
    column planes (shard_columns) and row factors, its outputs (the
    direction bytes of its columns, the finals of its last column) and
    its edge buffer in (ein, written by the previous shard; None on the
    first); `state`, the row state between blocks, on the block
    pipeline only."""

    def __init__(self, shard, cs, c1, colf, rowf, w1, blocks):
        self.shard, self.cs, self.c1 = shard, cs, c1
        self.done = None
        dev, n = shard.device, c1 - cs
        self.colf = shard_columns(colf, cs, c1, dev)
        self.rowf = torch.empty(rowf.shape, dtype=torch.int64, device=dev)
        self.rowf.copy_(rowf, non_blocking=True)
        self.dirs = torch.empty((w1 + 1, n), dtype=torch.uint8, device=dev)
        self.fin = torch.empty((w1, 3), dtype=torch.int64, device=dev)
        self.ein = (torch.empty((w1, 3), dtype=torch.int64, device=dev)
                    if cs > 0 else None)
        self.state = (torch.empty((3, n + 1), dtype=torch.int64, device=dev)
                      if blocks else None)
        kernels.TRAFFIC["bytes_shard"] += (self.colf.numel()
                                           + self.rowf.numel()) * 8


def _blocks(parts, w1, block, step):
    """The (shard, block) pipeline on a mesh of "cpu" shards: for each
    block of rows, each slice in order, its edges into the next slice's
    buffer and its row state kept for its next block."""
    for r0 in range(1, w1 + 1, block):
        r1 = min(r0 + block, w1 + 1)
        for s, part in enumerate(parts):
            nxt = parts[s + 1].ein if s + 1 < len(parts) else None
            step(part.colf, part.rowf, w1, part.cs, part.c1, r0, r1,
                 part.dirs, part.fin, part.state, ein=part.ein, eout=nxt)


def _tickets(parts, w1, order):
    """K10 once a shard (the module docstring): the device tables, their
    uploads, and the launches in `order`, each on its shard's stream
    after its device's copies and every upload; each shard's `done` then
    marks every launch of its device."""
    slices = [ShardSlice(p.colf, p.rowf, p.dirs, p.fin, p.ein,
                         parts[s + 1].ein if s + 1 < len(parts) else None,
                         p.cs, p.c1) for s, p in enumerate(parts)]
    tables, of = shard_tables(slices, w1)
    cuda = parts[0].shard.device.type == "cuda"
    first, copied, uploads = {}, {}, []
    for part in parts:              # each device's shards' copies
        first.setdefault(part.shard.device, part.shard)
        copied.setdefault(part.shard.device, []).append(part.shard.record())
    for a, b in zip(parts, parts[1:]):
        if cuda and a.shard.device != b.shard.device:
            enable_peer(a.shard.device, b.shard.device)
    if cuda:                        # every table allocated before any is
        for table in tables:        # filled: they point at each other
            with first[table.device].use():
                table.alloc()
        for table in tables:
            with first[table.device].use():
                table.upload()
                uploads.append(first[table.device].record())
    for s in order:
        part = parts[s]
        with part.shard.use():
            for event in copied[part.shard.device] + uploads:
                part.shard.wait(event)
            dp_shard(of[s])
            part.done = part.shard.record()
    for part in parts:              # the gather follows every launch of
        with part.shard.use():      # its device
            for other in parts:
                if other.shard.device == part.shard.device:
                    part.shard.wait(other.done)
    return tables


def _sharded(params, p1, p2, mesh, band, block, step, order):
    """The merge's DP on `mesh` (the module docstring), dispatched without
    waiting.  Returns (keep, full [(w1 + 1) * (w2 + 1)] uint8 and fin
    [1, w1, 3] int64 on the lead, Stage0).  The buffers are used on
    other streams than the ones they were allocated on, so the caller
    keeps them all (keep: the parts and tables) until it has waited for
    the lead's stream, which waits for every shard."""
    w1, w2 = p1.width, p2.width
    if w2 + 1 < mesh.size:
        raise ValueError(f"{w2 + 1} columns cannot fill {mesh.size} shards")
    cpu = mesh.lead.device.type == "cpu"
    if block is not None and (block < 1 or not cpu):
        raise ValueError("row blocks of one row or more run on a mesh of "
                         "cpu shards only")
    order = list(range(mesh.size)) if order is None else list(order)
    if sorted(order) != list(range(mesh.size)):
        raise ValueError(f"order must be a permutation of the {mesh.size} "
                         "shards")
    check_peers(mesh)
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
                               s0.rowf[0, :w1 + 1], w1, block is not None))
    tables = (_blocks(parts, w1, block, step) if block is not None
              else _tickets(parts, w1, order))
    # the gather, on each shard's stream after its device's launches (and
    # after the lead allocated the buffers); the last shard's finals too
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
    return (parts, tables), full, fin, s0


def dp_profile_sharded(params, p1, p2, mesh, band=None, block=None,
                       step=dp_shard_plain, order=None):
    """Column-sharded DP of one seq-prof or prof-prof merge of p1 (rows) x
    p2 (columns) on `mesh`, guided when band (core/dp_native.row_ranges)
    is given: the counterpart of famsa_tpu's dp_profile_sharded.  K10
    once a shard, launched in `order` (a permutation of the shards;
    default pipeline order); block (a mesh of "cpu" shards only): run the
    (shard, block) pipeline of `step` (dp_shard_plain or a function of its
    arguments) over blocks of `block` rows instead.  Returns (dirs [w1 +
    1, w2 + 1] uint8 numpy in the native layout, fin [w1, 3] int64 numpy:
    the (D, H, V) of column w2 of every row; the last row's are the
    merge's finals)."""
    keep, full, fin, _ = _sharded(params, p1, p2, mesh, band, block, step,
                                  order)
    with mesh.lead.use():
        return (full.view(p1.width + 1, p2.width + 1).cpu().numpy(),
                fin[0].cpu().numpy())


def dp_profile_sharded_paths(params, p1, p2, mesh, band=None, block=None,
                             step=dp_shard_plain):
    """Column-sharded DP and the device traceback (K4 on the gathered
    direction bytes) of one merge, as dp_profile_sharded (the counterpart
    of famsa_tpu's dp_profile_sharded_paths): only the path and total
    come to the host.  A side's resident counters are moved into the
    merge (take_resident).  Returns a PathResult (no merged counters:
    the caller constructs the profile on the host)."""
    keep, full, fin, s0 = _sharded(params, p1, p2, mesh, band, block,
                                   step, None)
    with mesh.lead.use():
        out = trace_paths(full, fin, s0.meta, meta_host=s0.meta_h)
        return paths_down(out, s0.meta_h).resolve()[0]
