"""A single-process device mesh, one Prim round on it (the row axis) and
the routing rules of both axes.

The counterpart of famsa_tpu/parallel/mesh.py:32-58 (make_mesh,
auto_mesh), :85 (prim_round_sharded) and :145 (dp_row_sharded, the
"cols" axis's row step, here a plain function; the column-sharded DP
itself is parallel/dp_sharded.py).  famsa_tpu's mesh is one controller
process driving jax.devices(); so is this one.  A Mesh is an ordered
list of shards, each a torch.device with a CUDA stream of its own,
driven from one thread; shard 0 is the lead.  A device may appear more
than once, each time with its own stream, so one card can hold a mesh of
several shards: every launch, copy and cross-stream wait of the route
then runs on it (only copies between distinct cards do not; a shard on
another card than the lead's issues those on a second stream of its own,
on the lead's card).  Work on one shard is ordered by its streams, work
across shards by CUDA events (recorded on one stream, waited for on
another), never by a device-wide synchronize.  On the CPU a shard has no
stream and its work is done when it is issued.  A run takes the route
only on a mesh a caller set (auto_mesh), never by itself.

A Prim round on the mesh (prim_round_sharded, the tree's inputs in
PrimShards): shard s holds the query columns [s0, s1) of the mask table
(and, for a family with a flagged sequence, its rows of the padded
symbols and the global flags).  Each round every shard, on its own
stream, waits for the lead's event of the previous round's K8, copies
the round's reference id and row from the lead, launches K1 wave on its
columns (then K9, which returns at once unless the reference is
flagged), copies its [1, n_s] LCS into columns [s0, s1) of the lead's
round row and records an event.  The lead waits for every shard's event
and runs K8 over the whole row, unchanged.  Gathering the row keeps K8's
lexicographic (dist, tieb, vertex) argmin exactly as it is, where
famsa_tpu all-gathers each shard's argmin candidate.
"""

import contextlib
import os

import numpy as np
import torch

from ..ops.distance import _pow075_table
from ..ops.lcs_torch import build_query_mask_table, lcs_refmask, lcs_rows
from ..ops.prim_torch import PrimState, prim_round


class Shard:
    """One shard of a Mesh: a torch.device and, on a CUDA device, a stream
    of its own (none with stream=False: its work then goes to the
    device's current stream).  A shard on another card than the lead's
    also owns a stream on the lead's card (link).  PyTorch runs a copy
    between two cards on the source card's current stream, behind a
    two-way barrier with the destination card's current stream; use()
    makes both of those the shard's own streams, so that the barriers
    order this shard's work alone and not the lead's stream or the other
    shards'."""

    def __init__(self, device, lead=None, stream=True):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda" and stream
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.link = (torch.cuda.Stream(lead) if cuda and lead is not None
                     and torch.device(lead) != self.device else None)

    @contextlib.contextmanager
    def use(self):
        """A context in which torch work and kernel launches go to this
        shard's device and stream, and its copies from and to the lead's
        card to its link stream."""
        with contextlib.ExitStack() as stack:
            for s in (self.link, self.stream):
                if s is not None:
                    stack.enter_context(torch.cuda.stream(s))
            yield

    def record(self):
        """An event marking the work issued on this shard's stream so far
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(self.stream if self.stream is not None
                     else torch.cuda.current_stream(self.device))
        return event

    def wait(self, event):
        """Make the work issued on this shard's streams from now on wait
        for `event` (recorded by record() on any shard of the mesh)."""
        if event is not None:
            for s in (self.link, self.stream):
                if s is not None:
                    s.wait_event(event)


class Mesh:
    """An ordered list of shards; shard 0 is the lead."""

    def __init__(self, shards):
        self.shards = list(shards)

    @property
    def size(self):
        return len(self.shards)

    @property
    def lead(self):
        return self.shards[0]

    def bounds(self, n):
        """[(s0, s1)] of each shard for n rows: contiguous slices, the
        first n % size of them one row longer; no pad rows."""
        s = self.size
        cuts = [k * (n // s) + min(k, n % s) for k in range(s + 1)]
        return list(zip(cuts[:-1], cuts[1:]))


def make_mesh(devices):
    """A mesh of one shard a device of `devices` (torch.device or str, one
    device type; a device may repeat, each shard with its own stream; the
    first is the lead's)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError("a mesh holds devices of one type")
    if devices[0].type == "cuda":
        devices = [torch.device("cuda", torch.cuda.current_device()
                                if d.index is None else d.index)
                   for d in devices]
    return Mesh(Shard(d, lead=devices[0]) for d in devices)


_AUTO_MESH = {}


def auto_mesh(axis="rows", device="cuda"):
    """The mesh a run on `device` shards `axis` over: the one a caller set
    in the cache, _AUTO_MESH[axis], when its devices are of `device`'s
    type; else None, and the run stays on one device.  Unlike famsa_tpu's
    auto_mesh it takes no visible device by itself: here the host issues
    every round shard by shard, and on one H100 a Prim round of the
    sharded route costs the host several times what one card's route
    does (PERF.md, section 6), with no multi-card run showing a gain."""
    mesh = _AUTO_MESH.get(axis)
    if mesh is None or mesh.lead.device.type != torch.device(device).type:
        return None
    return mesh


def rows_mesh(n, device="cuda"):
    """The mesh a run of n sequences on `device` shards its rows (the Prim
    rounds, the distance rows) over: auto_mesh("rows", device) when it
    has no more shards than there are sequences, else None."""
    mesh = auto_mesh("rows", device)
    return mesh if mesh is not None and n >= mesh.size else None


# A profile merge of at least FAMSA_TORCH_SHARD_DP_CELLS DP cells (read
# per call) shards its columns over the "cols" mesh a caller set: the
# counterpart of famsa_tpu's FAMSA_TPU_SHARD_DP_CELLS
# (famsa_tpu/core/aligner.py:22-24), with its default
SHARD_DP_CELLS_DEFAULT = "2e8"


def check_peers(mesh):
    """Raise unless each CUDA shard of a "cols" mesh can reach the memory
    of the next shard's card where that is another card: K10's edges
    cross there through peer access (parallel/dp_sharded.py), and no
    other route takes the merge's place."""
    devices = [shard.device for shard in mesh.shards]
    for a, b in zip(devices, devices[1:]):
        if (a.type == "cuda" and a != b
                and not torch.cuda.can_device_access_peer(a, b)):
            raise ValueError(f"a cols mesh from {a} to {b} needs peer "
                             "access between the two cards, which they lack")


def cols_mesh(p1, p2, device="cuda"):
    """The mesh a merge of p1 (its DP rows) and p2 (its columns), in
    align_into's operand order, on `device` shards its DP columns over
    (parallel/dp_sharded.py): auto_mesh("cols", device) when the merge
    has at least FAMSA_TORCH_SHARD_DP_CELLS cells and every shard's
    slice of its p2.width + 1 columns holds 1 to MAX_W2 + 1 columns (K10
    on one cluster of the widest body, the stripes body), else None.
    Raises for a mesh over two cards without peer access (check_peers).
    The one rule of the route's call sites (core/aligner.py:align_into
    and split_sharded)."""
    from ..ops.dp_wide import MAX_W2
    mesh = auto_mesh("cols", device)
    if mesh is None:
        return None
    check_peers(mesh)
    min_cells = int(float(os.environ.get("FAMSA_TORCH_SHARD_DP_CELLS",
                                         SHARD_DP_CELLS_DEFAULT)))
    cols = p2.width + 1
    if (p1.width * p2.width < min_cells or cols < mesh.size
            or -(-cols // mesh.size) > MAX_W2 + 1):
        return None
    return mesh


class _PrimPart:
    """A shard's part of a Prim tree: its columns [s0, s1) of the query
    mask table; its copies of the round's reference id (cur) and row
    (ref), which K8 never aliases; and, for a family with a flagged
    sequence, its rows of the padded symbols and all n flags (K9 reads
    flags[cur] with cur global)."""

    def __init__(self, shard, s0, s1, padded, flags):
        self.shard, self.s0, self.s1 = shard, s0, s1
        self.done = None
        dev = shard.device
        with shard.use():
            self.table = torch.from_numpy(build_query_mask_table(
                padded[s0:s1]).view(np.int32)).to(dev)
            self.cur = torch.zeros(1, dtype=torch.int64, device=dev)
            self.ref = torch.empty((1, padded.shape[1]), dtype=torch.int32,
                                   device=dev)
            self.flags = self.queries = None
            if flags is not None:
                self.flags = torch.from_numpy(flags).to(dev)
                self.queries = torch.from_numpy(
                    padded[s0:s1].astype(np.int32)).to(dev)


class PrimShards:
    """One Prim tree's inputs on a mesh.  The lead holds what K8 reads
    (the padded symbols, lengths, the host's pow(i, 0.75) table as
    pow_tab), the round state (a PrimState, updated in place) and the
    round's LCS row; each shard holds a _PrimPart.  padded: [n, L] int8
    symbols, L a multiple of 32, n >= the mesh's size; lengths [n] int64;
    flags: None, or [n] bool (famsa_flags, some set)."""

    def __init__(self, mesh, padded, lengths, flags=None):
        n = padded.shape[0]
        if n < mesh.size:
            raise ValueError(f"{n} sequences cannot fill {mesh.size} shards")
        self.mesh = mesh
        lead = mesh.lead
        dev = lead.device
        with lead.use():
            self.queries = torch.from_numpy(padded.astype(np.int32)).to(dev)
            self.lengths = torch.from_numpy(lengths).to(dev)
            self.pow_tab = torch.from_numpy(_pow075_table(
                2 * int(lengths.max()), np.float64)).to(dev)
            self.state = PrimState(self.queries)
            self.row = torch.empty((1, n), dtype=torch.int32, device=dev)
            self.ready = lead.record()
        self.parts = [_PrimPart(sh, s0, s1, padded, flags)
                      for sh, (s0, s1) in zip(mesh.shards, mesh.bounds(n))]


def prim_round_sharded(prim, edges, slot):
    """One Prim round of `prim` (a PrimShards) on its mesh, with no host
    wait: every shard's LCS of the round's reference into its columns of
    the lead's row, then K8 on the lead (ops/prim_torch.py:prim_round),
    which updates prim.state in place and writes slot `slot` of edges
    ([3, k] int64 on the lead).  Launches K1 wave (and, for a flagged
    family, K9) once a shard and K8 once."""
    st = prim.state
    for part in prim.parts:
        shard = part.shard
        with shard.use():
            # the copies (on the link stream for a shard on another card)
            # and the row write follow K8 of the last round, which
            # updated cur and ref and read the row
            shard.wait(prim.ready)
            part.cur.copy_(st.cur, non_blocking=True)
            part.ref.copy_(st.ref, non_blocking=True)
            lcs = lcs_rows(part.table, part.ref, variant="wave")
            if part.flags is not None:
                lcs_refmask(part.ref, part.queries, out=lcs, cur=part.cur,
                            flags=part.flags)
            prim.row[:, part.s0:part.s1].copy_(lcs, non_blocking=True)
            part.done = shard.record()
    lead = prim.mesh.lead
    with lead.use():
        for part in prim.parts:
            lead.wait(part.done)
        prim_round(prim.row, prim.lengths, prim.pow_tab, prim.queries,
                   st.cur, st.dist, st.tieb, st.active, st.ref, edges, slot)
        prim.ready = lead.record()


def dp_row_sharded(prevD, prevH, prevV, t_row, gh_start, gh_cont, gv_start,
                   gv_cont, delta_row, tvx_row):
    """One DP row over column-sharded state, the counterpart of
    famsa_tpu/parallel/mesh.py:145 dp_row_sharded (the interior form: no
    boundary column, no band, no directions; famsa_tpu reaches it only
    from its own test).  Every argument is a list of 1-D int64 tensors,
    one a shard, in column order (the shards' slices of the row).  D and
    V read the previous row (D at j - 1, through a halo of the left
    shard's last column, -inf left of the first shard); H is the
    max-plus prefix scan H[j] = max(max(D[j-1], V[j-1]) + gh_start[j],
    H[j-1] + gh_cont[j]) in two phases: each shard's local cummax of
    m - bc, then the exclusive combine of the shards' (totals, bests)
    before it, re-expressed in its own frame.  Returns (D, H, V), lists
    of tensors like the inputs."""
    neg = torch.tensor(-(1 << 62), dtype=torch.int64)
    size = len(prevD)

    def halo(xs):
        # each slice shifted right a column, the left shard's last column
        # (-inf left of the first) entering it
        lefts = [neg.reshape(1)] + [x[-1:] for x in xs[:-1]]
        return [torch.cat([left, x[:-1]]) for left, x in zip(lefts, xs)]

    def pick3(a, b, c):
        pa = (a > b) & (a > c)
        pb = ~pa & (b > c)
        return torch.where(pa, a, torch.where(pb, b, c))

    pD_l, pH_l, pV_l = halo(prevD), halo(prevH), halo(prevV)
    D = [pick3(pD_l[s] + t_row[s], pH_l[s] + t_row[s] + delta_row[s],
               pV_l[s] + t_row[s] + tvx_row[s]) for s in range(size)]
    V = [pick3(prevD[s] + gv_start[s], prevH[s] + gv_start[s],
               prevV[s] + gv_cont[s]) for s in range(size)]
    D_l, V_l = halo(D), halo(V)
    m = [torch.maximum(D_l[s], V_l[s]) + gh_start[s] for s in range(size)]
    bc = [torch.cumsum(g, 0) for g in gh_cont]
    run = [torch.cummax(m[s] - bc[s], 0).values for s in range(size)]
    # offs[r]: the sum of the shards' bc totals before shard r
    offs = [torch.zeros((), dtype=torch.int64)]
    for b in bc[:-1]:
        offs.append(offs[-1] + b[-1])
    H = []
    for s in range(size):
        # shard r's best is run[r][-1] - offs[r] in the global frame, and
        # that + offs[s] in shard s's
        carry = neg
        for r in range(s):
            carry = torch.maximum(carry, run[r][-1] - offs[r] + offs[s])
        H.append(bc[s] + torch.maximum(run[s], carry))
    return D, H, V
