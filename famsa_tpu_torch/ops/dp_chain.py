"""The chain route: caterpillar runs of serial merges as device-resident
chunks.

In a caterpillar stretch of a guide tree merge k+1 takes the profile of
merge k and one leaf, so its merges cannot be batched.  The pipeline
(pipeline.py) hands such a run to this module in chunks of up to
CHAIN_K merges.  A chunk is three device operations, with no host read:
one pinned upload of its leaves' symbol bytes and widths, one replay of
a CUDA graph and one copy of its paths down.  The graph holds, for each
step, stage 0 (K5's chain entry, csrc/stage0.cu:stage0_chain, which
first runs the chain's carry, csrc/chain.cuh: it folds the previous
step into the chain's state and writes the step's header and side
descriptors), the DP (K2's staged variant with B = 1 up to a capacity
of 8191 columns, else its stripes variant with B = 1, csrc/dp_wide.cu;
both read the step's widths from its meta), the traceback (K4) and the
merged counters (K6), which write the chain's counters into the other
of two ping-pong carry buffers; then K7 (csrc/chain.cu), the same carry
once more, folds the last step.  The chain's counters, width and
cardinality stay on the card from step to step and from chunk to chunk.

Port of famsa_tpu/ops/dp_chain.py: the constants (:44-66; all but
CHAIN_W1P are environment knobs read at each call), ChainState (:129-158),
dispatch_chain_chunk (:161-193) and _dp_chain_scan (:74), whose scan
carry (:81-101) and want_width (ops/dp_giant.py:477-479) are the carry
(K5's chain entry, K7).  Left
out as TPU compile workarounds: prewarm (:197-245) and _seed_state's
fixed row padding.  The score table is dp_resident._score_table, keyed
by content (not by id, as famsa_tpu's _sm_dev is).

Capacities.  A chunk is captured for a capacity `cap` (CHAIN_CAPS), the
widest chain profile its steps may read; the pipeline picks the
smallest that covers the width known at the last resolve plus
CHAIN_MARGIN for each chunk in flight and the new one, and aborts the
run when none does (CHAIN_CAPS[-1] is famsa_tpu's 8 * 2048 - 128).  A
step whose merged width passes `cap` poisons the chain on the card:
every kernel of every later step returns at once, and the host, which
sees the overflow when it builds that merge, requeues the rest and seeds
the chain again from its last host profile.

Buffers.  One ChainBuffers per (device, K, CHAIN_W1P, widest capacity)
holds every static buffer the chunks read and write, sized for the
widest capacity; each capacity's graph (ChainGraph) uses a prefix of
them, and all replays are ordered on one stream.  The chain's final
counters are copied out of the carry buffer (final_ref) before the
profile keeps them, so no later replay overwrites them.

On CPU tensors the chunk runs chunk_plain: the same steps on the same
buffers with every kernel's plain twin.
"""

import os

import numpy as np
import torch

from .. import kernels
from .dp_pack import NCOLF, NROWF
from .dp_resident import MergedRef, PathResult, _leaf_symbols, _score_table
from .dp_stage0 import TABLE_ROWS, stage0_plain
from .dp_wide import (BLK, dp_wide_plain, fold_geometry, k3_variant,
                      launch_key)
from .merged_torch import merged_from_paths_plain
from .sides import (DESC_WORDS, SIDE_LEAF, SIDE_RESIDENT, LaunchSides,
                    read_sides_plain)
from .traceback_torch import PATH_TRAILER, trace_paths_plain

# the padded leaf row (a multiple of 16), a constant as in famsa_tpu
CHAIN_W1P = 1024
# defaults of the FAMSA_TORCH_* knobs (famsa_tpu's values): the route on
# or off, merges a chunk (even: a full chunk leaves the carry in the
# buffer the next one starts from), the width below which a run's merges
# stay on the native host DP, the shortest run taken, and the width
# margin a chunk in flight
CHAIN = 1
CHAIN_K = 32
CHAIN_MIN_W2 = 1536
CHAIN_MIN_LEN = 64
CHAIN_MARGIN = 512
# capacities a chunk is captured for: K2 staged up to STAGED_MAX_W2 (8191:
# 8 and 16 folds), K2 stripes past it; the last is the widest chain
# profile the route takes
CHAIN_CAPS = (2047, 4095, 8191, 16256)
NOT_RUN = -2                # a step's recorded width when it did not run
STATE_SLOT = 4              # int64 words of a slot of the chain's state


def knob(name):
    """FAMSA_TORCH_<name> from the environment at the call, else this
    module's <name> (e.g. knob("CHAIN_MIN_W2"))."""
    return int(float(os.environ.get(f"FAMSA_TORCH_{name}", globals()[name])))


def cap_for(w2):
    """The smallest capacity that covers a chain profile of w2 columns,
    or None past the widest."""
    return next((c for c in CHAIN_CAPS if w2 <= c), None)


def dp_variant(cap):
    """The chunk's DP kernel: "staged" (K2 staged, B = 1) or "stripes" (K2
    stripes, B = 1), the body K3 takes at a width of cap."""
    return k3_variant(cap)


def path_stride(w1p, cap):
    """Bytes a step of K4's output takes in a chunk: its trailer and the
    longest path, w1p + cap, rounded up to 16."""
    return -(-(PATH_TRAILER + w1p + cap) // 16) * 16


class ChainBuffers:
    """The static buffers of one device's chain chunks, sized for the
    widest capacity max_cap (every one zero at first):
      inp    uint8: the K leaf rows [K, w1p] (symbol bytes) then lw [K]
             int64, their widths (0: an invalid lane); the chunk's upload
      st     [2, 4] int64 (flat): two slots of the chain's width,
             cardinality and poison; the carry before step k < K reads
             slot k % 2 and writes the other, the fold after the last
             step (K7) updates slot 0 in place, so a chunk starts and
             ends in slot 0 (st[:3])
      hdr    [K, 8] int64, desc [K, 2, DESC_WORDS] int64: each step's
             header and side descriptors (the carry)
      table  [25, 32] int64: the score table (dp_stage0.score_table)
      carry  [2, max_cap+1, 32] int32: the chain's counters, even steps
             read carry[0] and odd ones carry[1]; K6 writes the other
      colf, rowf, meta, dirs, fin: one step's K5 output and DP output
      out    uint8: K4's output of step j at j * ps, then widths [K]
             int32 (the carry's record of each step's merged width)
    graphs: {cap: ChainGraph}."""

    def __init__(self, device, k, w1p, max_cap):
        if k < 2 or k % 2:
            raise ValueError(f"a chunk takes an even number of merges, not "
                             f"{k}")
        if w1p % 16:
            raise ValueError(f"the leaf row {w1p} must be a multiple of 16")
        self.device, self.k, self.w1p, self.max_cap = device, k, w1p, max_cap

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.inp = zeros(k * w1p + 8 * k, dtype=torch.uint8)
        self.leaf = self.inp[:k * w1p].view(k, w1p)
        self.lw = self.inp[k * w1p:].view(torch.int64)
        self.st = zeros(2 * STATE_SLOT, dtype=torch.int64)
        self.hdr = zeros(k, 8, dtype=torch.int64)
        self.desc = zeros(k, 2, DESC_WORDS, dtype=torch.int64)
        self.table = zeros(TABLE_ROWS, 32, dtype=torch.int64)
        self.carry = zeros(2, max_cap + 1, 32, dtype=torch.int32)
        self.colf = zeros(NCOLF * (-(-(max_cap + 1) // 2) * 2),
                          dtype=torch.int64)
        self.rowf = zeros(1, w1p + 1, NROWF, dtype=torch.int64)
        self.meta = zeros(1, 4, dtype=torch.int64)
        self.dirs = zeros((w1p + 1) * (max_cap + 1), dtype=torch.uint8)
        self.fin = zeros(1, w1p, 3, dtype=torch.int64)
        self.out = zeros(k * path_stride(w1p, max_cap) + 4 * k,
                         dtype=torch.uint8)
        self.graphs = {}

    def out_bytes(self, cap):
        """Bytes of `out` a chunk of capacity cap copies down."""
        return self.k * path_stride(self.w1p, cap) + 4 * self.k

    def widths(self, cap):
        """[K] int32 view of the carry's record of a chunk of capacity
        cap."""
        at = self.k * path_stride(self.w1p, cap)
        return self.out[at:at + 4 * self.k].view(torch.int32)

    def graph(self, cap):
        """The chunk program of capacity cap (ChainGraph), made once."""
        if cap > self.max_cap:
            raise ValueError(f"capacity {cap} past the buffers' {self.max_cap}")
        if cap not in self.graphs:
            self.graphs[cap] = ChainGraph(self, cap)
        return self.graphs[cap]


_BUFFERS = {}


def buffers(device, k, w1p):
    """The shared ChainBuffers of a device (a torch.device or its name),
    chunk size and leaf row."""
    device = torch.device(device)
    key = (str(device), k, w1p, CHAIN_CAPS[-1])
    if key not in _BUFFERS:
        _BUFFERS[key] = ChainBuffers(device, k, w1p, CHAIN_CAPS[-1])
    return _BUFFERS[key]


def state_slots(k, nk):
    """(read, written) slot of the chain's state for the carry before
    step k of a chunk of nk steps (csrc/chain.cuh): k % 2 and the other,
    and for the fold after the last step (k = nk, even) slot 0 both."""
    return k % 2, (k + 1) % 2 if k < nk else k % 2


def chain_carry_plain(bufs, k, cap):
    """Plain PyTorch twin of the chain's carry (csrc/chain.cuh:fold: K5's
    chain entry before step k < K, K7 after the last step, k = K) on the
    same buffers: fold step k-1 into the state (k > 0), read from one
    slot and written to the other (state_slots), then write step k's
    header and descriptors (k < K)."""
    src, dst = (STATE_SLOT * x for x in state_slots(k, bufs.k))
    w, card, poison = (int(x) for x in bufs.st[src:src + 3].tolist())
    if k > 0:
        rec = NOT_RUN
        if int(bufs.hdr[k - 1, 0]) >= 1:
            at = (k - 1) * path_stride(bufs.w1p, cap) + 8
            n = int(bufs.out[at:at + 4].view(torch.int32)[0])
            rec = n
            if n < 0 or n > cap:
                poison = 1
            if n >= 0:
                w, card = n, card + 1
        bufs.widths(cap)[k - 1] = rec
    bufs.st[dst:dst + 3] = torch.tensor([w, card, poison])
    if k >= bufs.k:
        return
    lw = int(bufs.lw[k])
    w1 = lw if poison == 0 and lw >= 1 else 0
    bufs.hdr[k] = torch.tensor([w1, w, 0, 0, 1, card, 0, 0])
    leaf = bufs.leaf.data_ptr() + k * bufs.w1p
    carry = bufs.carry[k % 2].data_ptr()
    bufs.desc[k] = torch.tensor([[SIDE_LEAF, leaf, 1, w1, 1, 0, 0, 0],
                                 [SIDE_RESIDENT, carry, 32, w, card, 0, 0,
                                  0]])


def chain_carry(bufs, k, cap):
    """The chain's carry before step k of a chunk of capacity cap as a
    launch of its own (k = K: after the last step, the one K7 launch of a
    chunk; before a step K5's chain entry runs it).  CUDA buffers launch
    kernel K7 on the current stream; CPU buffers run chain_carry_plain."""
    if not 0 <= k <= bufs.k:
        raise ValueError(f"step {k} outside a chunk of {bufs.k}")
    if bufs.device.type == "cpu":
        return chain_carry_plain(bufs, k, cap)
    if bufs.device.type != "cuda":
        raise ValueError(f"unsupported device {bufs.device}")
    if not torch.cuda.is_current_stream_capturing():
        kernels.LAUNCHES["chain"] += 1
    stream = torch.cuda.current_stream(bufs.device).cuda_stream
    err = kernels.get("chain").chain_carry(
        bufs.leaf.data_ptr(), bufs.lw.data_ptr(), bufs.st.data_ptr(),
        bufs.out.data_ptr(), path_stride(bufs.w1p, cap),
        bufs.widths(cap).data_ptr(), bufs.hdr.data_ptr(),
        bufs.desc.data_ptr(), bufs.carry[0].data_ptr(),
        bufs.carry[1].data_ptr(), cap, bufs.w1p, k, bufs.k, stream)
    kernels.check(err, "chain_carry")


def chunk_plain(params, bufs, cap):
    """Plain PyTorch version of a chunk's graph on the same buffers, any
    device: per step the plain twin of K5's chain entry (chain_carry_plain,
    then, when the step runs, stage0_plain on the descriptor reader), of
    the DP (dp_wide_plain over the capacity's folds), of K4
    (trace_paths_plain, written at the step's place in `out`) and of K6
    (merged_from_paths_plain, into the other carry buffer); a last
    chain_carry_plain (K7's twin) folds the last step."""
    ps = path_stride(bufs.w1p, cap)
    _, threads, stripe = fold_geometry(cap)
    for s in range(bufs.k):
        chain_carry_plain(bufs, s, cap)
        w1, w2 = (int(x) for x in bufs.hdr[s, :2].tolist())
        if w1 < 1:
            continue
        hdr = bufs.hdr[s:s + 1]
        # the plain readers resolve the descriptors' addresses in the leaf
        # rows and the carry buffers
        sides = LaunchSides(bufs.desc[s], bufs.desc[s].cpu().numpy(),
                            [bufs.inp, bufs.carry])
        colf, rowf, meta = stage0_plain(params, *read_sides_plain(sides),
                                        hdr, bufs.table)
        dirs, fin = dp_wide_plain(colf, rowf, meta, (w1 + 1) * (w2 + 1),
                                  fold_cols=threads * stripe)
        out = trace_paths_plain(dirs, fin, meta)
        bufs.out[s * ps:s * ps + out.numel()] = out
        merged = merged_from_paths_plain(sides, out, hdr, cap)
        bufs.carry[(s + 1) % 2, :cap + 1] = merged[0]
    chain_carry_plain(bufs, bufs.k, cap)


class ChainGraph:
    """The chunk program of one capacity on a ChainBuffers: its launch
    sequence (launch) and that sequence captured once as a CUDA graph
    (replay)."""

    def __init__(self, bufs, cap):
        self.bufs, self.cap = bufs, cap
        self.variant = dp_variant(cap)
        self.ldc = -(-(cap + 1) // 2) * 2
        self.ps = path_stride(bufs.w1p, cap)
        self.folds, self.threads, self.stripe = fold_geometry(cap)
        self.graph = None

    def _count(self):
        """One launch a step of K5, the DP, K4 and K6 (K7: chain_carry
        counts its own, and a replay its one)."""
        dp = launch_key("K2", self.variant, self.folds)
        for key in ("stage0", dp, "traceback", "merged"):
            kernels.LAUNCHES[key] += self.bufs.k

    def launch(self):
        """Enqueue the chunk's steps on the current stream as separate
        launches: per step K5 (its chain entry runs the carry), the DP, K4
        and K6, then K7 once to fold the last step."""
        b, cap, k = self.bufs, self.cap, self.bufs.k
        stream = torch.cuda.current_stream(b.device).cuda_stream
        s0, dpw = kernels.get("stage0"), kernels.get("dp_wide")
        tb, mg = kernels.get("traceback"), kernels.get("merged")
        if not torch.cuda.is_current_stream_capturing():
            self._count()
        table, colf, rowf = (b.table.data_ptr(), b.colf.data_ptr(),
                             b.rowf.data_ptr())
        meta, dirs, fin = b.meta.data_ptr(), b.dirs.data_ptr(), b.fin.data_ptr()
        carry = (b.leaf.data_ptr(), b.lw.data_ptr(), b.st.data_ptr(),
                 b.out.data_ptr(), self.ps, b.widths(cap).data_ptr(),
                 b.hdr.data_ptr(), b.desc.data_ptr(), b.carry[0].data_ptr(),
                 b.carry[1].data_ptr(), cap)
        for s in range(k):
            hdr = b.hdr[s].data_ptr()
            desc = b.desc[s].data_ptr()
            path = b.out.data_ptr() + s * self.ps
            kernels.check(s0.stage0_chain(*carry, table, b.w1p, self.ldc,
                                          colf, rowf, meta, s, k, stream),
                          "stage0_chain")
            if self.variant == "staged":
                err = dpw.dp_profile_batched_staged(
                    colf, rowf, meta, 1, cap, self.folds, self.threads,
                    self.ldc, b.w1p + 1, b.w1p, BLK, dirs, fin, stream)
            else:
                err = dpw.dp_profile_batched_stripes(
                    colf, rowf, meta, 1, cap, self.folds, self.threads,
                    self.stripe, self.ldc, b.w1p + 1, b.w1p, BLK, dirs, fin,
                    stream)
            kernels.check(err, f"chain DP ({self.variant})")
            kernels.check(tb.trace_paths(dirs, fin, meta, 1, b.w1p, path,
                                         stream), "trace_paths")
            kernels.check(mg.merged_counters(desc, hdr, path, 1, cap,
                                             b.carry[(s + 1) % 2].data_ptr(),
                                             stream), "merged_counters")
        chain_carry(b, k, cap)

    def replay(self):
        """Run the chunk as one replay of its CUDA graph (captured)."""
        self.graph.replay()
        self._count()
        kernels.LAUNCHES["chain"] += 1
        kernels.CHAIN["replays"] += 1

    def capture(self):
        """Capture the chunk's graph, once: after one uncaptured warm-up
        of the launch sequence on all-invalid lanes (every kernel loads,
        sets its attributes and returns at once, and the chain's state is
        left as it was), on a side stream, with no synchronize.  A chunk's
        upload must follow it (the warm-up clears the leaf widths)."""
        if self.graph is not None:
            return
        b = self.bufs
        b.lw.zero_()
        self.launch()
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(b.device)
        side = torch.cuda.Stream(b.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.launch()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        cur.wait_stream(side)
        self.graph = graph
        kernels.CHAIN["captures"] += 1


def _pinned(nbytes, device):
    """A host staging buffer: pinned for a CUDA device."""
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


class ChainState:
    """The chain's host-side bookkeeping between chunks: its buffers, the
    width known at the last resolve, whether the device carry must be
    seeded again (dirty: at the start and after an overflow) and the
    valid steps of the last chunk dispatched."""
    __slots__ = ("bufs", "w_host", "dirty", "last_n")

    def __init__(self, bufs, profile):
        self.bufs = bufs
        self.w_host = profile.width
        self.dirty = True
        self.last_n = 0

    def seed(self, params, profile, dev=None):
        """Start the chain's device carry from a profile: its resident
        counters when it has them (dev, a MergedRef: one copy on the
        card), else one upload of its host counters; and the state and
        score table."""
        b = self.bufs
        w, card = profile.width, len(profile.data)
        if w > b.max_cap:
            raise ValueError(f"a chain of width {w} past the capacity "
                             f"{b.max_cap}")
        n = 32 if dev is not None else 32 + 128 * (w + 1)
        host = _pinned(n, b.device)
        h = host.numpy()
        h[:32].view(np.int64)[:] = (w, card, 0, 0)      # state slot 0
        if dev is None:
            h[32:].view(np.int32).reshape(w + 1, 32)[:] = profile.counters
        stage = host.to(b.device, non_blocking=True)
        kernels.CHAIN["bytes_up"] += n
        b.st[:STATE_SLOT].copy_(stage[:32].view(torch.int64))
        if dev is None:
            b.carry[0, :w + 1].copy_(stage[32:].view(torch.int32)
                                     .view(w + 1, 32))
        else:
            if dev.rows != w + 1:
                raise ValueError("resident counters of another width")
            b.carry[0, :w + 1].copy_(dev.tensor())
        b.table.copy_(_score_table(params, b.device))
        self.w_host = w
        self.dirty = False

    def final_ref(self, width):
        """The chain's counters after its last chunk as a MergedRef of
        their own (a copy on the card, which no later replay reuses)."""
        rows = self.bufs.carry[self.last_n % 2, :width + 1].clone()
        return MergedRef(rows[None], 0, width + 1)


class PendingChain:
    """A dispatched chunk whose paths are on their way to the host:
    resolve() waits for its copy and returns the PathResults of its steps
    in chain order, up to the first step that did not run (the chain was
    poisoned before it)."""

    def __init__(self, host, event, k, ps, n):
        self._host, self._event = host, event
        self._k, self._ps, self._n = k, ps, n

    def resolve(self):
        if self._event is not None:
            self._event.synchronize()
        buf = self._host.numpy()
        widths = buf[self._k * self._ps:].view(np.int32)
        out = []
        for t in range(self._n):
            if widths[t] == NOT_RUN:
                break
            if widths[t] < 0:
                raise RuntimeError("K4: a traceback left its direction "
                                   "matrix")
            at = t * self._ps
            total = int(buf[at:at + 8].view(np.int64)[0])
            path = buf[at + PATH_TRAILER:at + PATH_TRAILER + widths[t]]
            out.append(PathResult(path.astype(np.int64), total))
        return out


def upload_leaves(bufs, leaf_profiles):
    """One upload of a chunk's leaves into bufs.inp (a pinned buffer and
    one non-blocking copy on CUDA): each leaf's symbol bytes in its row
    and its width in lw, zero past them (invalid lanes)."""
    n = len(leaf_profiles)
    if not 1 <= n <= bufs.k:
        raise ValueError(f"a chunk takes 1 to {bufs.k} merges, not {n}")
    host = _pinned(bufs.inp.numel(), bufs.device)
    h = host.numpy()
    h[:] = 0
    leaf = h[:bufs.k * bufs.w1p].reshape(bufs.k, bufs.w1p)
    lw = h[bufs.k * bufs.w1p:].view(np.int64)
    for i, p in enumerate(leaf_profiles):
        sym = _leaf_symbols(p)
        if sym is None or len(sym) > bufs.w1p:
            raise ValueError(f"a chain leaf must be one ungapped sequence "
                             f"of at most {bufs.w1p} symbols")
        leaf[i, :len(sym)] = sym
        lw[i] = len(sym)
    bufs.inp.copy_(host, non_blocking=True)
    kernels.CHAIN["bytes_up"] += bufs.inp.numel()


def dispatch_chain_chunk(params, state, leaf_profiles, cap):
    """One chunk: merge len(leaf_profiles) <= K leaves, in order, into the
    chain on the card at capacity cap (the chain seeded).  On CUDA: one
    pinned upload of the leaves, one replay of the capacity's graph and
    one copy of the paths and widths down, nothing waited for; on the
    CPU, chunk_plain.  Returns a PendingChain."""
    b = state.bufs
    if state.dirty:
        raise ValueError("the chain must be seeded before a chunk")
    graph = b.graph(cap)
    cuda = b.device.type == "cuda"
    if cuda:
        graph.capture()
    upload_leaves(b, leaf_profiles)
    if cuda:
        graph.replay()
    else:
        chunk_plain(params, b, cap)
    nbytes = b.out_bytes(cap)
    kernels.CHAIN["chunks"] += 1
    kernels.CHAIN["bytes_down"] += nbytes
    state.last_n = len(leaf_profiles)
    down = _pinned(nbytes, b.device)
    down.copy_(b.out[:nbytes], non_blocking=True)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(b.device))
    return PendingChain(down, event, b.k, graph.ps, len(leaf_profiles))
