"""Whole-tree MST-Prim with the round state on the device.

The counterpart of the JAX package's ops/prim_device.py: the default
guide tree (FAMSA src/tree/MSTPrim.cpp:330-538) is n-1 rounds, each
computing the LCS of the newly added vertex against all sequences (one
launch of kernel K1's wave variant through ops/lcs_torch.lcs_rows), then
folding the distances into the per-vertex best (distance, tie-break key)
pair and taking the lexicographic argmin (one launch of kernel K8,
csrc/prim.cu, a cluster of cluster_size(n) CTAs, through prim_round; its
plain twin prim_round_plain on CPU tensors).  `cur/dist/tieb/active` and
the next round's reference row stay on the device and are updated in
place.  A family with a flagged sequence (ops/lcs_torch.py:famsa_flags:
FAMSA's own LCS departs from the exact one when that sequence is the
reference) launches kernel K9 between the two: it reads the round's
reference id and the flags on the card and, only when the reference is
flagged, overwrites the round's LCS row with FAMSA's value.  The rounds
run in chunks of
FAMSA_TORCH_PRIM_CHUNK, and only each chunk's edge buffer comes back to
the host, in one copy, where tree/mst_prim.py builds the dendrogram.

Two spots differ from a literal port, so that results equal the host
route (tree/mst_prim.py with ops/distance.py):
 - distance: indel ** 0.75 / lcs reads the host's float64
   pow(i, 0.75) table (ops/distance.py:_pow075_table), uploaded once,
   instead of a device pow that is not correctly rounded; lcs == 0 gives
   the host's nextafter(DBL_MAX, 0);
 - the round updates its state in place (the JAX round is pure).
The tie-break keys are the host's uint64 ~((lo << 32) + hi), held as
their bits in an int64 tensor and compared unsigned (K8 natively; the
plain twin with the sign bit flipped, which keeps the unsigned order).
"""

import os

import numpy as np
import torch

from .. import kernels
from ..tree.mst_prim import _mst_to_dendrogram
from .distance import _pow075_table
from .lcs_torch import (BV32, build_query_mask_table, famsa_flags,
                        lcs_refmask, lcs_rows, pad_sequences)

SIGN = -(1 << 63)                 # int64 sign bit
DMAX = np.finfo(np.float64).max
BIG = np.nextafter(DMAX, 0.0)     # the host transform's distance at lcs 0


# K8's shape rule (csrc/prim.cu:cluster_size): one CTA up to
# CTA_VERTICES vertices, a (non-portable) cluster of MAX_CLUSTER past
# them; CLUSTERS are the sizes a caller may force
CTA_VERTICES = 2048
MAX_CLUSTER = 16
CLUSTERS = (1, 2, 4, 8, 16)


def cluster_size(n):
    """The CTAs of the cluster K8 runs a round of n vertices on."""
    return 1 if n <= CTA_VERTICES else MAX_CLUSTER


def _unsigned(u):
    """int64 view of uint64 bits with the sign bit flipped: signed order of
    the result equals unsigned order of the input bits."""
    return u ^ SIGN


def prim_round_plain(lcs, lengths, pow_tab, queries, cur, dist, tieb,
                     active, ref, edges, slot):
    """Plain PyTorch twin of K8 (csrc/prim.cu), on prim_round's arguments
    and with its in-place effects: one Prim round after its LCS.

    lcs: [1, n] int32, the LCS row of reference cur; lengths [n] int64;
    pow_tab: float64 pow(i, 0.75) covering every indel count; queries
    [n, L] int32.  Updated in place: cur [1] int64, dist [n] float64,
    tieb [n] int64 (uint64 key bits), active [n] bool, ref [1, L] int32
    (set to queries[best]) and slot `slot` of edges [3, k] int64 (the
    edge's min and max id, and -dist[best] as float64 bits)."""
    n = lengths.shape[0]
    dev = lengths.device
    x = lcs.reshape(-1)[:n].to(torch.int64)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    indel = lengths.index_select(0, cur) + lengths - 2 * x
    d_new = torch.where(x > 0, pow_tab[indel] / x.to(torch.float64),
                        torch.tensor(BIG, dtype=torch.float64, device=dev))
    lo = torch.minimum(ids, cur)
    hi = torch.maximum(ids, cur)
    packed = ~((lo << 32) + hi)
    upd = active & ((d_new < dist)
                    | ((d_new == dist)
                       & (_unsigned(packed) < _unsigned(tieb))))
    dist.copy_(torch.where(upd, d_new, dist))
    tieb.copy_(torch.where(upd, packed, tieb))

    # lexicographic argmin over active vertices (keys are unique among
    # them; argmin takes the first index of a tie, as K8 the lowest v)
    d_m = torch.where(active, dist, float("inf"))
    t_m = torch.where(d_m == d_m.min(), _unsigned(tieb), -SIGN - 1)
    best = torch.argmin(t_m).view(1)
    bp = ~tieb.index_select(0, best)         # the host's packed ids
    p1 = (bp >> 32) & 0xFFFFFFFF
    p2 = bp & 0xFFFFFFFF
    edges[0, slot:slot + 1] = torch.minimum(p1, p2)
    edges[1, slot:slot + 1] = torch.maximum(p1, p2)
    edges[2, slot:slot + 1] = (-dist.index_select(0, best)).view(torch.int64)
    active.index_fill_(0, best, False)
    cur.copy_(best)
    ref.copy_(queries.index_select(0, best))


def prim_round(lcs, lengths, pow_tab, queries, cur, dist, tieb, active, ref,
               edges, slot, cluster=None):
    """One Prim round after its LCS (see prim_round_plain for the
    arguments and the in-place effects).  CUDA tensors launch kernel K8
    on the current stream, on a cluster of `cluster` CTAs (one of
    CLUSTERS; default cluster_size(n)); CPU tensors run prim_round_plain,
    whose result no cluster size changes."""
    n = lengths.shape[0]
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, not {cluster}")
    args = {"lcs": (lcs, torch.int32), "lengths": (lengths, torch.int64),
            "pow_tab": (pow_tab, torch.float64),
            "queries": (queries, torch.int32), "cur": (cur, torch.int64),
            "dist": (dist, torch.float64), "tieb": (tieb, torch.int64),
            "active": (active, torch.bool), "ref": (ref, torch.int32),
            "edges": (edges, torch.int64)}
    for name, (t, dtype) in args.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
        if t.device != lengths.device:
            raise ValueError("every tensor must be on one device")
    length = queries.shape[1]
    if (lcs.shape != (1, n) or queries.shape[0] != n or cur.shape != (1,)
            or dist.shape != (n,) or tieb.shape != (n,)
            or active.shape != (n,) or ref.shape != (1, length)
            or edges.dim() != 2 or edges.shape[0] != 3
            or not 0 <= slot < edges.shape[1]):
        raise ValueError("prim_round: shapes do not fit one round")
    dev = lengths.device
    if dev.type == "cpu":
        return prim_round_plain(lcs, lengths, pow_tab, queries, cur, dist,
                                tieb, active, ref, edges, slot)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t, _ in args.values()):
        raise ValueError("every tensor must be contiguous")
    lib = kernels.get("prim")
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.LAUNCHES["prim_round"] += 1
    err = lib.prim_round(lcs.data_ptr(), lengths.data_ptr(),
                         pow_tab.data_ptr(), queries.data_ptr(), n, length,
                         cur.data_ptr(), dist.data_ptr(), tieb.data_ptr(),
                         active.data_ptr(), ref.data_ptr(), edges.data_ptr(),
                         edges.shape[1], slot, cluster or 0, stream)
    kernels.check(err, "prim_round")


class PrimState:
    """The round state of one tree on the device: cur [1] int64, dist [n]
    float64, tieb [n] int64 (uint64 key bits), active [n] bool, and ref
    [1, L] int32, the reference row of the next round (queries[cur]);
    initialised as famsa_tpu/ops/prim_device.py:prim_device does, with
    vertex 0 in the tree.  flags: None, or [n] bool on the device
    (famsa_flags of the family, which has a flagged sequence): the rounds
    then launch K9 after K1 wave."""

    def __init__(self, queries, flags=None):
        n = queries.shape[0]
        dev = queries.device
        self.flags = flags
        self.cur = torch.zeros(1, dtype=torch.int64, device=dev)
        self.dist = torch.full((n,), DMAX, dtype=torch.float64, device=dev)
        self.tieb = torch.zeros(n, dtype=torch.int64, device=dev)
        self.active = torch.ones(n, dtype=torch.bool, device=dev)
        self.active[0] = False
        self.ref = queries[:1].clone()


def prim_chunk(table, queries, lengths, pow_tab, state, k):
    """k Prim rounds on `state` (a PrimState, updated in place): per
    round K1 wave, then K8, and nothing else (with state.flags, K1 wave,
    K9, then K8).  Returns the chunk's edge buffer, [3, k] int64 on the
    device (prim_round's `edges`)."""
    edges = torch.empty((3, k), dtype=torch.int64, device=queries.device)
    for slot in range(k):
        lcs = lcs_rows(table, state.ref, variant="wave")
        if state.flags is not None:
            lcs_refmask(state.ref, queries, out=lcs, cur=state.cur,
                        flags=state.flags)
        prim_round(lcs, lengths, pow_tab, queries, state.cur, state.dist,
                   state.tieb, state.active, state.ref, edges, slot)
    return edges


def device_flags(flags, device):
    """famsa_flags on `device` as PrimState takes them: None when no
    sequence is flagged (the rounds then launch no K9)."""
    if not flags.any():
        return None
    return torch.from_numpy(flags).to(torch.device(device))


def prim_rounds(table, queries, lengths, pow_tab, chunk=None, flags=None):
    """Run all n-1 Prim rounds.

    table: [32, W, N] int32 query masks; queries: [N, L] int32 symbols;
    lengths: [N] int64; pow_tab: float64 pow(i, 0.75) covering every indel
    count; flags: None or [N] bool (device_flags) (all on one device, the
    CPU or a CUDA card).  Returns numpy arrays (edge_p1, edge_p2,
    edge_dist_neg), each of length n-1."""
    state = PrimState(queries, flags)
    return chunked_rounds(queries.shape[0], chunk, lambda k: prim_chunk(
        table, queries, lengths, pow_tab, state, k))


def chunked_rounds(n, chunk, run_chunk):
    """The n-1 Prim rounds of a tree in chunks of `chunk` rounds (None:
    FAMSA_TORCH_PRIM_CHUNK, default 2048): run_chunk(k) issues k rounds
    and returns their [3, k] int64 edge buffer (prim_round's `edges`),
    which comes to the host in one copy, the chunk's only wait.  Returns
    numpy arrays (edge_p1, edge_p2, edge_dist_neg) of length n-1."""
    if chunk is None:
        chunk = int(os.environ.get("FAMSA_TORCH_PRIM_CHUNK", "2048"))
    outs = []
    done = 0
    while done < n - 1:
        k = min(chunk, n - 1 - done)
        outs.append(run_chunk(k).cpu().numpy())
        done += k
    e = (np.concatenate(outs, axis=1) if outs
         else np.zeros((3, 0), dtype=np.int64))
    return e[0], e[1], e[2].view(np.float64)


def prim_inputs(padded, lengths, device):
    """(table, queries, lengths, pow_tab) of prim_rounds on `device` from
    padded ([N, L] int8 symbols, L a multiple of 32) and lengths ([N]
    int64)."""
    dev = torch.device(device)
    table = torch.from_numpy(
        build_query_mask_table(padded).view(np.int32)).to(dev)
    queries = torch.from_numpy(padded.astype(np.int32)).to(dev)
    pow_tab = torch.from_numpy(
        _pow075_table(2 * int(lengths.max()), np.float64)).to(dev)
    return table, queries, torch.from_numpy(lengths).to(dev), pow_tab


def mst_prim_tree_torch(sequences, tree, device="cuda", chunk=None):
    """Device MST-Prim (indel075_div_lcs) + host dendrogram; drop-in for
    tree/mst_prim.py:mst_prim_tree on the default distance."""
    n = len(sequences)
    if n == 1:
        return
    padded = pad_sequences(sequences, align=BV32)
    lengths = np.array([s.length for s in sequences], dtype=np.int64)
    e1, e2, dneg = prim_rounds(*prim_inputs(padded, lengths, device),
                               chunk=chunk,
                               flags=device_flags(famsa_flags(padded), device))
    edges_to_tree(e1, e2, dneg, tree)


def edges_to_tree(e1, e2, dneg, tree):
    """The dendrogram (tree/mst_prim.py:_mst_to_dendrogram) of the n-1
    Prim edges (e1, e2, dneg: chunked_rounds' arrays) into `tree`."""
    n = len(e1) + 1
    prim_orders = np.full(n, n, dtype=np.int64)
    prim_orders[0] = 0
    edges_from = [0]
    edges_to = [0]
    edges_dist = [0.0]
    order = 1
    for k in range(n - 1):
        p1, p2 = int(e1[k]), int(e2[k])
        edges_from.append(p1)
        edges_to.append(p2)
        edges_dist.append(float(dneg[k]))
        if prim_orders[p1] == n:
            prim_orders[p1] = order
        else:
            prim_orders[p2] = order
        order += 1

    _mst_to_dendrogram(np.array(edges_from), np.array(edges_to),
                       np.array(edges_dist), prim_orders, tree)
