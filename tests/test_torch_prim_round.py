"""famsa_tpu_torch's Prim round after its LCS (ops/prim_torch.py:
prim_round_plain, the plain twin of kernel K8, csrc/prim.cu) against the
famsa_tpu package, round by round.

Each side carries its own state from round to round: the JAX package's
_prim_device_chunk(..., k_rounds=1) on its XLA path (pallas_meta=None),
and the port's K1 row (lcs_rows, plain on the CPU) then
prim_round_plain.  Compared exactly after every round: tieb as uint64
bits, active, cur, e1, e2 and the next reference row (queries[best]).
dist and dneg differ where the port departs from the JAX round on
purpose (ops/prim_torch.py docstring): the port divides the host's
pow(i, 0.75) table, the JAX round a device pow that differs from it in
the last bit for some i (271 of the first 5000 on XLA:CPU).  So each
vertex's dist is held bit for bit to the distance of the pair its key
names, through the host table on the port's side and through the JAX
pow on the other (equal wherever the two pows agree), and dneg to
-dist[best] on each side.  A set with lcs == 0 pairs (disjoint alphabets) is held against the host Prim
(famsa_tpu.tree.mst_prim.mst_prim_tree), edge by edge, since the JAX round
gives DBL_MAX there and the host nextafter(DBL_MAX, 0) (ROADMAP C2).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import famsa_tpu.tree.mst_prim as host_mst
from famsa_tpu.core.params import DIST_INDEL075_DIV_LCS
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.ops.distance import DistanceBackend
from famsa_tpu.ops.lcs_jax import build_query_mask_table as jax_table
from famsa_tpu.ops.prim_device import _prim_device_chunk
from famsa_tpu_torch import kernels
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops import prim_torch as pt
from famsa_tpu_torch.ops.lcs_torch import BV32, lcs_rows, pad_sequences

AA = "ARNDCQEGHILKMFPSTWYV"
ROUNDS = 20


def _strings(kind, rng):
    """Seeded families: random lengths 20-79; close relatives (point
    mutations, deletions) with exact duplicates, where the tie keys
    decide; and two groups on disjoint alphabets (lcs 0 between them)."""
    if kind == "random":
        return ["".join(AA[k] for k in rng.integers(
            0, 20, size=int(rng.integers(20, 80)))) for _ in range(77)]
    if kind == "disjoint":
        return ["".join(AA[k + 10 * (i % 2)] for k in rng.integers(
            0, 10, size=int(rng.integers(10, 40)))) for i in range(37)]
    root = rng.integers(0, 20, size=60)
    out = [root]
    while len(out) < 130:
        child = out[rng.integers(0, len(out))].copy()
        if rng.random() < 0.2:
            out.append(child)                    # an exact duplicate
            continue
        pos = rng.integers(0, len(child), size=2)
        child[pos] = rng.integers(0, 20, size=2)
        if rng.random() < 0.3:
            child = np.delete(child, int(rng.integers(0, len(child))))
        out.append(child)
    return ["".join(AA[c] for c in s) for s in out]


def _sequences(cls, strings):
    seqs = [cls(f">s{i}", s, i) for i, s in enumerate(strings)]
    ml = max(s.length for s in seqs)
    for s in seqs:
        s.resize(ml)
    return seqs


def _inputs(strings):
    seqs = _sequences(TSequence, strings)
    padded = pad_sequences(seqs, align=BV32)
    lengths = np.array([s.length for s in seqs], dtype=np.int64)
    return padded, lengths


@pytest.mark.parametrize("kind,seed", [("random", 3), ("family", 8),
                                       ("family", 19)])
def test_prim_round_plain_matches_jax_round_by_round(kind, seed):
    strings = _strings(kind, np.random.default_rng(seed))
    padded, lengths = _inputs(strings)
    n = len(strings)
    assert n % 32 and n % 1024
    table, queries, lens, pow_tab = pt.prim_inputs(padded, lengths, "cpu")
    st = pt.PrimState(queries)
    jtab = jnp.asarray(jax_table(padded))
    jq = jnp.asarray(padded.astype(np.int32))
    jl = jnp.asarray(lengths)
    jax_pow = jax.jit(lambda i: i.astype(jnp.float64) ** 0.75)
    host_pow = np.power(np.arange(2 * int(lengths.max()) + 1,
                                  dtype=np.float64), 0.75)
    jax_pows = np.asarray(jax_pow(jnp.arange(len(host_pow))))
    pow_same = jax_pows == host_pow
    edges = torch.empty((3, ROUNDS), dtype=torch.int64)
    j_state = (jnp.int64(0), jnp.asarray(st.dist.numpy()),
               jnp.asarray(st.tieb.numpy().view(np.uint64)),
               jnp.asarray(st.active.numpy()))
    rows = {}                        # reference -> its LCS row
    exact = 0
    for r in range(ROUNDS):
        out = _prim_device_chunk(jtab, jq, jl, *j_state, k_rounds=1)
        j_state = out[:4]
        j_cur, j_dist, j_tieb, j_active, j_e1, j_e2, j_dneg, j_best = (
            np.asarray(a) for a in out)
        lcs = lcs_rows(table, st.ref)
        rows[int(st.cur[0])] = lcs[0].numpy().astype(np.int64)
        pt.prim_round_plain(lcs, lens, pow_tab, queries, st.cur, st.dist,
                            st.tieb, st.active, st.ref, edges, r)

        best = int(st.cur[0])
        tieb = st.tieb.numpy().view(np.uint64)
        assert best == int(j_cur) == int(j_best[0])
        assert np.array_equal(st.active.numpy(), j_active)
        assert np.array_equal(tieb, j_tieb)
        assert (int(edges[0, r]), int(edges[1, r])) == (int(j_e1[0]),
                                                        int(j_e2[0]))
        assert torch.equal(st.ref[0], queries[best])
        # each vertex's distance is that of the pair its key names: the
        # host transform's on the port's side, the JAX pow's on the other
        dist = st.dist.numpy()
        for v in np.nonzero(tieb)[0]:
            pair = int(~tieb[v])
            u = (pair >> 32) + (pair & 0xFFFFFFFF) - v
            x = rows[u][v]
            assert x > 0
            indel = lengths[u] + lengths[v] - 2 * x
            assert dist[v].view(np.int64) == \
                (host_pow[indel] / x).view(np.int64)
            assert j_dist[v].view(np.int64) == \
                (jax_pows[indel] / x).view(np.int64)
            exact += bool(pow_same[indel])
        assert np.array_equal(dist[tieb == 0], j_dist[tieb == 0])
        dneg = edges[2, r:r + 1].view(torch.float64).numpy()
        assert np.array_equal(dneg.view(np.int64),
                              np.array([-dist[best]]).view(np.int64))
        assert np.array_equal(j_dneg.view(np.int64),
                              np.array([-j_dist[best]]).view(np.int64))
        # K8 reduces in another order than argmin: the (dist, tieb) keys of
        # the active vertices are unique, so every order picks this best
        act = np.nonzero(st.active.numpy() | (np.arange(n) == best))[0]
        assert len(np.unique(tieb[act])) == len(act)
        perm = np.random.default_rng(r).permutation(act)
        assert perm[np.lexsort((tieb[perm], dist[perm]))[0]] == best
    assert exact > ROUNDS * n // 2


def _capture(monkeypatch, module):
    """Record the edge lists `module` hands _mst_to_dendrogram."""
    seen = []
    orig = module._mst_to_dendrogram

    def keep(e_from, e_to, e_dist, prim_orders, tree):
        seen.append((e_from, e_to, np.asarray(e_dist, dtype=np.float64),
                     prim_orders))
        return orig(e_from, e_to, e_dist, prim_orders, tree)
    monkeypatch.setattr(module, "_mst_to_dendrogram", keep)
    return seen


@pytest.mark.parametrize("chunk", [5, 2048])
def test_prim_lcs_zero_matches_host(chunk, monkeypatch):
    """Disjoint alphabets: rows with lcs == 0 give nextafter(DBL_MAX, 0),
    as the host; edge by edge against the host Prim."""
    strings = _strings("disjoint", np.random.default_rng(5))
    padded, lengths = _inputs(strings)
    table, _, _, _ = pt.prim_inputs(padded, lengths, "cpu")
    row = lcs_rows(table, torch.from_numpy(padded[:1].astype(np.int32)))
    assert (row[0] == 0).sum() > 10

    jseqs = _sequences(JSequence, strings)
    be = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
    host_edges = _capture(monkeypatch, host_mst)
    tree_host = []
    host_mst.mst_prim_tree(len(jseqs), lambda r, ids: be.row(r, ids),
                           tree_host)
    port_edges = _capture(monkeypatch, pt)
    tree_port = []
    pt.mst_prim_tree_torch(_sequences(TSequence, strings), tree_port,
                           device="cpu", chunk=chunk)
    assert tree_port == tree_host
    (hf, ht, hd, ho), = host_edges
    (pf, pt_, pd, po), = port_edges
    assert np.array_equal(hf, pf) and np.array_equal(ht, pt_)
    assert np.array_equal(hd.view(np.int64), pd.view(np.int64))
    assert np.array_equal(ho, po)
    assert (pd == -pt.BIG).sum() == 1          # the edge between the groups


def _round_args(n=40, length=32, k=4, device="cpu"):
    queries = torch.zeros((n, length), dtype=torch.int32)
    st = pt.PrimState(queries)
    args = dict(lcs=torch.ones((1, n), dtype=torch.int32),
                lengths=torch.full((n,), 20, dtype=torch.int64),
                pow_tab=torch.arange(64, dtype=torch.float64),
                queries=queries, cur=st.cur, dist=st.dist, tieb=st.tieb,
                active=st.active, ref=st.ref,
                edges=torch.zeros((3, k), dtype=torch.int64), slot=0)
    return {k_: (v.to(device) if torch.is_tensor(v) else v)
            for k_, v in args.items()}


@pytest.mark.parametrize("bad,error", [
    ({"lcs": torch.ones((1, 40), dtype=torch.int64)}, TypeError),
    ({"tieb": torch.zeros(40, dtype=torch.float64)}, TypeError),
    ({"active": torch.ones(40, dtype=torch.uint8)}, TypeError),
    ({"lcs": torch.ones((1, 39), dtype=torch.int32)}, ValueError),
    ({"ref": torch.zeros((1, 31), dtype=torch.int32)}, ValueError),
    ({"slot": 4}, ValueError),
])
def test_prim_round_checks_its_arguments(bad, error):
    args = _round_args()
    args.update(bad)
    with pytest.raises(error):
        pt.prim_round(**args)


def test_prim_round_other_device_raises():
    """Neither the CPU nor a CUDA card: the wrapper and the whole tree
    raise rather than run anything."""
    with pytest.raises(ValueError, match="unsupported device"):
        pt.prim_round(**_round_args(device="meta"))
    strings = _strings("random", np.random.default_rng(2))[:12]
    with pytest.raises(ValueError, match="unsupported device"):
        pt.mst_prim_tree_torch(_sequences(TSequence, strings), [],
                               device="meta")


def test_prim_cpu_path_builds_no_kernel(monkeypatch):
    """CPU tensors run the plain twins only: kernels.get is never called,
    and the tree equals the host Prim's."""
    def refuse(name):
        raise AssertionError(f"kernels.get({name!r}) on the CPU path")
    monkeypatch.setattr(kernels, "get", refuse)
    before = dict(kernels.LAUNCHES)
    strings = _strings("random", np.random.default_rng(11))[:40]
    jseqs = _sequences(JSequence, strings)
    be = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
    tree_host = []
    host_mst.mst_prim_tree(len(jseqs), lambda r, ids: be.row(r, ids),
                           tree_host)
    tree_port = []
    pt.mst_prim_tree_torch(_sequences(TSequence, strings), tree_port,
                           device="cpu", chunk=6)
    assert tree_port == tree_host
    assert kernels.LAUNCHES == before


CSRC = pathlib.Path(pt.__file__).resolve().parent.parent / "csrc"


def _before(a, b):
    """K8's lexicographic order on (dist, tieb as uint64, vertex)."""
    return a < b


def _sliced_best(dist, tieb, active, c):
    """K8's sliced reduction on the round's updated state: CTA r of c owns
    vertices [r S, (r + 1) S), S = ceil(n / c), and folds the active ones
    into one partial (dist, tieb, vertex); the partials are folded in rank
    order.  Returns the best vertex, or n when none is active."""
    n = len(dist)
    per = -(-n // c)
    none = (np.inf, np.uint64(0xFFFFFFFFFFFFFFFF), 0x7FFFFFFF)
    best = none
    for r in range(c):
        part = none
        for v in range(r * per, min(n, (r + 1) * per)):
            if active[v]:
                part = min(part, (dist[v], tieb[v], v))
        if _before(part, best):
            best = part
    return best[2] if best[2] < n else n


@pytest.mark.parametrize("kind,seed", [("tie", 4), ("disjoint", 6)])
def test_sliced_reduction_matches_plain_and_famsa_tpu(kind, seed,
                                                      monkeypatch):
    """A plain emulation of K8's cluster reduction (per-slice partials for
    each cluster size, folded in rank order) picks prim_round_plain's best
    in every round, on ties (every sequence three times: the tie keys
    decide) and with lcs == 0 pairs (two disjoint alphabets).  On ties the
    JAX round (_prim_device_chunk, k_rounds=1, its own state) picks the
    same vertex; with lcs == 0 the JAX round gives DBL_MAX where the host
    gives nextafter(DBL_MAX, 0) (ROADMAP C2), so there the vertex is held
    to the host Prim's (famsa_tpu.tree.mst_prim) order of addition."""
    rng = np.random.default_rng(seed)
    if kind == "tie":
        base = _strings("random", rng)[:31]
        strings = [s for s in base for _ in range(3)]
    else:
        strings = _strings("disjoint", rng)
        jseqs = _sequences(JSequence, strings)
        be = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
        host_edges = _capture(monkeypatch, host_mst)
        host_mst.mst_prim_tree(len(jseqs), lambda r, ids: be.row(r, ids),
                               [])
        host_order = np.argsort(host_edges[0][3])
    padded, lengths = _inputs(strings)
    table, queries, lens, pow_tab = pt.prim_inputs(padded, lengths, "cpu")
    st = pt.PrimState(queries)
    jtab = jnp.asarray(jax_table(padded))
    jq = jnp.asarray(padded.astype(np.int32))
    jl = jnp.asarray(lengths)
    j_state = (jnp.int64(0), jnp.asarray(st.dist.numpy()),
               jnp.asarray(st.tieb.numpy().view(np.uint64)),
               jnp.asarray(st.active.numpy()))
    edges = torch.empty((3, ROUNDS), dtype=torch.int64)
    for r in range(ROUNDS):
        out = _prim_device_chunk(jtab, jq, jl, *j_state, k_rounds=1)
        j_state = out[:4]
        lcs = lcs_rows(table, st.ref)
        active = st.active.clone()
        pt.prim_round_plain(lcs, lens, pow_tab, queries, st.cur, st.dist,
                            st.tieb, st.active, st.ref, edges, r)
        best = int(st.cur[0])
        dist = st.dist.numpy()
        tieb = st.tieb.numpy().view(np.uint64)
        for c in pt.CLUSTERS:
            assert _sliced_best(dist, tieb, active.numpy(), c) == best
        if kind == "tie":
            assert int(np.asarray(out[7])[0]) == best
        else:
            assert host_order[r + 1] == best
    if kind == "disjoint":
        assert (edges[2].view(torch.float64) == -pt.BIG).any()


def _cu_constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / "prim.cu").read_text())
    assert m, f"{name} not in csrc/prim.cu"
    return int(m.group(1))


def test_cluster_rule_mirrors_the_cuda_source():
    """prim_torch.cluster_size is csrc/prim.cu's cluster_size: one CTA up
    to CTA_VERTICES vertices, MAX_CLUSTER CTAs past them, and every size
    a caller may force is a power of two up to MAX_CLUSTER."""
    src = (CSRC / "prim.cu").read_text()
    assert "return n <= CTA_VERTICES ? 1 : MAX_CLUSTER;" in src
    assert _cu_constant("CTA_VERTICES") == pt.CTA_VERTICES
    assert _cu_constant("MAX_CLUSTER") == pt.MAX_CLUSTER == max(pt.CLUSTERS)
    assert all(c & (c - 1) == 0 for c in pt.CLUSTERS)
    for n, c in ((1, 1), (1000, 1), (pt.CTA_VERTICES, 1),
                 (pt.CTA_VERTICES + 1, pt.MAX_CLUSTER),
                 (10000, pt.MAX_CLUSTER)):
        assert pt.cluster_size(n) == c


def test_prim_round_cluster_argument():
    """A forced cluster size is one of CLUSTERS; on the CPU every size gives
    the plain twin's round."""
    with pytest.raises(ValueError, match="cluster"):
        pt.prim_round(**_round_args(), cluster=3)
    results = []
    for c in (None,) + pt.CLUSTERS:
        args = _round_args()
        args["lcs"] = torch.arange(1, 41, dtype=torch.int32).view(1, 40)
        args["lengths"] = torch.arange(30, 70, dtype=torch.int64)
        args["pow_tab"] = torch.arange(256, dtype=torch.float64) ** 0.75
        pt.prim_round(**args, cluster=c)
        results.append([args[a].clone() for a in ("cur", "dist", "tieb",
                                                  "active", "edges")])
    for res in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(res, results[0]))
