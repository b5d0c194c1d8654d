"""famsa_tpu_torch's row axis of multi-device sharding (parallel/mesh.py,
parallel/dist_sharded.py) on meshes of "cpu" shards, against the
famsa_tpu package: its sharded programs (famsa_tpu/parallel/, on JAX's
8-device CPU mesh, tests/conftest.py) where their semantics agree with
-backend numpy (random families with no LCS of 0: their LCS takes the
carry as V2 < V on 32-bit words and gives LCS 0 DBL_MAX), and its host
routes everywhere (poly-Q families with flagged references, the distance
backend, whole runs).  Meshes of 1, 2, 3, 4 and 8 shards, n equal to the
shard count and not divisible by it, Prim chunks that cross their
boundaries.  On the CPU every shard runs the kernels' plain PyTorch
versions.  Tolerance: exact (equal floats bit for bit, equal trees,
byte-identical CSVs, trees and alignments).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from famsa_tpu.cli import main as j_main
from famsa_tpu.core.params import DIST_INDEL075_DIV_LCS, DIST_INDEL_DIV_LCS
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.ops.distance import DistanceBackend
from famsa_tpu.ops.lcs import build_bit_masks, lcs_ref_vs_queries
from famsa_tpu.ops.lcs_jax import build_bit_masks32
from famsa_tpu.parallel import dist_sharded as j_dist_sharded
from famsa_tpu.parallel import mesh as j_mesh
from famsa_tpu.tree.mst_prim import mst_prim_tree
from famsa_tpu_torch.cli import main as t_main
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops.distance import get_distance_backend
from famsa_tpu_torch.ops.lcs_torch import (TorchDistanceBackend, famsa_flags,
                                           pad_sequences)
from famsa_tpu_torch.parallel import mesh
from famsa_tpu_torch.parallel.dist_sharded import (ShardedDistanceBackend,
                                                   mst_prim_tree_sharded)

AA = "ARNDCQEGHILKMFPSTWYV"
SHARDS = (1, 2, 3, 4, 8)


def cpu_mesh(size):
    return mesh.make_mesh(["cpu"] * size)


def random_strings(rng, n, lmin, lmax):
    return ["".join(AA[k] for k in rng.integers(0, 20, size=int(
        rng.integers(lmin, lmax)))) for _ in range(n)]


def family_strings(rng, n, length):
    """Close relatives: many near-equal distances, so the tie keys
    decide."""
    root = rng.integers(0, 20, size=length)
    out = [root]
    while len(out) < n:
        child = out[rng.integers(0, len(out))].copy()
        pos = rng.integers(0, len(child), size=2)
        child[pos] = rng.integers(0, 20, size=2)
        if rng.random() < 0.3:
            child = np.delete(child, int(rng.integers(0, len(child))))
        out.append(child)
    return ["".join(AA[c] for c in s) for s in out]


def polyq_strings(n, seed, lo=40, hi=90, every=2):
    """n random sequences of length lo-hi; every `every`-th with a poly-Q
    tract of 64-150 residues at an offset of 0-63 (a flagged sequence)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        s = "".join(rng.choice(list(AA), size=int(rng.integers(lo, hi + 1))))
        if k % every == 0:
            off = int(rng.integers(0, 64))
            s = s[:off] + "Q" * int(rng.integers(64, 151)) + s[off:]
        out.append(s)
    return out


def padded(cls, strings):
    seqs = [cls(f">s{i}", s, i) for i, s in enumerate(strings)]
    ml = max(s.length for s in seqs)
    for s in seqs:
        s.resize(ml)
    return seqs


def host_tree(strings):
    """famsa_tpu's host Prim (tree/mst_prim.py on DistanceBackend rows)."""
    jseqs = padded(JSequence, strings)
    be = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
    tree = []
    mst_prim_tree(len(jseqs), lambda r, ids: be.row(r, ids), tree)
    return tree


def no_lcs_zero(strings):
    jseqs = padded(JSequence, strings)
    pad = np.stack([s.data for s in jseqs])
    return all(lcs_ref_vs_queries(build_bit_masks(s.data, s.data_size),
                                  pad).min() > 0 for s in jseqs)


def test_mesh_bounds_and_checks():
    """Contiguous slices, the first n % S one row longer, no pad rows;
    make_mesh refuses no device and mixed device types."""
    assert cpu_mesh(3).bounds(10) == [(0, 4), (4, 7), (7, 10)]
    assert cpu_mesh(4).bounds(4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert cpu_mesh(1).bounds(5) == [(0, 5)]
    m = cpu_mesh(8)
    for n in (8, 9, 15, 64):
        b = m.bounds(n)
        assert b[0][0] == 0 and b[-1][1] == n
        assert all(s1 - s0 in (n // 8, n // 8 + 1) for s0, s1 in b)
        assert all(b[k][1] == b[k + 1][0] for k in range(7))
    assert m.size == 8 and m.lead is m.shards[0]
    assert all(s.stream is None for s in m.shards)
    with pytest.raises(ValueError):
        mesh.make_mesh([])
    with pytest.raises(ValueError):
        mesh.make_mesh(["cpu", "meta"])


def test_auto_mesh_rules(monkeypatch):
    """No mesh unless a caller set one in the cache (none is made from the
    visible devices); a mesh set serves runs on its device type; the
    sharded routes (rows_mesh) need n >= the mesh's size, and
    get_distance_backend shards only over a mesh it is given."""
    monkeypatch.setattr(mesh, "_AUTO_MESH", {})
    assert mesh.auto_mesh("rows", "cpu") is None
    assert mesh.auto_mesh("rows", "cuda") is None
    assert mesh.rows_mesh(100, "cpu") is None
    assert mesh._AUTO_MESH == {}
    m = cpu_mesh(4)
    mesh._AUTO_MESH["rows"] = m
    assert mesh.auto_mesh("rows", "cpu") is m
    assert mesh.auto_mesh("rows", "cuda") is None
    assert mesh.auto_mesh("cols", "cpu") is None
    assert mesh.rows_mesh(4, "cpu") is m
    assert mesh.rows_mesh(3, "cpu") is None
    seqs = padded(TSequence, random_strings(np.random.default_rng(1), 4,
                                            10, 20))
    assert isinstance(get_distance_backend(
        seqs, DIST_INDEL075_DIV_LCS, np.float64, "torch", "cpu", mesh=m),
        ShardedDistanceBackend)
    assert not isinstance(get_distance_backend(
        seqs, DIST_INDEL075_DIV_LCS, np.float64, "torch", "cpu"),
        ShardedDistanceBackend)
    with pytest.raises(ValueError):
        ShardedDistanceBackend(seqs[:3], DIST_INDEL075_DIV_LCS, np.float64,
                               m)


@pytest.fixture(scope="module")
def jax_round():
    """One round of famsa_tpu.parallel.mesh.prim_round_sharded on JAX's
    8-device mesh (tests/test_parallel.py's case, lengths >= 20: no LCS
    of 0), and the JAX pow table its distances went through."""
    rng = np.random.default_rng(7)
    n, lmax = 64, 96
    lens = rng.integers(20, lmax, size=n)
    seqs = np.full((n, lmax), 22, dtype=np.int8)
    for i, l in enumerate(lens):
        seqs[i, :l] = rng.integers(0, 20, size=l)
    ref_idx = 3
    ref = seqs[ref_idx][:int(lens[ref_idx])]
    assert lcs_ref_vs_queries(build_bit_masks(ref, len(ref)), seqs).min() > 0
    dist0 = rng.random(n) * 2
    tieb0 = rng.integers(0, 2**63, size=n).astype(np.uint64)
    active = np.ones(n, dtype=bool)
    active[ref_idx] = False
    got = j_mesh.prim_round_sharded(
        j_mesh.make_mesh(axis="rows"),
        jnp.asarray(build_bit_masks32(ref, len(ref))),
        jnp.asarray(seqs.astype(np.int32)), jnp.asarray(lens.astype(np.int64)),
        np.int64(lens[ref_idx]), np.int64(ref_idx), jnp.asarray(dist0),
        jnp.asarray(tieb0), jnp.asarray(active))
    jax_pow = jax.jit(lambda i: i.astype(jnp.float64) ** 0.75)
    pow_tab = np.asarray(jax_pow(jnp.arange(2 * lmax + 1)))
    return (seqs, lens.astype(np.int64), ref_idx, dist0, tieb0, active,
            pow_tab, [np.asarray(x) for x in got])


@pytest.mark.parametrize("size", SHARDS)
def test_prim_round_sharded_matches_famsa_tpu(size, jax_round):
    """One round on `size` shards (64 sequences: 64 / 3 uneven) against
    famsa_tpu's round: dist and tieb bit for bit, the argmin and its
    distance; the state moves to the new vertex."""
    seqs, lens, ref_idx, dist0, tieb0, active, pow_tab, want = jax_round
    prim = mesh.PrimShards(cpu_mesh(size), seqs, lens)
    prim.pow_tab = torch.from_numpy(pow_tab.copy())   # the JAX pow's
    st = prim.state
    st.cur[0] = ref_idx
    st.ref.copy_(prim.queries[ref_idx:ref_idx + 1])
    st.dist.copy_(torch.from_numpy(dist0))
    st.tieb.copy_(torch.from_numpy(tieb0.view(np.int64)))
    st.active.copy_(torch.from_numpy(active))
    edges = torch.zeros((3, 2), dtype=torch.int64)
    mesh.prim_round_sharded(prim, edges, 1)
    d, t, best, best_d = want
    assert np.array_equal(st.dist.numpy().view(np.int64), d.view(np.int64))
    assert np.array_equal(st.tieb.numpy(), t.view(np.int64))
    assert int(st.cur[0]) == int(best)
    assert -edges[2, 1:].numpy().view(np.float64)[0] == float(best_d)
    want_active = active.copy()
    want_active[int(best)] = False
    assert np.array_equal(st.active.numpy(), want_active)
    assert np.array_equal(st.ref.numpy()[0], seqs[int(best)].astype(np.int32))
    assert not edges[:, 0].any()


# (shards, sequences, Prim chunk): n = S, n % S != 0, chunks crossed
TREE_CASES = [(1, 9, 4), (2, 9, 4), (3, 3, 7), (3, 10, 4), (4, 14, 5),
              (4, 4, 2), (8, 8, 3), (8, 19, 7)]


@pytest.mark.parametrize("size,n,chunk", TREE_CASES)
def test_tree_sharded_matches_famsa_tpu(size, n, chunk):
    """Random families with no LCS of 0: equal to famsa_tpu's sharded
    tree on a JAX mesh of the same size and to its host Prim."""
    strings = random_strings(np.random.default_rng(100 + n), n, 20, 60)
    assert no_lcs_zero(strings)
    want = []
    j_dist_sharded.mst_prim_tree_sharded(
        padded(JSequence, strings), want, j_mesh.make_mesh(size))
    got = []
    mst_prim_tree_sharded(padded(TSequence, strings), got, cpu_mesh(size),
                          chunk=chunk)
    assert got == want
    assert got == host_tree(strings)


@pytest.mark.parametrize("size", (2, 3, 4))
def test_tree_sharded_ties_matches_host(size):
    """A family of close relatives (the tie keys decide), chunks of 6."""
    strings = family_strings(np.random.default_rng(8), 25, 40)
    got = []
    mst_prim_tree_sharded(padded(TSequence, strings), got, cpu_mesh(size),
                          chunk=6)
    assert got == host_tree(strings)


@pytest.mark.parametrize("size,n", [(2, 10), (3, 11), (8, 9)])
def test_tree_sharded_polyq_matches_host(size, n, monkeypatch):
    """Poly-Q families (flagged references, K9 on every shard, reading
    the global flags at the global cur with the shard's own queries):
    equal to famsa_tpu's host Prim, where its sharded program differs
    (ROADMAP C2).  Every round calls K1 wave and K9 once a shard and K8
    once."""
    strings = polyq_strings(n, 20 + n)
    seqs = padded(TSequence, strings)
    assert famsa_flags(pad_sequences(seqs)).any()
    calls = {"wave": 0, "k9": 0, "k8": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mesh, "lcs_rows", counted("wave", mesh.lcs_rows))
    monkeypatch.setattr(mesh, "lcs_refmask", counted("k9", mesh.lcs_refmask))
    monkeypatch.setattr(mesh, "prim_round", counted("k8", mesh.prim_round))
    got = []
    mst_prim_tree_sharded(seqs, got, cpu_mesh(size), chunk=4)
    assert got == host_tree(strings)
    assert calls == {"wave": size * (n - 1), "k9": size * (n - 1),
                     "k8": n - 1}


@pytest.mark.parametrize("size", SHARDS)
@pytest.mark.parametrize("measure", [DIST_INDEL075_DIV_LCS,
                                     DIST_INDEL_DIV_LCS])
def test_sharded_distance_backend_matches_famsa_tpu(measure, size):
    """row, row_prefix (a prefix sweep in blocks of 4: shards past a
    block's last query stay idle) and rows_batch, float64 and float32,
    flagged references on K9, against famsa_tpu's DistanceBackend."""
    strings = polyq_strings(13, 5, lo=20, hi=60, every=3)
    n = len(strings)
    jseqs = padded(JSequence, strings)
    tseqs = padded(TSequence, strings)
    for dtype in (np.float64, np.float32):
        want = DistanceBackend(jseqs, measure, dtype)
        got = ShardedDistanceBackend(tseqs, measure, dtype, cpu_mesh(size),
                                     block_rows=4)
        assert got.flags.any()
        for i in range(n):
            assert np.array_equal(got.row_prefix(i, i), want.row_prefix(i, i))
        ids = np.array([3, 0, 12, 2, 9])
        assert np.array_equal(got.rows_batch(ids), want.rows_batch(ids))
        sub = np.array([1, 4, 11])
        assert np.array_equal(got.rows_batch(ids, sub),
                              want.rows_batch(ids, sub))
        assert np.array_equal(got.row(6, sub), want.row(6, sub))
        assert np.array_equal(got.row(0), want.row(0))


def _fasta(path, strings):
    path.write_text("".join(f">s{k}\n{s}\n" for k, s in enumerate(strings)))
    return path


# __graft_entry__.py:dryrun_multichip's family and medoid parameters at 4
# devices, and a poly-Q family
E2E = {
    "default": ([], "dryrun"),
    "polyq_default": ([], "polyq"),
    "medoidtree": (["-medoidtree", "-medoid_threshold", "8",
                    "-subtree_size", "3", "-sample_size", "8"], "dryrun"),
    "upgma": (["-gt", "upgma"], "dryrun"),
    "dist_export": (["-dist_export"], "polyq"),
}


@pytest.mark.parametrize("name", list(E2E))
def test_compute_msa_sharded_matches_famsa_tpu_numpy(name, tmp_path,
                                                     monkeypatch):
    """Whole runs of the port's CLI with a 4-shard CPU mesh in
    auto_mesh's cache, byte-equal to famsa_tpu -backend numpy; the guide
    tree took the sharded route."""
    flags, fam = E2E[name]
    if fam == "dryrun":
        rng = np.random.default_rng(42)
        strings = ["".join(AA[rng.integers(0, 20)] for _ in range(
            int(rng.integers(50, 100)))) for _ in range(12)]
    else:
        strings = polyq_strings(12, 9, lo=30, hi=60)
    fa = _fasta(tmp_path / "fam.fa", strings)
    want, got = tmp_path / "want", tmp_path / "got"
    assert j_main(["-backend", "numpy"] + flags + [str(fa), str(want)]) == 0
    monkeypatch.setattr(mesh, "_AUTO_MESH", {"rows": cpu_mesh(4)})
    sharded = {"tree": 0, "rows": 0}
    orig_tree = mesh.prim_round_sharded
    orig_rows = TorchDistanceBackend._lcs_block

    def tree_round(*a, **kw):
        sharded["tree"] += 1
        return orig_tree(*a, **kw)

    def rows(self, *a, **kw):
        sharded["rows"] += isinstance(self, ShardedDistanceBackend)
        return orig_rows(self, *a, **kw)

    monkeypatch.setattr(
        "famsa_tpu_torch.parallel.dist_sharded.prim_round_sharded",
        tree_round)
    monkeypatch.setattr(TorchDistanceBackend, "_lcs_block", rows)
    assert t_main(["-backend", "torch", "-device", "cpu"] + flags
                  + [str(fa), str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    if name.endswith("default"):
        assert sharded["tree"] == len(set(strings)) - 1
    else:
        assert sharded["rows"] > 0 and sharded["tree"] == 0
