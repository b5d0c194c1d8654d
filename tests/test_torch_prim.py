"""famsa_tpu_torch whole-tree MST-Prim (ops/prim_torch.py: the plain
twins of K1 wave and K8 on the CPU) against the famsa_tpu package: its
device Prim on the XLA path (mst_prim_tree_device(use_pallas=False)) and
its host Prim (tree/mst_prim.py on the host distance rows).  A chunk of 7
rounds makes the runs cross chunk boundaries; others divide the rounds
exactly, exceed them, or hold one round.  Tolerance: exact (equal tree
lists).  Round by round: tests/test_torch_prim_round.py.
"""

import numpy as np
import pytest

from famsa_tpu.core.params import DIST_INDEL075_DIV_LCS
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.ops.distance import DistanceBackend
from famsa_tpu.ops.prim_device import mst_prim_tree_device
from famsa_tpu.tree.mst_prim import mst_prim_tree
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops.prim_torch import mst_prim_tree_torch

AA = "ARNDCQEGHILKMFPSTWYV"


def _random_strings(rng, n, lmin, lmax):
    return ["".join(AA[k] for k in rng.integers(0, 20, size=int(
        rng.integers(lmin, lmax)))) for _ in range(n)]


def _family_strings(rng, n, length):
    """Close relatives (many near-equal distances, exercising the
    tie-break keys)."""
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


def _padded(cls, strings):
    seqs = [cls(f">s{i}", s, i) for i, s in enumerate(strings)]
    ml = max(s.length for s in seqs)
    for s in seqs:
        s.resize(ml)
    return seqs


@pytest.mark.parametrize("kind", ["random", "family"])
def test_prim_torch_matches_jax_and_host(kind, monkeypatch):
    rng = np.random.default_rng(3 if kind == "random" else 8)
    strings = (_random_strings(rng, 30, 10, 60) if kind == "random"
               else _family_strings(rng, 40, 50))

    jseqs = _padded(JSequence, strings)
    be = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
    tree_host = []
    mst_prim_tree(len(jseqs), lambda r, ids: be.row(r, ids), tree_host)

    monkeypatch.setenv("FAMSA_TPU_PRIM_CHUNK", "7")
    tree_jax = []
    mst_prim_tree_device(jseqs, tree_jax, use_pallas=False)

    tree_port = []
    mst_prim_tree_torch(_padded(TSequence, strings), tree_port,
                        device="cpu", chunk=7)

    assert tree_port == tree_host
    assert tree_port == tree_jax


def test_prim_torch_chunk_env_and_tiny(monkeypatch):
    """The FAMSA_TORCH_PRIM_CHUNK knob, and 1- and 2-sequence inputs."""
    rng = np.random.default_rng(21)
    strings = _random_strings(rng, 12, 20, 40)
    jseqs = _padded(JSequence, strings)
    be = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
    tree_host = []
    mst_prim_tree(len(jseqs), lambda r, ids: be.row(r, ids), tree_host)
    monkeypatch.setenv("FAMSA_TORCH_PRIM_CHUNK", "4")
    tree_port = []
    mst_prim_tree_torch(_padded(TSequence, strings), tree_port,
                        device="cpu")
    assert tree_port == tree_host

    one = []
    mst_prim_tree_torch(_padded(TSequence, strings[:1]), one, device="cpu")
    assert one == []
    two = []
    mst_prim_tree_torch(_padded(TSequence, strings[:2]), two, device="cpu")
    assert two == [(0, 1)]


@pytest.mark.parametrize("chunk", [8, 40, 1])
def test_prim_torch_chunk_boundaries(chunk):
    """25 sequences, 24 rounds: chunks that divide the rounds exactly (8),
    one chunk larger than them (40), and a chunk a round (1); the tree
    equals the host Prim's."""
    rng = np.random.default_rng(33)
    strings = _family_strings(rng, 25, 40)
    jseqs = _padded(JSequence, strings)
    be = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
    tree_host = []
    mst_prim_tree(len(jseqs), lambda r, ids: be.row(r, ids), tree_host)
    tree_port = []
    mst_prim_tree_torch(_padded(TSequence, strings), tree_port,
                        device="cpu", chunk=chunk)
    assert tree_port == tree_host
