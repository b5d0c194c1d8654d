"""famsa_tpu_torch's LCS in FAMSA's own layout and carry (kernel K9,
csrc/lcs.cu:lcs_refmask; on the CPU its plain version
ops/lcs_torch.py:lcs_refmask_plain) against the famsa_tpu package.

FAMSA builds 64-bit masks of the reference and takes a word's carry out
as V2 < V, which drops the carry where V & M is all ones and a carry comes
in: the host value departs from the exact LCS when some word k >= 1 of
the reference is one valid symbol (ops/lcs_torch.py:famsa_flags).  The
port sends such references to K9 (distance rows, Prim rounds) and the
rest to K1, which computes the exact LCS.  Covered here: the flag rule,
the plain version against famsa_tpu.ops.lcs.lcs_ref_vs_queries,
TorchDistanceBackend rows against famsa_tpu's DistanceBackend, the
routing (no K9 call for a family with no flagged sequence) and whole runs
of -backend torch -device cpu against famsa_tpu -backend numpy on seeded
poly-Q families.  Tolerance: exact (equal LCS values, byte-identical
trees, CSVs and alignments).
"""

import numpy as np
import pytest
import torch

from famsa_tpu.cli import main as j_main
from famsa_tpu.core.params import DIST_INDEL075_DIV_LCS
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.ops.distance import DistanceBackend
from famsa_tpu.ops.lcs import build_bit_masks, lcs_ref_vs_queries
from famsa_tpu_torch import kernels
from famsa_tpu_torch.cli import main as t_main
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops import lcs_torch, prim_torch
from famsa_tpu_torch.ops.lcs_torch import (PAD_SYMBOL, TorchDistanceBackend,
                                           famsa_flags, lcs_refmask,
                                           lcs_refmask_plain)

AMINO = "ARNDCQEGHILKMFPSTWYV"


def polyq_strings(n, seed, lo=60, hi=160, every=2, qlo=64, qhi=200):
    """n random sequences of length lo-hi; every `every`-th gets a
    poly-Q tract of qlo-qhi residues inserted at an offset of 0-63."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        s = "".join(rng.choice(list(AMINO), size=int(rng.integers(lo, hi + 1))))
        if k % every == 0:
            off = int(rng.integers(0, 64))
            s = s[:off] + "Q" * int(rng.integers(qlo, qhi + 1)) + s[off:]
        out.append(s)
    return out


def _padded(rows):
    """[N, L] int8 of symbol rows (lists of codes), padded with the no-op
    symbol."""
    lmax = max(len(r) for r in rows)
    pad = np.full((len(rows), lmax), PAD_SYMBOL, dtype=np.int8)
    for k, r in enumerate(rows):
        pad[k, :len(r)] = r
    return pad


def _random_codes(rng, n):
    return list(rng.integers(0, 20, size=n))


# case: (row maker, flagged): runs of one symbol at the word edges
FLAG_CASES = {
    # positions 0..63: word 0 only, which never has a carry in
    "word0_only": (lambda rng: [7] * 64 + _random_codes(rng, 40), False),
    # positions 64..127 (and more): word 1 is one symbol
    "word1": (lambda rng: _random_codes(rng, 64) + [7] * 64
              + _random_codes(rng, 10), True),
    # a run of 70 from offset 60 (60..129) covers word 1 (64..127) whole
    "straddle_covering": (lambda rng: _random_codes(rng, 60) + [3] * 70,
                          True),
    # a run of 64 from offset 10 fills no whole word
    "straddle_partial": (lambda rng: _random_codes(rng, 10) + [3] * 64
                         + _random_codes(rng, 80), False),
    # a run of a symbol >= 20 (no mask row) never flags
    "invalid_symbol": (lambda rng: _random_codes(rng, 64) + [22] * 128
                       + _random_codes(rng, 5), False),
    # a partial last word of one symbol is never all ones
    "partial_last_word": (lambda rng: _random_codes(rng, 64) + [9] * 63,
                          False),
    # word 2 (128..191) only
    "word2": (lambda rng: _random_codes(rng, 128) + [11] * 64, True),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_flag_rule(case):
    build, flagged = FLAG_CASES[case]
    rng = np.random.default_rng(5)
    row = build(rng)
    pad = _padded([row, _random_codes(rng, 50), _random_codes(rng, 300)])
    got = famsa_flags(pad)
    assert bool(got[0]) == flagged
    assert not got[1:].any()
    # the flag is exactly where FAMSA's value departs: against random
    # queries with long runs of the same symbol, an unflagged reference
    # gives the exact LCS (K1's plain version's value)
    queries = _padded([[row[0]] * 150, row, _random_codes(rng, 200)])
    refs = torch.from_numpy(pad[:1].astype(np.int32))
    q = torch.from_numpy(queries.astype(np.int32))
    famsa = lcs_refmask_plain(refs, q, q.shape[0])
    table = torch.from_numpy(
        lcs_torch.build_query_mask_table(queries).view(np.int32))
    exact = lcs_torch.lcs_plain(table, refs, q.shape[0])
    if not flagged:
        assert torch.equal(famsa, exact)


def _host_rows(pad, lengths, ref_ids):
    """famsa_tpu's host LCS of each reference against every row."""
    return np.stack([
        lcs_ref_vs_queries(build_bit_masks(pad[r][:lengths[r]], lengths[r]),
                           pad) for r in ref_ids])


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_refmask_plain_matches_famsa_tpu(seed):
    rows = [[AMINO.index(c) for c in s] for s in polyq_strings(24, seed)]
    pad = _padded(rows)
    lengths = np.array([len(r) for r in rows])
    flags = famsa_flags(pad)
    assert flags.any() and not flags.all()
    q = torch.from_numpy(pad.astype(np.int32))
    got = lcs_refmask_plain(q, q, q.shape[0]).numpy()
    want = _host_rows(pad, lengths, range(len(rows)))
    assert np.array_equal(got, want)
    # and K1's exact LCS differs from the host on flagged references only
    table = torch.from_numpy(
        lcs_torch.build_query_mask_table(pad).view(np.int32))
    exact = lcs_torch.lcs_plain(table, q, q.shape[0]).numpy()
    differs = (exact != want).any(axis=1)
    assert differs.any()
    assert not (differs & ~flags).any()


def test_refmask_wrapper_checks():
    q = torch.zeros((4, 70), dtype=torch.int32)
    with pytest.raises(TypeError):
        lcs_refmask(q.to(torch.int64), q)
    with pytest.raises(ValueError):
        lcs_refmask(q[:1], q, cur=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        lcs_refmask(q[:2], q, cur=torch.zeros(1, dtype=torch.int64),
                    flags=torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        lcs_refmask(q.to("meta"), q.to("meta"))
    # a Prim round: the row changes only when the reference is flagged
    pad = _padded([[4] * 140, _random_codes(np.random.default_rng(1), 90)])
    qq = torch.from_numpy(pad.astype(np.int32))
    flags = torch.from_numpy(famsa_flags(pad))
    assert flags.tolist() == [True, False]
    for v in (0, 1):
        row = torch.full((1, 2), -7, dtype=torch.int32)
        lcs_refmask(qq[v:v + 1], qq, out=row,
                    cur=torch.tensor([v], dtype=torch.int64), flags=flags)
        want = (lcs_refmask_plain(qq[v:v + 1], qq, 2) if v == 0
                else torch.full((1, 2), -7, dtype=torch.int32))
        assert torch.equal(row, want)


def _seqs(cls, strings):
    return [cls(f">s{k}", s) for k, s in enumerate(strings)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_distance_rows_match_famsa_tpu(seed, monkeypatch):
    """TorchDistanceBackend's rows (row, row_prefix, rows_batch) against
    famsa_tpu's DistanceBackend, each reference in the host role: flagged
    references through K9's plain version, the rest through K1's."""
    strings = polyq_strings(30, seed)
    jseqs = _seqs(JSequence, strings)
    tseqs = _seqs(TSequence, strings)
    want = DistanceBackend(jseqs, DIST_INDEL075_DIV_LCS, np.float64)
    got = TorchDistanceBackend(tseqs, DIST_INDEL075_DIV_LCS, np.float64,
                               device="cpu", block_rows=8)
    assert got.flags.any()
    calls = {"refmask": 0}
    orig = lcs_torch.lcs_refmask

    def counting(*a, **kw):
        calls["refmask"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(lcs_torch, "lcs_refmask", counting)
    n = len(strings)
    for i in range(n):
        assert np.array_equal(got.row_prefix(i, i), want.row_prefix(i, i))
    ids = np.array([3, 0, 17, 2, 29])
    assert np.array_equal(got.rows_batch(ids), want.rows_batch(ids))
    sub = np.array([1, 4, 28])
    assert np.array_equal(got.rows_batch(ids, sub),
                          want.rows_batch(ids, sub))
    assert np.array_equal(got.row(5, sub), want.row(5, sub))
    assert calls["refmask"] > 0


def test_unflagged_family_never_calls_refmask(monkeypatch):
    """A family with no flagged sequence runs what it ran before: no K9
    call in distance rows or in Prim rounds."""
    strings = polyq_strings(20, 9, every=1000)
    tseqs = _seqs(TSequence, strings)
    called = []
    monkeypatch.setattr(lcs_torch, "lcs_refmask",
                        lambda *a, **kw: called.append(1))
    monkeypatch.setattr(prim_torch, "lcs_refmask",
                        lambda *a, **kw: called.append(1))
    be = TorchDistanceBackend(tseqs, DIST_INDEL075_DIV_LCS, np.float64,
                              device="cpu")
    assert not be.flags.any()
    be.rows_batch(np.arange(len(strings)))
    prim_torch.mst_prim_tree_torch(tseqs, [], device="cpu")
    assert not called


def test_prim_rounds_call_refmask_each_round(monkeypatch):
    """With a flagged sequence every Prim round calls K9's wrapper once,
    after K1 wave and before K8, and never asks the host for cur."""
    strings = polyq_strings(12, 4)
    tseqs = _seqs(TSequence, strings)
    order = []
    orig_rows, orig_ref, orig_round = (prim_torch.lcs_rows,
                                       prim_torch.lcs_refmask,
                                       prim_torch.prim_round)

    def rows(*a, **kw):
        order.append("k1")
        return orig_rows(*a, **kw)

    def ref(*a, **kw):
        order.append("k9")
        return orig_ref(*a, **kw)

    def rnd(*a, **kw):
        order.append("k8")
        return orig_round(*a, **kw)

    monkeypatch.setattr(prim_torch, "lcs_rows", rows)
    monkeypatch.setattr(prim_torch, "lcs_refmask", ref)
    monkeypatch.setattr(prim_torch, "prim_round", rnd)
    prim_torch.mst_prim_tree_torch(tseqs, [], device="cpu")
    assert order == ["k1", "k9", "k8"] * (len(strings) - 1)


def test_cpu_path_never_builds_kernels(monkeypatch):
    def boom(name):
        raise AssertionError(f"kernels.get({name!r}) on the CPU path")
    monkeypatch.setattr(kernels, "get", boom)
    pad = _padded([[4] * 140, [4] * 90])
    q = torch.from_numpy(pad.astype(np.int32))
    lcs_refmask(q, q)


RUNS = {
    "default": [],
    "gt_export": ["-gt_export"],
    "dist_export": ["-dist_export"],
    "upgma_export": ["-gt", "upgma", "-gt_export"],
    "nj_export": ["-gt", "nj", "-gt_export"],
    "slink_export": ["-gt", "slink", "-gt_export"],
}


@pytest.fixture(scope="module")
def polyq_families(tmp_path_factory):
    base = tmp_path_factory.mktemp("polyq")
    out = {}
    for seed in (1, 2, 3):
        path = base / f"polyq{seed}.fa"
        path.write_text("".join(f">s{k}\n{s}\n" for k, s in
                                enumerate(polyq_strings(30, seed))))
        out[seed] = path
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("run", list(RUNS))
def test_polyq_runs_match_famsa_tpu_numpy(run, seed, polyq_families,
                                          tmp_path, monkeypatch):
    """-backend torch -device cpu gives famsa_tpu -backend numpy's bytes
    on the seeded poly-Q families (the default run, -gt_export and
    -dist_export departed before K9, when the device LCS took the exact
    value for flagged references too).  The profile DP stays on the host
    route (FAMSA_TORCH_DP_MIN_CELLS): the LCS is what differs here, and
    the device DP's plain versions would take a minute a run."""
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS", "1e18")
    fa = polyq_families[seed]
    flags = RUNS[run]
    want, got = tmp_path / "want", tmp_path / "got"
    assert j_main(["-backend", "numpy"] + flags + [str(fa), str(want)]) == 0
    assert t_main(["-backend", "torch", "-device", "cpu"] + flags
                  + [str(fa), str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
