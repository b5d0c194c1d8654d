"""famsa_tpu_torch's device-resident DP route (ops/dp_stage0.py,
ops/merged_torch.py, ops/dp_resident.py and its use by the pipeline)
against the host prep of the port and against the famsa_tpu package.

- Stage 0 from counters equals ops/dp_pack.py:prepare_merge + pack_batch
  in every int64, padding included, and its scores equal famsa_tpu's
  device derivation (famsa_tpu.ops.dp_pallas._scores_from_counters, run
  by jax on the CPU) and famsa_tpu's Profile.scores.
- The merged counters equal famsa_tpu.ops.dp_pallas.
  merged_counters_device for the same forward path, and the host
  construct counters of the port and of famsa_tpu.
- Side assembly mixes resident, leaf and uploaded rows in one launch.
- Whole runs on the CPU (every merge on the device route) are
  byte-identical to famsa_tpu -backend numpy, and every side that a
  device merge produced for another device merge is read resident.

Tolerance: exact everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from famsa_tpu.core.construct_fast import construct_profile_fast as \
    j_construct
from famsa_tpu.core.params import Params as JParams
from famsa_tpu.core.profile import Profile as JProfile
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.ops.dp_pallas import JaxPathResult, merged_counters_device
from famsa_tpu.ops.dp_pallas import _scores_from_counters as j_scores
from famsa_tpu.pipeline import compute_msa as j_compute_msa
from famsa_tpu_torch import kernels
from famsa_tpu_torch import pipeline as t_pipeline
from famsa_tpu_torch.core.construct_fast import construct_profile_fast
from famsa_tpu_torch.core.dp_native import row_ranges
from famsa_tpu_torch.core.params import Params as TParams
from famsa_tpu_torch.core.profile import Profile as TProfile
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops import dp_torch, dp_wide
from famsa_tpu_torch.ops.dp_pack import pack_batch, prepare_merge
from famsa_tpu_torch.ops.dp_resident import (MergedRef, PathResult,
                                             assemble_side, dispatch_paths)
from famsa_tpu_torch.ops.dp_stage0 import (both_sides, score_table,
                                           scores_from_counters, stage0_plain)
from famsa_tpu_torch.ops.merged_torch import merged_counters

from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port, _split_case
from test_torch_pipeline import _family_strings

CPU = torch.device("cpu")


def _stage0_inputs(pairs, dtype=np.int32):
    """(c1, c2, hdr) of a batch as the route assembles them."""
    w1p = max(p1.width for p1, _ in pairs)
    w2p = max(p2.width for _, p2 in pairs)
    c1 = np.zeros((len(pairs), w1p + 1, 32), dtype=dtype)
    c2 = np.zeros((len(pairs), w2p + 1, 32), dtype=dtype)
    hdr = np.zeros((len(pairs), 8), dtype=np.int64)
    off = 0
    for k, (p1, p2) in enumerate(pairs):
        c1[k, :p1.width + 1] = p1.counters
        c2[k, :p2.width + 1] = p2.counters
        hdr[k] = (p1.width, p2.width, off, 0, len(p1.data), len(p2.data),
                  0, 0)
        off += (p1.width + 1) * (p2.width + 1)
    return torch.from_numpy(c1), torch.from_numpy(c2), torch.from_numpy(hdr)


def _band_rows(pairs, bands):
    w1p = max(p1.width for p1, _ in pairs)
    out = np.zeros((len(pairs), w1p + 1, 2), dtype=np.int64)
    for k, ((p1, p2), bd) in enumerate(zip(pairs, bands)):
        out[k, :, 1] = p2.width
        if bd is not None:
            out[k, :p1.width + 1] = bd[:p1.width + 1]
    return torch.from_numpy(out)


def _assert_stage0(tp, pairs, bands=None, dtype=np.int32):
    bands = bands or [None] * len(pairs)
    want = pack_batch([prepare_merge(tp, p1, p2, bd)
                       for (p1, p2), bd in zip(pairs, bands)])
    c1, c2, hdr = _stage0_inputs(pairs, dtype)
    band = None if all(b is None for b in bands) else _band_rows(pairs, bands)
    got = stage0_plain(tp, c1, c2, hdr, torch.from_numpy(score_table(tp)),
                       band)
    for name, g, w in zip(("colf", "rowf", "meta"), got[:3], want[:3]):
        assert g.dtype == torch.int64 and g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name


# (n1, n2, w1, w2) per merge: seq-prof and prof-prof; widest w2 odd and
# even (the even-ldc pad: w2 36 and 37 both give ldc 38)
@pytest.mark.parametrize("shapes", [
    [(1, 4, 30, 36)],
    [(3, 4, 40, 37)],
    [(1, 3, 20, 36), (4, 2, 33, 12), (2, 5, 7, 37), (3, 3, 1, 1)],
])
def test_stage0_equals_host_prep(shapes):
    rng = np.random.default_rng(sum(w1 + w2 for _, _, w1, w2 in shapes))
    jp, tp = _params()
    pairs = [(_port(tp, _make_profile(rng, jp, n1, w1,
                                      0.0 if n1 == 1 else 0.2)),
              _port(tp, _make_profile(rng, jp, n2, w2)))
             for n1, n2, w1, w2 in shapes]
    _assert_stage0(tp, pairs)


def test_stage0_banded_and_big_card():
    """Band rows of two guided merges (one launch, one merge unbanded),
    a cardinality above 2^16 read from int64 counters, and 2^22-scaled
    costs."""
    rng = np.random.default_rng(12)
    jp, tp = _params()
    a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 55, lambda k: k % 2 == 0)
    c, d, cm3, cm4 = _split_case(rng, jp, 2, 3, 30, 45, lambda k: k == 0)
    pairs = [(_port(tp, a), _port(tp, b)), (_port(tp, c), _port(tp, d)),
             (_port(tp, _make_profile(rng, jp, 2, 20)),
              _port(tp, _make_profile(rng, jp, 3, 50)))]
    _assert_stage0(tp, pairs, [row_ranges(tp, cm1, cm2),
                               row_ranges(tp, cm3, cm4), None])
    big = [(_port(tp, _make_profile(rng, jp, 70000, 6, 0.1)),
            _port(tp, _make_profile(rng, jp, 3, 9)))]
    _assert_stage0(tp, big, dtype=np.int64)
    jps, tps = _params(shift=22)
    scaled = [(_port(tps, _make_profile(rng, jps, 3, 25)),
               _port(tps, _make_profile(rng, jps, 2, 40)))]
    _assert_stage0(tps, scaled)


def test_scores_equal_famsa_tpu():
    """scores_from_counters = famsa_tpu's device derivation
    (_scores_from_counters) = famsa_tpu's Profile.scores."""
    rng = np.random.default_rng(8)
    jp, tp = _params()
    profs = [_make_profile(rng, jp, n, w) for n, w in ((1, 30), (5, 44),
                                                       (9, 17))]
    gp = (int(jp.gap_open), int(jp.gap_ext), int(jp.gap_term_open),
          int(jp.gap_term_ext))
    sm = jnp.asarray(np.asarray(jp.score_matrix, dtype=np.int64))
    for p in profs:
        c = torch.from_numpy(p.counters)[None]
        got = scores_from_counters(c, torch.tensor([len(p.data)]),
                                   torch.from_numpy(score_table(tp)))[0]
        want = np.asarray(j_scores(jnp.asarray(p.counters),
                                   jnp.int64(len(p.data)),
                                   jnp.int64(p.width), sm, gp))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), p.scores)


def _path(*runs):
    """A forward path from (code, length) runs."""
    return np.concatenate([np.full(n, c, dtype=np.int64) for c, n in runs])


# gap runs at both ends of both sides, runs of length 1 and 2 and longer,
# a gap run in one side right after one in the other
PATHS = [
    _path((1, 3), (0, 4), (2, 1), (0, 2), (1, 2), (0, 3), (2, 2), (0, 1),
          (1, 1), (0, 2), (2, 4)),
    _path((2, 2), (0, 3), (1, 1), (2, 1), (0, 5), (1, 5), (0, 1), (1, 3)),
    _path((0, 6), (1, 1), (0, 2), (2, 3), (0, 3), (1, 2), (0, 3)),
]


@pytest.mark.parametrize("k", range(len(PATHS)))
def test_merged_counters_equal_famsa_tpu_and_host(k):
    path = PATHS[k]
    w1, w2 = int((path != 1).sum()), int((path != 2).sum())
    rng = np.random.default_rng(40 + k)
    jp, tp = _params()
    ja = _make_profile(rng, jp, 3 + k, w1)
    jb = _make_profile(rng, jp, 2, w2)
    ta, tb = _port(tp, ja), _port(tp, jb)
    s = len(path) + 3                          # sentinel tail
    fwd = np.full(s, 3, dtype=np.int64)
    fwd[:len(path)] = path
    card1, card2 = len(ja.data), len(jb.data)
    hdr = torch.tensor([[w1, w2, 0, 0, card1, card2, 0, 0]])
    sides = both_sides(torch.from_numpy(ta.counters)[None],
                       torch.from_numpy(tb.counters)[None], hdr)
    got = merged_counters(sides, torch.from_numpy(fwd)[None])[0].numpy()
    want_dev = np.asarray(merged_counters_device(
        jnp.asarray(ja.counters, jnp.int32), jnp.asarray(jb.counters,
                                                         jnp.int32),
        jnp.asarray(fwd, jnp.int32), jnp.int32(w1), jnp.int32(w2),
        jnp.int32(card1), jnp.int32(card2)))
    assert got.dtype == np.int32 and np.array_equal(got, want_dev)
    dest_t = TProfile(tp)
    construct_profile_fast(dest_t, ta, tb, PathResult(path, 0))
    dest_j = JProfile(jp)
    j_construct(dest_j, ja, jb, JaxPathResult(list(path), 0))
    assert np.array_equal(got[:len(path) + 1], dest_t.counters)
    assert np.array_equal(dest_t.counters, dest_j.counters)
    assert not got[len(path) + 1:].any()


def test_side_assembly_mixes_resident_leaf_and_uploaded():
    """One side of a launch from a resident MergedRef (gathered out of a
    previous launch's merged counters), an ungapped leaf (its symbol
    bytes) and a gapped profile (uploaded counters): equal to the host
    counters, each row counted under its kind."""
    rng = np.random.default_rng(21)
    jp, tp = _params()
    a = _port(tp, _make_profile(rng, jp, 3, 30))
    b = _port(tp, _make_profile(rng, jp, 2, 26))
    first = dispatch_paths(tp, [(a, b)], dp_torch.dp_dirs,
                           want_merged=True).resolve()[0]
    merged = TProfile(tp)
    construct_profile_fast(merged, a, b, first)
    assert isinstance(first.merged_dev, MergedRef)
    leaf = _port(tp, _make_profile(rng, jp, 1, 41, 0.0))
    other = _port(tp, _make_profile(rng, jp, 4, 35))
    profs = [leaf, merged, other, leaf]
    devs = [None, first.merged_dev, None, None]
    wp = max(p.width for p in profs)
    kernels.reset_launches()
    got = assemble_side(profs, devs, wp, CPU)
    assert got.dtype == torch.int32 and got.shape == (4, wp + 1, 32)
    for k, p in enumerate(profs):
        assert np.array_equal(got[k, :p.width + 1].numpy(), p.counters)
        assert not got[k, p.width + 1:].any()
    tr = kernels.TRAFFIC
    assert (tr["sides_resident"], tr["sides_leaf"],
            tr["sides_uploaded"]) == (1, 2, 1)
    # the resident and leaf rows moved no counters: two leaves' symbol
    # bytes, one uploaded profile's counters, the index vector
    assert tr["bytes_up"] == 2 * wp + (wp + 1) * 32 * 4 + 8 * (2 + 3)


def test_calculate_counters_scores_drops_resident_copy():
    rng = np.random.default_rng(2)
    jp, tp = _params()
    p = _port(tp, _make_profile(rng, jp, 3, 20))
    p.dev_counters = MergedRef(torch.zeros((1, 21, 32), dtype=torch.int32),
                               0, 21)
    p.calculate_counters_scores()
    assert p.dev_counters is None


class _Residency:
    """Counts, independently of the route's own counters, the device
    dispatches' sides that a previous device merge produced (the
    pipeline's construct of a result with merged counters) and that the
    host did not change since; and the bytes of the paths the route may
    copy down (16 + w1 + w2 a merge)."""

    def __init__(self, monkeypatch):
        self.produced = {}
        self.expected = 0
        self.path_bytes = 0
        orig_construct = t_pipeline.construct_profile

        def construct(dest, p1, p2, res):
            out = orig_construct(dest, p1, p2, res)
            if getattr(res, "merged_dev", None) is not None:
                self.produced[id(dest)] = (dest, dest.counters)
            return out
        monkeypatch.setattr(t_pipeline, "construct_profile", construct)

        def count(p):
            seen = self.produced.get(id(p))
            return seen is not None and seen[0] is p \
                and seen[1] is p.counters

        orig_k2 = dp_torch.dp_profile_torch_paths_async
        orig_k3 = dp_wide.dp_profile_torch_wide_paths_async

        def k2(params, pairs, *a, **kw):
            self.expected += sum(count(p1) + count(p2) for p1, p2 in pairs)
            self.path_bytes += sum(16 + p1.width + p2.width
                                   for p1, p2 in pairs)
            return orig_k2(params, pairs, *a, **kw)

        def k3(params, p1, p2, *a, **kw):
            self.expected += count(p1) + count(p2)
            self.path_bytes += 16 + p1.width + p2.width
            return orig_k3(params, p1, p2, *a, **kw)
        monkeypatch.setattr(dp_torch, "dp_profile_torch_paths_async", k2)
        monkeypatch.setattr(dp_wide, "dp_profile_torch_wide_paths_async", k3)


def _jax_alignment(strings, refine):
    params = JParams()
    params.backend = "numpy"
    params.refinement_mode = refine
    res = j_compute_msa(params, [JSequence(f">s{k}", s, k)
                                 for k, s in enumerate(strings)])
    return [gs.decode() for gs in res.alignment]


@pytest.mark.parametrize("route,refine", [("default", "off"),
                                          ("k3", "off"),
                                          ("default", "on")])
def test_whole_run_resident(route, refine, monkeypatch):
    """Every merge on the device route (FAMSA_TORCH_DP_MIN_CELLS=0;
    "k3": every one on K3's route): byte-identical to famsa_tpu -backend
    numpy; every side a device merge produced for another is read
    resident (and only those), and the paths are all that comes down."""
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS", "0")
    if route == "k3":
        monkeypatch.setenv("FAMSA_TORCH_WIDE_MIN_CELLS", "0")
        monkeypatch.setenv("FAMSA_TORCH_MAX_BATCH", "1")
    monkeypatch.setattr(dp_wide, "MIN_FOLD_COLS", 16)
    watch = _Residency(monkeypatch)
    strings = _family_strings(31, 24, 60)
    params = TParams(backend="torch", device="cpu")
    params.refinement_mode = refine
    kernels.reset_launches()
    res = t_pipeline.compute_msa(params, [TSequence(f">s{k}", s, k)
                                          for k, s in enumerate(strings)])
    tr = dict(kernels.TRAFFIC)
    assert [gs.decode() for gs in res.alignment] == \
        _jax_alignment(strings, refine)
    assert tr["sides_resident"] == watch.expected > 0
    assert tr["sides_leaf"] > 0
    assert 0 < tr["bytes_down"] == watch.path_bytes
