"""famsa_tpu_torch's column axis of multi-device sharding
(parallel/dp_sharded.py, parallel/mesh.py:cols_mesh and dp_row_sharded,
the routing in core/aligner.py and pipeline.py) on meshes of "cpu"
shards, where K10's tickets (ops/dp_wide.py:ShardTable, dp_shard: one
launch a shard, in any order) run its plain version
(ops/dp_wide.py:dp_shard_plain) a slice at a time, or every (shard, row
block) of the block pipeline runs it, against the famsa_tpu package: its host
DP (famsa_tpu.core.dp.dp_prof_prof / dp_seq_prof), its column-sharded
program (famsa_tpu.parallel.dp_sharded, on JAX's 8-device CPU mesh,
tests/conftest.py), its dp_row_sharded, and whole runs of -backend numpy
on __graft_entry__.py:dryrun_multichip's families.

Meshes of 1, 2, 3, 4 and 8 shards; w2 + 1 not divisible by the shard
count and slices of one column; row blocks of one row and blocks that
do not divide w1; folds inside a slice (fold_geometry forced to 32-column
folds); guided bands with slices outside a row's band; a gap run across
two shard boundaries; launches issued in permuted orders; the peer-access
rule of a mesh over two cards (torch.cuda.can_device_access_peer
monkeypatched).  Tolerance: exact.  Unguided direction bytes are
compared as tests/test_torch_dp.py does (D everywhere, H and V on
[1:, 1:], against the host DP) and in full against the port's one-device
plain DP (dp_plain); finals, paths and totals must be equal; whole runs
byte-identical.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from famsa_tpu.cli import main as j_main
from famsa_tpu.core.construct import _trace_path
from famsa_tpu.core.dp import find_row_ranges
from famsa_tpu.parallel import dp_sharded as j_dp_sharded
from famsa_tpu.parallel import mesh as j_mesh
from famsa_tpu_torch import kernels
from famsa_tpu_torch.cli import main as t_main
from famsa_tpu_torch.core import aligner as t_aligner
from famsa_tpu_torch.core.dp_native import finish_path, row_ranges
from famsa_tpu_torch.ops import dp_wide
from famsa_tpu_torch.ops.dp_torch import dp_plain, pack_batch, prepare_merge
from famsa_tpu_torch.ops.dp_wide import dp_shard, dp_shard_plain
from famsa_tpu_torch.parallel import dp_sharded, mesh

from test_dp_jax_parity import _make_profile
from test_torch_dp import _check, _params, _port, _ref, _split_case

AA = "ARNDCQEGHILKMFPSTWYV"


def cpu_mesh(size):
    return mesh.make_mesh(["cpu"] * size)


@pytest.fixture
def small_folds(monkeypatch):
    """fold_geometry down to 32-column folds, so slices of more than 32
    columns cross folds inside a shard."""
    monkeypatch.setattr(dp_wide, "MIN_FOLD_COLS", 16)


def _plain(tp, a, b, band=None):
    """The port's one-device plain DP of (a, b): dirs [w1+1, w2+1] and
    fin [w1, 3]."""
    colf, rowf, meta, total = pack_batch([prepare_merge(tp, a, b, band)])
    d, f = dp_plain(*(torch.from_numpy(x) for x in (colf, rowf, meta)),
                    total)
    w1, w2 = a.width, b.width
    return d.numpy().reshape(w1 + 1, w2 + 1), f[0, :w1].numpy()


def _last(fin):
    return tuple(int(v) for v in fin[-1])


# (shards, n1, n2, w1, w2, block): seq-prof and prof-prof; one shard;
# w2 + 1 divisible and not; slices of one column (w2 + 1 = shards);
# blocks of one row, blocks that do not divide w1, one block
SHARD_CASES = [
    (1, 1, 4, 30, 50, 256),
    (2, 3, 4, 40, 55, 7),
    (3, 2, 3, 37, 63, 1),
    (4, 3, 3, 25, 3, 10),
    (4, 1, 5, 30, 14, 8),
    (8, 2, 4, 33, 70, 16),
    (8, 4, 2, 21, 120, 5),
]


@pytest.mark.parametrize("size,n1,n2,w1,w2,block", SHARD_CASES)
def test_sharded_matches_host_dp(size, n1, n2, w1, w2, block, small_folds):
    """dp_profile_sharded against famsa_tpu's host DP and the port's
    one-device plain DP: every direction byte, the finals of every row,
    the path and the total."""
    rng = np.random.default_rng(size * 1000 + w1 * 7 + w2)
    jp, tp = _params()
    a = _make_profile(rng, jp, n1, w1, gap_frac=0.0 if n1 == 1 else 0.2)
    b = _make_profile(rng, jp, n2, w2)
    ta, tb = _port(tp, a), _port(tp, b)
    dirs, fin = dp_sharded.dp_profile_sharded(tp, ta, tb, cpu_mesh(size),
                                              block=block)
    _check(_ref(jp, a, b), dirs, _last(fin), w1, w2)
    want_d, want_f = _plain(tp, ta, tb)
    assert np.array_equal(dirs, want_d)
    assert np.array_equal(fin, want_f)


def test_sharded_gap_run_crosses_shards():
    """Profiles of very different widths: the best H run starts on one
    shard and ends two shards later, so each slice's scan starts from the
    carry of the one before it; 2^22-scaled costs (edges past 32 bits)."""
    rng = np.random.default_rng(5)
    jp, tp = _params(shift=22)
    a = _make_profile(rng, jp, 3, 8)
    b = _make_profile(rng, jp, 2, 120)
    ta, tb = _port(tp, a), _port(tp, b)
    dirs, fin = dp_sharded.dp_profile_sharded(tp, ta, tb, cpu_mesh(4),
                                              block=3)
    ref = _ref(jp, a, b)
    _check(ref, dirs, _last(fin), a.width, b.width)
    path, _ = _trace_path(ref, a.width, b.width)
    # an H run (a gap in profile1) over columns of three shards or more
    j, runs, cur = 0, [], None
    for code in path:
        if code == 1:
            cur = j if cur is None else cur
        elif cur is not None:
            runs.append((cur, j))
            cur = None
        j += code != 2
    if cur is not None:
        runs.append((cur, j))
    bounds = cpu_mesh(4).bounds(b.width + 1)
    shard_of = [next(s for s, (c0, c1) in enumerate(bounds) if c0 <= col < c1)
                for col in range(b.width + 1)]
    assert any(shard_of[e] - shard_of[s0] >= 2 for s0, e in runs)


@pytest.mark.parametrize("size,radius,block", [(3, 50, 8), (8, 3, 5),
                                               (4, 3, 1)])
def test_sharded_guided_band(size, radius, block, small_folds):
    """A refinement-style guided merge on the band of find_row_ranges:
    path and total against famsa_tpu's host DP, every byte and final
    against the port's one-device plain DP; at radius 3 on 8 shards a
    row's band misses whole slices."""
    rng = np.random.default_rng(53 + radius + size)
    jp, tp = _params()
    jp.guided_alignment_radius = tp.guided_alignment_radius = radius
    a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 100, lambda k: k % 2 == 0)
    ta, tb = _port(tp, a), _port(tp, b)
    band = row_ranges(tp, cm1, cm2)
    m = cpu_mesh(size)
    dirs, fin = dp_sharded.dp_profile_sharded(tp, ta, tb, m, band=band,
                                              block=block)
    path, total = _trace_path(_ref(jp, a, b, (cm1, cm2)), a.width, b.width)
    res = finish_path(dirs, a.width, b.width, _last(fin))
    assert res.total == total
    assert list(res.path) == list(path)
    want_d, want_f = _plain(tp, ta, tb, band)
    assert np.array_equal(dirs, want_d)
    assert np.array_equal(fin, want_f)
    if radius == 3:
        lo, hi = band[1:a.width + 1, 0], band[1:a.width + 1, 1]
        assert any(((hi < c0) | (lo > c1 - 1)).any()
                   for c0, c1 in m.bounds(b.width + 1))
    got = dp_sharded.dp_profile_sharded_paths(tp, ta, tb, m, band=band,
                                              block=block)
    assert got.total == total and list(got.path) == list(path)


@pytest.mark.parametrize("size,guided", [(3, False), (4, True)])
def test_sharded_paths_match_famsa_tpu_sharded(size, guided):
    """dp_profile_sharded_paths against famsa_tpu's
    dp_profile_sharded_paths on JAX's CPU mesh of as many devices."""
    rng = np.random.default_rng(9 + size)
    jp, tp = _params()
    if guided:
        a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 60, 80,
                                     lambda k: k % 2 == 1)
        rr = find_row_ranges(cm1, cm2, jp.guided_alignment_radius)
        bands = (np.fromiter((r[0] for r in rr), np.int32, len(rr)),
                 np.fromiter((r[1] for r in rr), np.int32, len(rr)))
        band = row_ranges(tp, cm1, cm2)
    else:
        a, b = _make_profile(rng, jp, 3, 60), _make_profile(rng, jp, 4, 90)
        bands = band = None
    want = j_dp_sharded.dp_profile_sharded_paths(
        jp, a, b, j_mesh.make_mesh(size, axis="cols"), bands=bands)
    got = dp_sharded.dp_profile_sharded_paths(tp, _port(tp, a), _port(tp, b),
                                              cpu_mesh(size), band=band,
                                              block=16)
    assert got.total == want.total
    assert list(got.path) == list(want.path)


# (shards, w1, w2, issue order, guided): the launches of K10's ticket
# route issued in reverse pipeline order, interleaved, last-first, and a
# slice of one column
TICKET_ORDERS = [
    (3, 30, 80, (2, 1, 0), False),
    (4, 25, 90, (1, 3, 0, 2), True),
    (5, 20, 60, (4, 0, 1, 2, 3), False),
    (4, 12, 3, (3, 2, 1, 0), False),
]


@pytest.mark.parametrize("size,w1,w2,order,guided", TICKET_ORDERS)
def test_ticket_order_does_not_change_bytes(size, w1, w2, order, guided,
                                            small_folds):
    """K10's route with one launch a shard (dp_shard on the CPU: the
    slice of the table's next ticket, dp_shard_plain over every row),
    launches issued in a permuted order: every direction byte and final
    equal the pipeline order's, the (shard, block) pipeline's and the
    one-device plain DP's, and the path and total famsa_tpu's host DP's."""
    rng = np.random.default_rng(size * 31 + w2)
    jp, tp = _params()
    if guided:
        a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, w1, w2,
                                     lambda k: k % 2 == 0)
        band = row_ranges(tp, cm1, cm2)
        ref = _ref(jp, a, b, (cm1, cm2))
    else:
        a, b = _make_profile(rng, jp, 3, w1), _make_profile(rng, jp, 2, w2)
        band, ref = None, _ref(jp, a, b)
    ta, tb = _port(tp, a), _port(tp, b)
    m = cpu_mesh(size)
    got = dp_sharded.dp_profile_sharded(tp, ta, tb, m, band=band,
                                        order=order)
    fwd = dp_sharded.dp_profile_sharded(tp, ta, tb, m, band=band)
    blocks = dp_sharded.dp_profile_sharded(tp, ta, tb, m, band=band,
                                           block=4)
    want = _plain(tp, ta, tb, band)
    for other in (fwd, blocks, want):
        assert np.array_equal(got[0], other[0])
        assert np.array_equal(got[1], other[1])
    path, total = _trace_path(ref, a.width, b.width)
    res = finish_path(got[0], a.width, b.width, _last(got[1]))
    assert res.total == total and list(res.path) == list(path)
    with pytest.raises(ValueError, match="permutation"):
        dp_sharded.dp_profile_sharded(tp, ta, tb, m, order=order[1:])


def test_tables_take_tickets_in_pipeline_order():
    """shard_tables groups a merge's slices by device in pipeline order
    and links each to its consumer; dp_shard on a CPU table runs the
    slices in ticket order whatever called it, and past the last ticket
    does nothing."""
    rng = np.random.default_rng(4)
    jp, tp = _params()
    a, b = _make_profile(rng, jp, 2, 15), _make_profile(rng, jp, 3, 40)
    colf, rowf, _, _ = pack_batch([prepare_merge(tp, _port(tp, a),
                                                 _port(tp, b))])
    colf, rowf = torch.from_numpy(colf[0]), torch.from_numpy(rowf[0])
    w1, bounds = a.width, cpu_mesh(3).bounds(b.width + 1)
    eins = [None] + [torch.zeros((w1, 3), dtype=torch.int64)
                     for _ in bounds[1:]]
    slices = [dp_wide.ShardSlice(
        dp_wide.shard_columns(colf, c0, c1, "cpu"), rowf,
        torch.zeros((w1 + 1, c1 - c0), dtype=torch.uint8),
        torch.zeros((w1, 3), dtype=torch.int64), eins[k],
        eins[k + 1] if k + 1 < len(bounds) else None, c0, c1)
        for k, (c0, c1) in enumerate(bounds)]
    tables, of = dp_wide.shard_tables(slices, w1)
    assert len(tables) == 1 and of == [tables[0]] * 3
    t = tables[0]
    assert t.nexts == [(t, 1), (t, 2), None]
    assert t.prev_peer == [False] * 3
    assert t.geometry == dp_wide.fold_geometry(
        max(c1 - c0 for c0, c1 in bounds) - 1)
    for _ in range(4):              # three slices, then past the last
        dp_shard(t)
    assert t.ticket == 4
    dirs = torch.cat([sl.dirs for sl in slices], dim=1).numpy()
    want_d, want_f = _plain(tp, _port(tp, a), _port(tp, b))
    assert np.array_equal(dirs, want_d)
    assert np.array_equal(slices[-1].fin.numpy(), want_f)


def _fake_mesh(indices):
    return mesh.Mesh(types.SimpleNamespace(device=torch.device("cuda", i))
                     for i in indices)


def test_cols_mesh_peer_rule(monkeypatch):
    """A "cols" mesh over two cards needs peer access from each shard's
    card to the next one's (K10 writes the next slice's edges there):
    cols_mesh and check_peers raise without it; shards on one card need
    none; the check reads each consecutive pair of distinct cards."""
    asked = []

    def peer(a, b, ok=set()):
        asked.append((a.index, b.index))
        return (a.index, b.index) in ok

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", peer)
    monkeypatch.setattr(mesh, "_AUTO_MESH", {})
    monkeypatch.setenv("FAMSA_TORCH_SHARD_DP_CELLS", "0")
    mesh.check_peers(_fake_mesh([0, 0, 0]))
    assert asked == []
    two = _fake_mesh([0, 0, 1, 1])
    mesh._AUTO_MESH["cols"] = two
    with pytest.raises(ValueError, match="peer access"):
        mesh.cols_mesh(_prof(10), _prof(100), "cuda")
    assert asked == [(0, 1)]
    with pytest.raises(ValueError, match="peer access"):
        mesh.check_peers(_fake_mesh([1, 0]))
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    assert mesh.cols_mesh(_prof(10), _prof(100), "cuda") is two
    mesh.check_peers(_fake_mesh([0, 1, 2, 3]))


def test_dp_row_sharded_matches_famsa_tpu():
    """The port's dp_row_sharded on 8 shards and on 3 uneven ones against
    famsa_tpu's on JAX's 8-device mesh, one row of 512 columns."""
    rng = np.random.default_rng(1)
    w = 512
    args = [rng.integers(-10**9, 10**9, size=w) for _ in range(3)] + [
        rng.integers(-10**6, 10**6, size=w) for _ in range(7)]
    want = j_mesh.dp_row_sharded(j_mesh.make_mesh(axis="cols"),
                                 *(jnp.asarray(x.astype(np.int64))
                                   for x in args))
    for size in (8, 3):
        bounds = cpu_mesh(size).bounds(w)
        split = [[torch.from_numpy(x[c0:c1].astype(np.int64))
                  for c0, c1 in bounds] for x in args]
        got = mesh.dp_row_sharded(*split)
        for g, wnt in zip(got, want):
            assert np.array_equal(torch.cat(g).numpy(), np.asarray(wnt))


def _prof(width):
    return types.SimpleNamespace(width=width)


def test_cols_mesh_rule(monkeypatch):
    """cols_mesh: no mesh unless a caller set one for the device type; a
    merge takes it from FAMSA_TORCH_SHARD_DP_CELLS cells (default 2e8),
    with at least one column a shard and at most MAX_W2 + 1 (K10's
    widest body) in every slice; split_sharded routes by it in
    align_into's operand order."""
    monkeypatch.setattr(mesh, "_AUTO_MESH", {})
    monkeypatch.delenv("FAMSA_TORCH_SHARD_DP_CELLS", raising=False)
    assert mesh.cols_mesh(_prof(20000), _prof(20000), "cpu") is None
    m = cpu_mesh(3)
    mesh._AUTO_MESH["cols"] = m
    assert mesh.auto_mesh("cols", "cpu") is m
    assert mesh.auto_mesh("rows", "cpu") is None
    assert mesh.cols_mesh(_prof(20000), _prof(20000), "cuda") is None
    # the default threshold, 2e8 cells
    assert mesh.cols_mesh(_prof(10000), _prof(20000), "cpu") is m
    assert mesh.cols_mesh(_prof(9999), _prof(20000), "cpu") is None
    monkeypatch.setenv("FAMSA_TORCH_SHARD_DP_CELLS", "1000")
    assert mesh.cols_mesh(_prof(10), _prof(100), "cpu") is m
    assert mesh.cols_mesh(_prof(10), _prof(99), "cpu") is None
    # every slice within MAX_W2 + 1 columns: 3 * 32768 columns fit
    cols = 3 * (dp_wide.MAX_W2 + 1)
    assert mesh.cols_mesh(_prof(10), _prof(cols - 1), "cpu") is m
    assert mesh.cols_mesh(_prof(10), _prof(cols), "cpu") is None
    # one column a shard at least
    monkeypatch.setenv("FAMSA_TORCH_SHARD_DP_CELLS", "0")
    assert mesh.cols_mesh(_prof(10), _prof(2), "cpu") is m
    assert mesh.cols_mesh(_prof(10), _prof(1), "cpu") is None
    # split_sharded: the operands in align_into's order (a single
    # sequence first), so the limit reads the wider profile's columns
    monkeypatch.setenv("FAMSA_TORCH_SHARD_DP_CELLS", "1000")
    jp, tp = _params()
    rng = np.random.default_rng(3)
    seq = _port(tp, _make_profile(rng, jp, 1, 30, gap_frac=0.0))
    prof = _port(tp, _make_profile(rng, jp, 3, 40))
    small = _port(tp, _make_profile(rng, jp, 2, 20))
    ready = [(7, prof, seq), (8, small, seq)]
    sharded, rest = t_aligner.split_sharded(ready, "cpu")
    assert sharded == [ready[0]] and rest == [ready[1]]
    mesh._AUTO_MESH.clear()
    assert t_aligner.split_sharded(ready, "cpu") == ([], ready)


def test_cpu_path_never_calls_kernels_get(monkeypatch):
    """On "cpu" shards the route runs dp_shard_plain and never loads a
    kernel; K10's wrapper checks its arguments and raises on another
    device type."""
    def no_kernels(name):
        raise AssertionError(f"kernels.get({name!r}) on the CPU")

    monkeypatch.setattr(kernels, "get", no_kernels)
    rng = np.random.default_rng(2)
    jp, tp = _params()
    a, b = _make_profile(rng, jp, 2, 20), _make_profile(rng, jp, 3, 30)
    ta, tb = _port(tp, a), _port(tp, b)
    before = dict(kernels.LAUNCHES)
    res = dp_sharded.dp_profile_sharded_paths(tp, ta, tb, cpu_mesh(3),
                                              block=4)
    assert kernels.LAUNCHES == before
    path, total = _trace_path(_ref(jp, a, b), a.width, b.width)
    assert res.total == total and list(res.path) == list(path)
    with pytest.raises(ValueError):
        dp_sharded.dp_profile_sharded(tp, ta, tb, cpu_mesh(3), block=0)
    with pytest.raises(ValueError):      # 31 columns on 32 shards
        dp_sharded.dp_profile_sharded(tp, ta, tb, cpu_mesh(32))

    w1, n = 4, 6
    colf = dp_wide.shard_columns(torch.zeros((44, 10), dtype=torch.int64),
                                 2, 2 + n, "cpu")
    args = dict(colf=colf, rowf=torch.zeros((w1 + 1, 77), dtype=torch.int64),
                w1=w1, cs=2, c1=2 + n, r0=1, r1=w1 + 1,
                dirs=torch.zeros((w1 + 1, n), dtype=torch.uint8),
                fin=torch.zeros((w1, 3), dtype=torch.int64),
                state=torch.zeros((3, n + 1), dtype=torch.int64),
                ein=torch.zeros((w1, 3), dtype=torch.int64))
    for bad in (dict(ein=None), dict(r0=0), dict(r1=w1 + 2),
                dict(state=torch.zeros((3, n), dtype=torch.int64)),
                dict(state=None, r1=w1), dict(colf=colf[:, :n + 2]),
                dict(fin=torch.zeros((w1, 3), dtype=torch.int32))):
        with pytest.raises((ValueError, TypeError)):
            dp_shard_plain(**{**args, **bad})
    # K10's table checks each slice as a whole one (every row)
    sl = dict((k, args[k]) for k in ("colf", "rowf", "dirs", "fin", "ein",
                                     "cs", "c1"))
    for bad in (dict(ein=None), dict(colf=colf[:, :n + 2]),
                dict(fin=torch.zeros((w1, 3), dtype=torch.int32)),
                dict(eout=torch.zeros((w1 - 1, 3), dtype=torch.int64))):
        with pytest.raises((ValueError, TypeError)):
            dp_wide.ShardTable("cpu", [dp_wide.ShardSlice(
                **{"eout": None, **sl, **bad})], w1)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in sl.items()}
    table = dp_wide.ShardTable("meta", [dp_wide.ShardSlice(eout=None,
                                                           **meta)], w1)
    with pytest.raises(ValueError, match="unsupported device"):
        dp_shard(table)


def test_shard_plain_blocks_equal_one_launch():
    """K10's plain version over row blocks (its state and edges carried
    across them) equals one launch over every row, and its fold geometry
    does not change its outputs."""
    rng = np.random.default_rng(8)
    jp, tp = _params()
    a, b = _make_profile(rng, jp, 2, 23), _make_profile(rng, jp, 3, 70)
    colf, rowf, _, _ = pack_batch([prepare_merge(tp, _port(tp, a),
                                                 _port(tp, b))])
    colf, rowf = torch.from_numpy(colf[0]), torch.from_numpy(rowf[0])
    w1, cs, c1 = a.width, 30, 55
    sc = dp_wide.shard_columns(colf, cs, c1, "cpu")
    # the edge into column cs from the one-device walk of [0, cs)
    ein = torch.zeros((w1, 3), dtype=torch.int64)
    dp_shard_plain(dp_wide.shard_columns(colf, 0, cs, "cpu"), rowf, w1, 0,
                   cs, 1, w1 + 1, torch.zeros((w1 + 1, cs),
                                              dtype=torch.uint8),
                   torch.zeros((w1, 3), dtype=torch.int64),
                   torch.zeros((3, cs + 1), dtype=torch.int64), eout=ein)
    outs = []
    for blocks, fold_cols in (([(1, w1 + 1)], None),
                              ([(1, 2), (2, 9), (9, w1 + 1)], 32),
                              ([(r, r + 1) for r in range(1, w1 + 1)], 7)):
        o = [torch.zeros((w1 + 1, c1 - cs), dtype=torch.uint8),
             torch.zeros((w1, 3), dtype=torch.int64),
             torch.zeros((3, c1 - cs + 1), dtype=torch.int64),
             torch.zeros((w1, 3), dtype=torch.int64)]
        for r0, r1 in blocks:
            dp_shard_plain(sc, rowf, w1, cs, c1, r0, r1, o[0], o[1], o[2],
                           ein=ein, eout=o[3], fold_cols=fold_cols)
        outs.append(o)
    for o in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))


def _fasta(path, strings):
    path.write_text("".join(f">s{k}\n{s}\n" for k, s in enumerate(strings)))
    return path


# __graft_entry__.py:dryrun_multichip's families at 3 devices: its
# default path (refinement on at this size) and its MedoidTree route
DRYRUN = {
    "default": [],
    "medoidtree": ["-medoidtree", "-medoid_threshold", "8", "-subtree_size",
                   "3", "-sample_size", "8"],
}


@pytest.mark.parametrize("name", list(DRYRUN))
def test_dryrun_families_sharded_match_famsa_tpu_numpy(name, tmp_path,
                                                       monkeypatch):
    """Whole runs of the port's CLI with "cols" and "rows" meshes of 3 CPU
    shards in auto_mesh's cache and the shard threshold forced low (as
    dryrun_multichip forces famsa_tpu's), byte-equal to famsa_tpu
    -backend numpy; progressive merges and guided re-alignments took the
    column-sharded route."""
    rng = np.random.default_rng(42)
    strings = ["".join(AA[rng.integers(0, 20)] for _ in range(
        int(rng.integers(50, 100)))) for _ in range(9)]
    fa = _fasta(tmp_path / "fam.fa", strings)
    want, got = tmp_path / "want", tmp_path / "got"
    assert j_main(["-backend", "numpy"] + DRYRUN[name]
                  + [str(fa), str(want)]) == 0
    monkeypatch.setattr(mesh, "_AUTO_MESH", {"cols": cpu_mesh(3),
                                             "rows": cpu_mesh(3)})
    monkeypatch.setenv("FAMSA_TORCH_SHARD_DP_CELLS", "5000")
    calls = {"guided": 0, "unguided": 0}
    orig = dp_sharded.dp_profile_sharded_paths

    def counted(*a, band=None, **kw):
        calls["unguided" if band is None else "guided"] += 1
        return orig(*a, band=band, **kw)

    monkeypatch.setattr(dp_sharded, "dp_profile_sharded_paths", counted)
    assert t_main(["-backend", "torch", "-device", "cpu"] + DRYRUN[name]
                  + [str(fa), str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert calls["unguided"] > 0 and calls["guided"] > 0
