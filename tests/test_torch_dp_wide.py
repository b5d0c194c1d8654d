"""famsa_tpu_torch wide-merge DP (ops/dp_wide.py; its plain PyTorch
version, the CPU path of kernel K3) against the batched plain DP
(ops/dp_torch.py:dp_plain) and the famsa_tpu package: the exact host DP
(famsa_tpu.core.dp) and the staggered-fold Pallas kernel in interpret
mode (famsa_tpu.ops.dp_giant).  Also the routing to K3 (core/aligner.py:
split_wide, wide_dp_ok, the guided route), fold_geometry and a whole run
with the wide route forced.

Tolerance: exact.  dp_wide_plain must equal dp_plain in every direction
byte and every per-row final; paths and totals must equal the host DP's
and the Pallas kernel's; whole runs must be byte-identical.  Fold widths
of 16-32 columns make small merges cross 3-6 folds.
"""

import shutil

import numpy as np
import pytest
import torch

from famsa_tpu.core.construct import _trace_path
from famsa_tpu.core.dp import dp_prof_prof, dp_seq_prof
from famsa_tpu_torch import kernels
from famsa_tpu_torch.core import aligner as t_aligner
from famsa_tpu_torch.core.dp_native import finish_path, row_ranges
from famsa_tpu_torch.core.params import Params as TParams
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops import dp_torch, dp_wide
from famsa_tpu_torch.ops.dp_torch import dp_plain, pack_batch, prepare_merge
from famsa_tpu_torch.ops.dp_wide import (MAX_W2, STAGED_MAX_W2,
                                         dp_dirs_wide, dp_profile_torch_wide,
                                         dp_wide_plain, fold_geometry,
                                         k3_variant)
from famsa_tpu_torch.pipeline import compute_msa as t_compute_msa

from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port, _split_case
from test_torch_pipeline import _run_jax


def _packed(tp, a, b, band=None):
    colf, rowf, meta, total = pack_batch([prepare_merge(tp, a, b, band)])
    return [torch.from_numpy(x) for x in (colf, rowf, meta)], total


def _assert_plain_equal(tp, a, b, band=None, fold_cols=16, blk=8):
    args, total = _packed(tp, a, b, band)
    want_d, want_f = dp_plain(*args, total)
    got_d, got_f = dp_wide_plain(*args, total, fold_cols=fold_cols, blk=blk)
    w1 = a.width
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_f[0, :w1], want_f[0, :w1])


# (n1, n2, w1, w2, fold_cols, blk): seq-prof and prof-prof; w2 + 1 not a
# multiple of the fold width; w2 the last column of a fold and one past
# it; w1 < blk and w1 not a multiple of blk; one fold; one row per step
PLAIN_CASES = [
    (1, 5, 30, 70, 16, 8),
    (3, 4, 40, 55, 16, 8),
    (2, 3, 37, 63, 16, 8),
    (2, 3, 37, 64, 16, 8),
    (4, 2, 5, 90, 32, 8),
    (3, 3, 41, 100, 20, 3),
    (2, 2, 20, 30, 32, 8),
    (2, 4, 12, 80, 16, 1),
]


@pytest.mark.parametrize("n1,n2,w1,w2,fold_cols,blk", PLAIN_CASES)
def test_wide_plain_equals_dp_plain(n1, n2, w1, w2, fold_cols, blk):
    rng = np.random.default_rng(n1 * 1000 + w1 * 7 + w2)
    jp, tp = _params()
    a = _make_profile(rng, jp, n1, w1, gap_frac=0.0 if n1 == 1 else 0.2)
    b = _make_profile(rng, jp, n2, w2)
    _assert_plain_equal(tp, _port(tp, a), _port(tp, b), fold_cols=fold_cols,
                        blk=blk)


def test_wide_plain_big_magnitudes():
    """Scores and gap costs scaled by 2^22: every cost term and the fold
    edges (D, V and the scan seed) exceed 32 bits."""
    rng = np.random.default_rng(23)
    jp, tp = _params(shift=22)
    a, b = _make_profile(rng, jp, 3, 40), _make_profile(rng, jp, 2, 110)
    _assert_plain_equal(tp, _port(tp, a), _port(tp, b), fold_cols=24)


@pytest.mark.parametrize("radius", [50, 3])
def test_wide_plain_guided_band(radius):
    """A refinement-style guided merge: the band complement reads -inf,
    and with radius 3 whole folds of a row lie outside the band."""
    rng = np.random.default_rng(53 + radius)
    jp, tp = _params()
    jp.guided_alignment_radius = tp.guided_alignment_radius = radius
    a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 100, lambda k: k % 2 == 0)
    _assert_plain_equal(tp, _port(tp, a), _port(tp, b),
                        row_ranges(tp, cm1, cm2), fold_cols=16)


@pytest.fixture
def small_folds(monkeypatch):
    """fold_geometry down to 32-column folds (one warp of stripe 1), so
    the default route of small merges crosses several folds."""
    monkeypatch.setattr(dp_wide, "MIN_FOLD_COLS", 16)


def _host(jp, a, b, cm=None):
    fn = dp_seq_prof if len(a.data) == 1 else dp_prof_prof
    return _trace_path(fn(jp, a, b, *(cm or ())), a.width, b.width)


@pytest.mark.parametrize("case", ["seq_prof", "prof_prof", "big", "guided"])
def test_wide_matches_host_dp(case, small_folds):
    """Path and total of dp_profile_torch_wide against famsa_tpu's host
    DP (unguided and guided)."""
    rng = np.random.default_rng(71)
    jp, tp = _params(shift=22 if case == "big" else 0)
    cm, band = None, None
    if case == "guided":
        a, b, cm1, cm2 = _split_case(rng, jp, 2, 3, 50, 110, lambda k: k == 0)
        cm = (list(cm1), list(cm2))
        band = row_ranges(tp, cm1, cm2)
    else:
        n1 = 1 if case == "seq_prof" else 4
        a = _make_profile(rng, jp, n1, 45, gap_frac=0.0 if n1 == 1 else 0.2)
        b = _make_profile(rng, jp, 3, 130)
    path, total = _host(jp, a, b, cm)
    assert fold_geometry(b.width)[0] >= 4
    dirs, last = dp_profile_torch_wide(tp, _port(tp, a), _port(tp, b), band)
    res = finish_path(dirs, a.width, b.width, last)
    assert res.total == total
    assert list(res.path) == list(path)


def _giant_case(monkeypatch, n1, n2, w1, w2, banded=False):
    from famsa_tpu.core.dp import find_row_ranges
    from famsa_tpu.ops import dp_giant
    monkeypatch.setattr(dp_giant, "_LWS", (32, 64))
    monkeypatch.setattr(dp_giant, "_w1_bucket",
                        lambda w: max(64, -(-w // 8) * 8))
    rng = np.random.default_rng(7 + w2)
    jp, tp = _params()
    bands = band = None
    if banded:
        a, b, cm1, cm2 = _split_case(rng, jp, n1, n2, w1, w2,
                                     lambda k: k % 2 == 0)
        rr = find_row_ranges(list(cm1), list(cm2), jp.guided_alignment_radius)
        bands = (np.fromiter((r[0] for r in rr), np.int32, len(rr)),
                 np.fromiter((r[1] for r in rr), np.int32, len(rr)))
        band = row_ranges(tp, cm1, cm2)
    else:
        a = _make_profile(rng, jp, n1, w1, gap_frac=0.0 if n1 == 1 else 0.2)
        b = _make_profile(rng, jp, n2, w2)
    want = dp_giant.dp_profile_giant_paths(jp, a, b, bands=bands,
                                           interpret=True)[0]
    dirs, last = dp_profile_torch_wide(tp, _port(tp, a), _port(tp, b), band)
    res = finish_path(dirs, a.width, b.width, last)
    assert res.total == want.total
    assert list(res.path) == list(want.path)


@pytest.mark.parametrize("n1,n2,w1,w2", [(3, 4, 40, 100), (1, 5, 30, 127)])
def test_wide_matches_giant_interpret(n1, n2, w1, w2, monkeypatch,
                                      small_folds):
    """Against the Pallas staggered-fold kernel it replaces (interpret
    mode, 32-lane folds): a 4-fold prof-prof merge and a seq-prof merge
    ending on a fold boundary."""
    _giant_case(monkeypatch, n1, n2, w1, w2)


@pytest.mark.slow
@pytest.mark.parametrize("n1,n2,w1,w2,banded", [
    (2, 2, 60, 64, False), (4, 3, 25, 31, False), (3, 4, 40, 100, True)])
def test_wide_matches_giant_interpret_more(n1, n2, w1, w2, banded,
                                           monkeypatch, small_folds):
    _giant_case(monkeypatch, n1, n2, w1, w2, banded)


def test_fold_geometry_edges():
    for w2 in (0, 1, 31, 255, 256, 1000, 4095, 4096, 8191, 8192, 16256,
               16383, 16384, MAX_W2):
        folds, threads, stripe = fold_geometry(w2)
        fw = threads * stripe
        assert 1 <= folds <= 16 and threads % 32 == 0 and threads <= 512
        assert stripe in (1, 2, 4)
        assert (folds - 1) * fw < w2 + 1 <= folds * fw, w2
    assert fold_geometry(255)[0] == 1 and fold_geometry(256)[0] == 2
    assert fold_geometry(4095) == (8, 512, 1)
    assert fold_geometry(8191) == (16, 512, 1)
    assert fold_geometry(16256) == (16, 512, 2)     # the JAX kernel's limit
    assert fold_geometry(MAX_W2) == (16, 512, 4)
    with pytest.raises(ValueError, match="K3 limit"):
        fold_geometry(MAX_W2 + 1)


@pytest.mark.parametrize("w2", [0, 255, 1227, 3844, 4014, STAGED_MAX_W2,
                                STAGED_MAX_W2 + 1, 16256, MAX_W2])
def test_k3_variant_by_width(w2):
    """The staged variant takes exactly the widths whose folds are one
    column a thread (at most 512 columns, the score planes' shared-memory
    tile); the stripes variant the rest, up to MAX_W2."""
    folds, threads, stripe = fold_geometry(w2)
    assert k3_variant(w2) == ("staged" if stripe == 1 else "stripes")
    assert (k3_variant(w2) == "staged") == (w2 <= STAGED_MAX_W2)
    if stripe == 1:
        assert threads <= 512 and folds * threads >= w2 + 1


@pytest.mark.parametrize("w2", [36, 37])
def test_pack_batch_even_ldc(w2):
    """pack_batch pads ldc to even (16-byte aligned planes for K3's bulk
    copies); the extra column changes no direction byte or final of the
    plain versions."""
    rng = np.random.default_rng(w2)
    jp, tp = _params()
    a = _port(tp, _make_profile(rng, jp, 3, 20))
    b = _port(tp, _make_profile(rng, jp, 2, w2))
    (colf, rowf, meta), total = _packed(tp, a, b)
    assert colf.shape[2] == w2 + 1 + (w2 + 1) % 2
    tight = colf[:, :, :w2 + 1].contiguous()
    want_d, want_f = dp_plain(tight, rowf, meta, total)
    for fn in (dp_plain, dp_wide_plain):
        got_d, got_f = fn(colf, rowf, meta, total)
        assert torch.equal(got_d, want_d)
        assert torch.equal(got_f[0, :a.width], want_f[0, :a.width])


def _stub(width, n_seqs=2):
    from types import SimpleNamespace
    return SimpleNamespace(width=width, data=range(n_seqs))


@pytest.mark.parametrize("n_ready,max_batch,want_wide", [
    (1, 16, ["a"]), (3, 16, ["a", "c"]), (4, 16, []), (6, 1, ["a", "c"]),
    (6, 3, ["a", "c"])])
def test_split_wide_by_cells_and_share(n_ready, max_batch, want_wide,
                                       monkeypatch):
    """Device merges take K3 from FAMSA_TORCH_WIDE_MIN_CELLS cells when
    they would share a K2 launch with fewer than WIDE_MAX_READY merges;
    the rest keep their order for K2."""
    monkeypatch.setenv("FAMSA_TORCH_WIDE_MIN_CELLS", "1000")
    monkeypatch.setattr(t_aligner, "WIDE_MAX_READY", 4)
    pool = [("a", _stub(40), _stub(30)),            # 1200 cells
            ("b", _stub(30), _stub(30)),            # 900
            ("c", _stub(10), _stub(500))]           # 5000
    pool += [(f"x{k}", _stub(5), _stub(5)) for k in range(3)]
    device = pool[:n_ready]
    wide, batched = t_aligner.split_wide(device, max_batch)
    assert [k for k, _, _ in wide] == want_wide
    assert [m for m in device if m not in wide] == batched


def test_wide_dp_ok_limits(monkeypatch):
    monkeypatch.setenv("FAMSA_TORCH_WIDE_MIN_CELLS", "0")
    assert t_aligner.wide_dp_ok(_stub(20000), _stub(MAX_W2))
    assert not t_aligner.wide_dp_ok(_stub(10), _stub(MAX_W2 + 1))
    monkeypatch.setenv("FAMSA_TORCH_WIDE_MIN_CELLS", "2e6")
    assert t_aligner.wide_dp_ok(_stub(1000), _stub(2000))
    assert not t_aligner.wide_dp_ok(_stub(999), _stub(2000))


def _count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(a[2][0, :2].tolist())
        return orig(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("wide_min,route", [("0", "k3"), ("1e12", "k2")])
def test_guided_route(wide_min, route, monkeypatch, small_folds):
    """A guided re-alignment on the device DP goes to K3 from
    FAMSA_TORCH_WIDE_MIN_CELLS cells, else to K2; both give the host
    DP's alignment."""
    from famsa_tpu.core.aligner import align_into as j_align_into
    from famsa_tpu.core.profile import Profile as JProfile
    from famsa_tpu_torch.core.profile import Profile as TProfile
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS", "0")
    monkeypatch.setenv("FAMSA_TORCH_WIDE_MIN_CELLS", wide_min)
    k3 = _count_calls(monkeypatch, dp_wide, "dp_dirs_wide")
    k2 = _count_calls(monkeypatch, dp_torch, "dp_dirs")
    rng = np.random.default_rng(5)
    jp, tp = _params()
    a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 90, lambda k: k % 2 == 0)
    ta, tb = _port(tp, a), _port(tp, b)
    want = JProfile(jp)
    j_align_into(want, a, b, list(cm1), list(cm2), backend="numpy")
    got = TProfile(tp)
    t_aligner.align_into(got, ta, tb, list(cm1), list(cm2), backend="torch")
    assert [g.decode() for g in got.data] == [g.decode() for g in want.data]
    assert (len(k3), len(k2)) == ((1, 0) if route == "k3" else (0, 1))


def test_whole_run_wide_route_forced(monkeypatch, small_folds):
    """The three knobs send every device merge and guided re-alignment
    through K3's route (refinement on): byte-identical to famsa_tpu's
    -backend numpy, and K2 is never called."""
    from test_torch_pipeline import _family_strings
    for k, v in (("FAMSA_TORCH_DP_MIN_CELLS", "0"),
                 ("FAMSA_TORCH_WIDE_MIN_CELLS", "0"),
                 ("FAMSA_TORCH_MAX_BATCH", "1")):
        monkeypatch.setenv(k, v)
    k3 = _count_calls(monkeypatch, dp_wide, "dp_dirs_wide")
    k2 = _count_calls(monkeypatch, dp_torch, "dp_dirs")
    strings = _family_strings(12, 40, 70)
    params = TParams(backend="torch", device="cpu")
    res = t_compute_msa(params, [TSequence(f">s{k}", s, k)
                                 for k, s in enumerate(strings)])
    assert [gs.decode() for gs in res.alignment] == _run_jax(strings)
    assert len(k2) == 0
    assert len(k3) > 100              # 39 merges minus seq-seq, 100 guided
    assert max(w2 for _, w2 in k3) >= 64    # several 32-column folds


def test_dp_dirs_wide_checks():
    rng = np.random.default_rng(4)
    jp, tp = _params()
    a = _port(tp, _make_profile(rng, jp, 2, 20))
    b = _port(tp, _make_profile(rng, jp, 2, 21))
    c = _port(tp, _make_profile(rng, jp, 2, 22))
    (colf, rowf, meta), total = _packed(tp, a, b)
    dirs, fin = dp_dirs_wide(colf, rowf, meta, total)
    assert dirs.shape == (total,) and fin.shape == (1, a.width, 3)
    with pytest.raises(TypeError):
        dp_dirs_wide(colf.to(torch.int32), rowf, meta, total)
    with pytest.raises(ValueError):
        dp_dirs_wide(colf[:, :10], rowf, meta, total)
    two = pack_batch([prepare_merge(tp, a, b), prepare_merge(tp, a, c)])
    with pytest.raises(ValueError):        # K3 takes one merge
        dp_dirs_wide(*(torch.from_numpy(x) for x in two[:3]), two[3])


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its source and every csrc header it
    includes: K2 and K3 (csrc/dp_wide.cu) and K5 include dp_common.cuh,
    so editing it renames exactly their libraries (K1's stays)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels._CSRC, csrc)
    monkeypatch.setattr(kernels, "_CSRC", csrc)
    assert [p.name for p in kernels._sources(csrc / "dp_wide.cu")] == \
        ["dp_wide.cu", "dp_common.cuh"]
    before = {n: kernels._so_path(n)[1].name for n in kernels.KERNELS}
    hdr = csrc / "dp_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: kernels._so_path(n)[1].name for n in kernels.KERNELS}
    assert after["lcs"] == before["lcs"]
    users = {n for n in kernels.KERNELS if "dp_common.cuh" in
             [p.name for p in kernels._sources(csrc / f"{n}.cu")]}
    assert {"dp_wide", "stage0"} <= users
    assert {n for n in kernels.KERNELS if after[n] != before[n]} == users


def test_cpu_runs_plain_without_launch():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    kernels.reset_launches()
    rng = np.random.default_rng(9)
    jp, tp = _params()
    a = _port(tp, _make_profile(rng, jp, 2, 30))
    b = _port(tp, _make_profile(rng, jp, 3, 40))
    dp_profile_torch_wide(tp, a, b)
    assert kernels.LAUNCHES["dp_wide"] == 0
    assert kernels.LAUNCHES["dp_wide16"] == 0
    assert kernels.LAUNCHES["dp_wide_stripes"] == 0
