"""famsa_tpu_torch K2 staged variant (ops/dp_torch.py:dp_dirs with
variant="staged"; on the CPU its plain version ops/dp_wide.py:
dp_staged_plain, the batch walked over the launch's column folds) against
the batched plain DP (ops/dp_torch.py:dp_plain) and the famsa_tpu
package: the exact host DP (famsa_tpu.core.dp) and the Pallas kernel B2
in interpret mode (famsa_tpu.ops.dp_pallas.dp_profile_pallas_paths).
Also the variant choice (k2_variant), the launch geometry of mixed
batches (staged_geometry) and dp_dirs's checks of `variant`.

Tolerance: exact.  dp_staged_plain must equal dp_plain in every direction
byte and every per-row final; paths and totals must equal the host DP's
and the Pallas kernel's; a whole run must be byte-identical to famsa_tpu's
-backend numpy.  With the small_folds fixture a fold is one warp of 32
columns, so merges of w2 < 256 cross 1 to 8 folds.
"""

import functools

import numpy as np
import pytest
import torch

from famsa_tpu_torch import kernels
from famsa_tpu_torch.core.dp_native import finish_path, row_ranges
from famsa_tpu_torch.core.params import Params as TParams
from famsa_tpu_torch.core.profile import Profile as TProfile
from famsa_tpu_torch.core.sequence import GappedSequence
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops import dp_torch, dp_wide
from famsa_tpu_torch.ops.dp_torch import (dp_dirs, dp_plain,
                                          dp_profile_torch_batched,
                                          k2_variant, pack_batch,
                                          prepare_merge)
from famsa_tpu_torch.ops.dp_wide import (MAX_W2, STAGED_MAX_W2,
                                         dp_staged_plain, fold_geometry,
                                         staged_geometry)
from famsa_tpu_torch.pipeline import compute_msa as t_compute_msa

from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port, _split_case
from test_torch_dp_wide import _host
from test_torch_pipeline import _family_strings, _run_jax


@pytest.fixture
def small_folds(monkeypatch):
    """fold_geometry down to 32-column folds (one warp of stripe 1)."""
    monkeypatch.setattr(dp_wide, "MIN_FOLD_COLS", 16)


def _leaves(tparams, rng, n_seqs, width):
    """A port profile of n_seqs ungapped random rows (built directly:
    tens of thousands of members in a few seconds)."""
    prof = TProfile(tparams)
    syms = rng.integers(0, 20, size=(n_seqs, width)).astype(np.int8)
    for k in range(n_seqs):
        prof.data.append(GappedSequence(
            f">c{k}", syms[k], np.zeros(width + 1, dtype=np.int64),
            np.ones(width, dtype=bool), [], k, k))
    prof.width = width
    prof.calculate_counters_scores()
    return prof


def _mixed_batch():
    """One packed batch of 11 merges: w2 from 20 to 255 (1 to 8 folds of
    32 columns), seq-prof, w1 = 1, a guided band, 2^22-scaled scores and
    costs, and a profile of 70000 members (counts > 2^16)."""
    rng = np.random.default_rng(404)
    jp, tp = _params()
    bp, btp = _params(shift=22)
    merges = []
    for n1, n2, w1, w2 in [(1, 3, 30, 20), (3, 2, 1, 40), (2, 4, 25, 70),
                           (4, 3, 17, 100), (2, 2, 9, 140), (3, 3, 12, 170),
                           (2, 5, 10, 200), (3, 2, 8, 255)]:
        a = _make_profile(rng, jp, n1, w1, gap_frac=0.0 if n1 == 1 else 0.2)
        b = _make_profile(rng, jp, n2, w2)
        merges.append(prepare_merge(tp, _port(tp, a), _port(tp, b)))
    a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 100, lambda k: k % 2 == 0)
    merges.append(prepare_merge(tp, _port(tp, a), _port(tp, b),
                                row_ranges(tp, cm1, cm2)))
    a, b = _make_profile(rng, bp, 3, 30), _make_profile(rng, bp, 2, 130)
    merges.append(prepare_merge(btp, _port(btp, a), _port(btp, b)))
    merges.append(prepare_merge(tp, _leaves(tp, rng, 70000, 24),
                                _port(tp, _make_profile(rng, jp, 4, 90))))
    colf, rowf, meta, total = pack_batch(merges)
    return [torch.from_numpy(x) for x in (colf, rowf, meta)], total


def test_staged_plain_equals_dp_plain_mixed_batch(monkeypatch, small_folds):
    """Every merge is walked over the launch's 32-column folds, whatever
    its own width, and the walk equals dp_plain byte for byte."""
    (colf, rowf, meta), total = _mixed_batch()
    folds, fold_cols, merge_folds = staged_geometry(meta[:, 1].tolist())
    assert (folds, fold_cols) == (8, 32)
    assert sorted(set(merge_folds)) == list(range(1, 9))
    seen = []
    orig = dp_wide.dp_wide_plain

    def spy(*a, fold_cols=None, blk=dp_wide.BLK, meta_host=None, span=None):
        seen.append(fold_cols)
        return orig(*a, fold_cols=fold_cols, blk=blk, meta_host=meta_host,
                    span=span)
    monkeypatch.setattr(dp_wide, "dp_wide_plain", spy)
    want_d, want_f = dp_plain(colf, rowf, meta, total)
    got_d, got_f = dp_dirs(colf, rowf, meta, total, variant="staged")
    assert seen == [32] * colf.shape[0]
    assert torch.equal(got_d, want_d)
    for k, w1 in enumerate(meta[:, 0].tolist()):
        assert torch.equal(got_f[k, :w1], want_f[k, :w1]), k


@pytest.mark.parametrize("blk", [1, 3])
def test_staged_plain_rows_per_step(blk, small_folds):
    """Fewer rows a wavefront step than the default (K3's BLK): a step
    boundary inside every merge."""
    rng = np.random.default_rng(blk)
    jp, tp = _params()
    merges = [prepare_merge(tp, _port(tp, _make_profile(rng, jp, 2, w1)),
                            _port(tp, _make_profile(rng, jp, 3, w2)))
              for w1, w2 in [(7, 50), (11, 90), (4, 33)]]
    colf, rowf, meta, total = (torch.from_numpy(x) if k < 3 else x for k, x
                               in enumerate(pack_batch(merges)))
    want_d, want_f = dp_plain(colf, rowf, meta, total)
    got_d, got_f = dp_staged_plain(colf, rowf, meta, total, blk=blk)
    assert torch.equal(got_d, want_d)
    for k, w1 in enumerate(meta[:, 0].tolist()):
        assert torch.equal(got_f[k, :w1], want_f[k, :w1])


def test_staged_matches_host_and_pallas_interpret(monkeypatch, small_folds):
    """Path and total of K2's staged variant (its plain version) against
    the Pallas kernel B2 in interpret mode and famsa_tpu's host DP, on one
    batch of a 2-fold seq-prof merge, a 2-fold prof-prof merge and a
    one-fold merge."""
    from famsa_tpu.ops import dp_pallas
    from famsa_tpu.ops.dp_jax import _bucket
    monkeypatch.setattr(dp_pallas, "_pallas_bucket",
                        lambda w: 40 if w <= 40 else _bucket(w))
    rng = np.random.default_rng(57)
    jp, tp = _params()
    pairs = [(_make_profile(rng, jp, 1, 26, gap_frac=0.0),
              _make_profile(rng, jp, 3, 38)),
             (_make_profile(rng, jp, 4, 30), _make_profile(rng, jp, 2, 40)),
             (_make_profile(rng, jp, 2, 20), _make_profile(rng, jp, 3, 24))]
    assert staged_geometry([b.width for _, b in pairs])[2] == [2, 2, 1]
    want = dp_pallas.dp_profile_pallas_paths(jp, pairs, interpret=True)
    got = dp_profile_torch_batched(
        tp, [(_port(tp, a), _port(tp, b)) for a, b in pairs],
        dirs_fn=functools.partial(dp_dirs, variant="staged"))
    for (a, b), w, (dirs, last) in zip(pairs, want, got):
        res = finish_path(dirs, a.width, b.width, last)
        path, total = _host(jp, a, b)
        assert res.total == w.total == total
        assert list(res.path) == list(w.path) == list(path)


def test_staged_matches_host_guided(small_folds):
    """A batch of guided re-alignments (radius 3: whole folds of a row
    outside the band) and an unguided merge against the host DP."""
    rng = np.random.default_rng(59)
    jp, tp = _params()
    jp.guided_alignment_radius = tp.guided_alignment_radius = 3
    cases = [_split_case(rng, jp, 3, 4, 40, 120, lambda k: k % 2 == 0),
             _split_case(rng, jp, 2, 3, 50, 70, lambda k: k == 0)]
    pairs, bands, refs = [], [], []
    for a, b, cm1, cm2 in cases:
        refs.append(_host(jp, a, b, (list(cm1), list(cm2))))
        pairs.append((_port(tp, a), _port(tp, b)))
        bands.append(row_ranges(tp, cm1, cm2))
    c, d = _make_profile(rng, jp, 2, 40), _make_profile(rng, jp, 3, 200)
    refs.append(_host(jp, c, d))
    pairs.append((_port(tp, c), _port(tp, d)))
    bands.append(None)
    out = dp_profile_torch_batched(
        tp, pairs, bands, dirs_fn=functools.partial(dp_dirs, variant="staged"))
    for (a, b), (path, total), (dirs, last) in zip(pairs, refs, out):
        res = finish_path(dirs, a.width, b.width, last)
        assert res.total == total
        assert list(res.path) == list(path)


@pytest.mark.parametrize("w2", [0, 255, 1235, 3844, STAGED_MAX_W2,
                                STAGED_MAX_W2 + 1, MAX_W2])
def test_k2_variant_by_width(w2):
    """The staged variant takes exactly the batches whose widest w2 fits
    K3's staged folds (one column a thread, <= 512 columns a fold, <= 16
    folds), the stripes variant the rest up to K3's MAX_W2."""
    assert STAGED_MAX_W2 == 8191
    assert k2_variant(w2) == ("staged" if w2 <= 8191 else "stripes")
    assert (k2_variant(w2) == "staged") == (fold_geometry(w2)[2] == 1)
    assert k2_variant(MAX_W2 + 1) == "spans"


@pytest.mark.parametrize("w2s,want", [
    ([1235], (5, 256, [5])),
    ([300, 1235, 40], (5, 256, [2, 5, 1])),
    ([3850, 300, 511, 512], (8, 512, [8, 1, 1, 2])),
    ([STAGED_MAX_W2, 0], (16, 512, [16, 1])),
    ([255, 256], (2, 160, [2, 2])),
    ([4095, 0], (8, 512, [8, 1])),
    ([4096, 3850], (9, 480, [9, 9])),
])
def test_staged_geometry_mixed_batches(w2s, want):
    """The launch's folds and fold width are fold_geometry's for the
    widest merge; merge k uses ceil((w2 + 1) / fold_cols) of them."""
    assert staged_geometry(w2s) == want
    folds, fold_cols, merge_folds = want
    assert fold_geometry(max(w2s))[:2] == (folds, fold_cols)
    assert max(merge_folds) == folds


def test_staged_geometry_limit():
    with pytest.raises(ValueError, match="staged"):
        staged_geometry([100, STAGED_MAX_W2 + 1])


def test_dp_dirs_variant_checks():
    """variant: None, "staged", "stripes" or "spans"; "staged" refuses a
    batch wider than STAGED_MAX_W2 and "spans" one within MAX_W2 (the
    first design's "global" is gone); on CPU tensors the default runs
    dp_plain, "staged" its fold walk, and nothing counts a launch."""
    rng = np.random.default_rng(8)
    jp, tp = _params()
    merges = [prepare_merge(tp, _port(tp, _make_profile(rng, jp, 2, 20)),
                            _port(tp, _make_profile(rng, jp, 3, w2)))
              for w2 in (30, 300)]
    colf, rowf, meta, total = pack_batch(merges)
    args = [torch.from_numpy(x) for x in (colf, rowf, meta)]
    for bad in ("l2", "global"):
        with pytest.raises(ValueError, match="variant"):
            dp_dirs(*args, total, variant=bad)
    with pytest.raises(ValueError, match="spans"):
        dp_dirs(*args, total, variant="spans")
    kernels.reset_launches()
    want = dp_plain(*args, total)
    for variant in (None, "staged"):
        got = dp_dirs(*args, total, variant=variant)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(got[1][k, :20], want[1][k, :20])
                   for k in range(2))
    assert kernels.LAUNCHES["dp_spans"] == kernels.LAUNCHES["dp_staged"] == 0
    wide = [torch.zeros((1, 44, 4098), dtype=torch.int64),
            torch.zeros((1, 2, 77), dtype=torch.int64),
            torch.tensor([[1, STAGED_MAX_W2 + 1, 0, 0]])]
    with pytest.raises(ValueError, match="staged"):
        dp_dirs(*wide, 2 * (STAGED_MAX_W2 + 2), variant="staged")


def test_whole_run_k2_staged_forced(monkeypatch, small_folds):
    """Every profile merge and guided re-alignment on K2 with the staged
    variant (its plain fold walk over 32-column folds), refinement on:
    byte-identical to famsa_tpu's -backend numpy."""
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS", "0")
    monkeypatch.setenv("FAMSA_TORCH_WIDE_MIN_CELLS", "1e30")
    calls = []
    orig = dp_torch.dp_dirs

    def staged(colf, rowf, meta, total, variant=None, meta_host=None):
        calls.append(meta[:, 1].tolist())
        return orig(colf, rowf, meta, total, variant="staged",
                    meta_host=meta_host)
    monkeypatch.setattr(dp_torch, "dp_dirs", staged)
    strings = _family_strings(12, 40, 70)
    params = TParams(backend="torch", device="cpu")
    res = t_compute_msa(params, [TSequence(f">s{k}", s, k)
                                 for k, s in enumerate(strings)])
    assert [gs.decode() for gs in res.alignment] == _run_jax(strings)
    assert len(calls) > 100                 # merges and 100 guided
    assert max(max(w2s) for w2s in calls) >= 64     # several folds
    assert max(len(w2s) for w2s in calls) >= 2      # batched merges
