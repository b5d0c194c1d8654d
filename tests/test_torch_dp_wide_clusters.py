"""famsa_tpu_torch DP on 9-16 column folds and on the stripes body
(ops/dp_wide.py: fold_geometry past 8 folds, S = 2 and 4 columns a
thread; on the CPU their plain versions, dp_wide_plain and
dp_staged_plain) against the batched plain DP (ops/dp_torch.py:dp_plain)
and the famsa_tpu package: the exact host DP (famsa_tpu.core.dp), the
staggered-fold Pallas kernel B3 and the batched Pallas kernel B2 in
interpret mode.  Also the variant choice of K2, K3 and the chain at the
widths where it changes, the pinned K3 limit, the constants mirrored from
csrc/dp_wide.cu and a whole run on the new geometries.

Tolerance: exact.  The plain versions must equal dp_plain in every
direction byte and every per-row final; paths and totals must equal the
host DP's and the Pallas kernels'; a whole run must be byte-identical to
famsa_tpu's -backend numpy.  The geometries are forced small
(`clusters`): a fold of 32 threads, so merges of a few hundred columns
cross 9-16 staged folds (one column a thread) or take the stripes body's
folds of 64 (S = 2) or 128 (S = 4) columns.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from famsa_tpu.core.params import Params as JParams
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.pipeline import compute_msa as j_compute_msa
from famsa_tpu_torch.core.dp_native import dp_profile, finish_path, row_ranges
from famsa_tpu_torch.core.params import Params as TParams
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops import dp_chain, dp_torch, dp_wide
from famsa_tpu_torch.ops.dp_pack import C_CUMT, MAX_THREADS
from famsa_tpu_torch.ops.dp_torch import (dp_dirs, dp_plain,
                                          dp_profile_torch_batched,
                                          k2_variant, pack_batch,
                                          prepare_merge)
from famsa_tpu_torch.ops.dp_wide import (dp_dirs_wide, dp_profile_torch_wide,
                                         dp_wide_plain, fold_geometry,
                                         k3_variant)
from famsa_tpu_torch.pipeline import compute_msa as t_compute_msa

from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port, _split_case
from test_torch_dp_staged import _leaves
from test_torch_dp_wide import _host
from test_torch_pipeline import _family_strings

CSRC = pathlib.Path(dp_wide.__file__).resolve().parent.parent / "csrc"

# forced geometries: (fold threads, widest staged w2) and the widths each
# takes a merge at: the staged body on 9-16 folds of 32 columns, the
# stripes body at S = 2 (folds of 64 columns) and at S = 4 (128)
BODIES = {"staged16": (32, 511, 288), "s2": (32, 255, 256),
          "s4": (8, 127, 256)}


def _force(monkeypatch, body):
    threads, staged_max, _ = BODIES[body]
    monkeypatch.setattr(dp_wide, "FOLD_THREADS", threads)
    monkeypatch.setattr(dp_wide, "STAGED_MAX_W2", staged_max)
    monkeypatch.setattr(dp_wide, "MIN_FOLD_COLS", 16)


def _check_geometry(body, w2):
    folds, threads, stripe = fold_geometry(w2)
    if body == "staged16":
        assert stripe == 1 and threads == 32 and 9 <= folds <= 16
        assert k3_variant(w2) == "staged"
    else:
        assert stripe == (2 if body == "s2" else 4) and threads == 32
        assert k3_variant(w2) == "stripes"
    return folds, threads * stripe


def _edge(lo):
    """w2 >= lo ending on the last column of a fold, w2 + 1 starting a
    fold of one column, in the forced geometry."""
    for w2 in range(lo, lo + 512):
        folds, threads, stripe = fold_geometry(w2)
        if (w2 + 1) == folds * threads * stripe and \
                fold_geometry(w2 + 1)[0] == folds + 1:
            return w2
    raise AssertionError(f"no fold edge from {lo}")


def _packed(tp, a, b, band=None):
    colf, rowf, meta, total = pack_batch([prepare_merge(tp, a, b, band)])
    return [torch.from_numpy(x) for x in (colf, rowf, meta)], total


def _plain_path(tp, a, b, band=None):
    """dp_wide_plain in the forced geometry, held against dp_plain in
    every direction byte and final; returns its (path, total)."""
    args, total = _packed(tp, a, b, band)
    want_d, want_f = dp_plain(*args, total)
    got_d, got_f = dp_wide_plain(*args, total)
    w1, w2 = a.width, b.width
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_f[0, :w1], want_f[0, :w1])
    res = finish_path(got_d.numpy().reshape(w1 + 1, w2 + 1), w1, w2,
                      got_f[0, w1 - 1].numpy())
    return list(res.path), res.total


@functools.lru_cache(maxsize=1)
def _card_side():
    """A port profile of 70000 ungapped members (counts > 2^16)."""
    _, tp = _params()
    return _leaves(tp, np.random.default_rng(65), 70000, 24)


CASES = ["edge", "past_edge", "seq_prof", "banded", "scaled", "card"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("body", list(BODIES))
def test_clusters_twin_equals_dp_plain_and_host(body, case, monkeypatch):
    """The fold walk on each forced geometry: w2 on a fold edge and one
    column past it, seq-prof, a guided band, 2^22-scaled scores and a
    side of cardinality > 2^16, against dp_plain and the host DP."""
    _force(monkeypatch, body)
    lo = BODIES[body][2]
    rng = np.random.default_rng(10 * CASES.index(case)
                                + list(BODIES).index(body))
    jp, tp = _params(shift=22 if case == "scaled" else 0)
    if case == "card":
        a = _card_side()
        b = _port(tp, _make_profile(rng, jp, 4, lo + 40))
        _check_geometry(body, b.width)
        path, total = _plain_path(tp, a, b)
        host = dp_profile(tp, a, b)
        assert (list(host.path), host.total) == (path, total)
        return
    cm = band = None
    if case == "banded":
        jp.guided_alignment_radius = tp.guided_alignment_radius = 3
        a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 30, lo + 10,
                                     lambda k: k % 2 == 0)
        cm, band = (list(cm1), list(cm2)), row_ranges(tp, cm1, cm2)
    else:
        w2 = {"edge": _edge(lo), "past_edge": _edge(lo) + 1}.get(case,
                                                                  lo + 33)
        n1 = 1 if case == "seq_prof" else 3
        a = _make_profile(rng, jp, n1, 21, gap_frac=0.0 if n1 == 1 else 0.2)
        b = _make_profile(rng, jp, 3, w2)
    folds, fw = _check_geometry(body, b.width)
    if case == "past_edge":
        assert (folds - 1) * fw == b.width
    path, total = _plain_path(tp, _port(tp, a), _port(tp, b), band)
    want_path, want_total = _host(jp, a, b, cm)
    assert (path, total) == (list(want_path), want_total)


def test_clusters_twin_matches_giant_interpret(monkeypatch):
    """One merge through the Pallas staggered-fold kernel B3 (interpret
    mode, 64-lane folds) and through the fold walk on each forced
    geometry: 10 staged folds, S = 2 and S = 4."""
    from famsa_tpu.ops import dp_giant
    monkeypatch.setattr(dp_giant, "_LWS", (32, 64))
    monkeypatch.setattr(dp_giant, "_w1_bucket",
                        lambda w: max(64, -(-w // 8) * 8))
    rng = np.random.default_rng(300)
    jp, tp = _params()
    a, b = _make_profile(rng, jp, 3, 20), _make_profile(rng, jp, 4, 300)
    want = dp_giant.dp_profile_giant_paths(jp, a, b, interpret=True)[0]
    for body in BODIES:
        _force(monkeypatch, body)
        _check_geometry(body, b.width)
        dirs, last = dp_profile_torch_wide(tp, _port(tp, a), _port(tp, b))
        res = finish_path(dirs, a.width, b.width, last)
        assert res.total == want.total, body
        assert list(res.path) == list(want.path), body


def test_batched_twin_mixed_matches_pallas_interpret(monkeypatch):
    """K2 on a batch mixing one merge past the staged widths with narrow
    ones (its plain version: every merge walked over the stripes folds
    of 64 columns) against the Pallas kernel B2 in interpret mode and the
    host DP; then the same merges with the widest on 10 staged folds."""
    from famsa_tpu.ops import dp_pallas
    from famsa_tpu.ops.dp_jax import _bucket
    monkeypatch.setattr(dp_pallas, "_pallas_bucket",
                        lambda w: 40 if w <= 40 else _bucket(w))
    rng = np.random.default_rng(61)
    jp, tp = _params()
    pairs = [(_make_profile(rng, jp, 1, 24, gap_frac=0.0),
              _make_profile(rng, jp, 3, 300)),
             (_make_profile(rng, jp, 4, 30), _make_profile(rng, jp, 2, 40)),
             (_make_profile(rng, jp, 2, 20), _make_profile(rng, jp, 3, 70))]
    want = dp_pallas.dp_profile_pallas_paths(jp, pairs, interpret=True)
    ported = [(_port(tp, a), _port(tp, b)) for a, b in pairs]
    for body, variant, merge_folds in (("s2", "stripes", [5, 1, 2]),
                                       ("staged16", "staged", [10, 2, 3])):
        _force(monkeypatch, body)
        w2s = [b.width for _, b in pairs]
        assert k2_variant(max(w2s)) == variant
        assert dp_wide.batch_geometry(w2s)[3] == merge_folds
        got = dp_profile_torch_batched(
            tp, ported, dirs_fn=functools.partial(dp_dirs, variant=variant))
        for (a, b), w, (dirs, last) in zip(pairs, want, got):
            res = finish_path(dirs, a.width, b.width, last)
            path, total = _host(jp, a, b)
            assert res.total == w.total == total
            assert list(res.path) == list(w.path) == list(path)
    # the batched walk equals dp_plain byte for byte
    merges = [prepare_merge(tp, a, b) for a, b in ported]
    colf, rowf, meta, total = (torch.from_numpy(x) if k < 3 else x
                               for k, x in enumerate(pack_batch(merges)))
    want_d, want_f = dp_plain(colf, rowf, meta, total)
    got_d, got_f = dp_dirs(colf, rowf, meta, total, variant="staged")
    assert torch.equal(got_d, want_d)
    for k, w1 in enumerate(meta[:, 0].tolist()):
        assert torch.equal(got_f[k, :w1], want_f[k, :w1])


@pytest.mark.parametrize("w2", [4095, 4096, 8191, 8192, 16256, 32767])
def test_variants_by_width(w2):
    """Up to 8191 columns the staged body (8 folds to 4095, then 9-16),
    past it the stripes body, for K3, K2 and a chain chunk's capacity;
    K2's spans variant only past MAX_W2."""
    folds, threads, stripe = fold_geometry(w2)
    want = "staged" if w2 <= 8191 else "stripes"
    assert k3_variant(w2) == k2_variant(w2) == dp_chain.dp_variant(w2) == want
    assert (folds <= dp_wide.PORTABLE_FOLDS) == (w2 <= 4095)
    assert folds <= 16 and threads <= 512 and folds * threads * stripe > w2
    assert stripe == (1 if w2 <= 8191 else 2 if w2 <= 16383 else 4)
    assert dp_wide.launch_key("K3", want, folds) == (
        "dp_wide" if w2 <= 4095 else "dp_wide16" if w2 <= 8191
        else "dp_wide_stripes")
    assert dp_wide.launch_key("K2", want, folds) == (
        "dp_staged" if w2 <= 4095 else "dp_staged16" if w2 <= 8191
        else "dp_stripes")
    assert k2_variant(32768) == "spans"


def test_max_w2_pinned():
    """K3's limit stays 32767 (core/aligner.py:wide_dp_ok reads it): the
    stripes body's reach, and the routes do not move."""
    assert dp_wide.MAX_W2 == 32767
    assert dp_wide.MAX_W2 == (dp_wide.MAX_FOLDS * dp_wide.FOLD_THREADS
                              * dp_wide.STRIPES[-1] - 1)
    assert dp_wide.STAGED_MAX_W2 == 8191
    assert dp_torch.MAX_W2 == 131071
    assert dp_chain.CHAIN_CAPS == (2047, 4095, 8191, 16256)
    with pytest.raises(ValueError, match="K3 limit"):
        fold_geometry(32768)


def _cu_constant(name):
    m = re.search(rf"constexpr (?:int|size_t) {name} =\s*([^;]+);",
                  (CSRC / "dp_wide.cu").read_text())
    assert m, f"{name} not in csrc/dp_wide.cu"
    return m.group(1).strip()


def test_constants_mirror_the_cuda_source():
    assert int(_cu_constant("MAX_FOLDS")) == dp_wide.MAX_FOLDS == 16
    assert int(_cu_constant("BLK_MAX")) == dp_wide.BLK_MAX >= dp_wide.BLK
    assert _cu_constant("NPLANE") == "C_CUMT + 1"
    assert dp_wide.NPLANE == C_CUMT + 1 == 43
    assert eval(_cu_constant("STRIPES_SMEM_MAX")) == dp_wide.STRIPES_SMEM_MAX
    assert dp_wide.FOLD_THREADS == MAX_THREADS == 512
    assert _cu_constant("NPLANE_CHIP") == "NPLANE - NSCORE"
    # the staged body's score planes and row tile, and the stripes body's
    # 13 non-score planes of its widest fold beside the row tile, fit a
    # CTA's 227 KB
    tile = 2 * dp_wide.BLK * 77 * 8
    assert 30 * 512 * 8 + 2 * dp_wide.BLK_MAX * 77 * 8 <= 232448 - 4096
    widest = dp_wide.FOLD_THREADS * dp_wide.STRIPES[-1]
    assert (43 - 30) * 8 * widest + tile <= dp_wide.STRIPES_SMEM_MAX


def test_variant_checks():
    """A forced variant takes only its widths; on the CPU nothing counts
    a launch."""
    rng = np.random.default_rng(6)
    jp, tp = _params()
    a = _port(tp, _make_profile(rng, jp, 2, 20))
    b = _port(tp, _make_profile(rng, jp, 2, 30))
    args, total = _packed(tp, a, b)
    with pytest.raises(ValueError, match="stripes"):
        dp_dirs_wide(*args, total, variant="stripes")
    with pytest.raises(ValueError, match="variant"):
        dp_dirs_wide(*args, total, variant="l2")
    with pytest.raises(ValueError, match="stripes"):
        dp_dirs(*args, total, variant="stripes")
    with pytest.raises(ValueError, match="stripes"):
        dp_wide.stripes_geometry([100, 32768])
    assert dp_wide.stripes_geometry([8192, 30]) == (15, 288, 2, [15, 1])


def _numpy_run(strings):
    params = JParams()
    params.backend = "numpy"
    params.refinement_mode = "off"
    res = j_compute_msa(params, [JSequence(f">s{k}", s, k)
                                 for k, s in enumerate(strings)])
    return [gs.decode() for gs in res.alignment]


def test_whole_run_on_clusters(monkeypatch):
    """Every device merge through K3's route (refinement off) with the
    staged body on 10 folds up to w2 296 and the stripes body (S = 2)
    past it: byte-identical to famsa_tpu's -backend numpy, with merges
    on both bodies."""
    _force(monkeypatch, "staged16")
    monkeypatch.setattr(dp_wide, "STAGED_MAX_W2", 296)
    for k, v in (("FAMSA_TORCH_DP_MIN_CELLS", "0"),
                 ("FAMSA_TORCH_WIDE_MIN_CELLS", "0"),
                 ("FAMSA_TORCH_MAX_BATCH", "1")):
        monkeypatch.setenv(k, v)
    calls = []
    orig = dp_wide.dp_dirs_wide

    def spy(colf, rowf, meta, total, **kw):
        w2 = int(meta[0, 1])
        calls.append((k3_variant(w2), fold_geometry(w2), w2))
        return orig(colf, rowf, meta, total, **kw)
    monkeypatch.setattr(dp_wide, "dp_dirs_wide", spy)
    strings = _family_strings(19, 6, 300)
    params = TParams(backend="torch", device="cpu")
    params.refinement_mode = "off"
    res = t_compute_msa(params, [TSequence(f">s{k}", s, k)
                                 for k, s in enumerate(strings)])
    assert [gs.decode() for gs in res.alignment] == _numpy_run(strings)
    bodies = {v for v, _, _ in calls}
    assert bodies == {"staged", "stripes"}, calls
    assert any(v == "staged" and g[0] >= 9 for v, g, _ in calls), calls
