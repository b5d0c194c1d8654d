"""famsa_tpu_torch K2 past 32767 columns: the spans variant
(csrc/dp_wide.cu:dp_profile_batched_spans, a merge over up to four
16-CTA clusters of the stripes body's 2048-column folds, the edge between
clusters through global memory; on the CPU its plain version, the fold
walk ops/dp_wide.py:dp_staged_plain with span MAX_FOLDS) against the
batched plain DP (ops/dp_torch.py:dp_plain) and the famsa_tpu package's
exact host DP (famsa_tpu.core.dp); the variant choice and the geometry at
the edges 32767/32768 and 131071/131072; and a profile-profile run with a
~40,000-column profile2 against famsa_tpu -backend numpy.

Tolerance: exact.  The fold walk must equal dp_plain in every direction
byte and every per-row final; paths and totals must equal the host DP's;
the run must be byte-identical.  Profile1 is 2-6 columns wide, so each
merge is a few DP rows over its full width.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from famsa_tpu.cli import main as j_main
from famsa_tpu.core.aligner import align_into as j_align_into
from famsa_tpu.core.profile import Profile as JProfile
from famsa_tpu_torch.cli import main as t_main
from famsa_tpu_torch.core import aligner as t_aligner
from famsa_tpu_torch.core.dp_native import finish_path, row_ranges
from famsa_tpu_torch.ops import dp_torch, dp_wide
from famsa_tpu_torch.ops.dp_torch import (dp_dirs, dp_plain, k2_variant,
                                          pack_batch, prepare_merge)
from famsa_tpu_torch.ops.dp_wide import (MAX_FOLDS, SPAN_FOLD_COLS,
                                         dp_staged_plain, spans_geometry)

from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port
from test_torch_dp_wide import _host

CSRC = pathlib.Path(dp_wide.__file__).resolve().parent.parent / "csrc"


def _merge(tp, pairs, bands):
    merges = [prepare_merge(tp, a, b, band)
              for (a, b), band in zip(pairs, bands)]
    colf, rowf, meta, total = pack_batch(merges)
    return [torch.from_numpy(x) for x in (colf, rowf, meta)], total


def _check_batch(jp, tp, jpairs, cms):
    """The spans fold walk on a batch against dp_plain (every byte and
    final), the wrapper's CPU route and the host DP (path and total)."""
    pairs = [(_port(tp, a), _port(tp, b)) for a, b in jpairs]
    bands = [None if cm is None else row_ranges(tp, *cm) for cm in cms]
    args, total = _merge(tp, pairs, bands)
    meta = args[2].numpy()
    assert k2_variant(int(meta[:, 1].max())) == "spans"
    got_d, got_f = dp_staged_plain(*args, total, span=MAX_FOLDS)
    want_d, want_f = dp_plain(*args, total)
    assert torch.equal(got_d, want_d)
    w_d, w_f = dp_dirs(*args, total, variant="spans")
    assert torch.equal(w_d, got_d)
    for k, ((a, b), cm) in enumerate(zip(jpairs, cms)):
        w1, w2, off, _ = (int(v) for v in meta[k])
        assert torch.equal(got_f[k, :w1], want_f[k, :w1])
        assert torch.equal(w_f[k, :w1], got_f[k, :w1])
        n = (w1 + 1) * (w2 + 1)
        res = finish_path(got_d[off:off + n].numpy().reshape(w1 + 1, w2 + 1),
                          w1, w2, got_f[k, w1 - 1].numpy())
        path, tot = _host(jp, a, b, cm)
        assert res.total == tot
        assert list(res.path) == list(path)


def _guided_split(rng, jp, w1, w2):
    """The refinement scenario at exact widths: ungapped profiles of 2
    sequences of w1 and w2 columns aligned on the host, split back into
    their members, condensed and re-aligned guided (famsa_tpu's
    find_row_ranges band).  Returns ((a, b), (cm1, cm2))."""
    p1 = _make_profile(rng, jp, 2, w1, gap_frac=0.0)
    p2 = _make_profile(rng, jp, 2, w2, gap_frac=0.0)
    dest = JProfile(jp)
    j_align_into(dest, p1, p2, backend="numpy")
    a, b = JProfile(jp), JProfile(jp)
    for gs in dest.data:
        (a if len(gs.symbols) == w1 else b).append_raw_sequence(gs)
    assert len(a.data) == len(b.data) == 2
    _, cm1 = a.condense()
    _, cm2 = b.condense()
    a.optimize_gaps()
    b.optimize_gaps()
    a.calculate_counters_scores()
    b.calculate_counters_scores()
    return (a, b), (list(cm1), list(cm2))


@pytest.mark.parametrize("banded", [False, True], ids=["plain", "banded"])
@pytest.mark.parametrize("w2", [32768, 65535, 65536, 131071])
def test_spans_walk_equals_dp_plain_and_host(w2, banded):
    rng = np.random.default_rng(w2 % 1000 + banded)
    jp, tp = _params()
    if banded:
        pair, cm = _guided_split(rng, jp, 4, w2)
    else:
        pair = (_make_profile(rng, jp, 3, 5),
                _make_profile(rng, jp, 2, w2, gap_frac=0.0))
        cm = None
    assert pair[1].width == w2
    _check_batch(jp, tp, [pair], [cm])


def test_spans_walk_mixed_batch():
    """A batch of three merges of 2, 4 and 6 rows and w2 33,000, 70,000
    and 131,071: 2, 3 and 4 clusters."""
    rng = np.random.default_rng(33)
    jp, tp = _params()
    jpairs = [(_make_profile(rng, jp, 2, w1),
               _make_profile(rng, jp, 2, w2, gap_frac=0.0))
              for w1, w2 in ((2, 33000), (4, 70000), (6, 131071))]
    assert spans_geometry([b.width for _, b in jpairs]) == (4, [2, 3, 4])
    _check_batch(jp, tp, jpairs, [None] * 3)


@pytest.mark.parametrize("w2,want", [
    (32767, "stripes"), (32768, "spans"), (131071, "spans"), (131072, None)])
def test_k2_variant_at_the_edges(w2, want):
    if want is None:
        with pytest.raises(ValueError, match="K2 limit"):
            k2_variant(w2)
        with pytest.raises(ValueError, match="spans"):
            spans_geometry([w2])
        return
    assert k2_variant(w2) == want
    if want == "stripes":
        with pytest.raises(ValueError, match="spans"):
            spans_geometry([w2])
        return
    span, merge_spans = spans_geometry([w2, 100])
    folds = -(-(w2 + 1) // SPAN_FOLD_COLS)
    assert span == merge_spans[0] == -(-folds // MAX_FOLDS)
    assert merge_spans[1] == 1
    assert span == (2 if w2 == 32768 else 4)


def _stub(width, n_seqs=2):
    class Stub:
        pass
    s = Stub()
    s.width, s.data = width, [None] * n_seqs
    return s


@pytest.mark.parametrize("w2,k2,k3", [(32767, True, True),
                                      (32768, True, False),
                                      (131071, True, False),
                                      (131072, False, False)])
def test_routes_past_32767(w2, k2, k3, monkeypatch):
    """A lone merge past 32767 keeps its route: wide_dp_ok (K3) rejects
    it and device_dp_ok sends it to K2 with B = 1, up to MAX_W2."""
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS", "0")
    monkeypatch.setenv("FAMSA_TORCH_WIDE_MIN_CELLS", "0")
    assert dp_torch.MAX_W2 == dp_wide.SPANS_MAX_W2 == 131071
    assert t_aligner.device_dp_ok(_stub(3), _stub(w2)) == k2
    assert t_aligner.wide_dp_ok(_stub(3), _stub(w2)) == k3


def _cu_constant(name):
    m = re.search(rf"constexpr (?:int|size_t) {name} =\s*([^;]+);",
                  (CSRC / "dp_wide.cu").read_text())
    assert m, f"{name} not in csrc/dp_wide.cu"
    return m.group(1).strip()


def test_spans_constants_mirror_the_cuda_source():
    assert int(_cu_constant("MAX_SPAN")) == dp_wide.MAX_SPAN == 4
    assert SPAN_FOLD_COLS == dp_wide.FOLD_THREADS * 4 == 2048
    assert dp_wide.SPANS_MAX_W2 == 4 * 16 * 2048 - 1
    # the stripes body at S = 4: its planes and row tile fit a CTA
    assert (13 * 8 * SPAN_FOLD_COLS + 2 * dp_wide.BLK * 77 * 8
            <= dp_wide.STRIPES_SMEM_MAX)
    assert not (CSRC / "dp.cu").exists()


def test_profile_profile_run_past_32767(tmp_path, monkeypatch):
    """Profile-profile mode with a ~40,000-column profile2: -backend torch
    -device cpu (the merge routed to K2 with B = 1; its plain version on
    the CPU) is byte-identical to famsa_tpu -backend numpy."""
    rng = np.random.default_rng(40)
    aa = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    base = "".join(rng.choice(aa, size=5))
    p1 = tmp_path / "p1.fa"
    p1.write_text(f">a0\n{base}\n>a1\n{base}\n")
    p2 = tmp_path / "p2.fa"
    p2.write_text("".join(f">b{k}\n{''.join(rng.choice(aa, size=40000))}\n"
                          for k in range(3)))
    calls = []
    orig = dp_torch.dp_dirs

    def spy(colf, rowf, meta, total, variant=None, meta_host=None):
        calls.append(int((meta_host if meta_host is not None
                          else meta.numpy())[:, 1].max()))
        return orig(colf, rowf, meta, total, variant=variant,
                    meta_host=meta_host)

    monkeypatch.setattr(dp_torch, "dp_dirs", spy)
    flags = ["-refine_mode", "off"]
    want, got = tmp_path / "want.fa", tmp_path / "got.fa"
    assert j_main(["-backend", "numpy"] + flags
                  + [str(p1), str(p2), str(want)]) == 0
    assert t_main(["-backend", "torch", "-device", "cpu"] + flags
                  + [str(p1), str(p2), str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert calls == [40000]
    assert k2_variant(calls[0]) == "spans"
