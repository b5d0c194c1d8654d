"""famsa_tpu_torch's dispatch of the device DP route (ops/dp_resident.py)
with its sides read where they lie (ops/sides.py descriptors), stage 0
(ops/dp_stage0.py:stage0, the CPU path of kernel K5), the merged counters
(ops/merged_torch.py:merged_from_paths, the CPU path of kernel K6) and
the DP wrappers given their widths from the host, against the port's
earlier route and the famsa_tpu package.

- The descriptor reader (read_sides_plain) equals assemble_side on a
  launch that mixes resident, leaf and uploaded sides of widths that
  differ per merge, and upload_launch counts every side by kind.
- Stage 0 fed through the descriptors equals ops/dp_pack.py:
  prepare_merge + pack_batch in every int64, banded and with 2^22-scaled
  costs.
- K6's plain twin, given K4's output buffer (its plain twin's, on the
  port's own DP), equals famsa_tpu.ops.dp_pallas.merged_counters_device
  (jax on the CPU) for the same forward paths and the host counters of
  core/construct_fast.py (the port's and famsa_tpu's).
- dp_dirs and dp_dirs_wide given meta_host return the same bytes as
  without it and read no tensor on the host.
- dispatch_paths runs stage 0 and the merged counters once per launch
  through their kernels' wrappers, never assemble_side, and hands the
  DP wrapper its widths from the host.

Tolerance: exact everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from famsa_tpu.core.construct_fast import construct_profile_fast as \
    j_construct
from famsa_tpu.core.profile import Profile as JProfile
from famsa_tpu.ops.dp_pallas import JaxPathResult, merged_counters_device
from famsa_tpu_torch import kernels
from famsa_tpu_torch.core.construct_fast import construct_profile_fast
from famsa_tpu_torch.core.dp_native import row_ranges
from famsa_tpu_torch.core.profile import Profile as TProfile
from famsa_tpu_torch.ops import dp_resident, dp_torch, dp_wide
from famsa_tpu_torch.ops.dp_pack import pack_batch, prepare_merge
from famsa_tpu_torch.ops.dp_resident import (PathResult, assemble_side,
                                             dispatch_paths, upload_launch)
from famsa_tpu_torch.ops.dp_stage0 import score_table, stage0
from famsa_tpu_torch.ops.merged_torch import (merged_from_paths,
                                              merged_from_paths_plain)
from famsa_tpu_torch.ops.sides import (D_KIND, SIDE_LEAF, SIDE_RESIDENT,
                                       SIDE_UPLOADED, read_sides_plain)
from famsa_tpu_torch.ops.traceback_torch import (PATH_TRAILER, path_offsets,
                                                 read_paths, trace_paths)

from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port, _split_case
from test_torch_resident import PATHS

CPU = torch.device("cpu")


def _hdr(pairs):
    """The route's hdr [B, 8] of a launch (dispatch_paths' layout)."""
    hdr = np.zeros((len(pairs), 8), dtype=np.int64)
    off = 0
    for k, (p1, p2) in enumerate(pairs):
        hdr[k] = (p1.width, p2.width, off, 0, len(p1.data), len(p2.data),
                  0, 0)
        off += (p1.width + 1) * (p2.width + 1)
    return hdr


def _band_rows(pairs, bands):
    w1p = max(p1.width for p1, _ in pairs)
    out = np.zeros((len(pairs), w1p + 1, 2), dtype=np.int64)
    for k, ((p1, p2), bd) in enumerate(zip(pairs, bands)):
        out[k, :, 1] = p2.width
        if bd is not None:
            out[k, :p1.width + 1] = bd[:p1.width + 1]
    return out


def _resident(tp, rng, jp, n1, w1, n2, w2):
    """A profile built by a device merge of the route, with its merged
    counters left on the device (a MergedRef)."""
    a = _port(tp, _make_profile(rng, jp, n1, w1))
    b = _port(tp, _make_profile(rng, jp, n2, w2))
    res = dispatch_paths(tp, [(a, b)], dp_torch.dp_dirs,
                         want_merged=True).resolve()[0]
    dest = TProfile(tp)
    construct_profile_fast(dest, a, b, res)
    return dest, res.merged_dev


def _mixed_launch(seed):
    """Three merges whose sides are resident (from two earlier launches),
    leaves and uploaded profiles, every width different."""
    rng = np.random.default_rng(seed)
    jp, tp = _params()
    m1, d1 = _resident(tp, rng, jp, 3, 30, 2, 26)
    m2, d2 = _resident(tp, rng, jp, 2, 17, 4, 21)
    leaf = _port(tp, _make_profile(rng, jp, 1, 41, 0.0))
    leaf2 = _port(tp, _make_profile(rng, jp, 1, 12, 0.0))
    other = _port(tp, _make_profile(rng, jp, 4, 35))
    other2 = _port(tp, _make_profile(rng, jp, 3, 9))
    pairs = [(leaf, m1), (other, leaf2), (m2, other2)]
    devs = [(None, d1), (None, None), (d2, None)]
    return tp, pairs, devs


def test_descriptor_reader_equals_assemble_side():
    tp, pairs, devs = _mixed_launch(21)
    kernels.reset_launches()
    _, _, sides = upload_launch(pairs, devs, _hdr(pairs), None, CPU)
    tr = dict(kernels.TRAFFIC)
    assert (tr["sides_resident"], tr["sides_leaf"],
            tr["sides_uploaded"]) == (2, 2, 2)
    assert list(sides.desc_h[:, D_KIND]) == [
        SIDE_LEAF, SIDE_UPLOADED, SIDE_RESIDENT,
        SIDE_RESIDENT, SIDE_LEAF, SIDE_UPLOADED]
    # one buffer: header, descriptors, two profiles' counter rows and two
    # leaves' symbol bytes, each section 16-byte aligned
    rows = 128 * (pairs[1][0].width + 1 + pairs[2][1].width + 1)
    syms = pairs[0][0].width + pairs[1][1].width
    assert tr["bytes_up"] == 3 * 64 + 6 * 64 + -(-rows // 16) * 16 + syms
    got = read_sides_plain(sides)
    for side, c in enumerate(got):
        profs = [pair[side] for pair in pairs]
        want = assemble_side(profs, [d[side] for d in devs],
                             max(p.width for p in profs), CPU)
        assert c.dtype == torch.int32 and torch.equal(c, want)
        for k, p in enumerate(profs):
            assert np.array_equal(c[k, :p.width + 1].numpy(), p.counters)


def _assert_stage0(tp, pairs, bands=None):
    bands = bands or [None] * len(pairs)
    want = pack_batch([prepare_merge(tp, p1, p2, bd)
                       for (p1, p2), bd in zip(pairs, bands)])
    band_h = None if all(b is None for b in bands) else \
        _band_rows(pairs, bands)
    hdr, band, sides = upload_launch(pairs, [(None, None)] * len(pairs),
                                     _hdr(pairs), band_h, CPU)
    got = stage0(tp, sides, hdr, torch.from_numpy(score_table(tp)), band)
    for name, g, w in zip(("colf", "rowf", "meta"), got, want[:3]):
        assert g.dtype == torch.int64 and g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("case", ["mixed", "banded", "scaled", "resident"])
def test_stage0_through_descriptors_equals_host_prep(case):
    """Seq-prof and prof-prof merges with odd and even widest w2; band
    rows of two guided merges beside an unguided one; costs scaled by
    2^22 with a cardinality above 2^16; resident and leaf sides."""
    rng = np.random.default_rng(len(case))
    if case == "scaled":
        jp, tp = _params(shift=22)
        pairs = [(_port(tp, _make_profile(rng, jp, 3, 25)),
                  _port(tp, _make_profile(rng, jp, 2, 40))),
                 (_port(tp, _make_profile(rng, jp, 70000, 6, 0.1)),
                  _port(tp, _make_profile(rng, jp, 3, 9)))]
        _assert_stage0(tp, pairs)
        return
    jp, tp = _params()
    if case == "mixed":
        shapes = [(1, 3, 20, 36), (4, 2, 33, 12), (2, 5, 7, 37), (3, 3, 1, 1)]
        _assert_stage0(tp, [(_port(tp, _make_profile(
            rng, jp, n1, w1, 0.0 if n1 == 1 else 0.2)),
            _port(tp, _make_profile(rng, jp, n2, w2)))
            for n1, n2, w1, w2 in shapes])
    elif case == "banded":
        a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 55,
                                     lambda k: k % 2 == 0)
        c, d, cm3, cm4 = _split_case(rng, jp, 2, 3, 30, 45, lambda k: k == 0)
        pairs = [(_port(tp, a), _port(tp, b)), (_port(tp, c), _port(tp, d)),
                 (_port(tp, _make_profile(rng, jp, 2, 20)),
                  _port(tp, _make_profile(rng, jp, 3, 50)))]
        _assert_stage0(tp, pairs, [row_ranges(tp, cm1, cm2),
                                   row_ranges(tp, cm3, cm4), None])
    else:
        tp, pairs, devs = _mixed_launch(5)
        want = pack_batch([prepare_merge(tp, p1, p2) for p1, p2 in pairs])
        hdr, _, sides = upload_launch(pairs, devs, _hdr(pairs), None, CPU)
        got = stage0(tp, sides, hdr, torch.from_numpy(score_table(tp)))
        for g, w in zip(got, want[:3]):
            assert np.array_equal(g.numpy(), w)


def _k4_buffer(paths, hdr):
    """K4's output buffer (ops/traceback_torch.py) holding given forward
    paths, with zero totals."""
    poff, nbytes = path_offsets(hdr[:, :4])
    buf = np.zeros(nbytes, dtype=np.uint8)
    trailer = buf[:PATH_TRAILER * len(paths)].view(np.int64).reshape(-1, 2)
    for k, path in enumerate(paths):
        trailer[k, 1] = len(path)
        buf[poff[k]:poff[k] + len(path)] = path
    return torch.from_numpy(buf)


def _j_merged(ja, jb, path, smax):
    fwd = np.full(smax, 3, dtype=np.int64)
    fwd[:len(path)] = path
    return np.asarray(merged_counters_device(
        jnp.asarray(ja.counters, jnp.int32), jnp.asarray(jb.counters,
                                                         jnp.int32),
        jnp.asarray(fwd, jnp.int32), jnp.int32(ja.width),
        jnp.int32(jb.width), jnp.int32(len(ja.data)),
        jnp.int32(len(jb.data))))


@pytest.mark.parametrize("source", ["dp", "runs"])
def test_merged_plain_twin_equals_famsa_tpu_and_host(source):
    """"dp": the paths of the port's DP on a launch of a seq-prof, a
    prof-prof and a guided merge, walked by K4's plain twin; "runs":
    gap runs at both ends of both sides, runs of length 1, 2 and longer,
    one side's run right after the other's."""
    rng = np.random.default_rng(33 if source == "dp" else 34)
    jp, tp = _params()
    if source == "dp":
        a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 55,
                                     lambda k: k % 2 == 0)
        jpairs = [(_make_profile(rng, jp, 1, 30, 0.0),
                   _make_profile(rng, jp, 4, 44)),
                  (_make_profile(rng, jp, 5, 26), _make_profile(rng, jp, 2,
                                                                31)),
                  (a, b)]
        bands = [None, None, row_ranges(tp, cm1, cm2)]
    else:
        jpairs = []
        for k, path in enumerate(PATHS):
            w1, w2 = int((path != 1).sum()), int((path != 2).sum())
            jpairs.append((_make_profile(rng, jp, 3 + k, w1),
                           _make_profile(rng, jp, 2, w2)))
    pairs = [(_port(tp, ja), _port(tp, jb)) for ja, jb in jpairs]
    hdr_h = _hdr(pairs)
    band_h = _band_rows(pairs, bands) if source == "dp" else None
    hdr, band, sides = upload_launch(pairs, [(None, None)] * len(pairs),
                                     hdr_h, band_h, CPU)
    if source == "dp":
        colf, rowf, meta = stage0(tp, sides, hdr,
                                  torch.from_numpy(score_table(tp)), band)
        dirs, fin = dp_torch.dp_dirs(colf, rowf, meta,
                                     int(((hdr_h[:, 0] + 1)
                                          * (hdr_h[:, 1] + 1)).sum()),
                                     meta_host=hdr_h[:, :4])
        buf = trace_paths(dirs, fin, meta, meta_host=hdr_h[:, :4])
        paths = [p for p, _ in read_paths(buf.numpy(), hdr_h[:, :4])]
    else:
        paths = PATHS
        buf = _k4_buffer(paths, hdr_h)
    smax = int((hdr_h[:, 0] + hdr_h[:, 1]).max())
    got = merged_from_paths(sides, buf, hdr, smax)
    assert torch.equal(got, merged_from_paths_plain(sides, buf, hdr, smax))
    assert got.dtype == torch.int32 and got.shape == (len(pairs), smax + 1,
                                                      32)
    for k, ((ja, jb), (ta, tb), path) in enumerate(zip(jpairs, pairs,
                                                       paths)):
        g = got[k].numpy()
        assert np.array_equal(g, _j_merged(ja, jb, path, smax))
        dest_t = TProfile(tp)
        construct_profile_fast(dest_t, ta, tb, PathResult(path, 0))
        dest_j = JProfile(jp)
        j_construct(dest_j, ja, jb, JaxPathResult(list(path), 0))
        assert np.array_equal(g[:len(path) + 1], dest_t.counters)
        assert np.array_equal(dest_t.counters, dest_j.counters)
        assert not g[len(path) + 1:].any()


@pytest.fixture
def no_host_reads(monkeypatch):
    """Make every host read of a tensor raise while active."""
    state = {"on": False}

    def guard(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            if state["on"]:
                raise AssertionError(f"Tensor.{name} called")
            return orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    for name in ("tolist", "cpu", "item", "numpy"):
        guard(name)
    return state


@pytest.mark.parametrize("fn,variant", [("dp_dirs", None),
                                        ("dp_dirs", "staged"),
                                        ("dp_dirs_wide", None)])
def test_dp_wrappers_take_widths_from_host(fn, variant, no_host_reads,
                                           monkeypatch):
    monkeypatch.setattr(dp_wide, "MIN_FOLD_COLS", 16)
    rng = np.random.default_rng(61)
    jp, tp = _params()
    shapes = [(1, 4, 30, 70), (3, 2, 26, 41)]
    if fn == "dp_dirs_wide":
        shapes = shapes[:1]
    pairs = [(_port(tp, _make_profile(rng, jp, n1, w1,
                                      0.0 if n1 == 1 else 0.2)),
              _port(tp, _make_profile(rng, jp, n2, w2)))
             for n1, n2, w1, w2 in shapes]
    colf, rowf, meta, total = pack_batch([prepare_merge(tp, p1, p2)
                                          for p1, p2 in pairs])
    args = [torch.from_numpy(x) for x in (colf, rowf, meta)]
    call = getattr(dp_torch if fn == "dp_dirs" else dp_wide, fn)
    want = call(*args, total, variant=variant)
    no_host_reads["on"] = True
    got = call(*args, total, variant=variant, meta_host=meta.copy())
    no_host_reads["on"] = False
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        call(*args, total, variant=variant, meta_host=meta[:, :3])


def test_dispatch_runs_kernel_wrappers_once(monkeypatch):
    """One launch of the route: one stage 0 and one merged-counter call
    through the wrappers of K5 and K6, the DP wrapper handed meta_host,
    and no side assembled into a copy."""
    tp, pairs, devs = _mixed_launch(8)
    calls = {"stage0": 0, "merged": 0, "meta_host": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(dp_resident, "stage0",
                        counted("stage0", dp_resident.stage0))
    monkeypatch.setattr(dp_resident, "merged_from_paths",
                        counted("merged", dp_resident.merged_from_paths))

    def assembled(*a, **kw):
        raise AssertionError("assemble_side on the route")
    monkeypatch.setattr(dp_resident, "assemble_side", assembled)

    def dirs_fn(colf, rowf, meta, total, meta_host=None):
        assert meta_host is not None
        calls["meta_host"] += 1
        return dp_torch.dp_dirs(colf, rowf, meta, total, meta_host=meta_host)
    out = dispatch_paths(tp, pairs, dirs_fn, devs, want_merged=True)
    assert calls == {"stage0": 1, "merged": 1, "meta_host": 1}
    for (p1, p2), res in zip(pairs, out.resolve()):
        dest = TProfile(tp)
        construct_profile_fast(dest, p1, p2, res)
        assert np.array_equal(res.merged_dev.tensor().numpy(),
                              dest.counters)
