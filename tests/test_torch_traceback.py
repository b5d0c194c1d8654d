"""famsa_tpu_torch's device traceback (ops/traceback_torch.py; its plain
PyTorch version trace_paths_plain, the CPU path of kernel K4) against
the native host walk (core/dp_native.py:finish_path, the port's) and
famsa_tpu's construct walk (famsa_tpu.core.construct._trace_path) on the
direction matrices of famsa_tpu's host DP (famsa_tpu.core.dp) and of the
port's own DP (ops/dp_torch.py:dp_dirs, the K2 route's input to K4).

Tolerance: exact.  Paths (every code) and totals must be equal; the
output buffer's layout (trailer, offsets, zero tail) is checked too.
"""

import numpy as np
import pytest
import torch

from famsa_tpu.core.construct import _trace_path
from famsa_tpu.core.dp import dp_prof_prof, dp_seq_prof
from famsa_tpu_torch import kernels
from famsa_tpu_torch.core.dp_native import finish_path, row_ranges
from famsa_tpu_torch.ops.dp_torch import dp_dirs, pack_batch, prepare_merge
from famsa_tpu_torch.ops.traceback_torch import (PATH_TRAILER, path_offsets,
                                                 read_paths, trace_paths,
                                                 trace_paths_plain)

from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port, _split_case


def _packed_host_dirs(ref):
    """famsa_tpu host DP result -> the packed byte matrix of K2 / K3."""
    return (ref.dirs_D | (ref.dirs_H << 2) | (ref.dirs_V << 4)).astype(
        np.uint8)


def _batch(mats, lasts):
    """(dirs [total] uint8, fin [B, max w1, 3] int64, meta [B, 4]) of a
    batch of packed matrices with their last-row finals (the other rows'
    finals are zero, as K4 reads only row w1 - 1)."""
    w1s = [m.shape[0] - 1 for m in mats]
    meta = np.zeros((len(mats), 4), dtype=np.int64)
    fin = np.zeros((len(mats), max(w1s), 3), dtype=np.int64)
    off = 0
    for k, (m, last) in enumerate(zip(mats, lasts)):
        meta[k, :3] = (m.shape[0] - 1, m.shape[1] - 1, off)
        fin[k, w1s[k] - 1] = last
        off += m.size
    dirs = np.concatenate([m.reshape(-1) for m in mats])
    return torch.from_numpy(dirs), torch.from_numpy(fin), \
        torch.from_numpy(meta)


def _check_batch(mats, lasts, refs=None):
    """trace_paths_plain on the batch against finish_path per merge (and
    _trace_path of the famsa_tpu results in refs); the buffer's layout."""
    dirs, fin, meta = _batch(mats, lasts)
    out = trace_paths(dirs, fin, meta)
    meta_h = meta.numpy()
    poff, nbytes = path_offsets(meta_h)
    assert out.dtype == torch.uint8 and out.numel() == nbytes
    buf = out.numpy()
    got = read_paths(buf, meta_h)
    trailer = buf[:PATH_TRAILER * len(mats)].view(np.int64).reshape(-1, 2)
    for k, (m, last) in enumerate(zip(mats, lasts)):
        w1, w2 = m.shape[0] - 1, m.shape[1] - 1
        want = finish_path(m, w1, w2, last)
        path, total = got[k]
        assert total == want.total
        assert np.array_equal(path, want.path)
        assert trailer[k, 1] >> 32 == (want.path[-1] if len(want.path)
                                        else trailer[k, 1] >> 32)
        tail = buf[poff[k] + len(path):poff[k] + w1 + w2]
        assert not tail.any()
        if refs is not None:
            rp, rt = _trace_path(refs[k], w1, w2)
            assert rt == total
            assert list(rp) == list(path)


# (n1, n2, w1, w2): seq-prof and prof-prof; w1 = 1, w2 = 1; chain shapes
# (w2 >> w1) whose paths are long H runs, wider than a warp's window
SHAPES = [(1, 4, 30, 45), (3, 4, 40, 55), (2, 3, 1, 20), (3, 2, 25, 1),
          (1, 1, 1, 1), (2, 3, 6, 300), (3, 5, 3, 200), (4, 2, 70, 9)]


@pytest.mark.parametrize("n1,n2,w1,w2", SHAPES)
def test_plain_matches_native_and_construct(n1, n2, w1, w2):
    rng = np.random.default_rng(1000 + 7 * w1 + w2)
    jp, _ = _params()
    a = _make_profile(rng, jp, n1, w1, 0.0 if n1 == 1 else 0.2)
    b = _make_profile(rng, jp, n2, w2)
    ref = (dp_seq_prof if n1 == 1 else dp_prof_prof)(jp, a, b)
    _check_batch([_packed_host_dirs(ref)], [ref.last], [ref])


def test_plain_batch_of_mixed_merges():
    """One launch of several merges: offsets, trailers and paths of each,
    on the port's own DP output (what the K2 route hands K4)."""
    rng = np.random.default_rng(71)
    jp, tp = _params()
    pairs = [(_port(tp, _make_profile(rng, jp, n1, w1)),
              _port(tp, _make_profile(rng, jp, n2, w2)))
             for n1, n2, w1, w2 in ((2, 3, 30, 40), (3, 2, 12, 90),
                                    (4, 4, 50, 17), (2, 2, 1, 33))]
    colf, rowf, meta, total = pack_batch([prepare_merge(tp, p1, p2)
                                          for p1, p2 in pairs])
    meta_t = torch.from_numpy(meta)
    dirs, fin = dp_dirs(torch.from_numpy(colf), torch.from_numpy(rowf),
                        meta_t, total)
    mats = [dirs.numpy()[o:o + (w1 + 1) * (w2 + 1)].reshape(w1 + 1, w2 + 1)
            for w1, w2, o, _ in meta]
    lasts = [fin.numpy()[k, w1 - 1] for k, (w1, *_) in enumerate(meta)]
    _check_batch(mats, lasts)
    # the kernel's inputs as the route gives them: the full fin, meta_host
    out = trace_paths(dirs, fin, meta_t, meta_host=meta)
    got = read_paths(out.numpy(), meta)
    for (path, total_k), m, last in zip(got, mats, lasts):
        want = finish_path(m, m.shape[0] - 1, m.shape[1] - 1, last)
        assert total_k == want.total and np.array_equal(path, want.path)


@pytest.mark.parametrize("last", [(5, 5, 5), (5, 5, 4), (5, 4, 5),
                                  (4, 5, 5), (4, 5, 4), (4, 4, 5),
                                  (-7, -7, -9), (-9, -7, -7)])
def test_plain_ties_in_the_finals(last):
    """The first channel and total from tied finals: D when D >= H and
    D >= V, else H when H > V, else V (the native trace_path)."""
    rng = np.random.default_rng(5)
    jp, _ = _params()
    a = _make_profile(rng, jp, 3, 30)
    b = _make_profile(rng, jp, 2, 26)
    ref = dp_prof_prof(jp, a, b)
    big = 1 << 40
    _check_batch([_packed_host_dirs(ref)],
                 [tuple(big * x for x in last)])


@pytest.mark.parametrize("radius", [50, 3])
def test_plain_banded(radius):
    """Guided merges: the port's banded DP bytes (out-of-band cells -inf)
    walk to famsa_tpu's guided host path."""
    rng = np.random.default_rng(90 + radius)
    jp, tp = _params()
    jp.guided_alignment_radius = tp.guided_alignment_radius = radius
    a, b, cm1, cm2 = _split_case(rng, jp, 3, 4, 40, 70, lambda k: k % 2 == 0)
    ref = dp_prof_prof(jp, a, b, list(cm1), list(cm2))
    ta, tb = _port(tp, a), _port(tp, b)
    band = row_ranges(tp, cm1, cm2)
    colf, rowf, meta, total = pack_batch([prepare_merge(tp, ta, tb, band)])
    dirs, fin = dp_dirs(torch.from_numpy(colf), torch.from_numpy(rowf),
                        torch.from_numpy(meta), total)
    w1, w2 = a.width, b.width
    _check_batch([dirs.numpy().reshape(w1 + 1, w2 + 1)],
                 [fin.numpy()[0, w1 - 1]], [ref])


def test_walk_that_leaves_the_matrix_is_flagged():
    """A byte matrix no DP kernel writes (H from column 0 of a row > 0):
    the trailer's length is -1 and read_paths raises."""
    m = np.full((3, 3), 1 | (1 << 2) | (1 << 4), dtype=np.uint8)
    m[1:, 0] = 1 << 2                  # column 0: H channel stays H
    dirs, fin, meta = _batch([m], [(0, 5, 0)])
    buf = trace_paths_plain(dirs, fin, meta).numpy()
    assert buf[:16].view(np.int64)[1] & 0xFFFFFFFF == 0xFFFFFFFF
    with pytest.raises(RuntimeError, match="left"):
        read_paths(buf, meta.numpy())


def test_trace_paths_checks_and_cpu_plain():
    """The wrapper raises on what K4 does not take, and on CPU tensors
    runs the plain version without counting a launch."""
    m = np.zeros((3, 4), dtype=np.uint8)
    dirs, fin, meta = _batch([m], [(1, 0, 0)])
    kernels.reset_launches()
    trace_paths(dirs, fin, meta)
    assert kernels.LAUNCHES["traceback"] == 0
    with pytest.raises(TypeError):
        trace_paths(dirs.to(torch.int32), fin, meta)
    with pytest.raises(TypeError):
        trace_paths(dirs, fin.to(torch.int32), meta)
    with pytest.raises(ValueError):
        trace_paths(dirs, fin[:, :, :2], meta)
    with pytest.raises(ValueError):
        trace_paths(dirs[:5], fin, meta)          # dirs too short
    zero = meta.clone()
    zero[0, 1] = 0
    with pytest.raises(ValueError):
        trace_paths(dirs, fin, zero)              # w2 = 0
    with pytest.raises(ValueError):
        trace_paths(dirs, fin, meta, meta_host=np.zeros((2, 4), np.int64))
