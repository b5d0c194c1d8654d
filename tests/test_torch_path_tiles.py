"""famsa_tpu_torch's traceback (K4) and merged counters (K6) at the edges
of their kernels' windows and tiles, through their plain PyTorch twins
(the CPU path of both wrappers) against the famsa_tpu package and the
port's native host code.

K4 (csrc/traceback.cu) stages a window of a merge's direction bytes in
shared memory, its shape picked from w1 : w2 (window_shape); K6
(csrc/merged.cu) spreads a merge over CTAs of MERGED_TILE path steps.
The cases come from chip_smoke.py (k4_edge_paths at each of EDGE_WIDTHS,
k6_edge_paths), which runs the same cases through the kernels on the
card; each is a forward path, and path_matrix makes direction bytes
whose walk is that path.

- The constants mirrored in ops/traceback_torch.py and
  ops/merged_torch.py equal the .cu sources'.
- window_shape keeps every window inside its shared-memory budget and
  stages a matrix whole when it fits.
- K4's plain twin walks every edge case to its path and total, as the
  native trace_path, famsa_tpu's host walk (core/construct.py:
  _trace_path) and its device walks (ops/dp_pallas.py:_traceback_one and
  _traceback_runs, jax on the CPU) do.
- K6's plain twin, on K4's plain buffer of every tile edge case with a
  tile of rows past the longest path, equals famsa_tpu's
  merged_counters_device (jax on the CPU) and the host counters of
  core/construct_fast.py (the port's and famsa_tpu's).

Tolerance: exact everywhere.
"""

import pathlib
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from famsa_tpu.core.construct import _trace_path
from famsa_tpu.core.construct_fast import construct_profile_fast as \
    j_construct
from famsa_tpu.core.profile import Profile as JProfile
from famsa_tpu.ops.dp_pallas import (JaxPathResult, _forward_paths,
                                     _traceback_one, _traceback_runs,
                                     merged_counters_device)
from famsa_tpu_torch.core.construct_fast import construct_profile_fast
from famsa_tpu_torch.core.profile import Profile as TProfile
from famsa_tpu_torch.ops import merged_torch, traceback_torch
from famsa_tpu_torch.ops.dp_resident import PathResult, upload_launch
from famsa_tpu_torch.ops.merged_torch import MERGED_TILE, merged_from_paths
from famsa_tpu_torch.ops.sides import SIDE_LEAF
from famsa_tpu_torch.ops.traceback_torch import (TB_WINDOW_BYTES,
                                                 read_paths, row_stride,
                                                 trace_paths, window_shape)

from test_dp_jax_parity import _make_profile
from test_torch_dispatch import _hdr
from test_torch_dp import _params, _port

CSRC = pathlib.Path(traceback_torch.__file__).resolve().parent.parent / "csrc"
CPU = torch.device("cpu")


def _constant(name, source):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, f"{name} not in csrc/{source}"
    return int(m.group(1))


def test_window_and_tile_constants_mirror_the_cuda_sources():
    assert _constant("TB_WINDOW_BYTES", "traceback.cu") == TB_WINDOW_BYTES
    assert _constant("K6_TILE", "merged.cu") == merged_torch.MERGED_TILE
    # the kernels' shared memory: a block takes at most 227 KB
    assert TB_WINDOW_BYTES <= 232448


@pytest.mark.parametrize("w1,w2", list(chip_smoke.EDGE_WIDTHS) + [
    (1, 1), (30, 40), (1, 32767), (64, 32767), (16384, 1), (16384, 16256),
    (3564, 1334), (49, 3850), (50, 3850), (300, 607), (300, 608)])
def test_window_shape_fits_its_budget(w1, w2):
    rows, cols = window_shape(w1, w2)
    stride = row_stride(cols)
    assert 1 <= rows <= w1 + 1 and 1 <= cols <= w2 + 1
    assert rows * stride <= TB_WINDOW_BYTES
    # an odd multiple of 16 that holds a row's span from its aligned start
    assert stride % 16 == 0 and (stride // 16) % 2 == 1
    assert stride >= -(-(15 + cols) // 16) * 16
    whole = (w1 + 1) * row_stride(w2 + 1) <= TB_WINDOW_BYTES
    assert whole == ((rows, cols) == (w1 + 1, w2 + 1))


def _jax_walks(mats, lasts, paths):
    """famsa_tpu's device walks (_traceback_one, _traceback_runs) of each
    matrix, padded to one shape (one compile each): forward paths."""
    w1p = max(m.shape[0] - 1 for m in mats)
    w2pe = max(m.shape[1] for m in mats)
    nsteps = w1p + w2pe
    one = jax.jit(_traceback_one, static_argnames=("nsteps",))
    runs = jax.jit(_traceback_runs, static_argnames=("nsteps",))
    fwd = jax.jit(_forward_paths)
    for m, last, path in zip(mats, lasts, paths):
        w1, w2 = m.shape[0] - 1, m.shape[1] - 1
        dm = np.zeros((w1p, w2pe), dtype=np.int32)
        dm[:w1, :w2 + 1] = m[1:]
        args = (jnp.asarray(dm), jnp.int32(w1), jnp.int32(w2),
                jnp.int32(int(np.argmax(last))))
        for walk in (one, runs):
            em = walk(*args, nsteps=nsteps)
            f = np.asarray(fwd(em[None], args[3][None]))[0]
            assert (f != 3).sum() == len(path)
            assert np.array_equal(f[:len(path)], path)


@pytest.mark.parametrize("w1,w2", chip_smoke.EDGE_WIDTHS)
def test_k4_edges_equal_famsa_tpu_and_native(w1, w2):
    """H, V and D runs of 31-33 cells ending beside, on and past the
    first window's edges, widths at the window's and the whole-matrix
    limits, an all-H top row and an all-V first column."""
    rng = np.random.default_rng(w1 + w2)
    cases = chip_smoke.k4_edge_paths(w1, w2, rng)
    assert len(cases) >= 40
    paths = [p for _, p in cases]
    (dirs, fin, meta), natives = chip_smoke.edge_batch(paths, rng, CPU)
    got = read_paths(trace_paths(dirs, fin, meta).numpy(), meta.numpy())
    mats, lasts = [], []
    off = meta.numpy()[:, 2]
    for k, ((name, path), (p, total), nat) in enumerate(
            zip(cases, got, natives)):
        a, b = chip_smoke.path_widths(path)
        m = dirs.numpy()[off[k]:off[k] + (a + 1) * (b + 1)].reshape(
            a + 1, b + 1)
        last = fin.numpy()[k, a - 1]
        assert np.array_equal(p, path), name
        assert np.array_equal(nat.path, path) and nat.total == total, name
        res = SimpleNamespace(path=None, last=tuple(last), dirs_D=m & 3,
                              dirs_H=(m >> 2) & 3, dirs_V=(m >> 4) & 3)
        hp, ht = _trace_path(res, a, b)
        assert list(hp) == list(path) and ht == total, name
        mats.append(m)
        lasts.append(last)
    _jax_walks(mats, lasts, paths)


def test_k6_edges_equal_famsa_tpu_and_host():
    """Path lengths T - 1, T, T + 1, 2T + 1, gap runs straddling a tile
    boundary or starting on a tile's first step, a run across three
    tiles; side 1 of the first merge a leaf; rows past each path zero
    through a whole tile."""
    rng = np.random.default_rng(61)
    jp, tp = _params()
    cases = chip_smoke.k6_edge_paths(rng)
    paths = [p for _, p in cases]
    lens = [len(p) for p in paths]
    assert {MERGED_TILE - 1, MERGED_TILE, MERGED_TILE + 1,
            2 * MERGED_TILE + 1} <= set(lens)
    (dirs, fin, meta), _ = chip_smoke.edge_batch(paths, rng, CPU)
    buf = trace_paths(dirs, fin, meta)
    jpairs = []
    for k, p in enumerate(paths):
        a, b = chip_smoke.path_widths(p)
        jpairs.append((_make_profile(rng, jp, 1 if k == 0 else 3, a,
                                     0.0 if k == 0 else 0.2),
                       _make_profile(rng, jp, 2, b)))
    pairs = [(_port(tp, ja), _port(tp, jb)) for ja, jb in jpairs]
    hdr_h = _hdr(pairs)
    assert np.array_equal(hdr_h[:, :2], meta.numpy()[:, :2])
    hdr, _, sides = upload_launch(pairs, [(None, None)] * len(pairs),
                                  hdr_h, None, CPU)
    assert sides.desc_h[0, 0] == SIDE_LEAF
    smax = int((hdr_h[:, 0] + hdr_h[:, 1]).max()) + MERGED_TILE
    got = merged_from_paths(sides, buf, hdr, smax).numpy()
    assert got.shape == (len(paths), smax + 1, 32)
    w1p = max(ja.width for ja, _ in jpairs)
    w2p = max(jb.width for _, jb in jpairs)
    run = jax.jit(merged_counters_device)
    for k, ((ja, jb), (ta, tb), path) in enumerate(zip(jpairs, pairs,
                                                       paths)):
        path = path.astype(np.int64)
        c1 = np.zeros((w1p + 1, 32), dtype=np.int32)
        c2 = np.zeros((w2p + 1, 32), dtype=np.int32)
        c1[:ja.width + 1] = ja.counters
        c2[:jb.width + 1] = jb.counters
        fwd = np.full(smax, 3, dtype=np.int32)
        fwd[:len(path)] = path
        want = np.asarray(run(jnp.asarray(c1), jnp.asarray(c2),
                              jnp.asarray(fwd), jnp.int32(ja.width),
                              jnp.int32(jb.width), jnp.int32(len(ja.data)),
                              jnp.int32(len(jb.data))))
        assert np.array_equal(got[k], want), cases[k][0]
        dest_t = TProfile(tp)
        construct_profile_fast(dest_t, ta, tb, PathResult(path, 0))
        dest_j = JProfile(jp)
        j_construct(dest_j, ja, jb, JaxPathResult(list(path), 0))
        assert np.array_equal(got[k, :len(path) + 1], dest_t.counters)
        assert np.array_equal(dest_t.counters, dest_j.counters)
        assert not got[k, len(path) + 1:].any()
