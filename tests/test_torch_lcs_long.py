"""famsa_tpu_torch's LCS past 65,536 residues (kernel K1's wave variant
past 2048 32-bit words and K9 past 1024 64-bit words, csrc/lcs.cu's
segments across warps) on the CPU, against the famsa_tpu package's host
LCS (famsa_tpu/ops/lcs.py:45 lcs_ref_vs_queries, FAMSA's 64-bit layout
and carry).

The Python mirrors of the kernels' geometry (wave_geometry,
seg_geometry, refmask_scratch_words, lcs_variant, rows_geometry) against
the constants parsed from csrc/lcs.cu at W 2049, 2188, 8192 and 65536 and
W64 1025 and 4096; the plain twins' order (lcs_wave_plain,
lcs_refmask_wave_plain) on segments across warps, with the words a lane
forced small by monkeypatching so that small inputs span several warps,
and at the real geometry of a 2049-word query and a 1025-word reference;
the wrappers' ceilings.  Inputs come from numpy default_rng(seed):
queries with runs of 64 and more equal residues (K1's exact carry) and
references with a whole 64-position word of one residue (flagged: FAMSA's
carry departs from the exact LCS there).  Tolerance: exact (equal LCS
values).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from famsa_tpu.ops.lcs import build_bit_masks, lcs_ref_vs_queries
from famsa_tpu_torch.ops import lcs_torch
from famsa_tpu_torch.ops.lcs_torch import (PAD_SYMBOL, build_query_mask_table,
                                           famsa_flags, lcs_plain,
                                           lcs_refmask, lcs_refmask_plain,
                                           lcs_refmask_wave_plain, lcs_rows,
                                           lcs_variant, lcs_wave_plain,
                                           refmask_scratch_words,
                                           rows_geometry, seg_geometry,
                                           wave_geometry)

LCS_CU = (pathlib.Path(lcs_torch.__file__).resolve().parent.parent
          / "csrc" / "lcs.cu")
Q = 5                                    # glutamine's code


def _cu(name):
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);",
                  LCS_CU.read_text())
    assert m, f"{name} not in csrc/lcs.cu"
    return m.group(1).strip()


def test_constants_mirror_the_cuda_source():
    """The segment constants of csrc/lcs.cu and their Python mirrors: the
    window of 256 steps, 1024 lanes at most, 64 32-bit and 32 64-bit
    words a lane, the 227 KB of shared memory, the control words; K1
    wave past 2048 words to 65,536, K9 past 1024 to 32,768 (2,097,152
    residues both); the segment geometry's rule and its dispatch."""
    assert int(_cu("SEG_TILE")) == lcs_torch.SEG_TILE == 256
    assert int(_cu("SEG_MAX_LANES")) == lcs_torch.SEG_MAX_LANES == 1024
    assert int(_cu("WAVE_WPL_MAX")) == lcs_torch.WAVE_WPL_MAX == 64
    assert int(_cu("REFMASK_WPL_MAX")) == lcs_torch.REFMASK_WPL_MAX == 32
    assert int(_cu("SEG_SMEM_MAX")) == lcs_torch.SEG_SMEM_MAX
    assert int(_cu("W_LOCAL_MAX")) == lcs_torch.ROWS_MAX_W == 2048
    assert int(_cu("REFMASK_W_MAX")) == lcs_torch.REFMASK_W_MAX == 1024
    assert _cu("WAVE_MAX_W") == "SEG_MAX_LANES * WAVE_WPL_MAX"
    assert _cu("REFMASK_SEG_MAX_W") == "SEG_MAX_LANES * REFMASK_WPL_MAX"
    assert _cu("SEG_CTRL") == "4 * SEG_WARPS + 2"
    assert lcs_torch.WAVE_MAX_W * 32 == 64 * lcs_torch.REFMASK_SEG_MAX_W \
        == 2097152
    src = LCS_CU.read_text()
    assert "while (g.wseg * wpl_max < W) g.wseg <<= 1;" in src
    assert "if (W > W_LOCAL_MAX) {" in src
    assert "if (W64 > REFMASK_W_MAX) {" in src
    assert "g.staged = masks + common <= SEG_SMEM_MAX;" in src


# (W, (wseg, wpl, nl), staged): the first word past one warp, one not on
# a lane edge, a table past shared memory (past 2816 words), the widest
WAVE_LONG = [(2049, (64, 33, 63), True), (2188, (64, 35, 63), True),
             (8192, (128, 64, 128), False), (65536, (1024, 64, 1024), False)]


@pytest.mark.parametrize("w,geom,staged", WAVE_LONG)
def test_wave_geometry_past_one_warp(w, geom, staged):
    """K1 past 2048 words: the wave variant whatever R and n_queries,
    rows_geometry never reached (it takes W <= 2048 and raises past it),
    a segment of wseg > 32 lanes of <= 64 words, the masks staged only
    while they fit with the ring, the control words and the window."""
    assert wave_geometry(w) == geom
    wseg, wpl, nl = geom
    assert wseg > 32 and wpl <= 64 and (nl - 1) * wpl < w <= nl * wpl
    for r, nq in ((1, 10), (256, 200), (4096, 100000)):
        assert lcs_variant(r, nq, w) == "wave"
    assert lcs_variant(4096, 100000, 2048) == "rows"
    assert rows_geometry(2048)[0] == 2048
    with pytest.raises(ValueError, match="2048"):
        rows_geometry(w)
    got = seg_geometry(w)
    assert got[:3] == geom and got[3] == staged
    common = (wseg // 32) * 256 * 4 + (4 * 32 + 2) * 4 + ((256 + wseg + 7)
                                                          & ~7)
    assert got[4] == common + (20 * wpl * wseg * 4 if staged else 0)
    assert got[4] <= 232448


# (W64, (wseg, wpl, nl), staged): K9's first word past one warp, one past
# shared memory
REFMASK_LONG = [(1025, (64, 17, 61), True), (4096, (128, 32, 128), False)]


@pytest.mark.parametrize("w64,geom,staged", REFMASK_LONG)
def test_refmask_geometry_past_one_warp(w64, geom, staged):
    """K9 past 1024 64-bit words: a segment across warps of <= 32 words a
    lane, its reference's masks in shared memory while they fit, else in
    scratch of R x 21 x wpl x wseg words that the wrapper allocates."""
    assert wave_geometry(w64, lcs_torch.REFMASK_WPL_MAX) == geom
    got = seg_geometry(w64, "refmask")
    assert got[:4] == (*geom, staged)
    wseg, wpl, _ = geom
    assert refmask_scratch_words(3, 64 * w64) == (
        0 if staged else 3 * 21 * wpl * wseg)
    assert refmask_scratch_words(3, 64 * 1024) == 0


def test_ceilings_raise():
    """Past the geometry's 2,097,152 residues the wrappers raise, on the
    CPU too; the rows variant forced past 2048 words raises."""
    table = torch.zeros((32, lcs_torch.WAVE_MAX_W + 1, 1), dtype=torch.int32)
    syms = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="words"):
        lcs_rows(table, syms)
    with pytest.raises(ValueError, match="words"):
        lcs_rows(table[:, :2049].contiguous(), syms, variant="rows")
    refs = torch.zeros((1, 64 * lcs_torch.REFMASK_SEG_MAX_W + 1),
                       dtype=torch.int32)
    with pytest.raises(ValueError, match="positions"):
        lcs_refmask(refs, syms)


def _queries_with_runs(rng, n, length):
    """[n, length] int8 queries: random residues (codes >= 20 included)
    with a run of 64-200 equal residues in every second one, padded with
    the no-op symbol past lengths of length // 2 to length."""
    padded = np.full((n, length), PAD_SYMBOL, dtype=np.int8)
    for i in range(n):
        ln = int(rng.integers(length // 2, length + 1)) if i else length
        row = rng.choice(24, size=ln, p=[0.048] * 20 + [0.01] * 4)
        if i % 2 == 0:
            run = int(rng.integers(64, 201))
            off = int(rng.integers(0, max(1, ln - run)))
            row[off:off + run] = rng.integers(0, 20)
        padded[i, :ln] = row
    return padded


def _host(refs, queries, n_queries):
    """famsa_tpu's host LCS of each reference row (int8; codes >= 20,
    pads included, are no-ops in place) against the first n_queries
    queries, [R, N] int64."""
    out = np.zeros((refs.shape[0], queries.shape[0]), dtype=np.int64)
    for i, ref in enumerate(refs):
        out[i, :n_queries] = lcs_ref_vs_queries(
            build_bit_masks(ref, len(ref)), queries[:n_queries])
    return out


# (words a lane forced, W): segments of 2 warps (W 33..64 at 1 word a
# lane), 4 warps and a partial last lane, 2 warps of 2 words
SMALL_SEGMENTS = [(1, 40), (1, 100), (2, 70), (3, 100)]


@pytest.mark.parametrize("wpl_max,w", SMALL_SEGMENTS)
def test_wave_plain_across_warps(wpl_max, w, monkeypatch):
    """lcs_wave_plain on a segment across warps (K1 wave's order past 32
    lanes, the lanes' words forced small) = lcs_plain = famsa_tpu's host
    LCS, on queries with runs of equal residues, unflagged references
    and a triangular n_queries."""
    monkeypatch.setattr(lcs_torch, "WAVE_WPL_MAX", wpl_max)
    wseg, wpl, nl = wave_geometry(w)
    assert wseg > 32 and wpl <= wpl_max
    rng = np.random.default_rng(300 + 7 * w + wpl_max)
    padded = _queries_with_runs(rng, 9, 32 * w)
    refs = padded[[1, 4]][:, :200].copy()
    assert not famsa_flags(refs).any()
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    syms = torch.from_numpy(refs.astype(np.int32))
    nq = 7
    got = lcs_wave_plain(table, syms, nq)
    assert torch.equal(got, lcs_plain(table, syms, nq))
    assert np.array_equal(got.numpy(), _host(refs, padded, nq))


def _flagged_refs(rng, n, length):
    """[n, length] int8 references, each with a whole 64-position word k >= 1
    of glutamine (flagged) and some codes >= 20."""
    refs = rng.choice(24, size=(n, length), p=[0.048] * 20 + [0.01] * 4)
    for ref in refs:
        word = int(rng.integers(1, length // 64))
        ref[64 * word:64 * (word + 1)] = Q
    return refs.astype(np.int8)


@pytest.mark.parametrize("trim", [True, False])
@pytest.mark.parametrize("wpl_max,w64", [(1, 40), (1, 100), (2, 70)])
def test_refmask_wave_plain_across_warps(wpl_max, w64, trim, monkeypatch):
    """lcs_refmask_wave_plain on a segment across warps (K9's order past
    32 lanes, the lanes' words forced small; a query a CTA, stopping
    after its last live symbol) = lcs_refmask_plain = famsa_tpu's host
    LCS on flagged references, where FAMSA's carry departs from the
    exact LCS, against queries with poly-Q runs."""
    monkeypatch.setattr(lcs_torch, "REFMASK_WPL_MAX", wpl_max)
    wseg, wpl, nl = wave_geometry(w64, wpl_max)
    assert wseg > 32
    rng = np.random.default_rng(500 + w64 + wpl_max)
    refs = _flagged_refs(rng, 2, 64 * w64)
    assert famsa_flags(refs).all()
    queries = _queries_with_runs(rng, 7, 120)
    queries[1, :] = Q
    nq = 6
    r, q = (torch.from_numpy(x.astype(np.int32)) for x in (refs, queries))
    got = lcs_refmask_wave_plain(r, q, nq, trim=trim)
    assert torch.equal(got, lcs_refmask_plain(r, q, nq))
    assert np.array_equal(got.numpy(), _host(refs, queries, nq))
    table = torch.from_numpy(build_query_mask_table(queries).view(np.int32))
    exact = lcs_plain(table, r, nq)
    assert not torch.equal(got, exact)      # FAMSA's carry, not the exact


def test_real_geometry_2049_words_and_1025_64bit_words():
    """At the real geometry, no monkeypatch: a 65,537-residue query (2049
    words, 64 lanes of 33) against short references through lcs_rows
    (the wave variant) = lcs_plain = the host LCS; a flagged reference
    of 65,537 residues (1025 64-bit words, 64 lanes of 17) against short
    queries through lcs_refmask_wave_plain = lcs_refmask_plain = the
    host LCS."""
    rng = np.random.default_rng(65537)
    padded = _queries_with_runs(rng, 4, 65537)
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    assert table.shape[1] == 2049
    refs = padded[[1, 3]][:, :24].copy()
    syms = torch.from_numpy(refs.astype(np.int32))
    got = lcs_rows(table, syms)
    assert torch.equal(got, lcs_plain(table, syms, 4))
    assert np.array_equal(got.numpy(), _host(refs, padded, 4))

    ref = _flagged_refs(rng, 1, 65537)
    queries = _queries_with_runs(rng, 5, 40)
    r, q = (torch.from_numpy(x.astype(np.int32)) for x in (ref, queries))
    got = lcs_refmask_wave_plain(r, q, 5)
    assert wave_geometry(1025, lcs_torch.REFMASK_WPL_MAX) == (64, 17, 61)
    assert torch.equal(got, lcs_refmask_plain(r, q, 5))
    assert np.array_equal(got.numpy(), _host(ref, queries, 5))
