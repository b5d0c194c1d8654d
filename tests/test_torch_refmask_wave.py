"""The order of kernel K9 (csrc/lcs.cu:lcs_refmask_kernel, FAMSA's LCS
layout and carry as a word wavefront) on the CPU: its plain emulation
ops/lcs_torch.py:lcs_refmask_wave_plain (the geometry wseg, wpl, nl; the
carry one step late; lanes and words past the reference's W64 words;
pad and no-op symbols; a warp's queries stopping after their last live
symbol) held bit for bit against the plain version lcs_refmask_plain and
against famsa_tpu's host LCS famsa_tpu/ops/lcs.py:lcs_ref_vs_queries, on
poly-Q inputs made with numpy default_rng(seed) at W64 = 1, 2, 3, 5, 17
and 33 (wpl = 2), two seeds each, with and without the stop; and the
geometry and constants mirrored from the CUDA source.  Tolerance: exact
(equal LCS values).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from famsa_tpu.ops.lcs import build_bit_masks, lcs_ref_vs_queries
from famsa_tpu_torch.ops import lcs_torch
from famsa_tpu_torch.ops.lcs_torch import (PAD_SYMBOL, famsa_flags,
                                           lcs_refmask_plain,
                                           lcs_refmask_wave_plain,
                                           wave_geometry)

LCS_CU = (pathlib.Path(lcs_torch.__file__).resolve().parent.parent
          / "csrc" / "lcs.cu")
Q = 5                                    # glutamine's code


def _polyq_case(w64, seed, n_refs=3, n_queries=45):
    """(refs [R, Lr], queries [N, Lq] int32): references
    of exactly W64 64-bit words, each with a poly-Q tract covering a whole
    word k >= 1 when W64 >= 2 (a flagged reference), some symbols >= 20
    inside; queries of 1-260 residues, every third with a poly-Q tract of
    64-200, one all glutamine, padded with the no-op symbol past their
    ends and past the longest."""
    rng = np.random.default_rng(seed)
    lr = 64 * w64 if w64 <= 2 else int(rng.integers(64 * (w64 - 1) + 1,
                                                    64 * w64 + 1))
    refs = []
    for _ in range(n_refs):
        ref = rng.choice(24, size=lr, p=[0.048] * 20 + [0.01] * 4)
        if w64 >= 2:                     # a whole word k >= 1 of Q
            word = int(rng.integers(1, lr // 64))
            ref[64 * word:64 * (word + 1)] = Q
        refs.append(ref)
    rows = []
    for j in range(n_queries):
        row = rng.choice(24, size=int(rng.integers(1, 261)),
                         p=[0.048] * 20 + [0.01] * 4)
        if j % 3 == 0:
            off = int(rng.integers(0, min(64, len(row)) + 1))
            row = np.concatenate([row[:off],
                                  np.full(int(rng.integers(64, 201)), Q),
                                  row[off:]])
        rows.append(row)
    rows[1] = np.full(150, Q)
    lq = max(len(r) for r in rows) + 7
    queries = np.full((n_queries, lq), PAD_SYMBOL, dtype=np.int32)
    for j, r in enumerate(rows):
        queries[j, :len(r)] = r
    return (torch.from_numpy(np.stack(refs).astype(np.int32)),
            torch.from_numpy(queries))


def _host(refs, queries, n_queries):
    """famsa_tpu's host LCS of each reference against the first
    n_queries queries, [R, N] int64 (zero past n_queries)."""
    q = queries.numpy().astype(np.int8)[:n_queries]
    out = np.zeros((refs.shape[0], queries.shape[0]), dtype=np.int64)
    for i, ref in enumerate(refs.numpy().astype(np.int8)):
        out[i, :n_queries] = lcs_ref_vs_queries(
            build_bit_masks(ref, len(ref)), q)
    return out


@pytest.mark.parametrize("trim", [True, False])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("w64", [1, 2, 3, 5, 17, 33])
def test_wave_order_matches_plain_and_host(w64, seed, trim):
    """The wavefront's order gives lcs_refmask_plain's and the host's
    values on flagged and unflagged references, a triangular n_queries
    that ends inside a warp, queries shorter than the padded length and
    no-op symbols inside them."""
    refs, queries = _polyq_case(w64, seed)
    wseg, wpl, nl = wave_geometry(w64)
    assert wseg * wpl >= w64 and nl <= wseg
    nq = queries.shape[0] - 4               # not a multiple of a warp's
    got = lcs_refmask_wave_plain(refs, queries, nq, trim=trim)
    want = lcs_refmask_plain(refs, queries, nq)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), _host(refs, queries, nq))
    assert famsa_flags(refs.numpy().astype(np.int8)).all() == (w64 >= 2)


def test_wave_order_departs_from_exact_lcs():
    """The emulation keeps FAMSA's V2 < V test: on a flagged reference
    against an all-glutamine query it gives the host's value, which is
    not the exact LCS that K1's plain version computes."""
    refs, queries = _polyq_case(3, 4)
    nq = queries.shape[0]
    got = lcs_refmask_wave_plain(refs, queries, nq)
    table = torch.from_numpy(lcs_torch.build_query_mask_table(
        queries.numpy().astype(np.int8)).view(np.int32))
    exact = lcs_torch.lcs_plain(table, refs, nq)
    assert np.array_equal(got.numpy(), _host(refs, queries, nq))
    assert not torch.equal(got, exact)


def _cu_int(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", LCS_CU.read_text())
    assert m, name
    return m.group(1)


def test_geometry_mirrors_source():
    """The constants and the geometry rule of csrc/lcs.cu: a CTA of 128
    threads, windows of 256 steps with 31 positions of lookback (an odd
    number of words a window), references up to 1024 words, and at the
    widest reference the masks and windows fit a CTA's shared memory."""
    assert int(_cu_int("REFMASK_THREADS")) == lcs_torch.REFMASK_THREADS
    assert int(_cu_int("REFMASK_TILE")) == lcs_torch.REFMASK_TILE
    assert int(_cu_int("REFMASK_W_MAX")) == lcs_torch.REFMASK_W_MAX
    assert int(_cu_int("WAVE_LAG")) == 31
    assert _cu_int("REFMASK_WIN") == "REFMASK_TILE + WAVE_LAG + 5"
    win = lcs_torch.REFMASK_TILE + 31 + 5
    assert win % 4 == 0 and (win // 4) % 2 == 1
    for w64, want in ((1, (1, 1, 1)), (2, (2, 1, 2)), (3, (4, 1, 3)),
                      (5, (8, 1, 5)), (17, (32, 1, 17)), (32, (32, 1, 32)),
                      (33, (32, 2, 17)), (65, (32, 3, 22)),
                      (1024, (32, 32, 32))):
        assert wave_geometry(w64) == want
    wseg, wpl, _ = wave_geometry(lcs_torch.REFMASK_W_MAX)
    smem = 21 * wpl * wseg * 8 + (lcs_torch.REFMASK_THREADS // wseg) * win
    assert smem <= 232448
