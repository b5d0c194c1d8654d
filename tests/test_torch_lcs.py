"""famsa_tpu_torch bit-parallel LCS against the famsa_tpu package.

The port's plain PyTorch LCS versions (the CPU paths of kernel K1's rows
variant, lcs_plain, and of its wave variant, lcs_wave_plain, which walks
the wave's segments, lanes and steps) are held against the Pallas kernel
in interpret mode (famsa_tpu.ops.lcs_pallas.lcs_rows) and the scalar host
reference (famsa_tpu.ops.lcs.lcs_ref_vs_queries); the port's
TorchDistanceBackend against famsa_tpu's DistanceBackend; lcs_rows'
choice of variant against its rule.
Tolerance: exact (integer LCS, correctly-rounded host float transforms).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from famsa_tpu.core.params import DIST_INDEL075_DIV_LCS, DIST_INDEL_DIV_LCS
from famsa_tpu.ops.distance import DistanceBackend
from famsa_tpu.ops.lcs import build_bit_masks, lcs_ref_vs_queries
from famsa_tpu_torch.ops import lcs_torch
from famsa_tpu_torch.ops.lcs_torch import (TorchDistanceBackend,
                                           build_query_mask_table, lcs_plain,
                                           lcs_rows, lcs_variant,
                                           lcs_wave_plain, wave_geometry)


def _random_padded(rng, n, lmin, lmax):
    lens = rng.integers(lmin, lmax + 1, size=n)
    padded = np.full((n, int(lens.max())), 22, dtype=np.int8)
    for i, ln in enumerate(lens):
        padded[i, :ln] = rng.integers(0, 24, size=ln)   # incl. codes >= 20
    return padded, lens


def _host_lcs(padded, lens, ref):
    masks = build_bit_masks(padded[ref][:int(lens[ref])], int(lens[ref]))
    return lcs_ref_vs_queries(masks, padded)


def _port_lcs(padded, ref_ids, n_queries=None):
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    syms = torch.from_numpy(padded[ref_ids].astype(np.int32))
    return lcs_rows(table, syms, n_queries=n_queries).numpy()


@pytest.mark.parametrize("n,lmin,lmax,w", [
    (37, 5, 31, 1), (41, 20, 63, 2), (29, 40, 95, 3)])
def test_plain_lcs_matches_host(n, lmin, lmax, w):
    rng = np.random.default_rng(n)
    padded, lens = _random_padded(rng, n, lmin, lmax)
    assert (padded.shape[1] + 31) // 32 == w
    ref_ids = np.array([0, 1, n // 2, n - 1])
    got = _port_lcs(padded, ref_ids)
    for k, r in enumerate(ref_ids):
        np.testing.assert_array_equal(got[k], _host_lcs(padded, lens, r))


def test_plain_lcs_matches_pallas_interpret_and_triangular():
    """Against the Pallas kernel (interpret mode), full and with the
    triangular n_queries prefix (only the first n_queries columns are
    defined)."""
    import jax.numpy as jnp
    from famsa_tpu.ops.lcs_pallas import lcs_rows as pallas_rows
    from famsa_tpu.ops.lcs_pallas import pack_query_table

    rng = np.random.default_rng(5)
    padded, lens = _random_padded(rng, 45, 10, 70)
    w = (padded.shape[1] + 31) // 32
    ql = 2                       # 16 queries per block: several blocks
    tab, _, nb = pack_query_table(padded, ql)
    assert nb > 2
    ref_ids = np.array([0, 7, 44])
    syms = padded[ref_ids].astype(np.int32)
    want = pallas_rows(jnp.asarray(tab), syms, w, ql, len(padded),
                       interpret=True)
    np.testing.assert_array_equal(_port_lcs(padded, ref_ids), want)
    nq = 19
    got = _port_lcs(padded, ref_ids, n_queries=nq)
    want = pallas_rows(jnp.asarray(tab), syms, w, ql, len(padded),
                       interpret=True, n_queries=nq)
    np.testing.assert_array_equal(got[:, :nq], want[:, :nq])
    for k, r in enumerate(ref_ids):
        np.testing.assert_array_equal(got[k, :nq],
                                      _host_lcs(padded, lens, r)[:nq])


def test_lcs_rows_uint16_and_checks():
    rng = np.random.default_rng(9)
    padded, lens = _random_padded(rng, 20, 30, 60)
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    syms = torch.from_numpy(padded[:3].astype(np.int32))
    out = lcs_rows(table, syms, out_dtype=torch.uint16)
    assert out.dtype == torch.uint16
    np.testing.assert_array_equal(out.to(torch.int32).numpy()[2],
                                  _host_lcs(padded, lens, 2))
    with pytest.raises(TypeError):
        lcs_rows(table.to(torch.int64), syms)
    with pytest.raises(ValueError):
        lcs_rows(table[0], syms)


class _Seq:
    def __init__(self, data, length):
        self.data = data
        self.length = length
        self.data_size = len(data)


def _seqs(rng, n, lmin, lmax):
    out = []
    for _ in range(n):
        ln = int(rng.integers(lmin, lmax))
        out.append(_Seq(rng.integers(0, 24, size=ln).astype(np.int8), ln))
    return out


@pytest.mark.parametrize("measure,dtype", [
    (DIST_INDEL075_DIV_LCS, np.float64), (DIST_INDEL_DIV_LCS, np.float32)])
def test_distance_backend_rows(measure, dtype):
    rng = np.random.default_rng(3)
    seqs = _seqs(rng, 50, 10, 120)
    ref = DistanceBackend(seqs, measure, dtype)
    dev = TorchDistanceBackend(seqs, measure, dtype, device="cpu",
                               block_rows=7)
    for i in (0, 3, 11, 49):
        np.testing.assert_array_equal(dev.row(i), ref.row(i))
        np.testing.assert_array_equal(dev.row_prefix(i, i),
                                      ref.row_prefix(i, i))
    ids = [2, 9, 30]
    np.testing.assert_array_equal(dev.rows_batch(ids), ref.rows_batch(ids))
    q = np.array([1, 4, 40])
    np.testing.assert_array_equal(dev.rows_batch(ids, q),
                                  ref.rows_batch(ids, q))


def test_distance_backend_row_nonprefix_query_ids():
    """row(ref, query_ids) where max(query_ids) reaches beyond the
    sequential prefetch window (ref_idx + block_rows): the need_cols rule
    must widen the prefetched block (the JAX package's a1e6336 fix)."""
    rng = np.random.default_rng(11)
    seqs = _seqs(rng, 64, 10, 90)
    ref = DistanceBackend(seqs, DIST_INDEL075_DIV_LCS, np.float64)
    dev = TorchDistanceBackend(seqs, DIST_INDEL075_DIV_LCS, np.float64,
                               device="cpu", block_rows=4)
    qids = np.arange(1, 64)
    np.testing.assert_array_equal(dev.row(0, qids), ref.row(0, qids))
    qids2 = np.array([5, 20, 40, 63])
    np.testing.assert_array_equal(dev.row(1, qids2), ref.row(1, qids2))
    dev2 = TorchDistanceBackend(seqs, DIST_INDEL075_DIV_LCS, np.float64,
                                device="cpu", block_rows=4)
    qids3 = np.array([2, 50])
    np.testing.assert_array_equal(dev2.row(3, qids3), ref.row(3, qids3))



def _words_case(rng, n, w):
    """Queries of exactly w mask words (lengths in (32 (w-1), 32 w], the
    first one 32 w long, codes >= 20 included)."""
    lens = rng.integers(32 * (w - 1) + 1, 32 * w + 1, size=n)
    lens[0] = 32 * w
    padded = np.full((n, 32 * w), 22, dtype=np.int8)
    for i, ln in enumerate(lens):
        padded[i, :ln] = rng.integers(0, 24, size=ln)
    return padded, lens


# W edges of the wave variant: one word; W not a power of two (a partial
# segment of lanes); W = 16 and 32 (full segments of 2 and 1 a warp); 17
# (one lane past 16); 33 and 64 (two words a lane); > 64 (the rows
# variant's local-memory state; three words a lane, the last lane partial)
WAVE_WS = [1, 3, 11, 16, 17, 32, 33, 64, 70]


@pytest.mark.parametrize("w", WAVE_WS)
def test_wave_plain_matches_plain_and_host(w):
    """lcs_wave_plain = lcs_plain = the host LCS, with a triangular
    n_queries that is not a multiple of any segment count."""
    rng = np.random.default_rng(100 + w)
    n = 9
    padded, lens = _words_case(rng, n, w)
    # long references only where W is small: the plain loops are L x W
    cut = 32 * w if w <= 17 else 90
    refs = padded[[0, 5], :cut]
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    syms = torch.from_numpy(refs.astype(np.int32))
    nq = 7
    got = lcs_wave_plain(table, syms, nq)
    np.testing.assert_array_equal(got.numpy(), lcs_plain(table, syms,
                                                         nq).numpy())
    assert not got[:, nq:].any()
    for k in range(2):
        ref = refs[k][refs[k] != 22]
        masks = build_bit_masks(ref, len(ref))
        np.testing.assert_array_equal(got[k, :nq].numpy(),
                                      lcs_ref_vs_queries(masks, padded)[:nq])
    wseg, wpl, nl = wave_geometry(w)
    assert wseg * wpl >= w and (nl - 1) * wpl < w and wseg <= 32


@pytest.mark.parametrize("w", [1, 3, 11])
def test_wave_plain_matches_pallas_interpret(w):
    """Against the Pallas kernel in interpret mode, full and triangular."""
    import jax.numpy as jnp
    from famsa_tpu.ops.lcs_pallas import lcs_rows as pallas_rows
    from famsa_tpu.ops.lcs_pallas import pack_query_table
    rng = np.random.default_rng(7 + w)
    padded, _ = _words_case(rng, 20, w)
    ql = 2
    tab, _, _ = pack_query_table(padded, ql)
    ref_ids = np.array([0, 13])
    syms = padded[ref_ids].astype(np.int32)
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    for nq in (20, 11):
        want = pallas_rows(jnp.asarray(tab), syms, w, ql, len(padded),
                           interpret=True, n_queries=nq)
        got = lcs_wave_plain(table, torch.from_numpy(syms), nq)
        np.testing.assert_array_equal(got[:, :nq].numpy(),
                                      np.asarray(want)[:, :nq])


def test_lcs_variant_rule(monkeypatch):
    """The wave variant while R x ceil(n_queries / 128) < WAVE_MAX_GRID,
    the rows variant from there on, at the crossover measured on an H100
    (wave up to 32 x 1000, 16 x 2000 and 4 x 10,000 references x
    queries, rows from 64 x 1000, 32 x 2000 and 8 x 10,000); lcs_rows
    runs the chosen variant's plain twin on CPU tensors."""
    grid = lcs_torch.WAVE_MAX_GRID
    assert grid == 512
    assert lcs_variant(1, 1000) == "wave"
    assert lcs_variant(1, 128 * (grid - 1)) == "wave"
    assert lcs_variant(1, 128 * grid) == "rows"
    assert lcs_variant(grid, 1) == "rows"
    assert lcs_variant(grid - 1, 128) == "wave"
    for r, n in ((32, 1000), (16, 2000), (4, 10000)):
        assert lcs_variant(r, n) == "wave"
        assert lcs_variant(2 * r, n) == "rows"
    assert lcs_variant(256, 257) == "rows"       # distance row blocks
    assert lcs_variant(256, 2000) == "rows"
    calls = []
    for name in ("rows", "wave"):
        orig = lcs_torch.PLAIN[name]
        monkeypatch.setitem(lcs_torch.PLAIN, name,
                            lambda *a, _n=name, _o=orig: (calls.append(_n),
                                                          _o(*a))[1])
    rng = np.random.default_rng(2)
    padded, lens = _random_padded(rng, 12, 10, 40)
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    one = torch.from_numpy(padded[:1].astype(np.int32))
    many = torch.from_numpy(np.repeat(padded[:1], grid, 0).astype(np.int32))
    lcs_rows(table, one)
    out = lcs_rows(table, many)
    lcs_rows(table, one, variant="rows")
    assert calls == ["wave", "rows", "rows"]
    np.testing.assert_array_equal(out[-1].numpy(), _host_lcs(padded, lens, 0))
    with pytest.raises(ValueError, match="variant"):
        lcs_rows(table, one, variant="diagonal")


CSRC = pathlib.Path(lcs_torch.__file__).resolve().parent.parent / "csrc"


def _cu_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "lcs.cu").read_text())
    assert m, f"{name} not in csrc/lcs.cu"
    return int(m.group(1))


def test_rows_template_mirrors_the_cuda_source():
    """lcs_torch.rows_geometry is csrc/lcs.cu's rows variant: the W
    template's caps (lcs_bitpar's dispatch), refs_in_flight's P by cap,
    the CTA's warps and the staged range, at each edge of the template."""
    src = (CSRC / "lcs.cu").read_text()
    caps = [int(c) for c in re.findall(r"e = launch<(\d+)>", src)]
    assert caps == list(lcs_torch.ROWS_CAPS[:-1])
    assert "else e = launch<W_LOCAL_MAX>" in src
    assert _cu_int("W_LOCAL_MAX") == lcs_torch.ROWS_CAPS[-1]
    assert _cu_int("ROWS_WARPS") == lcs_torch.ROWS_WARPS
    assert _cu_int("STAGED_MAX_W") == lcs_torch.ROWS_STAGED_MAX_W
    assert _cu_int("P_NARROW_MAX_W") == lcs_torch.ROWS_P_NARROW_MAX_W
    assert _cu_int("P_NARROW") == lcs_torch.ROWS_P_NARROW
    assert _cu_int("P_WIDE") == lcs_torch.ROWS_P_WIDE
    assert "return wmax <= P_NARROW_MAX_W ? P_NARROW : P_WIDE;" in src
    rpc = lcs_torch.ROWS_WARPS
    assert lcs_torch.rows_geometry(1) == (2, 4, 4 * rpc, True)
    assert lcs_torch.rows_geometry(16) == (16, 4, 4 * rpc, True)
    assert lcs_torch.rows_geometry(17) == (32, 2, 2 * rpc, True)
    assert lcs_torch.rows_geometry(64) == (64, 2, 2 * rpc, True)
    assert lcs_torch.rows_geometry(65) == (2048, 2, 2 * rpc, False)
    assert lcs_torch.rows_geometry(2048) == (2048, 2, 2 * rpc, False)


def _dp_lcs(a, b):
    """The LCS length of two symbol rows by the textbook dynamic program;
    symbols >= 20 match nothing."""
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y and x < 20
                       else max(prev[j + 1], cur[j]))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("run", [33, 64, 70, 100])
def test_plain_lcs_exact_on_runs_of_equal_residues(run):
    """Queries with a run of `run` equal residues from a word's start: a
    word of V all ones, covered by the mask, takes a carry in, where the
    test V2 < V misses the carry.  Both plain versions (the CPU paths of
    K1's variants, whose exact carry the kernels compute) equal the
    dynamic program."""
    rng = np.random.default_rng(run)
    n = 6
    padded = np.full((n, 160), 22, dtype=np.int8)
    for i in range(n):
        ln = int(rng.integers(run + 10, 161))
        padded[i, :ln] = rng.integers(0, 20, size=ln)
        start = 32 * (i % 2)
        padded[i, start:start + run] = i % 3
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    refs = np.concatenate([padded[:3, :90], np.full((2, 90), 22, np.int8)])
    refs[3, :5] = [0, 1, 1, 2, 0]
    refs[4, :40] = 1
    syms = torch.from_numpy(refs.astype(np.int32))
    got = lcs_plain(table, syms, n).numpy()
    np.testing.assert_array_equal(lcs_wave_plain(table, syms, n).numpy(),
                                  got)
    for k in range(len(refs)):
        for q in range(n):
            assert got[k, q] == _dp_lcs(refs[k].tolist(),
                                        padded[q].tolist())
