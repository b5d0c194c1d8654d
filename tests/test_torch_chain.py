"""famsa_tpu_torch's chain route (ops/dp_chain.py: the chunk, the carry's
plain twin chain_carry_plain; pipeline.py: run detection and run_chain)
against famsa_tpu's (ops/dp_chain.py:_dp_chain_scan, pipeline.py
_run_chain) on the CPU, where every chunk runs its kernels' plain twins.

Both packages run in a shrunk geometry, as tests/test_dp_chain.py runs
famsa_tpu: leaf rows of 64 symbols, chunks of 4 merges, width floor 40,
runs of 3, margin 16; famsa_tpu's fold widths 32 and 64 (capacities
8 * 32 - 128 = 128 and 384), the port's capacities 128 and 384 to
match, so both route every merge alike.  famsa_tpu's chain scan is run
by jax in interpret mode at fold width 32 only: its one compile takes
~50 s on this CPU, and each other fold width or row count would add as
much, so the runs that need one (overflow recovery, which continues at
384) are held to famsa_tpu -backend numpy alone, as is the run whose
last merge overflows, where famsa_tpu raises (ROADMAP C2).

- One chunk with a trailing invalid lane: paths, first channels, totals,
  the final counters, width and cardinality equal _dp_chain_scan's.
- chain_carry_plain (the twin of the carry that K5's chain entry runs
  before each step and K7 after the last) on a step that ran (its width
  the path's emits that are not 3, as want_width counts them), an
  overflow, a poisoned chain, an invalid lane and a failed walk, each
  reading one slot of the double-buffered state and writing the other
  (the fold after the last step: slot 0 in place); and a whole chunk's
  carries, step by step, equal to the carry kept as one state updated in
  place (the order before it was folded into K5).
- Whole runs on caterpillar trees, both child orders, a width abort,
  overflow recovery and an overflow on the run's last merge: byte-
  identical to famsa_tpu -backend numpy (and -backend jax where it does
  not raise and needs no other compile); the chain counters show the
  chunks, overflows and aborts each case forces.
- The CLI on small variant families (chip_smoke.py's generator): byte-
  identical to famsa_tpu, and the post-chain profile's resident counters
  equal its host counters.

Tolerance: exact everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from famsa_tpu.cli import main as j_main
from famsa_tpu.core.params import Params as JParams
from famsa_tpu.core.sequence import GappedSequence as JGapped
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.ops import dp_chain as j_chain
from famsa_tpu.ops import dp_giant as j_giant
from famsa_tpu.ops.dp_pallas import PendingPaths as JPending
from famsa_tpu.pipeline import compute_alignment as j_compute_alignment
from famsa_tpu_torch import kernels
from famsa_tpu_torch import pipeline as t_pipeline
from famsa_tpu_torch.cli import main as t_main
from famsa_tpu_torch.core.construct_fast import drain_gap_queue as t_drain
from famsa_tpu_torch.core.params import Params as TParams
from famsa_tpu_torch.core.profile import Profile as TProfile
from famsa_tpu_torch.core.sequence import GappedSequence as TGapped
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.ops import dp_chain

from test_dp_chain import _caterpillar
from test_dp_jax_parity import _make_profile
from test_torch_dp import _params, _port

CPU = torch.device("cpu")
AA = "ARNDCQEGHILKMFPSTWYV"
K, W1P, ROWS = 4, 64, 8 * 64 + 1


@pytest.fixture(autouse=True)
def _small_geometry(monkeypatch):
    monkeypatch.setattr(j_giant, "_LWS", (32, 64))
    monkeypatch.setattr(j_giant, "GMAX_ROWS", ROWS)
    monkeypatch.setattr(j_giant, "_w1_bucket",
                        lambda w: max(64, -(-w // 8) * 8))
    for mod in (j_chain, dp_chain):
        monkeypatch.setattr(mod, "CHAIN_W1P", W1P)
        monkeypatch.setattr(mod, "CHAIN_K", K)
        monkeypatch.setattr(mod, "CHAIN_MIN_W2", 40)
        monkeypatch.setattr(mod, "CHAIN_MIN_LEN", 3)
        monkeypatch.setattr(mod, "CHAIN_MARGIN", 16)
    monkeypatch.setattr(dp_chain, "CHAIN_CAPS", (128, 384))
    for k in list(dp_chain.__dict__):
        if k.startswith("CHAIN"):
            monkeypatch.delenv(f"FAMSA_TORCH_{k}", raising=False)
    monkeypatch.setenv("FAMSA_TPU_DP_PALLAS", "interpret")
    monkeypatch.setenv("FAMSA_TPU_CHAIN", "1")
    monkeypatch.setenv("FAMSA_TPU_GIANT", "0")
    yield


def make_variants(n, root_len, seed, indel_rate):
    """FASTA text of a family of n variants of one root (chip_smoke.py's
    generator, the same draw order): sequence 0 is the root; each other
    one copies it, mutates max(1, floor(r L)) positions at a rate r ~
    U(0.01, 0.25), then applies Poisson(indel_rate) indels of 1-8
    residues, half insertions, half deletions."""
    rng = np.random.default_rng(seed)
    root = rng.integers(0, 20, size=root_len)
    seqs = [root]
    for _ in range(1, n):
        r = rng.uniform(0.01, 0.25)
        c = root.copy()
        k = max(1, int(root_len * r))
        pos = rng.integers(0, len(c), size=k)
        c[pos] = rng.integers(0, 20, size=k)
        for _ in range(rng.poisson(indel_rate)):
            p = rng.integers(0, len(c))
            ln = int(rng.integers(1, 9))
            if rng.random() < 0.5:
                c = np.insert(c, p, rng.integers(0, 20, size=ln))
            else:
                c = np.delete(c, slice(p, p + ln))
        seqs.append(c)
    return "".join(f">v_{i}\n{''.join(AA[x] for x in s)}\n"
                   for i, s in enumerate(seqs))


def _strings(fasta):
    return fasta.split("\n")[1::2]


def _random_strings(seed, n, lmin, lmax):
    rng = np.random.default_rng(seed)
    return ["".join(AA[rng.integers(0, 20)]
                    for _ in range(int(rng.integers(lmin, lmax))))
            for _ in range(n)]


def _leaf(tp, s, k):
    return TProfile.from_gapped_sequence(
        TGapped.from_sequence(TSequence(f">l{k}", s, k)), tp)


# ---------------------------------------------------------------- a chunk
def _jax_chunk(jp, c, w, card, syms, lws, n):
    """famsa_tpu's chain scan on one chunk (interpret mode, fold width
    32): (paths, dir0, totals, final counters, width, cardinality)."""
    pad = np.zeros((ROWS, 32), dtype=np.int32)
    pad[:w + 1] = c
    s = np.full((K, W1P), 31, dtype=np.int8)
    lw = np.zeros(K, dtype=np.int32)
    for i in range(n):
        s[i, :lws[i]] = syms[i]
        lw[i] = lws[i]
    gp = tuple(np.int64(x) for x in (jp.gap_open, jp.gap_ext,
                                     jp.gap_term_open, jp.gap_term_ext))
    packs, cfin, wfin, cardfin = j_chain._dp_chain_scan(
        jnp.asarray(pad), jnp.int32(w), jnp.int32(card), jnp.asarray(s),
        jnp.asarray(lw), jnp.asarray((lw > 0).astype(np.int32)),
        jnp.asarray(np.asarray(jp.score_matrix, dtype=np.int64)), gp,
        lw=32, nl=3, interpret=True)
    jax.block_until_ready(packs)
    res = JPending(packs[:n], n).resolve()
    packs = np.asarray(packs)
    return ([np.asarray(r.path) for r in res], packs[:n, -3],
            [r.total for r in res], np.asarray(cfin), int(wfin),
            int(cardfin), packs)


_JAX = {}


def _chunk_case(n_valid):
    """One seeded chunk on both packages: a 9-member start profile of 40
    columns and n_valid leaves of 12-30 symbols."""
    if n_valid in _JAX:
        return _JAX[n_valid]
    rng = np.random.default_rng(20 + n_valid)
    jp, tp = _params(12)
    start = _make_profile(rng, jp, 9, 40)
    leaves = _random_strings(30 + n_valid, n_valid, 12, 30)
    tleaves = [_leaf(tp, s, k) for k, s in enumerate(leaves)]
    syms = [p.data[0].symbols for p in tleaves]
    want = _jax_chunk(jp, start.counters, start.width, len(start.data), syms,
                      [len(x) for x in syms], n_valid)
    bufs = dp_chain.ChainBuffers(CPU, K, W1P, 384)
    tstart = _port(tp, start)
    state = dp_chain.ChainState(bufs, tstart)
    state.seed(tp, tstart)
    got = dp_chain.dispatch_chain_chunk(tp, state, tleaves, 128).resolve()
    _JAX[n_valid] = (want, got, bufs, state)
    return _JAX[n_valid]


@pytest.mark.parametrize("n_valid", [3, 4])
def test_chunk_matches_famsa_tpu_chain_scan(n_valid):
    """3 valid lanes: the fourth is a trailing invalid lane (famsa_tpu
    passes the carry through, the port skips the step)."""
    (paths, dir0, totals, cfin, wfin, cardfin, _), got, bufs, state = \
        _chunk_case(n_valid)
    ps = dp_chain.path_stride(W1P, 128)
    assert len(got) == n_valid
    for t, res in enumerate(got):
        assert np.array_equal(res.path, paths[t])
        assert res.total == totals[t]
        at = t * ps + 12
        assert int(bufs.out[at:at + 4].view(torch.int32)[0]) == dir0[t]
    w, card, poison = bufs.st[:3].tolist()
    assert (w, card, poison) == (wfin, cardfin, 0)
    assert w <= 128                   # no overflow in this case
    assert bufs.widths(128)[:n_valid].tolist() == [len(p) for p in paths]
    assert bufs.widths(128)[n_valid:].tolist() == \
        [dp_chain.NOT_RUN] * (K - n_valid)
    final = state.final_ref(w).tensor()
    assert np.array_equal(final.numpy(), cfin[:w + 1])


# ------------------------------------------------------- the chain carry
def _carry_case(bufs, cap, st, lw_prev, n, lw_next, k=1):
    """Buffers where step k-1 ran with a path of length n (or did not
    run: lw_prev 0) and step k's lane (k < K) has width lw_next; the
    state in the slot the carry before step k reads, the other slot
    holding a marker."""
    src, dst = dp_chain.state_slots(k, bufs.k)
    bufs.st[:] = -9
    bufs.st[4 * src:4 * src + 3] = torch.tensor(st)
    bufs.lw[:] = 0
    if k < bufs.k:
        bufs.lw[k] = lw_next
    bufs.hdr[k - 1, 0] = lw_prev
    at = (k - 1) * dp_chain.path_stride(bufs.w1p, cap) + 8
    bufs.out[at:at + 4].view(torch.int32)[0] = n


CARRY_CASES = ["ran", "overflow", "poisoned", "invalid_lane", "failed_walk"]


def _carry_want(case, cap, n, st):
    """(w, card, poison, recorded width) after the fold of case."""
    if case == "poisoned":
        return st[0], st[1], 1, dp_chain.NOT_RUN
    if case == "failed_walk":
        return st[0], st[1], 1, -1
    return n, st[1] + 1, int(case == "overflow"), n


@pytest.mark.parametrize("case", CARRY_CASES)
def test_chain_carry_plain(case):
    """The carry's twin folds step 0 and writes step 1's header and
    descriptors; it reads state slot 1 and writes slot 0, leaving slot 1
    as it was.  "ran": the width is the path's emits that are not 3
    (famsa_tpu's want_width, from the chain scan's packed output) and the
    cardinality the host's card + 1."""
    bufs = dp_chain.ChainBuffers(CPU, K, W1P, 384)
    cap = 128
    (paths, _, _, _, _, _, packs), _, _, _ = _chunk_case(3)
    words = packs[0, :-3].astype(np.uint32)
    emits = (words[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    want_width = int((emits != 3).sum())
    assert want_width == len(paths[0])
    n = {"ran": want_width, "overflow": cap + 1, "poisoned": 50,
         "invalid_lane": 70, "failed_walk": -1}[case]
    st = (60, 7, 1 if case == "poisoned" else 0)
    lw_prev = 0 if case == "poisoned" else 30
    lw_next = 0 if case == "invalid_lane" else 25
    _carry_case(bufs, cap, st, lw_prev, n, lw_next)
    dp_chain.chain_carry_plain(bufs, 1, cap)
    assert bufs.st[4:7].tolist() == list(st)
    w, card, poison = bufs.st[:3].tolist()
    rec = int(bufs.widths(cap)[0])
    if case == "poisoned":
        assert (w, card, poison, rec) == (60, 7, 1, dp_chain.NOT_RUN)
    elif case == "failed_walk":
        assert (w, card, poison, rec) == (60, 7, 1, -1)
    else:
        assert (w, card, rec) == (n, 8, n)
        assert poison == (case == "overflow")
    live = not poison and lw_next >= 1
    assert bufs.hdr[1].tolist() == [25 if live else 0, w, 0, 0, 1, card,
                                    0, 0]
    d1, d2 = bufs.desc[1].tolist()
    assert d1[:5] == [dp_chain.SIDE_LEAF, bufs.leaf[1].data_ptr(), 1,
                      25 if live else 0, 1]
    assert d2[:5] == [dp_chain.SIDE_RESIDENT, bufs.carry[1].data_ptr(), 32,
                      w, card]


@pytest.mark.parametrize("k", [2, K])
@pytest.mark.parametrize("case", CARRY_CASES)
def test_chain_carry_plain_slots(case, k):
    """The five cases at an even step (the carry before step 2 reads
    slot 0 and writes slot 1) and at the fold after the last step (K7:
    slot 0 in place, no header written)."""
    bufs = dp_chain.ChainBuffers(CPU, K, W1P, 384)
    cap = 128
    n = {"ran": 77, "overflow": cap + 1, "poisoned": 50,
         "invalid_lane": 70, "failed_walk": -1}[case]
    st = (60, 7, 1 if case == "poisoned" else 0)
    lw_next = 0 if case == "invalid_lane" else 25
    _carry_case(bufs, cap, st, 0 if case == "poisoned" else 30, n, lw_next,
                k=k)
    src, dst = dp_chain.state_slots(k, K)
    assert (src, dst) == ((0, 1) if k < K else (0, 0))
    hdr = bufs.hdr.clone()
    dp_chain.chain_carry_plain(bufs, k, cap)
    w, card, poison, rec = _carry_want(case, cap, n, st)
    assert bufs.st[4 * dst:4 * dst + 3].tolist() == [w, card, poison]
    if src != dst:
        assert bufs.st[4 * src:4 * src + 3].tolist() == list(st)
    assert int(bufs.widths(cap)[k - 1]) == rec
    if k == K:
        assert torch.equal(bufs.hdr, hdr)
        return
    live = not poison and lw_next >= 1
    assert bufs.hdr[k].tolist() == [25 if live else 0, w, 0, 0, 1, card,
                                    0, 0]
    assert bufs.desc[k, 1, 1] == bufs.carry[k % 2].data_ptr()


def _unfolded_carries(bufs, cap, st0):
    """The chain's carry as it ran before it was folded into K5: one state
    (w, card, poison) updated in place, a launch before every step and
    one after the last, over a chunk's finished buffers (each step's
    header word w1, path length and leaf width are written once).
    Returns per fold k = 0..K (state after it, width recorded, header,
    descriptors)."""
    w, card, poison = st0
    out = []
    for k in range(bufs.k + 1):
        rec = None
        if k > 0:
            rec = dp_chain.NOT_RUN
            if int(bufs.hdr[k - 1, 0]) >= 1:
                at = (k - 1) * dp_chain.path_stride(bufs.w1p, cap) + 8
                n = int(bufs.out[at:at + 4].view(torch.int32)[0])
                rec = n
                poison = int(poison or n < 0 or n > cap)
                if n >= 0:
                    w, card = n, card + 1
        hdr = desc = None
        if k < bufs.k:
            lw = int(bufs.lw[k])
            w1 = lw if not poison and lw >= 1 else 0
            hdr = [w1, w, 0, 0, 1, card, 0, 0]
            desc = [[dp_chain.SIDE_LEAF, bufs.leaf[k].data_ptr(), 1, w1, 1,
                     0, 0, 0],
                    [dp_chain.SIDE_RESIDENT, bufs.carry[k % 2].data_ptr(), 32,
                     w, card, 0, 0, 0]]
        out.append(((w, card, poison), rec, hdr, desc))
    return out


@pytest.mark.parametrize("over", [False, True])
def test_folded_carry_matches_unfolded(over, monkeypatch):
    """A chunk through its plain twin (the carry run before each step, as
    K5's chain entry runs it, and once after the last, as K7): after each
    fold the state slot it wrote, the recorded width, the step's header
    and descriptors equal the carry kept as one state updated in place,
    fold for fold; the slot it read is left as it was.  3 valid lanes and
    a trailing invalid one; with `over`, a capacity that a merge
    overflows (the later steps poisoned)."""
    jp, tp = _params(12)

    def make():
        start = _make_profile(np.random.default_rng(71), jp, 9, 40)
        return _port(tp, start), [_leaf(tp, s, k) for k, s in enumerate(
            _random_strings(73, 3, 40, 60))]
    cap, ran = 128, 3
    if over:
        # the width after the last merge that the next one widens: the
        # next one overflows it (align_into consumes its profiles)
        prof, leaves = make()
        widths = []
        for leaf in leaves:
            prof = t_pipeline.align_into(TProfile(tp), leaf, prof,
                                         backend="numpy")
            widths.append(prof.width)
        j = max(j for j in range(2) if widths[j + 1] > widths[j])
        cap, ran = widths[j], j + 2
    start, leaves = make()
    bufs = dp_chain.ChainBuffers(CPU, K, W1P, 384)
    state = dp_chain.ChainState(bufs, start)
    state.seed(tp, start)
    st0 = tuple(bufs.st[:3].tolist())
    seen = []
    orig = dp_chain.chain_carry_plain

    def carry(b, k, c):
        before = b.st.clone()
        orig(b, k, c)
        seen.append((k, before, b.st.clone(), b.widths(c).clone(),
                     b.hdr.clone(), b.desc.clone()))
    monkeypatch.setattr(dp_chain, "chain_carry_plain", carry)
    res = dp_chain.dispatch_chain_chunk(tp, state, leaves, cap).resolve()
    assert len(res) == ran
    want = _unfolded_carries(bufs, cap, st0)
    assert [k for k, *_ in seen] == list(range(K + 1))
    for (k, before, st, widths, hdr, desc), (wst, rec, whdr, wdesc) in \
            zip(seen, want):
        src, dst = dp_chain.state_slots(k, K)
        assert st[4 * dst:4 * dst + 3].tolist() == list(wst), k
        if src != dst:
            assert torch.equal(st[4 * src:4 * src + 4],
                               before[4 * src:4 * src + 4]), k
        if rec is not None:
            assert int(widths[k - 1]) == rec, k
        if whdr is not None:
            assert hdr[k].tolist() == whdr, k
            assert desc[k].tolist() == wdesc, k
    assert bufs.st[:3].tolist() == list(want[-1][0])
    assert (bufs.st[2] == 1) == over


# ------------------------------------------------------------ whole runs
def _j_align(strings, tree, backend):
    params = JParams()
    params.adjust(len(strings))
    params.backend = backend
    gapped = [JGapped.from_sequence(JSequence(f">s{k}", s, k))
              for k, s in enumerate(strings)]
    for i, g in enumerate(gapped):
        g.sequence_no = i
    prof = j_compute_alignment(params, gapped, tree)
    from famsa_tpu.core.construct_fast import drain_gap_queue
    drain_gap_queue()
    out = [None] * len(prof.data)
    for gs in prof.data:
        out[gs.sequence_no] = gs.decode()
    return out


def _t_align(strings, tree):
    params = TParams(backend="torch", device="cpu")
    params.adjust(len(strings))
    gapped = [TGapped.from_sequence(TSequence(f">s{k}", s, k))
              for k, s in enumerate(strings)]
    for i, g in enumerate(gapped):
        g.sequence_no = i
    kernels.reset_launches()
    prof = t_pipeline.compute_alignment(params, gapped, tree)
    t_drain()
    out = [None] * len(prof.data)
    for gs in prof.data:
        out[gs.sequence_no] = gs.decode()
    return out, dict(kernels.CHAIN), prof


def _host_widths(strings, tree):
    """The chain profile's width after each merge of the caterpillar, on
    the host route (FAMSA_TORCH_CHAIN=0 is not needed: no run is taken
    with CHAIN_MIN_LEN past the run)."""
    widths = []
    orig = t_pipeline.align_into

    def align_into(dest, *a, **kw):
        out = orig(dest, *a, **kw)
        widths.append(out.width)
        return out
    t_pipeline.align_into = align_into
    try:
        old = dp_chain.CHAIN_MIN_LEN
        dp_chain.CHAIN_MIN_LEN = len(strings) + 1
        _t_align(strings, tree)
    finally:
        t_pipeline.align_into = orig
        dp_chain.CHAIN_MIN_LEN = old
    return widths


@pytest.mark.parametrize("case", ["leaf_first", "prev_first", "abort",
                                  "overflow", "last_overflow"])
def test_caterpillar_run(case, monkeypatch):
    """leaf_first / prev_first: a variant family of 14 (every chunk at
    capacity 128), against numpy and jax.  The other cases take random
    sequences, the whole run on the chain (width floor 0) at margin 0,
    and capacities set from the host route's widths: abort, one capacity
    equal to the width after a merge that the next one widens, so that
    one overflows it and the run is handed back to the other routes
    (against numpy and jax); overflow, the same capacity and 384, on
    which the run goes on (against numpy); last_overflow, one capacity
    equal to the width before the last merge, which overflows it (against
    numpy: famsa_tpu raises there)."""
    if case in ("leaf_first", "prev_first"):
        strings = _strings(make_variants(14, 44, 3, 0.6))
    else:
        strings = _random_strings({"abort": 48, "overflow": 37,
                                   "last_overflow": 42}[case], 10, 24, 40)
    tree = _caterpillar(len(strings), case != "prev_first")
    if case in ("abort", "overflow", "last_overflow"):
        widths = _host_widths(strings, tree)
        if case == "last_overflow":
            cap = widths[-2]
            assert widths[-1] > cap
        else:
            cap = next(widths[j] for j in range(3, len(widths) - 3)
                       if widths[j + 1] > widths[j])
        monkeypatch.setattr(dp_chain, "CHAIN_MARGIN", 0)
        monkeypatch.setattr(dp_chain, "CHAIN_MIN_W2", 0)
        monkeypatch.setattr(dp_chain, "CHAIN_CAPS",
                            (cap, 384) if case == "overflow" else (cap,))
    got, ch, prof = _t_align(strings, tree)
    assert got == _j_align(strings, tree, "numpy")
    if case in ("leaf_first", "prev_first", "abort"):
        assert got == _j_align(strings, tree, "jax")
    assert ch["runs"] == 1 and ch["chunks"] > 0
    assert (ch["aborts"] > 0) == (case == "abort")
    assert ch["overflows"] == (0 if case in ("leaf_first", "prev_first")
                               else 1)
    chained = ch["prefix"] + ch["merges"]
    if case == "abort":
        assert chained < len(strings) - 2
        assert prof.dev_counters is None
    else:
        assert chained == len(strings) - 2
    if case == "last_overflow":
        assert prof.dev_counters is None
    elif case != "abort":
        assert np.array_equal(prof.dev_counters.tensor().numpy(),
                              prof.counters)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("n,root,seed,min_w2", [(60, 50, 5, 40),
                                                (40, 56, 9, 60)])
def test_cli_variant_family(n, root, seed, min_w2, tmp_path, monkeypatch):
    """A variant family whose guide tree is one caterpillar run (its MST
    a star): the port's CLI output equals famsa_tpu's -backend numpy
    byte for byte, the run went through chunks (the second family after a
    prefix of host merges below the width floor 60), and the post-chain
    profile's resident counters equal its host counters."""
    monkeypatch.setattr(dp_chain, "CHAIN_MIN_W2", min_w2)
    fa = tmp_path / "var.fa"
    fa.write_text(make_variants(n, root, seed, 0.6))
    seen = []
    orig = t_pipeline.compute_alignment

    def compute_alignment(*a):
        prof = orig(*a)
        seen.append((prof.dev_counters.tensor().numpy().copy(),
                     prof.counters.copy()))
        return prof
    monkeypatch.setattr(t_pipeline, "compute_alignment", compute_alignment)
    want, got = tmp_path / "want.fa", tmp_path / "got.fa"
    assert j_main(["-backend", "numpy", str(fa), str(want)]) == 0
    kernels.reset_launches()
    assert t_main(["-backend", "torch", "-device", "cpu", str(fa),
                   str(got)]) == 0
    ch = dict(kernels.CHAIN)
    assert got.read_bytes() == want.read_bytes()
    assert ch["runs"] == 1 and ch["chunks"] > 0 and ch["merges"] > 0
    assert (ch["prefix"] > 0) == (min_w2 > 40)
    (dev, host), = seen
    assert np.array_equal(dev, host)


def test_variant_generator_matches_smoke():
    """The generator here is chip_smoke.py's, draw for draw; the chip
    family (4000 x 800, seed 5, indel rate 0.6) holds sequences of
    775-816 residues, all under the default leaf row of 1024."""
    import chip_smoke
    assert chip_smoke.make_variants(50, 60, 7, 0.6) == \
        make_variants(50, 60, 7, 0.6)
    lens = [len(s) for s in _strings(make_variants(4000, 800, 5, 0.6))]
    assert (min(lens), max(lens)) == (775, 816)
