#!/usr/bin/env python3
"""Old against new designs of K1, K2, K3, K4, K6, K7, K8 and K9 on one
card, in alternating order.

    python3 scripts/torch_kernel_redesign.py [--reps 200] [--rounds 2]
        [--parts k1,k2,k3,k4,k6,k8,k1rows,wide,split,threads,spans,k9,k7,
        e2e] [--parent .parent]

K1's old design is still in the port: its rows variant (one thread a
query, ops/lcs_torch.py variant="rows"); the new one is its wave
variant.  K2's first design (one CTA a merge, csrc/dp.cu, the "global"
variant), K3's first design (the L2 variant) and K4's and K6's old
designs live only in an earlier tree: parts k2, k3, k4, k6, wide, spans
and e2e build that tree's csrc/dp.cu, csrc/dp_wide.cu, csrc/traceback.cu
and csrc/merged.cu (--parent: a directory with the tree unpacked, e.g.
`git archive <commit> | tar -x -C .parent`) into libraries of their own
under DIR/_build.

k1   Kernel-only CUDA-event times of one MST-Prim round, the first
     reference of chip_smoke.py's 1000-, 2000- and 10,000-sequence
     families (seed 7, mean length 300, padded to 32 as ops/prim_torch.py
     pads) against all sequences, rows, wave, wave, rows; then the
     dispatch crossover: both variants for R = 1..256 references against
     each family, with the rows grid R x ceil(n / 128) beside them.
k8   K8 (csrc/prim.cu), the parent's design against this tree's, old,
     new, new, old in at least three rounds, at round n/2 of
     chip_smoke.py's 1000, 10,000 and 10,000 x 600 families: a launch's
     device ms in a CUDA graph (chip_smoke.py:graph_ms) and its ms from a
     launch loop; this tree's at its shape rule's cluster and at every
     cluster size forced.  Both designs' states and edges after one round
     must be equal.
k1rows K1's rows variant (csrc/lcs.cu:lcs_bitpar), the parent's design
     against this tree's, old, new, new, old in at least three rounds
     (CUDA events around the C entry): 256 references against the
     2000-sequence family of phase 5 (seed 11; the -dist run's blocks)
     and the 10,000 of phase 6, a case of W >= 40 (256 x 2000 of mean
     length 1300) and one past 64 words (64 x 1000 of mean length 2600);
     both designs' outputs must be equal.
k2   Kernel-only times of K2, global (the parent's csrc/dp.cu), staged,
     staged, global: a lone
     2048x2048 merge (random profiles of 12 and 9 sequences, as
     chip_smoke.py phase 3), and the largest batch of 16 merges (by
     cells) that the 1000- and the 10,000-sequence default runs launch,
     replayed from the inputs kept during the run; with the bound of each.
     Then the staged launch of those batches three ways, in turns: as the
     port runs it, with every fold 512 columns wide (the fewest folds and
     CTAs a cluster), and split into one launch per merge fold count;
     with the clusters that fit on the card at once.
k3   Kernel-only times of one merge at the main path's shapes (random
     profiles of 50 sequences, 20 % gaps), the parent's L2 variant (its
     8-fold geometry) against this tree's staged variant, old, new, new,
     old; then the staged variant at rows-per-step BLK 8, 16 and 32 and
     minimum fold widths of 128 and 256 columns.
wide The redesigns past 4095 columns, old, new, new, old in --rounds
     rounds (CUDA events; both designs' direction bytes and finals must
     be equal), each with its bound (chip_smoke.py:dp_bound_ms): K3 on
     lone seq-prof merges of 600 x 4500, 600 x 5906, 300 x 8000,
     300 x 12,000 and 300 x 16,256 and a 2000 x 6000 prof-prof merge
     (the parent's L2 variant against this tree's staged body on 9-16
     folds or its stripes body); the DP of one chain step at capacities
     8191 and 16256 (the parent's dp_profile_wide_l2_meta against this
     tree's batched entry with B = 1, as a chunk launches them, on the
     step's K5 output); and the largest K2 batch whose widest w2 is past
     4095 in a default run of chip_smoke.py's WIDE_FAMILY (this tree's K2
     global, the design that took such batches before, against staged or
     stripes), or a line saying the run launched none.
split The stripes body's split between shared memory and global memory,
     in turns: csrc/dp_wide.cu with scripts/dp_wide_variants.patch
     applied, built with -DSTRIPES_SCORES_ON_CHIP=1 (every plane of a
     fold's first ~634 columns in shared memory, the rest read from
     global memory) against this tree's build (only the 13 non-score
     planes on chip, for all of a fold's <= 2048 columns; the score
     planes read from global memory), on lone seq-prof merges of
     300 x 9000,
     300 x 12,000, 300 x 16,256 and 300 x 30,000 and prof-prof merges of
     1000 x 12,000 and 1000 x 16,256; both builds' bytes must be equal.
threads The stripes body's thread cap, in turns: this tree's build (512
     threads a fold at most, 128 registers a thread: stripes of 2 and 4
     columns) against the patched source of part split built with
     -DSTRIPES_MAX_THREADS=256 (255 registers: stripes of 4 and 8), each
     at its own fold geometry, on the merges of part split; both builds'
     bytes must be equal.
k4   Kernel-only device times of K4 (launches captured in a CUDA graph,
     chip_smoke.py:graph_ms), old, new, new, old, in at least three
     rounds, on the inputs of three launches: the 10,000-sequence default
     run's largest K4 launch (by path steps: a batch of K2 merges, kept by
     chip_smoke.py's LaunchRecorder), its longest lone merge (a K3
     dispatch), and one chain step of capacity 2047 (the
     second of two 800-residue leaves merged into a 1040-column chain in
     one chunk of ops/dp_chain.py, its K4 called as the chunk calls it:
     nb 1, ldf the leaf row).  Both designs' output bytes must be equal.
k6   The same for K6 on those launches' merged counters (the chain step
     at smax = its capacity); both designs' int32 must be equal.
spans K2 past 32767 columns, the parent's first design (csrc/dp.cu, one
     CTA a merge, up to 256 columns a thread) against this tree's spans
     variant (up to 4 clusters of 16 folds a merge) and against design
     (a), built from csrc/dp_wide.cu with scripts/dp_wide_variants.patch
     (dp_profile_batched_wide_stripes: one cluster of 16 folds of 8 or 16
     columns a thread, every plane read from L2), old, new, a, a, new,
     old in --rounds rounds (CUDA events; every design's direction bytes
     and finals must be equal), each with its bound: lone merges of
     1000 x 40,000, 1000 x 100,000 and 300 x 131,071 and a batch of
     three of w2 33,000, 70,000 and 131,071 (chip_smoke.py's
     SPANS_LONE and SPANS_BATCH), each plain and banded.
k9   K9 (csrc/lcs.cu:lcs_refmask), the parent's design (one thread a
     query, its W64 words one after another) against this tree's word
     wavefront, old, new, new, old in at least three rounds (a launch's
     device ms in a CUDA graph, chip_smoke.py:graph_ms), with the bound
     (chip_smoke.py:refmask_bound_ms) and K1 wave's time on the same
     round: a flagged Prim round of the poly-Q family of phase 5b (1 x
     500), the rows path's 18 flagged references x 500 (the -dist_export
     block, rows padded to the longest), a flagged round of a 10,000-
     sequence poly-Q family (make_polyq(10000, 300, 13)), and a round
     whose reference is not flagged (both return at once).  Both designs'
     rows must be equal.
k7   The chain chunk, the parent's launch order (K7 before every step
     and after the last: 5 launches a step and 1) against this tree's
     (K5's chain entry runs the carry: 4 a step and 1), old, new, new, old
     in at least three rounds: one replay of each order's CUDA graph from
     the same state (a chain of 4 variants of chip_smoke.py's 800-residue
     family aligned on the host, then 32 more at capacity 2047), and
     a launch of each design's K5 chain entry and of K7 in a CUDA graph.
     The parent's K7 and K5 (csrc/chain.cu, csrc/stage0.cu) are built from
     --parent; the DP, K4 and K6 are this tree's in both.  Both orders'
     state, widths, carry buffers, headers, descriptors and paths must be
     equal.
e2e  The 1000-sequence default run (refinement on) and the 10,000-
     sequence run (the wide route) through the CLI entry point, K1's and
     K2's old designs forced (WAVE_MAX_GRID 0, every K2 launch on the
     parent's global design) and not, in --rounds rounds of old, new,
     new, old: stage seconds and launches per kernel variant.

Needs a CUDA device; every block of lines carries the card's name and
power limit."""

import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the smoke's families, timers and CLI)

K3_SHAPES = ((328, 1227), (454, 1065), (307, 3844), (422, 4014), (3564, 1334))


def prim_round_inputs(n):
    """(table, syms) of the first Prim round of the n-sequence family."""
    import torch
    from famsa_tpu_torch.core.sequence import Sequence
    from famsa_tpu_torch.ops.lcs_torch import (BV32, build_query_mask_table,
                                               pad_sequences)
    text = chip_smoke.make_family(n, 300, 7)
    seqs, name, body = [], None, []
    for line in text.splitlines() + [">"]:
        if line.startswith(">"):
            if name is not None:
                seqs.append(Sequence(name, "".join(body), len(seqs)))
            name, body = line, []
        else:
            body.append(line)
    padded = pad_sequences(seqs, align=BV32)
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    queries = torch.from_numpy(padded.astype(np.int32))
    return table.cuda(), queries.cuda()


def part_k1(reps, smi):
    from famsa_tpu_torch.ops.lcs_torch import lcs_rows

    def ms(table, syms, variant, r=reps):
        return chip_smoke.cuda_ms(
            lambda: lcs_rows(table, syms, variant=variant), r)

    for n in (1000, 2000, 10000):
        table, queries = prim_round_inputs(n)
        syms = queries[:1].contiguous()
        t = {v: [] for v in ("rows", "wave")}
        for v in ("rows", "wave", "wave", "rows"):
            t[v].append(ms(table, syms, v))
        print(f"k1 prim round 1 ref x {n} queries, L={syms.shape[1]}, "
              f"W={table.shape[1]}: rows {t['rows']} ms, wave {t['wave']} "
              f"ms; {smi}", flush=True)
        for r in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            syms = queries[:r].contiguous()
            grid = r * -(-n // 128)
            k = max(5, reps // r)
            rows, wave = ms(table, syms, "rows", k), ms(table, syms, "wave", k)
            print(f"k1 crossover n={n} R={r} grid={grid}: rows {rows:.5f} "
                  f"wave {wave:.5f} ms ({'wave' if wave < rows else 'rows'} "
                  "faster)", flush=True)


def k8_inputs(fam):
    """(inputs, state, lcs) of chip_smoke.py's family `fam` at round n/2:
    the device Prim's inputs, the state after n/2 rounds (K1 wave and K8)
    and the next round's LCS row."""
    from famsa_tpu_torch.ops.lcs_torch import lcs_rows
    from famsa_tpu_torch.ops.prim_torch import PrimState, prim_chunk
    inputs = chip_smoke.prim_case(
        chip_smoke.fasta_strings(chip_smoke.make_family(*fam)), "cuda")
    state = PrimState(inputs[1])
    prim_chunk(*inputs, state, inputs[1].shape[0] // 2)
    return inputs, state, lcs_rows(inputs[0], state.ref)


def part_k8(parent, rounds, reps, smi):
    """The parent's K8 against this tree's, old, new, new, old."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.prim_torch import CLUSTERS, cluster_size
    if not parent:
        raise SystemExit("part k8 needs --parent DIR")
    old_lib, new_lib = parent_lib(parent, "prim"), kernels.get("prim")
    for name, fam in (("1000", (1000, 300, 7)), ("10000", (10000, 300, 7)),
                      ("wide600", (10000, 600, 7))):
        inputs, state, lcs = k8_inputs(fam)
        _, queries, lengths, pow_tab = inputs
        n, length = queries.shape

        def call(v, st, edges, cluster=0):
            head = (lcs.data_ptr(), lengths.data_ptr(), pow_tab.data_ptr(),
                    queries.data_ptr(), n, length,
                    *(getattr(st, a).data_ptr() for a in chip_smoke.STATE),
                    edges.data_ptr(), 1, 0)
            stream = torch.cuda.current_stream().cuda_stream
            if v == "old":
                return kernels.check(old_lib.prim_round(*head, stream), v)
            return kernels.check(new_lib.prim_round(*head, cluster, stream),
                                 v)

        def fresh():
            return (chip_smoke.clone_state(state),
                    torch.zeros((3, 1), dtype=torch.int64, device="cuda"))
        outs = {}
        for v in ("old", "new"):
            st, edges = fresh()
            call(v, st, edges)
            outs[v] = [chip_smoke._bits(getattr(st, a))
                       for a in chip_smoke.STATE] + [edges]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs["old"],
                                                     outs["new"])):
            raise AssertionError(f"k8 {name}: the designs differ")
        t = {k: [] for k in ("old", "new", "old_loop", "new_loop")}
        by_c = {c: [] for c in CLUSTERS}
        for _ in range(rounds):
            for v in ("old", "new", "new", "old"):
                st, edges = fresh()
                t[v].append(chip_smoke.graph_ms(
                    lambda: call(v, st, edges), n=20, reps=reps // 10))
                t[v + "_loop"].append(chip_smoke.cuda_ms(
                    lambda: call(v, st, edges), reps // 4))
            for c in CLUSTERS:
                st, edges = fresh()
                by_c[c].append(chip_smoke.graph_ms(
                    lambda: call("new", st, edges, c), n=20,
                    reps=reps // 10))
        after, _ = fresh()
        call("new", after, torch.zeros((3, 1), dtype=torch.int64,
                                       device="cuda"))
        bms, by = chip_smoke.k8_bound_ms(state, after, lcs)
        print(f"k8 {name} (n={n}, L={length}) round {n // 2}: device ms a "
              f"launch in a CUDA graph old {t['old']}, new (cluster of "
              f"{cluster_size(n)}) {t['new']}; from a launch loop old "
              f"{t['old_loop']}, new {t['new_loop']}; new by cluster size "
              f"forced {by_c}; bound {bms:.7f} ms ({by}); {smi}", flush=True)


def k1rows_cases():
    """{name: (table, syms)} of part k1rows."""
    import torch
    from famsa_tpu_torch.core.sequence import Sequence
    from famsa_tpu_torch.ops.lcs_torch import (build_query_mask_table,
                                               pad_sequences)
    out = {}
    for name, fam in (("256x2000", (2000, 300, 11)),
                      ("256x10000", (10000, 300, 7))):
        seqs = [Sequence(f">s{k}", s, k) for k, s in enumerate(
            chip_smoke.fasta_strings(chip_smoke.make_family(*fam)))]
        padded = pad_sequences(seqs)         # TorchDistanceBackend's rows
        table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
        out[name] = (table.cuda(),
                     torch.from_numpy(padded[:256].astype(np.int32)).cuda())
    out["256x2000 W>=40"] = chip_smoke.lcs_case(256, 2000, 1300, 41, "cuda")
    out["64x1000 W>64"] = chip_smoke.lcs_case(64, 1000, 2600, 82, "cuda")
    return out


def part_k1rows(parent, rounds, reps, smi):
    """The parent's K1 rows against this tree's, old, new, new, old."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.lcs_torch import rows_geometry
    if not parent:
        raise SystemExit("part k1rows needs --parent DIR")
    libs = {"old": parent_lib(parent, "lcs"), "new": kernels.get("lcs")}
    for name, (table, syms) in k1rows_cases().items():
        _, w, n = table.shape
        r, length = syms.shape
        outs = {v: torch.empty((r, n), dtype=torch.uint16, device="cuda")
                for v in libs}

        def call(v):
            kernels.check(libs[v].lcs_bitpar(
                table.data_ptr(), syms.data_ptr(), r, length, w, n, n,
                outs[v].data_ptr(), 1,
                torch.cuda.current_stream().cuda_stream), v)
        for v in libs:
            call(v)
        torch.cuda.synchronize()
        if not torch.equal(outs["old"], outs["new"]):
            raise AssertionError(f"k1rows {name}: the designs differ")
        t = {v: [] for v in libs}
        k = max(3, reps // 20)
        for _ in range(rounds):
            for v in ("old", "new", "new", "old"):
                t[v].append(chip_smoke.cuda_ms(lambda: call(v), k))
        bms, by = chip_smoke.lcs_bound_ms(table, syms, n)
        print(f"k1rows {name} (L={length}, W={w}, new geometry (cap, P, "
              f"refs a CTA, staged) {rows_geometry(w)}): ms old {t['old']}, "
              f"new {t['new']}; bound {bms:.5f} ms ({by}); {smi}",
              flush=True)


def largest_k2_batch(work, n, max_batch=16):
    """(colf, rowf, meta, total) of the largest K2 launch of max_batch
    merges (by direction bytes) in the n-sequence default run."""
    from famsa_tpu_torch.ops import dp_torch
    fa = os.path.join(work, f"fam{n}.fa")
    with open(fa, "w") as f:
        f.write(chip_smoke.make_family(n, 300, 7))
    best = {}
    orig = dp_torch.dp_dirs

    def keep(colf, rowf, meta, total, variant=None, meta_host=None):
        if meta.shape[0] == max_batch and total > best.get("total", -1):
            best.update(total=total, args=(colf, rowf, meta, total))
        return orig(colf, rowf, meta, total, variant=variant,
                    meta_host=meta_host)
    dp_torch.dp_dirs = keep
    try:
        rc, _ = chip_smoke.run_cli(["-backend", "torch", "-device", "cuda", fa,
                                    os.path.join(work, "out.fa")], {})
    finally:
        dp_torch.dp_dirs = orig
    if rc != 0 or not best:
        raise AssertionError(f"k2: no batch of {max_batch} in the {n} run")
    return best["args"]


def old_k2_geometry(max_w2):
    """(threads, stripe) of K2's first design (csrc/dp.cu): the smallest
    register stripe (1, 2, 4, 8) whose 512 threads cover max_w2 + 1
    columns, else a local-memory stripe; threads in whole warps."""
    cols = max_w2 + 1
    for s in (1, 2, 4, 8):
        if s * 512 >= cols:
            break
    else:
        s = -(-cols // 512)
    threads = -(-cols // s)
    return ((threads + 31) // 32) * 32, s


def old_k2(lib, colf, rowf, meta, total, variant=None, meta_host=None):
    """K2's first design (the parent's csrc/dp.cu:dp_profile_batched, one
    CTA a merge) on a packed batch, on dp_dirs's arguments: (dirs, fin)."""
    import torch
    from famsa_tpu_torch import kernels
    b, _, ldc = colf.shape
    ldr = rowf.shape[1]
    dirs = torch.empty(total, dtype=torch.uint8, device=colf.device)
    fin = torch.empty((b, ldr - 1, 3), dtype=torch.int64, device=colf.device)
    threads, stripe = old_k2_geometry(ldc - 1)
    kernels.check(lib.dp_profile_batched(
        colf.data_ptr(), rowf.data_ptr(), meta.data_ptr(), b, threads,
        stripe, ldc, ldr, ldr - 1, dirs.data_ptr(), fin.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "parent dp_profile_batched")
    return dirs, fin


def part_k2(parent, reps, smi):
    import torch
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops.dp_torch import dp_dirs, pack_batch, prepare_merge
    from famsa_tpu_torch.ops.dp_wide import staged_geometry
    if not parent:
        raise SystemExit("part k2 needs --parent DIR")
    old_lib = parent_lib(parent, "dp")
    fns = {"global": lambda *a: old_k2(old_lib, *a),
           "staged": lambda *a: dp_dirs(*a, variant="staged")}
    rng = np.random.default_rng(17)
    params = Params(device="cuda")
    params.adjust(1000)
    p1 = chip_smoke.random_profile(rng, params, 12, 2048)
    p2 = chip_smoke.random_profile(rng, params, 9, 2048)
    colf, rowf, meta, total = pack_batch([prepare_merge(params, p1, p2)])
    cases = [("lone 2048x2048",
              [torch.from_numpy(x).cuda() for x in (colf, rowf, meta)] + [total])]
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
        for n in (1000, 10000):
            cases.append((f"largest 16-merge batch of the {n} run",
                          list(largest_k2_batch(work, n))))
    reps = max(3, reps // 20)
    for what, args in cases:
        t = {v: [] for v in ("global", "staged")}
        for v in ("global", "staged", "staged", "global"):
            t[v].append(chip_smoke.cuda_ms(lambda: fns[v](*args), reps))
        w1s, w2s = args[2][:, 0].tolist(), args[2][:, 1].tolist()
        bms, by = chip_smoke.dp_bound_ms(*args)
        print(f"k2 {what}: merges (w1, w2) {list(zip(w1s, w2s))}, staged "
              f"geometry {staged_geometry(w2s)}: global {t['global']} ms, "
              f"staged {t['staged']} ms; us per row of the deepest merge "
              f"global {[x / max(w1s) * 1e3 for x in t['global']]} staged "
              f"{[x / max(w1s) * 1e3 for x in t['staged']]}; bound {bms:.5f} "
              f"ms ({by}); {smi}", flush=True)
        if len(w1s) > 1:
            staged_alternatives(args, reps, smi, what)


def staged_alternatives(args, reps, smi, what):
    """CUDA-event ms of K2's staged variant on one batch as the port
    launches it, with MIN_FOLD_COLS 512 (fold_geometry then picks the
    fewest folds), and as one launch per group of merges of equal fold
    count, in the order port, wide, split, split, wide, port."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_wide
    from famsa_tpu_torch.ops.dp_torch import dp_dirs
    colf, rowf, meta, total = args
    w2s = meta[:, 1].tolist()
    folds, fw, merge_folds = dp_wide.staged_geometry(w2s)
    groups = {}
    for k, f in enumerate(merge_folds):
        groups.setdefault(f, []).append(k)
    parts = []
    for idx in groups.values():
        i = torch.tensor(idx, device=colf.device)
        parts.append((colf[i].contiguous(), rowf[i].contiguous(),
                      meta[i].contiguous()))

    def port():
        dp_dirs(*args, variant="staged")

    def split():
        for c, r, m in parts:
            dp_dirs(c, r, m, total, variant="staged")

    def wide():
        old = dp_wide.MIN_FOLD_COLS
        dp_wide.MIN_FOLD_COLS = dp_wide.MAX_THREADS
        try:
            dp_dirs(*args, variant="staged")
        finally:
            dp_wide.MIN_FOLD_COLS = old
    t = {"port": [], "wide": [], "split": []}
    fns = {"port": port, "wide": wide, "split": split}
    for v in ("port", "wide", "split", "split", "wide", "port"):
        t[v].append(chip_smoke.cuda_ms(fns[v], reps))
    lib = kernels.get("dp_wide")
    old = dp_wide.MIN_FOLD_COLS
    dp_wide.MIN_FOLD_COLS = dp_wide.MAX_THREADS
    wide_geo = dp_wide.staged_geometry(w2s)
    dp_wide.MIN_FOLD_COLS = old
    print(f"k2 staged co-residency, {what}: {len(w2s)} merges, port "
          f"geometry ({folds} folds of {fw}, merge folds {merge_folds}; "
          f"{lib.dp_wide_max_clusters(folds, fw, 1, dp_wide.BLK)} clusters "
          f"fit) {t['port']} ms; folds of 512 ({wide_geo[0]} folds; "
          f"{lib.dp_wide_max_clusters(wide_geo[0], wide_geo[1], 1, dp_wide.BLK)}"
          f" fit) {t['wide']} ms; one launch per fold count "
          f"({len(parts)} launches) {t['split']} ms; {smi}", flush=True)


def old_fold_geometry(w2):
    """(folds, threads, stripe) of K3's first design (the parent's L2
    variant): up to 8 folds of >= 256 columns, stripes of 1-8 columns."""
    cols = w2 + 1
    folds = min(8, -(-cols // 256))
    per = -(-cols // folds)
    stripe = next(s for s in (1, 2, 4, 8) if s * 512 >= per)
    threads = -(-(-(-per // stripe)) // 32) * 32
    return -(-cols // (threads * stripe)), threads, stripe


def old_k3(lib, args, total):
    """The parent's L2 variant on one packed merge (its 8-fold geometry);
    returns (dirs, fin)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_wide
    colf, rowf, meta = args
    w1, w2 = (int(x) for x in meta[0, :2].tolist())
    folds, threads, stripe = old_fold_geometry(w2)
    dirs = torch.empty(total, dtype=torch.uint8, device="cuda")
    fin = torch.empty((1, rowf.shape[1] - 1, 3), dtype=torch.int64,
                      device="cuda")
    kernels.check(lib.dp_profile_wide_l2(
        colf.data_ptr(), rowf.data_ptr(), w1, w2, folds, threads, stripe,
        colf.shape[2], dp_wide.BLK, dirs.data_ptr(), fin.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "dp_profile_wide_l2")
    return dirs, fin


def k3_pair(old_lib, args, total, rounds, reps):
    """Old (the parent's L2) and new (this tree's K3) on one merge: equal
    dirs and finals, then CUDA-event ms in old, new, new, old rounds."""
    import torch
    from famsa_tpu_torch.ops import dp_wide
    w1 = int(args[2][0, 0])
    got = {"old": old_k3(old_lib, args, total),
           "new": dp_wide.dp_dirs_wide(*args, total)}
    if not (torch.equal(got["old"][0], got["new"][0]) and torch.equal(
            got["old"][1][0, :w1], got["new"][1][0, :w1])):
        raise AssertionError("k3: the designs differ")
    fns = {"old": lambda: old_k3(old_lib, args, total),
           "new": lambda: dp_wide.dp_dirs_wide(*args, total)}
    t = {"old": [], "new": []}
    for _ in range(rounds):
        for v in ("old", "new", "new", "old"):
            t[v].append(chip_smoke.cuda_ms(fns[v], reps))
    return t


def packed_merge(params, rng, n1, w1, n2, w2):
    import torch
    from famsa_tpu_torch.ops.dp_torch import pack_batch, prepare_merge
    p1 = chip_smoke.random_profile(rng, params, n1, w1,
                                   0.0 if n1 == 1 else 0.2)
    p2 = chip_smoke.random_profile(rng, params, n2, w2)
    colf, rowf, meta, total = pack_batch([prepare_merge(params, p1, p2)])
    return [torch.from_numpy(x).cuda() for x in (colf, rowf, meta)], total


def part_k3(parent, reps, smi):
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops import dp_wide
    if not parent:
        raise SystemExit("part k3 needs --parent DIR")
    old_lib = parent_lib(parent, "dp_wide")
    rng = np.random.default_rng(31)
    params = Params(device="cuda")
    params.adjust(1000)
    reps = max(3, reps // 20)
    for w1, w2 in K3_SHAPES:
        args, total = packed_merge(params, rng, 50, w1, 50, w2)
        t = k3_pair(old_lib, args, total, 1, reps)
        per_row = {v: [x / w1 * 1e3 for x in t[v]] for v in t}
        print(f"k3 {w1}x{w2} old {old_fold_geometry(w2)} new "
              f"{dp_wide.fold_geometry(w2)}: l2 {t['old']} ms, staged "
              f"{t['new']} ms; us per row l2 {per_row['old']} staged "
              f"{per_row['new']}; {smi}", flush=True)
        if (w1, w2) in ((328, 1227), (454, 1065), (307, 3844)):
            old = dp_wide.BLK, dp_wide.MIN_FOLD_COLS
            try:
                for blk in (8, 16, 32):
                    for mfc in (128, 256):
                        dp_wide.BLK, dp_wide.MIN_FOLD_COLS = blk, mfc
                        k = chip_smoke.cuda_ms(
                            lambda: dp_wide.dp_dirs_wide(*args, total), reps)
                        print(f"k3 staged {w1}x{w2} BLK={blk} MIN_FOLD_COLS="
                              f"{mfc} {dp_wide.fold_geometry(w2)}: {k:.4f} "
                              "ms", flush=True)
            finally:
                dp_wide.BLK, dp_wide.MIN_FOLD_COLS = old


# the redesign past 4095 columns: lone seq-prof merges (w1, w2), and a
# prof-prof one
WIDE_LONE = ((600, 4500), (600, 5906), (300, 8000), (300, 12000),
             (300, 16256))
WIDE_PROF = (2000, 6000)


def chain_dp_pair(old_lib, cap, rounds, reps, smi):
    """The DP of one chain step at capacity cap, on the step's K5 output
    in the chunk's buffers: the parent's dp_profile_wide_l2_meta (8 folds)
    against this tree's batched entry with B = 1 (as ChainGraph.launch
    calls it), equal dirs and finals, old, new, new, old."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_wide
    b = chain_step(cap, leaf_len=300, width=cap - 700)
    g = b.graph(cap)
    w1, w2 = (int(x) for x in b.meta[0, :2].tolist())
    stream = torch.cuda.current_stream().cuda_stream
    ofolds, othreads, ostripe = old_fold_geometry(cap)
    outs = {v: (torch.zeros_like(b.dirs), torch.zeros_like(b.fin))
            for v in ("old", "new")}
    new_lib = kernels.get("dp_wide")

    def old(o=outs["old"]):
        kernels.check(old_lib.dp_profile_wide_l2_meta(
            b.colf.data_ptr(), b.rowf.data_ptr(), b.meta.data_ptr(), cap,
            ofolds, othreads, ostripe, g.ldc, dp_wide.BLK, o[0].data_ptr(),
            o[1].data_ptr(), stream), "l2_meta")

    def new(o=outs["new"]):
        if g.variant == "staged":
            err = new_lib.dp_profile_batched_staged(
                b.colf.data_ptr(), b.rowf.data_ptr(), b.meta.data_ptr(), 1,
                cap, g.folds, g.threads, g.ldc, b.w1p + 1, b.w1p,
                dp_wide.BLK, o[0].data_ptr(), o[1].data_ptr(), stream)
        else:
            err = new_lib.dp_profile_batched_stripes(
                b.colf.data_ptr(), b.rowf.data_ptr(), b.meta.data_ptr(), 1,
                cap, g.folds, g.threads, g.stripe, g.ldc, b.w1p + 1, b.w1p,
                dp_wide.BLK, o[0].data_ptr(), o[1].data_ptr(), stream)
        kernels.check(err, f"chain DP {g.variant}")
    old()
    new()
    torch.cuda.synchronize()
    n = (w1 + 1) * (w2 + 1)
    if not (torch.equal(outs["old"][0][:n], outs["new"][0][:n])
            and torch.equal(outs["old"][1][0, :w1], outs["new"][1][0, :w1])):
        raise AssertionError(f"chain DP at {cap}: the designs differ")
    t = {"old": [], "new": []}
    fns = {"old": old, "new": new}
    for _ in range(rounds):
        for v in ("old", "new", "new", "old"):
            t[v].append(chip_smoke.cuda_ms(fns[v], reps))
    meta = torch.tensor([[w1, w2, 0, 0]], device="cuda")
    bms, by = chip_smoke.dp_bound_ms(
        b.colf.view(1, -1, g.ldc)[:, :, :w2 + 1], b.rowf[:, :w1 + 1], meta,
        n)
    print(f"wide chain step DP at capacity {cap} ({w1}x{w2}; old "
          f"{(ofolds, othreads, ostripe)} l2_meta, new {g.variant} "
          f"{(g.folds, g.threads, g.stripe)}): old {t['old']} ms, new "
          f"{t['new']} ms; bound {bms:.5f} ms ({by}); {smi}", flush=True)


def wide_k2_batch(work):
    """(colf, rowf, meta, total) of the largest K2 launch (by direction
    bytes) whose widest w2 is past 4095 in a default run of
    chip_smoke.WIDE_FAMILY, and the run's count of such launches."""
    from famsa_tpu_torch.ops import dp_torch
    n, mean_len, seed = chip_smoke.WIDE_FAMILY
    fa = os.path.join(work, "wide.fa")
    with open(fa, "w") as f:
        f.write(chip_smoke.make_family(n, mean_len, seed))
    best, count = {}, [0]
    orig = dp_torch.dp_dirs

    def keep(colf, rowf, meta, total, variant=None, meta_host=None):
        w2s = (meta.cpu().numpy() if meta_host is None else meta_host)[:, 1]
        if max(w2s) > 4095:
            count[0] += 1
            if total > best.get("total", -1):
                best.update(total=total, args=(colf, rowf, meta, total))
        return orig(colf, rowf, meta, total, variant=variant,
                    meta_host=meta_host)
    dp_torch.dp_dirs = keep
    try:
        rc, _ = chip_smoke.run_cli(["-backend", "torch", "-device", "cuda",
                                    fa, os.path.join(work, "out.fa")], {})
    finally:
        dp_torch.dp_dirs = orig
    if rc != 0:
        raise AssertionError(f"wide: the {n}-sequence run failed, rc={rc}")
    return best.get("args"), count[0]


def part_wide(parent, rounds, reps, smi):
    import torch
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops import dp_wide
    from famsa_tpu_torch.ops.dp_torch import dp_dirs, k2_variant
    if not parent:
        raise SystemExit("part wide needs --parent DIR")
    old_lib = parent_lib(parent, "dp_wide")
    rng = np.random.default_rng(37)
    params = Params(device="cuda")
    params.adjust(1000)
    reps = max(3, reps // 20)
    cases = [(1, w1, 300, w2) for w1, w2 in WIDE_LONE]
    cases.append((400, WIDE_PROF[0], 300, WIDE_PROF[1]))
    for n1, w1, n2, w2 in cases:
        args, total = packed_merge(params, rng, n1, w1, n2, w2)
        t = k3_pair(old_lib, args, total, rounds, reps)
        bms, by = chip_smoke.dp_bound_ms(*args, total)
        print(f"wide k3 {'seq-prof' if n1 == 1 else 'prof-prof'} {w1}x{w2} "
              f"(old l2 {old_fold_geometry(w2)}, new "
              f"{dp_wide.k3_variant(w2)} {dp_wide.fold_geometry(w2)}): old "
              f"{t['old']} ms, new {t['new']} ms; bound {bms:.5f} ms ({by}); "
              f"{smi}", flush=True)
    for cap in (8191, 16256):
        chain_dp_pair(old_lib, cap, rounds, reps, smi)
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
        args, count = wide_k2_batch(work)
    if args is None:
        print(f"wide k2: the {chip_smoke.WIDE_FAMILY} run launched no K2 "
              f"batch past 4095 columns; {smi}", flush=True)
        return
    w2s = args[2][:, 1].tolist()
    new_v = k2_variant(max(w2s))
    k2_lib = parent_lib(parent, "dp")
    fns = {"global": lambda: old_k2(k2_lib, *args),
           new_v: lambda: dp_dirs(*args, variant=new_v)}
    got = {v: fn() for v, fn in fns.items()}
    if not torch.equal(got["global"][0], got[new_v][0]):
        raise AssertionError("wide k2: the designs differ")
    t = {"global": [], new_v: []}
    for _ in range(rounds):
        for v in ("global", new_v, new_v, "global"):
            t[v].append(chip_smoke.cuda_ms(fns[v], reps))
    bms, by = chip_smoke.dp_bound_ms(*args)
    print(f"wide k2 largest batch past 4095 of the {chip_smoke.WIDE_FAMILY} "
          f"run ({count} such launches): merges (w1, w2) "
          f"{args[2][:, :2].tolist()}, new geometry "
          f"{dp_wide.batch_geometry(w2s)}: global {t['global']} ms, {new_v} "
          f"{t[new_v]} ms; bound {bms:.5f} ms ({by}); {smi}", flush=True)


def parent_lib(parent, name):
    """ctypes library of csrc/<name>.cu of the tree unpacked at `parent`,
    built with the port's nvcc flags into parent/_build."""
    import ctypes
    import subprocess
    from famsa_tpu_torch import kernels
    src = pathlib.Path(parent) / "famsa_tpu_torch" / "csrc" / f"{name}.cu"
    so = pathlib.Path(parent) / "_build" / f"libparent_{name}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,"
                    "code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    if name == "prim" and not hasattr(lib, "prim_cluster_size"):
        # the parent's K8 (one CTA a round) takes no cluster argument
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.prim_round.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp,
                                   vp, vp, ci, ci, vp]
        lib.prim_round.restype = ci
        return lib
    if name == "dp":
        # K2's first design, deleted from this tree
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dp_profile_batched.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                           ci, vp, vp, vp]
        lib.dp_profile_batched.restype = ci
        return lib
    if name != "dp_wide":
        kernels._configure(name, lib)
        if name == "lcs" and b"void* scratch" not in src.read_bytes():
            # a parent whose K9 entry takes no scratch argument
            types = lib.lcs_refmask.argtypes
            lib.lcs_refmask.argtypes = types[:11] + types[12:]
        return lib
    # the parent's K3 L2 entries (the first design)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dp_profile_wide_l2.argtypes = [vp, vp, ll, ll, ci, ci, ci, ci, ci,
                                       vp, vp, vp]
    lib.dp_profile_wide_l2_meta.argtypes = [vp, vp, vp, ll, ci, ci, ci, ci,
                                            ci, vp, vp, vp]
    for fn in (lib.dp_profile_wide_l2, lib.dp_profile_wide_l2_meta):
        fn.restype = ci
    return lib


def run_inputs(work):
    """The 10,000-sequence default run under chip_smoke.py's
    LaunchRecorder, which keeps K4's and K6's largest launch (inputs);
    returns it and the inputs of the longest lone merge's K4 and K6
    launches (a K3 dispatch), {"traceback": args, "merged": args}."""
    from famsa_tpu_torch import kernels
    import famsa_tpu_torch.ops.dp_resident as dpr
    fa = os.path.join(work, "fam10000.fa")
    with open(fa, "w") as f:
        f.write(chip_smoke.make_family(10000, 300, 7))
    rec = chip_smoke.LaunchRecorder()
    lone, best = {}, {}
    orig_tb, orig_mg = dpr.trace_paths, dpr.merged_from_paths

    def keep(key, size, args):
        if size > best.get(key, -1):
            best[key], lone[key] = size, args

    def trace_paths(dirs, fin, meta, meta_host=None):
        if meta_host is not None and len(meta_host) == 1:
            keep("traceback", int(meta_host[0, 0] + meta_host[0, 1]),
                 (dirs, fin, meta, meta_host))
        return orig_tb(dirs, fin, meta, meta_host=meta_host)

    def merged_from_paths(sides, paths, hdr, smax):
        if sides.b == 1:
            keep("merged", smax, (sides, paths, hdr, smax))
        return orig_mg(sides, paths, hdr, smax)
    dpr.trace_paths, dpr.merged_from_paths = trace_paths, merged_from_paths
    rec.start("10000")
    try:
        rc, _ = chip_smoke.run_cli(["-backend", "torch", "-device", "cuda",
                                    fa, os.path.join(work, "out.fa")], {})
    finally:
        dpr.trace_paths, dpr.merged_from_paths = orig_tb, orig_mg
    rec.stop(dict(kernels.LAUNCHES))
    if rc != 0:
        raise AssertionError(f"k4/k6: the 10,000-sequence run failed, rc={rc}")
    return rec, lone


def chain_step(cap=2047, leaf_len=800, width=1040):
    """A chain of `width` columns merging two leaves of leaf_len residues
    in one chunk of capacity cap (ops/dp_chain.py), run; returns the
    buffers, whose dirs, fin, meta, hdr[1], desc[1] and second path are
    the last step's K4 and K6 inputs (K6 reads the carry the first step
    wrote)."""
    import torch
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops import dp_chain
    rng = np.random.default_rng(23)
    params = Params(device="cuda")
    params.adjust(1000)
    start = chip_smoke.random_profile(rng, params, 12, width)
    leaves = [chip_smoke.random_profile(rng, params, 1, leaf_len, 0.0)
              for _ in range(2)]
    bufs = dp_chain.ChainBuffers(torch.device("cuda"), 2,
                                 dp_chain.CHAIN_W1P, cap)
    state = dp_chain.ChainState(bufs, start)
    state.seed(params, start)
    res = dp_chain.dispatch_chain_chunk(params, state, leaves, cap).resolve()
    if len(res) != 2:
        raise AssertionError("k4/k6: the chain steps did not run")
    return bufs


def k46_cases(work, cap=2047):
    """{what: (K4 call, its output bytes, K6 call, its output int32,
    shape)}: each call a function (lib, out) -> cudaError_t that launches
    the design in `lib` on one kept launch's inputs into `out`."""
    import torch
    from famsa_tpu_torch.ops.traceback_torch import path_offsets
    rec, lone = run_inputs(work)
    cases = {}
    for what, (k4args, k6args) in (
            ("largest launch of the 10,000 run",
             (rec.inputs["traceback"][1], rec.inputs["merged"][1])),
            ("longest lone merge of the 10,000 run",
             (lone["traceback"], lone["merged"]))):
        dirs, fin, meta, meta_h = k4args
        sides, paths, hdr, smax = k6args
        b4, b6 = meta.shape[0], sides.b
        cases[what] = (
            lambda lib, out, a=(dirs, fin, meta, b4): lib.trace_paths(
                a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), a[3],
                a[1].shape[1], out.data_ptr(),
                torch.cuda.current_stream().cuda_stream),
            path_offsets(meta_h)[1],
            lambda lib, out, a=(sides, paths, hdr, b6, smax):
                lib.merged_counters(
                    a[0].desc.data_ptr(), a[2].data_ptr(), a[1].data_ptr(),
                    a[3], a[4], out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream),
            b6 * (smax + 1) * 32,
            f"K4: {b4} merge(s) {meta_h[:, :2].tolist()}; K6: {b6} "
            f"merge(s), smax {smax}")
    b = chain_step(cap)
    ps = b.graph(cap).ps
    path = b.out[ps:2 * ps]
    w1, w2 = b.meta[0, :2].tolist()
    cases[f"chain step, capacity {cap}"] = (
        lambda lib, out: lib.trace_paths(
            b.dirs.data_ptr(), b.fin.data_ptr(), b.meta.data_ptr(), 1,
            b.w1p, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        path.numel(),
        lambda lib, out: lib.merged_counters(
            b.desc[1].data_ptr(), b.hdr[1].data_ptr(), path.data_ptr(), 1,
            cap, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        (cap + 1) * 32,
        f"one merge {w1}x{w2}, ldf {b.w1p}, smax {cap}")
    return cases


def part_k46(parts, parent, rounds, reps, smi):
    """Parts k4 and k6: the parent's design against this tree's on each
    case of k46_cases, old, new, new, old in `rounds` rounds."""
    import torch
    from famsa_tpu_torch import kernels
    if not parent:
        raise SystemExit("parts k4 and k6 need --parent DIR")
    names = [n for n, k in (("traceback", "k4"), ("merged", "k6"))
             if k in parts]
    libs = {n: {"old": parent_lib(parent, n), "new": kernels.get(n)}
            for n in names}
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
        cases = k46_cases(work)
    for what, (k4, n4, k6, n6, shape) in cases.items():
        for name in names:
            call, size, dtype = ((k4, n4, torch.uint8) if name == "traceback"
                                 else (k6, n6, torch.int32))
            outs = {v: torch.zeros(size, dtype=dtype, device="cuda")
                    for v in ("old", "new")}
            for v in ("old", "new"):
                kernels.check(call(libs[name][v], outs[v]), f"{name} {v}")
            torch.cuda.synchronize()
            if not torch.equal(outs["old"], outs["new"]):
                raise AssertionError(f"{name} {what}: the designs differ")
            t = {"old": [], "new": []}
            for _ in range(rounds):
                for v in ("old", "new", "new", "old"):
                    t[v].append(chip_smoke.graph_ms(
                        lambda: kernels.check(call(libs[name][v], outs[v]),
                                              name), n=reps))
            print(f"{'k4' if name == 'traceback' else 'k6'} {what} ({shape}): "
                  f"device ms a launch (CUDA graph of {reps}) old {t['old']}, "
                  f"new {t['new']}; {smi}", flush=True)


SPLIT_SHAPES = ((1, 300, 9000), (1, 300, 12000), (1, 300, 16256),
                (1, 300, 30000), (400, 1000, 12000), (400, 1000, 16256))


def apply_patch(text, patch):
    """`text` with the hunks of the unified diff `patch` applied: each
    hunk's old lines (context and removals) must occur exactly once and
    become its new lines (context and additions)."""
    hunks, cur = [], None
    for line in patch.splitlines(keepends=True):
        if line.startswith("@@"):
            cur = ([], [])
            hunks.append(cur)
        elif cur is not None and line[:1] in (" ", "-", "+"):
            if line[0] != "+":
                cur[0].append(line[1:])
            if line[0] != "-":
                cur[1].append(line[1:])
    for old, new in hunks:
        old, new = "".join(old), "".join(new)
        if text.count(old) != 1:
            raise SystemExit("scripts/dp_wide_variants.patch does not apply "
                             "to csrc/dp_wide.cu: bring it up to date")
        text = text.replace(old, new)
    return text


def variant_lib(define, name):
    """ctypes library of csrc/dp_wide.cu with scripts/dp_wide_variants.patch
    applied, built with -D`define` into the port's build directory as
    lib<name>.so (the rejected designs of the stripes body)."""
    import ctypes
    import subprocess
    from famsa_tpu_torch import kernels
    src = kernels.BUILD_DIR / f"{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(apply_patch(
        (kernels._CSRC / "dp_wide.cu").read_text(),
        (ROOT / "scripts" / "dp_wide_variants.patch").read_text()))
    so = kernels.BUILD_DIR / f"lib{name}.so"
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,"
                    "code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", f"-D{define}",
                    f"-I{kernels._CSRC}", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    kernels._configure("dp_wide", lib)
    lib.dp_stripes_shared_cols.argtypes = [ctypes.c_int] * 3
    lib.dp_stripes_shared_cols.restype = ctypes.c_int
    return lib


def part_split(rounds, reps, smi):
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops import dp_wide
    libs = {"all": variant_lib("STRIPES_SCORES_ON_CHIP=1",
                               "famsa_dp_wide_scores_on_chip"),
            "factors": kernels.get("dp_wide")}
    rng = np.random.default_rng(41)
    params = Params(device="cuda")
    params.adjust(1000)
    reps = max(3, reps // 20)
    for n1, w1, w2 in SPLIT_SHAPES:
        args, total = packed_merge(params, rng, n1, w1, 300, w2)
        colf, rowf, meta = args
        folds, threads, stripe = dp_wide.fold_geometry(w2)
        outs = {v: (torch.empty(total, dtype=torch.uint8, device="cuda"),
                    torch.empty((1, rowf.shape[1] - 1, 3), dtype=torch.int64,
                                device="cuda")) for v in libs}

        def call(v):
            kernels.check(libs[v].dp_profile_wide_stripes(
                colf.data_ptr(), rowf.data_ptr(), w1, w2, folds, threads,
                stripe, colf.shape[2], dp_wide.BLK, outs[v][0].data_ptr(),
                outs[v][1].data_ptr(),
                torch.cuda.current_stream().cuda_stream), f"split {v}")
        for v in libs:
            call(v)
        torch.cuda.synchronize()
        if not (torch.equal(outs["all"][0], outs["factors"][0]) and
                torch.equal(outs["all"][1][0, :w1],
                            outs["factors"][1][0, :w1])):
            raise AssertionError(f"split {w1}x{w2}: the builds differ")
        t = {v: [] for v in libs}
        for _ in range(rounds):
            for v in ("all", "factors", "factors", "all"):
                t[v].append(chip_smoke.cuda_ms(lambda: call(v), reps))
        bms, by = chip_smoke.dp_bound_ms(colf, rowf, meta, total)
        nsh = {"all": libs["all"].dp_stripes_shared_cols(threads, stripe,
                                                          dp_wide.BLK),
               "factors": threads * stripe}
        print(f"split {'seq-prof' if n1 == 1 else 'prof-prof'} {w1}x{w2} "
              f"{(folds, threads, stripe)}: every plane on chip ({nsh['all']}"
              f" columns a fold) {t['all']} ms, factors only "
              f"({nsh['factors']} columns) {t['factors']} ms; bound "
              f"{bms:.5f} ms ({by}); {smi}", flush=True)


def stripes_geometry_256(w2):
    """(folds, threads, stripe) of the stripes body built for at most 256
    threads a fold: 16 folds of the smallest stripe in (2, 4, 8) that 256
    threads cover (fold_geometry's rule at another thread cap)."""
    cols = w2 + 1
    per = -(-cols // 16)
    stripe = next(s for s in (2, 4, 8) if s * 256 >= per)
    threads = -(-(-(-per // stripe)) // 32) * 32
    return -(-cols // (threads * stripe)), threads, stripe


def part_threads(rounds, reps, smi):
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops import dp_wide
    libs = {"512": kernels.get("dp_wide"),
            "256": variant_lib("STRIPES_MAX_THREADS=256",
                               "famsa_dp_wide_256")}
    geos = {"512": dp_wide.fold_geometry, "256": stripes_geometry_256}
    rng = np.random.default_rng(41)
    params = Params(device="cuda")
    params.adjust(1000)
    reps = max(3, reps // 20)
    for n1, w1, w2 in SPLIT_SHAPES:
        args, total = packed_merge(params, rng, n1, w1, 300, w2)
        colf, rowf, meta = args
        outs = {v: (torch.empty(total, dtype=torch.uint8, device="cuda"),
                    torch.empty((1, rowf.shape[1] - 1, 3), dtype=torch.int64,
                                device="cuda")) for v in libs}

        def call(v):
            folds, threads, stripe = geos[v](w2)
            kernels.check(libs[v].dp_profile_wide_stripes(
                colf.data_ptr(), rowf.data_ptr(), w1, w2, folds, threads,
                stripe, colf.shape[2], dp_wide.BLK, outs[v][0].data_ptr(),
                outs[v][1].data_ptr(),
                torch.cuda.current_stream().cuda_stream), f"threads {v}")
        for v in libs:
            call(v)
        torch.cuda.synchronize()
        if not (torch.equal(outs["512"][0], outs["256"][0]) and
                torch.equal(outs["512"][1][0, :w1],
                            outs["256"][1][0, :w1])):
            raise AssertionError(f"threads {w1}x{w2}: the builds differ")
        t = {v: [] for v in libs}
        for _ in range(rounds):
            for v in ("512", "256", "256", "512"):
                t[v].append(chip_smoke.cuda_ms(lambda: call(v), reps))
        print(f"threads {'seq-prof' if n1 == 1 else 'prof-prof'} {w1}x{w2}: "
              f"512 threads {geos['512'](w2)} {t['512']} ms, 256 threads "
              f"{geos['256'](w2)} {t['256']} ms; {smi}", flush=True)


def part_spans(parent, rounds, reps, smi):
    import torch
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops.dp_torch import dp_dirs, pack_batch, prepare_merge
    from famsa_tpu_torch.ops.dp_wide import spans_geometry
    if not parent:
        raise SystemExit("part spans needs --parent DIR")
    import ctypes
    old_lib = parent_lib(parent, "dp")
    a_lib = variant_lib("STRIPES_SCORES_ON_CHIP=0", "dp_wide_design_a")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    a_lib.dp_profile_batched_wide_stripes.argtypes = [
        vp, vp, vp, ci, ctypes.c_longlong, ci, ci, ci, ci, ci, vp, vp, vp]
    a_lib.dp_profile_batched_wide_stripes.restype = ci

    def design_a(colf, rowf, meta, total, max_w2):
        from famsa_tpu_torch import kernels
        from famsa_tpu_torch.ops.dp_wide import BLK
        b, _, ldc = colf.shape
        ldr = rowf.shape[1]
        dirs = torch.empty(total, dtype=torch.uint8, device=colf.device)
        fin = torch.empty((b, ldr - 1, 3), dtype=torch.int64,
                          device=colf.device)
        kernels.check(a_lib.dp_profile_batched_wide_stripes(
            colf.data_ptr(), rowf.data_ptr(), meta.data_ptr(), b, max_w2,
            8 if max_w2 <= 65535 else 16, ldc, ldr, ldr - 1, BLK,
            dirs.data_ptr(), fin.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "design (a)")
        return dirs, fin

    rng = np.random.default_rng(29)
    params = Params(device="cuda")
    params.adjust(1000)
    reps = max(2, reps // 100)
    for banded in (False, True):
        for shapes in ([[sh] for sh in chip_smoke.SPANS_LONE]
                       + [list(chip_smoke.SPANS_BATCH)]):
            pairs, bands, _ = chip_smoke.spans_pairs(rng, params, shapes,
                                                     banded)
            colf, rowf, meta, total = pack_batch(
                [prepare_merge(params, a, b, bd)
                 for (a, b), bd in zip(pairs, bands)])
            args = [torch.from_numpy(x).cuda() for x in (colf, rowf, meta)]
            fns = {"old": lambda: old_k2(old_lib, *args, total),
                   "new": lambda: dp_dirs(*args, total),
                   "a": lambda: design_a(*args, total,
                                         int(meta[:, 1].max()))}
            got = {v: fn() for v, fn in fns.items()}
            if chip_smoke.dp_max_err(got["old"], got["new"], meta) or \
                    chip_smoke.dp_max_err(got["a"], got["new"], meta):
                raise AssertionError(f"spans {shapes}: the designs differ")
            t = {"old": [], "new": [], "a": []}
            for _ in range(rounds):
                for v in ("old", "new", "a", "a", "new", "old"):
                    t[v].append(chip_smoke.cuda_ms(fns[v], reps))
            bms, by = chip_smoke.dp_bound_ms(*args, total)
            w2s = meta[:, 1].tolist()
            print(f"spans {'banded ' if banded else ''}merges (w1, w2) "
                  f"{meta[:, :2].tolist()} (old {old_k2_geometry(max(w2s))}"
                  f" threads, stripe; new clusters a merge "
                  f"{spans_geometry(w2s)[1]}; a: 16 folds of "
                  f"{8 if max(w2s) <= 65535 else 16} columns a thread): old "
                  f"{t['old']} ms, new {t['new']} ms, a {t['a']} ms; bound "
                  f"{bms:.5f} ms ({by}); {smi}",
                  flush=True)


def part_k9(parent, rounds, reps, smi):
    """The parent's K9 against this tree's, old, new, new, old."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.sequence import Sequence
    from famsa_tpu_torch.ops.lcs_torch import (famsa_flags, lcs_rows,
                                               pad_sequences,
                                               wave_geometry)
    if not parent:
        raise SystemExit("part k9 needs --parent DIR")
    libs = {"old": parent_lib(parent, "lcs"), "new": kernels.get("lcs")}
    cases = []
    for fam in ((500, 300, 13), (10000, 300, 13)):
        strings = chip_smoke.fasta_strings(chip_smoke.make_polyq(*fam))
        table, queries, _, _ = chip_smoke.prim_case(strings, "cuda")
        fl = famsa_flags(queries.cpu().numpy().astype(np.int8))
        flags = torch.from_numpy(fl).cuda()
        n = queries.shape[0]
        for flagged in (True, False):
            i = int(np.nonzero(fl == flagged)[0][0])
            ref = queries[i:i + 1].contiguous()
            cur = torch.tensor([i], dtype=torch.int64, device="cuda")
            cases.append((f"round 1 x {n} ({'' if flagged else 'un'}"
                          f"flagged)", ref, queries, cur, flags, table))
        if n == 500:
            seqs = [Sequence(f">s{k}", s, k) for k, s in enumerate(strings)]
            padded = pad_sequences(seqs)       # TorchDistanceBackend's rows
            rows = torch.from_numpy(padded.astype(np.int32)).cuda()
            ids = np.nonzero(famsa_flags(padded))[0][:18]
            cases.append((f"rows {len(ids)} x {n}",
                          rows[torch.from_numpy(ids).cuda()].contiguous(),
                          rows, None, None, None))
    for name, refs, queries, cur, flags, table in cases:
        r, lr = refs.shape
        n, lq = queries.shape
        outs = {v: torch.full((r, n), -1, dtype=torch.int32, device="cuda")
                for v in libs}

        def call(v):
            fn = libs[v].lcs_refmask
            scratch = (None,) * (len(fn.argtypes) - 12)
            kernels.check(fn(
                refs.data_ptr(), queries.data_ptr(), r, lr, n, lq, n,
                outs[v].data_ptr(), 0,
                None if cur is None else cur.data_ptr(),
                None if flags is None else flags.data_ptr(), *scratch,
                torch.cuda.current_stream().cuda_stream), v)
        for v in libs:
            call(v)
        torch.cuda.synchronize()
        if not torch.equal(outs["old"], outs["new"]):
            raise AssertionError(f"k9 {name}: the designs differ")
        t = {v: [] for v in libs}
        for _ in range(rounds):
            for v in ("old", "new", "new", "old"):
                t[v].append(chip_smoke.graph_ms(lambda: call(v), n=20,
                                                reps=max(3, reps // 20)))
        bms, by = chip_smoke.refmask_bound_ms(refs, queries, n)
        wave = ""
        if table is not None:
            wave_ms = chip_smoke.graph_ms(
                lambda: lcs_rows(table, refs, variant="wave"), n=20,
                reps=max(3, reps // 20))
            wave = f"; K1 wave on the round {wave_ms:.5f} ms"
        print(f"k9 {name} (Lr={lr}, Lq={lq}, W64={-(-lr // 64)}, new "
              f"geometry (wseg, wpl, nl) {wave_geometry(-(-lr // 64))}): "
              f"device ms a launch in a CUDA graph old {t['old']}, new "
              f"{t['new']}; bound {bms:.6f} ms ({by}){wave}; {smi}",
              flush=True)


def k7_chain(device="cuda", k=32, w1p=1024, cap=2047):
    """(params, start profile, leaves) of part k7: 4 variants of
    chip_smoke.py's 800-residue family (seed 5) aligned on the host into
    the chain's start, and the next k as ungapped leaves."""
    from famsa_tpu_torch.core.aligner import align_into
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.core.profile import Profile
    from famsa_tpu_torch.core.sequence import GappedSequence, Sequence
    params = Params(device=device)
    params.adjust(1700)
    strings = chip_smoke.fasta_strings(
        chip_smoke.make_variants(k + 4, 800, 5, 0.6))

    def leaf(i):
        return Profile.from_gapped_sequence(GappedSequence.from_sequence(
            Sequence(f">v{i}", strings[i], i)), params)
    start = leaf(0)
    for i in range(1, 4):
        start = align_into(Profile(params), leaf(i), start, backend="numpy")
    return params, start, [leaf(i) for i in range(4, k + 4)]


def part_k7(parent, rounds, reps, smi):
    """The parent's chunk order (K7 a step) against this tree's (the carry
    in K5's chain entry), old, new, new, old."""
    import ctypes

    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_chain
    from famsa_tpu_torch.ops.dp_wide import BLK
    if not parent:
        raise SystemExit("part k7 needs --parent DIR")
    old_chain, old_s0 = parent_lib(parent, "chain"), parent_lib(parent,
                                                                "stage0")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    old_s0.stage0_chain.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, vp]
    params, start, leaves = k7_chain()
    cap = 2047
    bufs = {v: dp_chain.ChainBuffers(torch.device("cuda"), 32, 1024,
                                     dp_chain.CHAIN_CAPS[-1])
            for v in ("old", "new")}
    for b in bufs.values():
        dp_chain.ChainState(b, start).seed(params, start)
    new_graph = bufs["new"].graph(cap)
    new_graph.capture()
    b = bufs["old"]
    g = dp_chain.ChainGraph(b, cap)
    dpw = kernels.get("dp_wide")
    tb, mg = kernels.get("traceback"), kernels.get("merged")

    def old_launch():
        """The parent's chunk: per step K7, K5, the DP, K4, K6; K7."""
        stream = torch.cuda.current_stream().cuda_stream

        def k7(s):
            kernels.check(old_chain.chain_carry(
                b.leaf.data_ptr(), b.lw.data_ptr(), b.st.data_ptr(),
                b.out.data_ptr(), g.ps, b.widths(cap).data_ptr(),
                b.hdr.data_ptr(), b.desc.data_ptr(), b.carry[0].data_ptr(),
                b.carry[1].data_ptr(), cap, b.w1p, s, b.k, stream), "old K7")
        for s in range(b.k):
            k7(s)
            hdr, desc = b.hdr[s].data_ptr(), b.desc[s].data_ptr()
            kernels.check(old_s0.stage0_chain(
                desc, hdr, b.table.data_ptr(), b.w1p, g.ldc,
                b.colf.data_ptr(), b.rowf.data_ptr(), b.meta.data_ptr(),
                stream), "old K5")
            kernels.check(dpw.dp_profile_batched_staged(
                b.colf.data_ptr(), b.rowf.data_ptr(), b.meta.data_ptr(), 1,
                cap, g.folds, g.threads, g.ldc, b.w1p + 1, b.w1p, BLK,
                b.dirs.data_ptr(), b.fin.data_ptr(), stream), "DP")
            path = b.out.data_ptr() + s * g.ps
            kernels.check(tb.trace_paths(b.dirs.data_ptr(), b.fin.data_ptr(),
                                         b.meta.data_ptr(), 1, b.w1p, path,
                                         stream), "K4")
            kernels.check(mg.merged_counters(
                desc, hdr, path, 1, cap, b.carry[(s + 1) % 2].data_ptr(),
                stream), "K6")
        k7(b.k)
    if g.variant != "staged":
        raise AssertionError(f"k7: capacity {cap} is not staged")
    b.lw.zero_()
    old_launch()                         # the warm-up on invalid lanes
    old_graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        old_graph.capture_begin()
        old_launch()
        old_graph.capture_end()
    cur.wait_stream(side)
    for x in bufs.values():
        dp_chain.upload_leaves(x, leaves)
    saved = {v: [x.clone() for x in (bufs[v].st, bufs[v].carry,
                                      bufs[v].inp)] for v in bufs}
    replays = {"old": old_graph.replay, "new": new_graph.graph.replay}

    def restore(v):
        for x, y in zip((bufs[v].st, bufs[v].carry, bufs[v].inp), saved[v]):
            x.copy_(y)
    for v in bufs:
        restore(v)
        replays[v]()
    torch.cuda.synchronize()
    a, n = bufs["old"], bufs["new"]
    ran = [w for w in n.widths(cap).tolist() if w != dp_chain.NOT_RUN]
    if len(ran) != len(leaves) or max(ran) > cap:
        raise AssertionError(f"k7: the chunk ran {ran}")
    same = (torch.equal(a.st[:3], n.st[:3]) and torch.equal(a.carry, n.carry)
            and torch.equal(a.widths(cap), n.widths(cap))
            and torch.equal(a.hdr, n.hdr)
            and all(torch.equal(chip_smoke.addr_offsets(a, s),
                                chip_smoke.addr_offsets(n, s))
                    for s in range(a.k))
            and torch.equal(a.out[:a.k * g.ps], n.out[:n.k * g.ps]))
    if not same:
        raise AssertionError("k7: the two orders' chunks differ")
    t = {v: [] for v in bufs}
    for _ in range(rounds):
        for v in ("old", "new", "new", "old"):
            base = chip_smoke.cuda_ms(lambda: restore(v), reps // 20)
            t[v].append(chip_smoke.cuda_ms(
                lambda: (restore(v), replays[v]()), reps // 20) - base)
    # one launch of each design's K5 chain entry (step 5 of the chunk's
    # final buffers: both entries rewrite what they read it from) and of
    # K7 (the fold after the last step)
    def stream():
        return torch.cuda.current_stream().cuda_stream
    carry_args = (n.leaf.data_ptr(), n.lw.data_ptr(), n.st.data_ptr(),
                  n.out.data_ptr(), g.ps, n.widths(cap).data_ptr(),
                  n.hdr.data_ptr(), n.desc.data_ptr(), n.carry[0].data_ptr(),
                  n.carry[1].data_ptr(), cap)
    s0, lib = kernels.get("stage0"), kernels.get("chain")

    def k7_args(x):
        return (x.leaf.data_ptr(), x.lw.data_ptr(), x.st.data_ptr(),
                x.out.data_ptr(), g.ps, x.widths(cap).data_ptr(),
                x.hdr.data_ptr(), x.desc.data_ptr(), x.carry[0].data_ptr(),
                x.carry[1].data_ptr(), cap, x.w1p, x.k, x.k)
    calls = {("K5", "old"): lambda: old_s0.stage0_chain(
                 a.desc[5].data_ptr(), a.hdr[5].data_ptr(),
                 a.table.data_ptr(), a.w1p, g.ldc, a.colf.data_ptr(),
                 a.rowf.data_ptr(), a.meta.data_ptr(), stream()),
             ("K5", "new"): lambda: s0.stage0_chain(
                 *carry_args, n.table.data_ptr(), n.w1p, g.ldc,
                 n.colf.data_ptr(), n.rowf.data_ptr(), n.meta.data_ptr(), 5,
                 n.k, stream()),
             ("K7", "old"): lambda: old_chain.chain_carry(*k7_args(a),
                                                          stream()),
             ("K7", "new"): lambda: lib.chain_carry(*k7_args(n), stream())}
    one = {key: [] for key in calls}
    for _ in range(rounds):
        for v in ("old", "new", "new", "old"):
            for kern in ("K5", "K7"):
                fn = calls[kern, v]
                one[kern, v].append(chip_smoke.graph_ms(
                    lambda: kernels.check(fn(), f"{kern} {v}"), n=20,
                    reps=max(3, reps // 20)))
    steps = list(zip(n.lw[:n.k].tolist(), [int(saved["new"][0][0])] +
                     ran[:-1]))
    print(f"k7 chunk of {len(leaves)} variant leaves at capacity {cap} "
          f"(steps (w1, w2) {steps[0]} .. {steps[-1]}): one replay ms, old "
          f"order ({5 * n.k + 1} launches) {t['old']}, new ({4 * n.k + 1}) "
          f"{t['new']}; K5 chain entry at step 5, a launch in a CUDA graph, "
          f"old {one['K5', 'old']}, new (with the carry) {one['K5', 'new']}; "
          f"K7 after the last step, a launch in a CUDA graph, old "
          f"{one['K7', 'old']}, new {one['K7', 'new']}; {smi}", flush=True)


def part_e2e(parent, rounds, smi):
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_torch, lcs_torch
    if not parent:
        raise SystemExit("part e2e needs --parent DIR")
    old_lib = parent_lib(parent, "dp")
    wave, dirs = lcs_torch.WAVE_MAX_GRID, dp_torch.dp_dirs
    designs = {"old": (0, lambda *a, **kw: old_k2(old_lib, *a, **kw)),
               "new": (wave, dirs)}
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
        fams = {}
        for n in (1000, 10000):
            fams[n] = os.path.join(work, f"fam{n}.fa")
            with open(fams[n], "w") as f:
                f.write(chip_smoke.make_family(n, 300, 7))
        try:
            for rnd in range(rounds):
                for design in ("old", "new", "new", "old"):
                    for n in (1000, 10000):
                        lcs_torch.WAVE_MAX_GRID, dp_torch.dp_dirs = \
                            designs[design]
                        stats = os.path.join(work, "stats.txt")
                        kernels.reset_launches()
                        rc, secs = chip_smoke.run_cli(
                            ["-backend", "torch", "-device", "cuda",
                             "-stats", stats, fams[n],
                             os.path.join(work, "out.fa")], {})
                        if rc != 0:
                            raise AssertionError(f"e2e {design} n={n}: "
                                                 f"rc={rc}")
                        st = chip_smoke.read_stats(stats)
                        print(f"e2e round {rnd} {design} n={n}: {secs:.3f} "
                              f"s (tree {float(st['time.tree_build']):.3f}, "
                              f"alignment {float(st['time.alignment']):.3f},"
                              f" refinement "
                              f"{float(st['time.refinement']):.3f}); "
                              f"launches {dict(kernels.LAUNCHES)}; {smi}",
                              flush=True)
        finally:
            lcs_torch.WAVE_MAX_GRID, dp_torch.dp_dirs = wave, dirs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parts",
                    default="k1,k2,k3,k4,k6,k8,k1rows,wide,split,threads,"
                            "spans,k9,k7,e2e")
    ap.add_argument("--parent",
                    help="a tree with the old K1 rows, K2, K3, K4, K6, "
                         "K7, K8 and K9")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_redesign: no CUDA device", file=sys.stderr)
        return 1
    from famsa_tpu_torch import kernels
    kernels.build_all()
    smi = chip_smoke.nvidia_smi()
    parts = args.parts.split(",")
    if "k1" in parts:
        part_k1(args.reps, smi)
    if "k2" in parts:
        part_k2(args.parent, args.reps, smi)
    if "k3" in parts:
        part_k3(args.parent, args.reps, smi)
    if "wide" in parts:
        part_wide(args.parent, max(2, args.rounds), args.reps, smi)
    if "split" in parts:
        part_split(max(2, args.rounds), args.reps, smi)
    if "threads" in parts:
        part_threads(max(2, args.rounds), args.reps, smi)
    if "k4" in parts or "k6" in parts:
        part_k46(parts, args.parent, max(3, args.rounds),
                 max(10, args.reps // 10), smi)
    if "k8" in parts:
        part_k8(args.parent, max(3, args.rounds), args.reps, smi)
    if "k1rows" in parts:
        part_k1rows(args.parent, max(3, args.rounds), args.reps, smi)
    if "spans" in parts:
        part_spans(args.parent, max(2, args.rounds), args.reps, smi)
    if "k9" in parts:
        part_k9(args.parent, max(3, args.rounds), args.reps, smi)
    if "k7" in parts:
        part_k7(args.parent, max(3, args.rounds), args.reps, smi)
    if "e2e" in parts:
        part_e2e(args.parent, args.rounds, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
