#!/usr/bin/env python3
"""Old against new designs of K1, K2, K3, K4 and K6 on one card, in
alternating order.

    python3 scripts/torch_kernel_redesign.py [--reps 200] [--rounds 2]
        [--parts k1,k2,k3,k4,k6,e2e] [--parent .parent]

The old designs of K1, K2 and K3 are still in the port: K1's rows
variant (one thread a query, ops/lcs_torch.py variant="rows"), K2's
global variant (one CTA a merge, ops/dp_torch.py variant="global") and
K3's L2 variant (its first design, ops/dp_wide.py variant="l2"); the new
ones are K1's wave variant and K2's and K3's staged variants.  K4's and
K6's old designs live only in an earlier tree: parts k4 and k6 build that
tree's csrc/traceback.cu and csrc/merged.cu (--parent: a directory with
the tree unpacked, e.g. `git archive <commit> | tar -x -C .parent`) into
libraries of their own under DIR/_build.

k1   Kernel-only CUDA-event times of one MST-Prim round, the first
     reference of chip_smoke.py's 1000- and 10,000-sequence families
     (seed 7, mean length 300, padded to 32 as ops/prim_torch.py pads)
     against all sequences, rows, wave, wave, rows; then the dispatch
     crossover: both variants for R = 1..256 references against each
     family, with the rows grid R x ceil(n / 128) beside them.
k2   Kernel-only times of K2, global, staged, staged, global: a lone
     2048x2048 merge (random profiles of 12 and 9 sequences, as
     chip_smoke.py phase 3), and the largest batch of 16 merges (by
     cells) that the 1000- and the 10,000-sequence default runs launch,
     replayed from the inputs kept during the run; with the bound of each.
     Then the staged launch of those batches three ways, in turns: as the
     port runs it, with every fold 512 columns wide (the fewest folds and
     CTAs a cluster), and split into one launch per merge fold count;
     with the clusters that fit on the card at once.
k3   Kernel-only times of one merge at the main path's shapes (random
     profiles of 50 sequences, 20 % gaps), l2, staged, staged, l2; then
     the staged variant at rows-per-step BLK 8, 16 and 32 and minimum
     fold widths of 128 and 256 columns.
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
e2e  The 1000-sequence default run (refinement on) and the 10,000-
     sequence run (the wide route) through the CLI entry point, old
     designs forced (WAVE_MAX_GRID 0, STAGED_MAX_W2 -1, which sends K2 to
     its global variant and K3 to its L2 one) and new, in
     --rounds rounds of old, new, new, old: stage seconds and launches
     per kernel variant.

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

    for n in (1000, 10000):
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


def part_k2(reps, smi):
    import torch
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops.dp_torch import dp_dirs, pack_batch, prepare_merge
    from famsa_tpu_torch.ops.dp_wide import staged_geometry
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
            t[v].append(chip_smoke.cuda_ms(
                lambda: dp_dirs(*args, variant=v), reps))
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
          f"{lib.dp_staged_max_clusters(folds, fw, dp_wide.BLK)} clusters "
          f"fit) {t['port']} ms; folds of 512 ({wide_geo[0]} folds; "
          f"{lib.dp_staged_max_clusters(wide_geo[0], wide_geo[1], dp_wide.BLK)}"
          f" fit) {t['wide']} ms; one launch per fold count "
          f"({len(parts)} launches) {t['split']} ms; {smi}", flush=True)


def part_k3(reps, smi):
    import torch
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops import dp_wide
    from famsa_tpu_torch.ops.dp_torch import pack_batch, prepare_merge
    rng = np.random.default_rng(31)
    params = Params(device="cuda")
    params.adjust(1000)
    reps = max(3, reps // 20)
    for w1, w2 in K3_SHAPES:
        p1 = chip_smoke.random_profile(rng, params, 50, w1)
        p2 = chip_smoke.random_profile(rng, params, 50, w2)
        colf, rowf, meta, total = pack_batch([prepare_merge(params, p1, p2)])
        args = [torch.from_numpy(x).cuda() for x in (colf, rowf, meta)]
        t = {v: [] for v in ("l2", "staged")}
        for v in ("l2", "staged", "staged", "l2"):
            t[v].append(chip_smoke.cuda_ms(
                lambda: dp_wide.dp_dirs_wide(*args, total, variant=v), reps))
        per_row = {v: [x / w1 * 1e3 for x in t[v]] for v in t}
        print(f"k3 {w1}x{w2} {dp_wide.fold_geometry(w2)}: l2 {t['l2']} ms, "
              f"staged {t['staged']} ms; us per row l2 {per_row['l2']} "
              f"staged {per_row['staged']}; {smi}", flush=True)
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
    kernels._configure(name, lib)
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


def part_e2e(rounds, smi):
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_wide, lcs_torch
    designs = {"old": (0, -1),
               "new": (lcs_torch.WAVE_MAX_GRID, dp_wide.STAGED_MAX_W2)}
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
        fams = {}
        for n in (1000, 10000):
            fams[n] = os.path.join(work, f"fam{n}.fa")
            with open(fams[n], "w") as f:
                f.write(chip_smoke.make_family(n, 300, 7))
        for rnd in range(rounds):
            for design in ("old", "new", "new", "old"):
                for n in (1000, 10000):
                    lcs_torch.WAVE_MAX_GRID, dp_wide.STAGED_MAX_W2 = \
                        designs[design]
                    stats = os.path.join(work, "stats.txt")
                    kernels.reset_launches()
                    rc, secs = chip_smoke.run_cli(
                        ["-backend", "torch", "-device", "cuda", "-stats",
                         stats, fams[n], os.path.join(work, "out.fa")], {})
                    if rc != 0:
                        raise AssertionError(f"e2e {design} n={n}: rc={rc}")
                    st = chip_smoke.read_stats(stats)
                    print(f"e2e round {rnd} {design} n={n}: {secs:.3f} s "
                          f"(tree {float(st['time.tree_build']):.3f}, "
                          f"alignment {float(st['time.alignment']):.3f}, "
                          f"refinement {float(st['time.refinement']):.3f}); "
                          f"launches {dict(kernels.LAUNCHES)}; {smi}",
                          flush=True)
        lcs_torch.WAVE_MAX_GRID, dp_wide.STAGED_MAX_W2 = designs["new"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parts", default="k1,k2,k3,k4,k6,e2e")
    ap.add_argument("--parent", help="a tree with the old K4 and K6")
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
        part_k2(args.reps, smi)
    if "k3" in parts:
        part_k3(args.reps, smi)
    if "k4" in parts or "k6" in parts:
        part_k46(parts, args.parent, max(3, args.rounds),
                 max(10, args.reps // 10), smi)
    if "e2e" in parts:
        part_e2e(args.rounds, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
