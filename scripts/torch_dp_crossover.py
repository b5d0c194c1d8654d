#!/usr/bin/env python3
"""Where each profile-DP route wins on the merges of the main path: the
native host DP, kernel K2 (batched merges in one launch; at w2 <= 4095
its staged variant, one cluster of column folds a merge) and kernel K3
(one wide merge over up to 8 SMs).

    python3 scripts/torch_dp_crossover.py [--n 1000] [--wide-n 10000]
        [--reps 3] [--rounds 4] [--wide-rounds 2] [--e2e auto]

1. Records the main path's DP work through compute_msa (torch backend,
   the default knobs): chip_smoke.py's family (--n sequences of mean
   length 300, seed 7, refinement AUTO = on) and the wide family (--wide-n
   sequences, refinement AUTO = off).  Of the first it keeps the operands
   of every chunk of profile merges the scheduler took from its ready
   heap, and the operands and column mappings of every guided
   re-alignment; of the second its lone merges (ready alone) of at least
   2^20 cells, at most --max-wide of them.
2. Re-times those merges on the three routes, DP and traceback only (not
   the construct that follows): host = the native DP + traceback of each
   merge on a pool of min(cpus, 8) threads (the scheduler's host route);
   K2 = dp_profile_torch_batched in launches of up to 16 merges; K3 =
   dp_profile_torch_wide, one launch per merge, one after another; each
   device route + the native traceback.  Prints the three routes' summed
   ms per class of chunk size and band of cells per merge (the
   crossover), for the guided re-alignments and for the wide family's
   lone merges (these two timed one merge at a time, as they run); then
   each routing rule's summed ms over every recorded
   chunk and re-alignment, median of --reps.  A rule is the scheduler's
   and the aligner's own routing (core/aligner.py device_dp_ok,
   split_wide, wide_dp_ok) under one setting of FAMSA_TORCH_DP_MIN_CELLS,
   FAMSA_TORCH_WIDE_MIN_CELLS and WIDE_MAX_READY.
   On a CUDA device it first prints kernel-only times of K2 (both
   variants) and K3 on a few of those merges, K3 at several minimum fold
   widths.
3. End to end under the rules of --e2e ("auto": PR 1's routing, K2 only,
   and the two fastest rules of step 2 that use the device; "none"
   skips this step), in rounds
   that rotate their order: the --n family with refinement on (--rounds,
   alignment and refinement stage seconds) and the wide family's
   alignment stage (--wide-rounds).  Prints every run, the medians and
   how often each rule beat "K2 only" in the same round.

Needs a CUDA device; --device cpu rehearses it (plain PyTorch DP) at a
small --n and --wide-n.  Every line carries the card's name and power
limit."""

import argparse
import contextlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

MAX_BATCH = 16
NEVER = 1e30
BANDS = [0, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22,
         1 << 23, 1 << 62]
CLASSES = [(1, 1), (2, 3), (4, 7), (8, 15), (16, 1 << 30)]
# name: (FAMSA_TORCH_DP_MIN_CELLS, FAMSA_TORCH_WIDE_MIN_CELLS, WIDE_MAX_READY)
RULES = {
    "host only": (NEVER, NEVER, 4),
    "K2 only": (1 << 16, NEVER, 4),
    "K3 lone from 2^16": (1 << 16, 1 << 16, 2),
    "K3 lone from 2^20": (1 << 16, 1 << 20, 2),
    "K3 below 4 from 2^16": (1 << 16, 1 << 16, 4),
    "K3 below 4 from 2^18": (1 << 16, 1 << 18, 4),
    "K3 below 4 from 2^20": (1 << 16, 1 << 20, 4),
    "K3 below 8 from 2^16": (1 << 16, 1 << 16, 8),
    "K3 every device merge": (1 << 16, 1 << 16, MAX_BATCH + 1),
}
BASE = "K2 only"


class Operand:
    """What the DP routes read of a Profile."""

    def __init__(self, prof):
        if prof.counters is None:
            prof.calculate_counters_scores()
        self.counters = np.array(prof.counters)
        self.scores = np.array(prof.scores)
        self.width = prof.width
        self.data = range(len(prof.data))


def record(params, seqs):
    """Runs compute_msa once; returns (chunks [[(p1, p2)]], guided
    [(p1, p2, cm1, cm2)]) with operands in align_into's order."""
    import famsa_tpu_torch.core.refinement as refinement
    import famsa_tpu_torch.pipeline as pipeline
    from famsa_tpu_torch.core.aligner import order_operands
    chunks, guided = [], []
    orig_split, orig_align = pipeline.split_ready, refinement.align_into

    def split_ready(ready):
        chunks.append([tuple(map(Operand, order_operands(a, b)))
                       for _, a, b in ready])
        return orig_split(ready)

    def align_into(dest, a, b, cm1=None, cm2=None, backend="numpy"):
        if len(a.data) + len(b.data) > 2 and cm1 is not None:
            p1, p2 = order_operands(a, b)
            c1, c2 = (cm1, cm2) if p1 is a else (cm2, cm1)
            guided.append((Operand(p1), Operand(p2), list(c1), list(c2)))
        return orig_align(dest, a, b, cm1, cm2, backend=backend)

    pipeline.split_ready, refinement.align_into = split_ready, align_into
    try:
        pipeline.compute_msa(params, seqs)
    finally:
        pipeline.split_ready, refinement.align_into = orig_split, orig_align
    return [c for c in chunks if c], guided


@contextlib.contextmanager
def knobs(rule):
    """The routing knobs of one rule, for the duration of the block."""
    from famsa_tpu_torch.core import aligner
    dp_min, wide_min, max_ready = rule
    env = {"FAMSA_TORCH_DP_MIN_CELLS": repr(float(dp_min)),
           "FAMSA_TORCH_WIDE_MIN_CELLS": repr(float(wide_min))}
    old = {k: os.environ.get(k) for k in env}
    old_ready = aligner.WIDE_MAX_READY
    os.environ.update(env)
    aligner.WIDE_MAX_READY = max_ready
    try:
        yield
    finally:
        aligner.WIDE_MAX_READY = old_ready
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def route_chunk(merges):
    """(host, K2, K3) lists of one chunk under the knobs in force: the
    scheduler's split_ready (by cells) and split_wide."""
    from famsa_tpu_torch.core.aligner import device_dp_ok, split_wide
    device = [(k, *m) for k, m in enumerate(merges) if device_dp_ok(*m[:2])]
    host = [m for m in merges if not device_dp_ok(*m[:2])]
    wide, batched = split_wide(device, MAX_BATCH)
    return host, [m[1:] for m in batched], [m[1:] for m in wide]


def route_guided(m):
    """The route (0 host, 1 K2, 2 K3) of one guided re-alignment under the
    knobs in force: align_into's device_dp_ok, then _dp_torch's
    wide_dp_ok."""
    from famsa_tpu_torch.core.aligner import device_dp_ok, wide_dp_ok
    if not device_dp_ok(*m[:2]):
        return 0
    return 2 if wide_dp_ok(*m[:2]) else 1


def median_by_cells(merges):
    return sorted(merges, key=lambda m: m[0].width * m[1].width)[
        len(merges) // 2]


def kernel_times(params, smi, cases, fold_cols=(128, 256, 512)):
    """Kernel-only CUDA-event ms of K2 (the global variant, and the staged
    one where it takes the merge) and K3 on single recorded merges (guided
    ones with their band), K3 at several minimum fold widths."""
    import torch
    from chip_smoke import cuda_ms
    from famsa_tpu_torch.core.dp_native import row_ranges
    from famsa_tpu_torch.ops import dp_wide
    from famsa_tpu_torch.ops.dp_torch import (dp_dirs, k2_variant,
                                              launch_geometry, pack_batch,
                                              prepare_merge)
    for what, m in cases:
        band = row_ranges(params, m[2], m[3]) if len(m) > 2 else None
        colf, rowf, meta, total = pack_batch([prepare_merge(params, m[0],
                                                            m[1], band)])
        args = [torch.from_numpy(x).cuda() for x in (colf, rowf, meta)]
        k2 = {v: cuda_ms(lambda: dp_dirs(*args, total, variant=v), 5)
              for v in ("global", "staged")
              if v == "global" or k2_variant(m[1].width) == "staged"}
        msg = (f"kernel only, {what} ({m[0].width}x{m[1].width}): K2 global "
               f"{launch_geometry(colf.shape[2] - 1)} {k2['global']:.3f} ms, "
               f"K2 staged {k2.get('staged', float('nan')):.3f} ms")
        orig = dp_wide.MIN_FOLD_COLS
        try:
            for fc in fold_cols:
                dp_wide.MIN_FOLD_COLS = fc
                ms = cuda_ms(lambda: dp_wide.dp_dirs_wide(*args, total), 5)
                msg += (f"; K3 folds >= {fc} cols "
                        f"{dp_wide.fold_geometry(m[1].width)} {ms:.3f} ms")
        finally:
            dp_wide.MIN_FOLD_COLS = orig
        print(f"{msg} ({smi})", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--wide-n", type=int, default=10000)
    ap.add_argument("--max-wide", type=int, default=200)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--wide-rounds", type=int, default=2)
    ap.add_argument("--e2e", default="auto",
                    help='"auto", "none" or rule names joined by ","')
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import famsa_tpu_torch.pipeline as pipeline
    from chip_smoke import make_family
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.dp_native import (dp_profile, finish_path,
                                                row_ranges)
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.core.sequence import Sequence
    from famsa_tpu_torch.ops.dp_torch import dp_profile_torch_batched
    from famsa_tpu_torch.ops.dp_wide import dp_profile_torch_wide

    if args.device == "cuda":
        kernels.build_all()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    else:
        smi = "cpu rehearsal"

    def family(n):
        text = make_family(n, 300, 7)
        recs = [r.split("\n", 1) for r in text.split(">")[1:]]
        return [Sequence(">" + h, b.replace("\n", ""), k)
                for k, (h, b) in enumerate(recs)]

    def cells(m):
        return m[0].width * m[1].width

    params = Params(backend="torch", device=args.device)
    t0 = time.perf_counter()
    chunks, guided = record(params, family(args.n))
    print(f"recorded {sum(map(len, chunks))} profile merges in "
          f"{len(chunks)} chunks and {len(guided)} guided re-alignments of "
          f"the {args.n}-sequence family ({time.perf_counter() - t0:.2f} s; "
          f"{smi})", flush=True)
    t0 = time.perf_counter()
    wide_chunks, _ = record(Params(backend="torch", device=args.device),
                            family(args.wide_n))
    lone = [c[0] for c in wide_chunks if len(c) == 1 and cells(c[0]) >= 1 << 20]
    lone = lone[::max(1, -(-len(lone) // args.max_wide))]
    print(f"recorded {sum(map(len, wide_chunks))} profile merges of the "
          f"{args.wide_n}-sequence family; kept {len(lone)} lone merges of "
          f">= 2^20 cells ({time.perf_counter() - t0:.2f} s; {smi})",
          flush=True)

    pool = ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 8))

    def band(m):
        return row_ranges(params, m[2], m[3]) if len(m) > 2 else None

    def host(merges):
        futs = [pool.submit(dp_profile, params, *m) for m in merges]
        return [f.result() for f in futs]

    def k2(merges):
        out = []
        for k in range(0, len(merges), MAX_BATCH):
            part = merges[k:k + MAX_BATCH]
            res = dp_profile_torch_batched(params, [m[:2] for m in part],
                                           [band(m) for m in part])
            out += [finish_path(d, m[0].width, m[1].width, last)
                    for m, (d, last) in zip(part, res)]
        return out

    def k3(merges):
        out = []
        for m in merges:
            d, last = dp_profile_torch_wide(params, m[0], m[1], band(m))
            out.append(finish_path(d, m[0].width, m[1].width, last))
        return out

    routes = {"host": host, "K2": k2, "K3": k3}

    def ms(fn, merges):
        if not merges:
            return 0.0
        if args.device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn(merges)
        return (time.perf_counter() - t) * 1e3

    def best_ms(fn, merges):
        return min(ms(fn, merges) for _ in range(args.reps))

    if args.device == "cuda":
        kernel_times(params, smi, [
            ("guided, median cells", median_by_cells(guided)),
            ("share 1, largest", max((c[0] for c in chunks if len(c) == 1),
                                     key=cells)),
            (f"{args.wide_n}-family lone, median cells",
             median_by_cells(lone)),
            (f"{args.wide_n}-family lone, largest", max(lone, key=cells))])

    # the three routes give the same paths and totals on every merge
    for merges in chunks + [guided, lone]:
        res = [fn(merges) for fn in routes.values()]
        for rh, r2, r3 in zip(*res):
            for r in (r2, r3):
                if rh.total != r.total or not np.array_equal(rh.path, r.path):
                    raise AssertionError("DP routes differ")

    def report(what, groups):
        table = {}
        for key, merges in groups:
            for lo, hi in zip(BANDS, BANDS[1:]):
                part = [m for m in merges if lo <= cells(m) < hi]
                if part:
                    row = table.setdefault((key, lo), [[], 0.0, 0.0, 0.0])
                    row[0] += part
                    for k, fn in enumerate(routes.values()):
                        row[1 + k] += best_ms(fn, part)
        for (key, lo), (part, h, d2, d3) in sorted(table.items()):
            win = min(zip((h, d2, d3), routes))[1]
            w1 = statistics.median(m[0].width for m in part)
            w2 = statistics.median(m[1].width for m in part)
            print(f"{what} {key} cells/merge >= {lo}: {len(part)} merges "
                  f"(median w1 {w1}, w2 {w2}), host {h:.3f} ms, K2 "
                  f"{d2:.3f} ms, K3 {d3:.3f} ms ({win} wins; {smi})",
                  flush=True)

    # crossover by chunk-size class and band of cells per merge; K3 runs a
    # chunk's merges one after another, K2 in one launch
    groups = []
    for merges in chunks:
        share = min(len(merges), MAX_BATCH)
        cls = next(c for c in CLASSES if c[0] <= share <= c[1])
        groups.append((f"{cls[0]}-{min(cls[1], MAX_BATCH)}", merges))
    report("share", groups)
    # guided re-alignments and lone merges run one at a time
    report("guided", [("", [m]) for m in guided])
    report(f"{args.wide_n}-family lone", [("", [m]) for m in lone])

    # routing rules over the whole recorded run
    totals = {name: [] for name in RULES}
    for rep in range(args.reps):
        for name in rotated(list(RULES), rep):
            with knobs(RULES[name]):
                t_align = 0.0
                for merges in chunks:
                    for fn, part in zip(routes.values(), route_chunk(merges)):
                        t_align += ms(fn, part)
                t_guided = sum(ms(list(routes.values())[route_guided(m)],
                                  [m]) for m in guided)
            totals[name].append((t_align, t_guided))
    summary = {}
    for name, runs in totals.items():
        a = statistics.median(r[0] for r in runs)
        g = statistics.median(r[1] for r in runs)
        summary[name] = [round(a, 3), round(g, 3)]
        print(f"rule {name} {RULES[name]}: alignment merges {a:.3f} ms, "
              f"guided re-alignments {g:.3f} ms (median of {args.reps}; "
              f"{smi})", flush=True)
    pool.shutdown()

    # end to end, after one warm-up run
    if args.e2e == "none":
        print(json.dumps({"device": smi, "rules_ms": summary}))
        return 0
    if args.e2e == "auto":
        ranked = sorted((sum(v), k) for k, v in summary.items()
                        if k not in ("host only", BASE))
        e2e = [BASE] + [k for _, k in ranked[:2]]
    else:
        e2e = args.e2e.split(",")
    print(f"end-to-end rules: {e2e}", flush=True)

    def rounds(n, n_rounds, stages):
        secs = {name: [] for name in e2e}
        want = None
        for r in range(-1, n_rounds):
            for name in (rotated(e2e, r) if r >= 0 else e2e[:1]):
                with knobs(RULES[name]):
                    res = pipeline.compute_msa(
                        Params(backend="torch", device=args.device),
                        family(n))
                got = [gs.decode() for gs in res.alignment]
                if want is None:
                    want = got
                if got != want:
                    raise AssertionError("alignments differ between rules")
                if r >= 0:
                    st = res.statistics._stats
                    secs[name].append(tuple(st[s] for s in stages))
        ref = [sum(v) for v in secs[BASE]]
        for name, v in secs.items():
            tot = [sum(x) for x in v]
            wins = sum(a < b for a, b in zip(tot, ref))
            meds = ", ".join(f"{s} {statistics.median(x[k] for x in v):.3f}"
                             for k, s in enumerate(stages))
            print(f"{n} seqs, rule {name}: median {meds} s; sum faster than "
                  f"{BASE} in {wins} of {len(v)} rounds; runs "
                  f"{' '.join('+'.join(f'{y:.3f}' for y in x) for x in v)} "
                  f"({smi})", flush=True)
        return secs

    main_secs = rounds(args.n, args.rounds,
                       ("time.alignment", "time.refinement"))
    wide_secs = rounds(args.wide_n, args.wide_rounds, ("time.alignment",))
    print(json.dumps({"device": smi, "rules_ms": summary,
                      "main_s": main_secs, "wide_s": wide_secs}))
    return 0


def rotated(names, k):
    k %= len(names)
    return names[k:] + names[:k]


if __name__ == "__main__":
    sys.exit(main())
