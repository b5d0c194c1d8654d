#!/usr/bin/env python3
"""The guide-tree stage (the device MST-Prim) of two trees of
famsa_tpu_torch on one card: a parent tree (unpacked with `git archive`
into a git-ignored directory) against this one, on chip_smoke.py's seeded
families through the CLI entry point (-gt_export).

    python3 scripts/torch_prim_rounds.py --parent DIR [--rounds 3]
        [--parts split,profile,e2e] [--sizes 1000,10000,wide600]

Families: 1000 (1000 sequences of mean length 300, seed 7; phase 4's),
10000 (10,000 x 300, seed 7; phase 6's) and wide600 (10,000 x 600, seed
7; phase 6b's).

split    One run per tree and family with the tree stage's steps wrapped
         in torch.cuda.synchronize() and a host clock: padding
         (pad_sequences), the query mask table (build_query_mask_table),
         the rounds (prim_rounds), the dendrogram (_mst_to_dendrogram) and
         the rest of mst_prim_tree_torch (the uploads and the pow table,
         and the edge list loop), beside the stage's seconds (-stats
         time.tree_build).
profile  One window of 64 rounds, after the first 256, of each tree under
         torch.profiler: the device operations a round and their device
         ms a round, and the host's ms a round (the host clock between the
         window's first and last round's LCS call, no wait in between).
e2e      Alternating rounds, parent, this tree, this tree, parent, of
         the plain runs: the CLI's seconds and the tree stage's, and the
         trees' bytes (equal across trees, or the script fails).

Every child process imports the package from its tree and runs one small
family first, so that no measured run pays for the card's start-up.
Needs a CUDA device; every line carries the card's name and power limit.
"""

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAMILIES = {"1000": (1000, 300, 7), "10000": (10000, 300, 7),
            "wide600": (10000, 600, 7)}
WINDOW = (256, 64)              # rounds before the profiled window, rounds


def nvidia_smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def wrap_split(pt, times):
    """Wrap the tree stage's steps in prim_torch's namespace (both trees
    call them through it) with a synchronised host clock."""
    import torch

    def timed(name, label):
        orig = getattr(pt, name)

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + time.perf_counter() - t0
            return out
        setattr(pt, name, run)
    for name, label in (("pad_sequences", "pad"),
                        ("build_query_mask_table", "mask table"),
                        ("prim_rounds", "rounds"),
                        ("_mst_to_dendrogram", "dendrogram"),
                        ("mst_prim_tree_torch", "tree")):
        timed(name, label)


def wrap_profile(pt):
    """Profile rounds WINDOW[0] .. WINDOW[0] + WINDOW[1] of a tree:
    prim_torch.lcs_rows is called once at the start of every round.
    Returns start(rec): count the next tree's rounds from 0, its window's
    numbers into rec."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    orig = pt.lcs_rows
    state = {}
    skip, k = WINDOW

    def lcs_rows(*a, **kw):
        r = state["round"]
        state["round"] += 1
        if r == skip:
            torch.cuda.synchronize()
            state["prof"] = profile(activities=[ProfilerActivity.CUDA])
            state["prof"].__enter__()
            state["t0"] = time.perf_counter()
        if r == skip + k:
            host = time.perf_counter() - state["t0"]
            torch.cuda.synchronize()
            prof = state["prof"]
            prof.__exit__(None, None, None)
            ops = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            names = {}
            for e in ops:
                short = e.name.replace("(anonymous namespace)::", "")
                short = short.split("(")[0].split("<")[0].strip()
                names[short] = names.get(short, 0) + 1
            state["rec"]["profile"] = {
                "rounds": k, "device_ops_a_round": len(ops) / k,
                "device_ms_a_round": sum(e.time_range.elapsed_us()
                                         for e in ops) / 1e3 / k,
                "host_ms_a_round": host * 1e3 / k,
                "ops_by_name": names}
        return orig(*a, **kw)
    pt.lcs_rows = lcs_rows

    def start(rec):
        state.update(round=0, rec=rec)
    return start


def child(tree, mode, sizes, work):
    """Runs in a process of its own on `tree`'s package; prints one JSON
    line per family."""
    sys.path.insert(0, str(tree))
    import chip_smoke
    import famsa_tpu_torch.ops.prim_torch as pt
    from famsa_tpu_torch import kernels
    assert pathlib.Path(kernels.__file__).resolve().is_relative_to(
        pathlib.Path(tree).resolve()), kernels.__file__
    kernels.build_all()

    def run(name, fam):
        fa = os.path.join(work, f"prim{name}.fa")
        if not os.path.exists(fa):
            with open(fa + ".tmp", "w") as f:
                f.write(chip_smoke.make_family(*fam))
            os.replace(fa + ".tmp", fa)
        out = os.path.join(work, f"{os.getpid()}_{name}.dnd")
        stats = os.path.join(work, f"{os.getpid()}_{name}.txt")
        kernels.reset_launches()
        rc, secs = chip_smoke.run_cli(["-backend", "torch", "-device", "cuda",
                                       "-gt_export", "-stats", stats, fa,
                                       out], {})
        st = chip_smoke.read_stats(stats)
        with open(out, "rb") as f:
            tree_bytes = f.read()
        return {"rc": rc, "seconds": secs,
                "tree_s": float(st["time.tree_build"]),
                "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                "tree_bytes": len(tree_bytes),
                "tree_sha1": hashlib.sha1(tree_bytes).hexdigest()}

    run("warm", (50, 100, 3))
    times = {}
    if mode == "split":
        wrap_split(pt, times)
    elif mode == "profile":
        start = wrap_profile(pt)
    for name in sizes:
        times.clear()
        rec = {}
        if mode == "profile":
            start(rec)
        rec.update(run(name, FAMILIES[name]))
        if mode == "split":
            rec["split"] = dict(times)
        rec["family"] = name
        print("RESULT " + json.dumps(rec), flush=True)


def run_child(tree, mode, sizes, work):
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "torch_prim_rounds.py"),
                           "--child", str(tree), "--mode", mode, "--sizes",
                           ",".join(sizes), "--work", work],
                          capture_output=True, text=True, cwd=str(tree))
    out = [json.loads(line[7:]) for line in proc.stdout.splitlines()
           if line.startswith("RESULT ")]
    if proc.returncode != 0 or len(out) != len(sizes):
        raise RuntimeError(f"{tree} {mode}: rc {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parts", default="split,profile,e2e")
    ap.add_argument("--sizes", default="1000,10000,wide600")
    ap.add_argument("--child")
    ap.add_argument("--mode")
    ap.add_argument("--work")
    args = ap.parse_args()
    sizes = args.sizes.split(",")
    if args.child:
        child(args.child, args.mode, sizes, args.work)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_prim_rounds: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    trees = {"parent": pathlib.Path(args.parent).resolve(), "change": ROOT}
    parts = args.parts.split(",")
    with tempfile.TemporaryDirectory(prefix=".smoke_prim_", dir=ROOT) as work:
        for mode in ("split", "profile"):
            if mode not in parts:
                continue
            for name in ("parent", "change"):
                for rec in run_child(trees[name], mode, sizes, work):
                    if mode == "split":
                        t = rec["split"]
                        t["rest"] = t["tree"] - sum(
                            t.get(k, 0.0) for k in ("pad", "mask table",
                                                    "rounds", "dendrogram"))
                    print(f"[{smi}] {mode} {name} {rec['family']}: tree "
                          f"{rec['tree_s']:.4f} s, CLI {rec['seconds']:.4f} "
                          f"s; {json.dumps(rec.get(mode))}; launches "
                          f"{rec['launches']}", flush=True)
        if "e2e" in parts:
            hashes = {}
            for r in range(args.rounds):
                for name in ("parent", "change", "change", "parent"):
                    for rec in run_child(trees[name], "e2e", sizes, work):
                        fam = rec["family"]
                        hashes.setdefault(fam, set()).add(
                            (rec["tree_sha1"], rec["rc"]))
                        print(f"[{smi}] e2e round {r} {name} {fam}: tree "
                              f"{rec['tree_s']:.4f} s, CLI "
                              f"{rec['seconds']:.4f} s, {rec['tree_bytes']} "
                              f"bytes; launches {rec['launches']}",
                              flush=True)
            for fam, seen in hashes.items():
                if len(seen) != 1:
                    raise AssertionError(f"{fam}: the trees differ: {seen}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
