#!/usr/bin/env python3
"""The device DP route of two trees of famsa_tpu_torch on one card: a
parent tree (unpacked with `git archive` into a git-ignored directory)
against this one, on chip_smoke.py's seeded 1000- and 10,000-sequence
families (mean length 300, seed 7), through the CLI entry point.

    python3 scripts/torch_resident_rounds.py --parent DIR [--rounds 1]
        [--parts split,e2e] [--sizes 1000,10000]

split  One run per tree and family with every step of a device merge
       wrapped in torch.cuda.synchronize() and a host clock: the host
       seconds of the alignment stage per device merge, split into the
       steps the tree has (host-prep route: prepare_merge, pack_batch,
       the copies, K2/K3, the native traceback; resident route: side
       assembly or the one upload of the side descriptors, stage 0
       (torch ops or K5), K2/K3, K4, merged counters (torch ops or K6),
       the wait in resolve), and construct.  The synchronisation serialises what the
       resident route overlaps, so these are costs, not the stage time.
       Also the bytes each route copies: direction bytes and planes for
       the host-prep route (from the kernels' arguments), kernels.TRAFFIC
       for the resident one.
e2e    Alternating rounds, parent, this tree, this tree, parent, of the
       plain runs (nothing wrapped): stage seconds and kernel launches.

Every run is a subprocess of its own that imports the package from its
tree.  Needs a CUDA device; every block of lines carries the card's name
and power limit.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (module, attribute, label) of the steps the split times, where the tree
# has them
STEPS = [
    ("famsa_tpu_torch.ops.dp_pack", "prepare_merge", "prep"),
    ("famsa_tpu_torch.ops.dp_pack", "pack_batch", "pack"),
    ("famsa_tpu_torch.ops.dp_torch", "dp_profile_torch_batched",
     "host-prep call"),
    ("famsa_tpu_torch.ops.dp_torch", "dp_dirs", "K2"),
    ("famsa_tpu_torch.ops.dp_wide", "dp_dirs_wide", "K3"),
    ("famsa_tpu_torch.pipeline", "finish_path", "native traceback"),
    ("famsa_tpu_torch.ops.dp_resident", "assemble_side", "sides"),
    ("famsa_tpu_torch.ops.dp_resident", "upload_launch", "sides"),
    ("famsa_tpu_torch.ops.dp_resident", "stage0", "stage 0"),
    ("famsa_tpu_torch.ops.dp_resident", "trace_paths", "K4"),
    ("famsa_tpu_torch.ops.dp_resident", "merged_counters", "merged"),
    ("famsa_tpu_torch.ops.dp_resident", "merged_from_paths", "merged"),
    ("famsa_tpu_torch.ops.dp_resident", "PendingPaths.resolve", "resolve"),
    ("famsa_tpu_torch.ops.dp_torch", "dp_profile_torch_paths_async",
     "dispatch"),
    ("famsa_tpu_torch.ops.dp_wide", "dp_profile_torch_wide_paths_async",
     "dispatch"),
    ("famsa_tpu_torch.pipeline", "construct_profile", "construct"),
]


def nvidia_smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def child(tree, n, mode, work):
    """One run in this process on `tree`'s package; prints one JSON line."""
    sys.path.insert(0, str(tree))
    import importlib
    import importlib.util

    import torch

    import chip_smoke
    from famsa_tpu_torch import kernels
    assert pathlib.Path(kernels.__file__).resolve().is_relative_to(
        pathlib.Path(tree).resolve()), kernels.__file__
    kernels.build_all()
    fa = os.path.join(work, f"fam{n}.fa")
    if not os.path.exists(fa):
        with open(fa, "w") as f:
            f.write(chip_smoke.make_family(n, 300, 7))
    times, calls, moved = {}, {}, {"dense_down": 0, "planes_up": 0}

    def wrap(mod, attr, label):
        *owner, attr = attr.split(".")
        for part in owner:
            mod = getattr(mod, part)
        orig = getattr(mod, attr)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + time.perf_counter() - t0
            calls[label] = calls.get(label, 0) + 1
            if label in ("K2", "K3") and not hasattr(kernels, "TRAFFIC"):
                moved["dense_down"] += int(a[3])
                moved["planes_up"] += a[0].nbytes + a[1].nbytes
            return out
        setattr(mod, attr, timed)

    if mode == "split":
        for name, attr, label in STEPS:
            if importlib.util.find_spec(name) is None:
                continue                 # a module this tree does not have
            mod = importlib.import_module(name)
            if hasattr(mod, attr.split(".")[0]):
                wrap(mod, attr, label)
    out = os.path.join(work, f"out{n}.fa")
    stats = os.path.join(work, f"stats{n}.txt")
    kernels.reset_launches()
    rc, secs = chip_smoke.run_cli(["-backend", "torch", "-device", "cuda",
                                   "-stats", stats, fa, out], {})
    st = chip_smoke.read_stats(stats)
    rec = {"rc": rc, "seconds": secs,
           "stages": {k: float(st[f"time.{k}"])
                      for k in ("tree_build", "alignment", "refinement")},
           "launches": dict(kernels.LAUNCHES)}
    if hasattr(kernels, "TRAFFIC"):
        rec["traffic"] = dict(kernels.TRAFFIC)
    else:
        rec["traffic"] = moved
    if mode == "split":
        rec["times"], rec["calls"] = times, calls
    with open(out, "rb") as f:
        rec["bytes_out"] = len(f.read())
    print("RESULT " + json.dumps(rec), flush=True)


def run_child(tree, n, mode, work):
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "torch_resident_rounds.py"),
                           "--child", str(tree), "--n", str(n), "--mode",
                           mode, "--work", work],
                          capture_output=True, text=True, cwd=str(tree))
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[7:])
    raise RuntimeError(f"{tree} n={n} {mode}: rc {proc.returncode}\n"
                       f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")


def split_line(name, n, rec):
    """Per device merge: the host seconds of each step."""
    la = rec["launches"]
    # K3 calls; a parent tree may count its first design as dp_wide_l2
    merges = sum(la.get(k, 0) for k in ("dp_wide", "dp_wide16",
                                        "dp_wide_stripes", "dp_wide_l2"))
    calls = rec["calls"]
    parts = []
    for label, t in sorted(rec["times"].items(), key=lambda x: -x[1]):
        parts.append(f"{label} {t:.3f} s / {calls[label]} calls")
    return (f"{name} n={n}: alignment {rec['stages']['alignment']:.3f} s, "
            f"refinement {rec['stages']['refinement']:.3f} s (synchronised "
            f"split); " + ", ".join(parts) + f"; K3 calls {merges}, "
            f"K2 launches {la.get('dp_staged', 0) + la.get('dp', 0)}, K4 "
            f"launches {la.get('traceback', 0)}; traffic {rec['traffic']}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", default="split,e2e")
    ap.add_argument("--sizes", default="1000,10000")
    ap.add_argument("--child")
    ap.add_argument("--n", type=int)
    ap.add_argument("--mode")
    ap.add_argument("--work")
    args = ap.parse_args()
    if args.child:
        child(args.child, args.n, args.mode, args.work)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_resident_rounds: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    trees = {"parent": pathlib.Path(args.parent).resolve(), "change": ROOT}
    sizes = [int(x) for x in args.sizes.split(",")]
    parts = args.parts.split(",")
    with tempfile.TemporaryDirectory(prefix=".smoke_rounds_", dir=ROOT) as work:
        if "split" in parts:
            for n in sizes:
                for name in ("parent", "change"):
                    rec = run_child(trees[name], n, "split", work)
                    print(f"[{smi}] split {split_line(name, n, rec)}",
                          flush=True)
        if "e2e" in parts:
            for r in range(args.rounds):
                for n in sizes:
                    outs = set()
                    for name in ("parent", "change", "change", "parent"):
                        rec = run_child(trees[name], n, "stages", work)
                        outs.add(rec["bytes_out"])
                        s = rec["stages"]
                        print(f"[{smi}] e2e round {r} n={n} {name}: "
                              f"{rec['seconds']:.3f} s (tree "
                              f"{s['tree_build']:.3f}, alignment "
                              f"{s['alignment']:.3f}, refinement "
                              f"{s['refinement']:.3f}); launches "
                              f"{rec['launches']}; traffic "
                              f"{rec['traffic']}", flush=True)
                    if len(outs) != 1:
                        raise AssertionError(f"n={n}: outputs differ in size")
    return 0


if __name__ == "__main__":
    sys.exit(main())
