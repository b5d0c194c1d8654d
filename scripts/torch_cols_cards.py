#!/usr/bin/env python3
"""Phase 5c's profile-profile merge (chip_smoke.py:make_profiles, 1500 x
40,000 columns) on the column-sharded route across the cards of one
host, against K2 spans on one card.

    python3 scripts/torch_cols_cards.py [--meshes 1,2@0,2,4]
        [--rounds 3] [--shape 1500x40000] [--device cuda]

Mesh 1 is one card's route on cuda:0 (ops/dp_torch.py:
dp_profile_torch_paths_async: K5, K2 spans, K4); mesh k is
parallel/dp_sharded.py:dp_profile_sharded_paths on cuda:0 .. cuda:k-1,
one shard a card (K10's edges from one card into the next by peer
access), and k@0 is k shards on cuda:0.  The meshes run in turns,
--rounds rounds, the order reversed every second round.  For each run:
the merge's ms on the host clock, every card synchronized before and
after (K5, the slices' copies, K10, the gather, K4, the path on the
host), and each K10 launch's CUDA-event ms on its shard's stream; the
path and total equal to mesh 1's, or the script fails.  Prints every
card's name and power limit.  Needs as many CUDA devices as the widest
mesh.  --device cpu runs the same steps on shards of the CPU (the
kernels' plain versions) at a small --shape, a check of the script.
"""

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def sync_all():
    import torch
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def card(device, k):
    return device if device == "cpu" else f"{device}:{k}"


def profiles(params, w1, w2):
    """chip_smoke.py's phase 5c profiles at widths w1 x w2, in
    align_into's operand order."""
    import chip_smoke
    from famsa_tpu_torch.core.aligner import order_operands
    from famsa_tpu_torch.core.profile import Profile
    from famsa_tpu_torch.core.sequence import encode_gapped
    chip_smoke.PROFPROF = (w1, w2)
    profs, k = [], 0
    for text in chip_smoke.make_profiles():
        prof = Profile(params)
        for row in chip_smoke.fasta_strings(text):
            prof.append_raw_sequence(encode_gapped(f">p{k}", row, k))
            k += 1
        prof.calculate_counters_scores()
        profs.append(prof)
    return order_operands(*profs)


def run(params, a, b, spec, device, launches):
    """One merge on mesh `spec`; returns (PathResult, host ms)."""
    from famsa_tpu_torch.ops.dp_torch import dp_profile_torch_paths_async
    from famsa_tpu_torch.parallel import dp_sharded, mesh
    if spec == "1":
        fn = lambda: dp_profile_torch_paths_async(  # noqa: E731
            params, [(a, b)]).resolve()[0]
    else:
        k, _, at = spec.partition("@")
        devices = ([card(device, at)] * int(k) if at
                   else [card(device, d) for d in range(int(k))])
        m = mesh.make_mesh(devices)
        fn = lambda: dp_sharded.dp_profile_sharded_paths(  # noqa: E731
            params, a, b, m)
    launches.clear()
    sync_all()
    t0 = time.perf_counter()
    res = fn()
    sync_all()
    return res, (time.perf_counter() - t0) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1,2@0,2,4")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--shape", default="1500x40000")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.parallel import dp_sharded
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        print(f"build {kernels.build_all():.1f} s", flush=True)
    w1, w2 = (int(x) for x in args.shape.split("x"))
    meshes = args.meshes.split(",")
    params = Params(device=args.device)     # the lead: the current card, 0
    params.adjust(16)
    a, b = profiles(params, w1, w2)
    launches = []
    orig = dp_sharded.dp_shard

    def timed(table):
        if table.device.type != "cuda":
            return orig(table)
        with torch.cuda.device(table.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            orig(table)
            end.record()
        launches.append((table.device, start, end))

    dp_sharded.dp_shard = timed
    want, times, k10 = None, {}, {}
    for r in range(args.rounds + 1):        # round 0 warms every mesh up
        for spec in (meshes if r % 2 else meshes[::-1]):
            res, ms = run(params, a, b, spec, args.device, launches)
            if want is None:
                want = run(params, a, b, "1", args.device, [])[0]
            if res.total != want.total or list(res.path) != list(want.path):
                raise AssertionError(f"mesh {spec}: the path differs from "
                                     "one card's")
            if r:
                times.setdefault(spec, []).append(ms)
                k10.setdefault(spec, []).append(
                    [f"{d}: {s.elapsed_time(e):.3f}" for d, s, e in launches])
    print(f"the {w1}x{w2} merge, host ms with every card synchronized "
          f"({args.rounds} rounds in turns; mesh 1: K2 spans on one card, "
          f"k: k cards, k@0: k shards on card 0); the path equal to mesh "
          f"1's everywhere", flush=True)
    for spec in meshes:
        print(f"  mesh {spec}: " + " / ".join(f"{t:.3f}" for t in
                                               times[spec]), flush=True)
        if spec != "1":
            print(f"    K10 launches (device: event ms): {k10[spec]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
