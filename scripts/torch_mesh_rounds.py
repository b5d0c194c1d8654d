#!/usr/bin/env python3
"""The sharded guide tree (famsa_tpu_torch/parallel/) against one card's
route, on the cards of one host: chip_smoke.py's seeded families
(make_family), sorted and deduplicated as the CLI builds its tree.

    python3 scripts/torch_mesh_rounds.py [--sizes 10000x600,30000x600]
        [--meshes 1,2,4] [--rounds 256] [--device cuda]

Mesh 1 is one card's route (ops/prim_torch.py:mst_prim_tree_torch on
cuda:0); mesh k > 1 is mst_prim_tree_sharded on cuda:0 .. cuda:k-1, one
shard a card (k@0: k shards on cuda:0; ks: k cards with every shard's
copies from and to the lead on the lead's current stream, Shard.link
off, which serializes the shards).  For each family and mesh: the
tree's seconds (every card synchronized before and after), the tree
equal to one card's route's or the script fails; then the host's ms a
round to issue --rounds rounds (after the first --rounds) against their
ms a round to the last card's end.  A small family first builds the
kernels and starts every card.  Needs as many CUDA devices as the
largest mesh; prints every card's name and power limit.  --device cpu
runs the same steps on shards of the CPU (the kernels' plain versions),
a check of the script at a small size.
"""

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def sync_all():
    import torch
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def card(device, k):
    return device if device == "cpu" else f"{device}:{k}"


def make_mesh(spec, device):
    from famsa_tpu_torch.parallel import mesh
    if "@" in spec:
        k, d = spec.split("@")
        return mesh.make_mesh([card(device, d)] * int(k))
    m = mesh.make_mesh([card(device, d) for d in range(int(spec.rstrip("s")))])
    if spec.endswith("s"):
        for shard in m.shards:
            shard.link = None
    return m


def build_tree(seqs, spec, device):
    from famsa_tpu_torch.ops.prim_torch import mst_prim_tree_torch
    from famsa_tpu_torch.parallel.dist_sharded import mst_prim_tree_sharded
    tree = []
    sync_all()
    t0 = time.perf_counter()
    if spec == "1":
        mst_prim_tree_torch(seqs, tree, device=card(device, 0))
    else:
        mst_prim_tree_sharded(seqs, tree, make_mesh(spec, device))
    sync_all()
    return tree, time.perf_counter() - t0


def round_split(seqs, spec, rounds, device):
    """(host ms a round, ms a round to the last card's end) of `rounds`
    rounds issued after the first `rounds`."""
    import torch
    from famsa_tpu_torch.ops.lcs_torch import BV32, pad_sequences
    from famsa_tpu_torch.ops.prim_torch import (PrimState, prim_chunk,
                                                prim_inputs)
    from famsa_tpu_torch.parallel import mesh
    padded = pad_sequences(seqs, align=BV32)
    lengths = np.array([s.length for s in seqs], dtype=np.int64)
    if spec == "1":
        table, queries, lens, pow_tab = prim_inputs(padded, lengths,
                                                    card(device, 0))
        state = PrimState(queries)

        def run():
            prim_chunk(table, queries, lens, pow_tab, state, rounds)
    else:
        m = make_mesh(spec, device)
        prim = mesh.PrimShards(m, padded, lengths)
        edges = torch.empty((3, rounds), dtype=torch.int64,
                            device=m.lead.device)

        def issue():
            for slot in range(rounds):
                mesh.prim_round_sharded(prim, edges, slot)

        def run():
            with m.lead.use():
                issue()
    run()
    sync_all()
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    sync_all()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / rounds, (t2 - t0) * 1e3 / rounds


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="10000x600,30000x600")
    ap.add_argument("--meshes", default="1,2,4")
    ap.add_argument("--rounds", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    import chip_smoke
    dev = args.device
    if dev == "cuda":
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        for k, line in enumerate(smi.splitlines()):
            print(f"cuda:{k}: {line}", flush=True)
    meshes = args.meshes.split(",")
    warm = chip_smoke.cli_sequences(chip_smoke.fasta_strings(
        chip_smoke.make_family(200, 100, args.seed)))
    for spec in meshes:
        build_tree(warm, spec, dev)
    for size in args.sizes.split(","):
        n, mean_len = (int(x) for x in size.split("x"))
        t0 = time.perf_counter()
        seqs = chip_smoke.cli_sequences(chip_smoke.fasta_strings(
            chip_smoke.make_family(n, mean_len, args.seed)))
        print(f"family {size} seed {args.seed}: {len(seqs)} sequences "
              f"after dedup ({time.perf_counter() - t0:.1f} s to make)",
              flush=True)
        want = None
        for spec in meshes:
            tree, secs = build_tree(seqs, spec, dev)
            if want is None:
                want = tree
            elif tree != want:
                sys.exit(f"{size} mesh {spec}: the tree differs from one "
                         "card's route's")
            host, end = round_split(seqs, spec, args.rounds, dev)
            print(f"{size} mesh {spec}: tree {secs:.3f} s; {args.rounds} "
                  f"rounds: host {host:.4f} ms a round, device end "
                  f"{end:.4f} ms a round", flush=True)
    print("ok", flush=True)


if __name__ == "__main__":
    main()
