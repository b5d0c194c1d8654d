#!/usr/bin/env python3
"""Chip smoke test of the famsa_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any mismatch or exception exits non-zero):
 1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
    print the build seconds and the card's name and power limit; write
    phases 4-8's inputs, build phases 6's and 6b's guide trees with
    -backend torch (-gt_export) and start every -backend numpy reference
    run of phases 4-8 but phase 7's as child processes at the lowest CPU
    priority, REF_WIDTH (4) at a time, phase 4's and then the longest
    first, so that they run beside phases 2-3c
    (start_references; each phase waits for its own);
 2. K1 (csrc/lcs.cu) against its plain PyTorch version on the card,
    bit-exact, each variant: rows on 256 refs x 4096 queries of mean
    length 300 (W=10) and 256 x 10,000 of mean length 346 (the -dist
    and heuristics' blocks), a case with W >= 40, a triangular n_queries
    case, W > 64 and 37 refs x 300 queries at W = 16, 17, 64 and 65 (the
    edges of the rows variant's P template); wave on 1 ref x 1000 and x
    10,000 queries, W = 1, 11, 16, 17, 32, 33, 64 and 70 (2 refs x 257
    queries: a partial last segment; no-op symbols throughout) and a
    triangular n_queries of 333 that ends inside a warp; both variants
    on 40 queries with runs of 33-130 equal residues (the exact carry).
    K9 (csrc/lcs.cu:lcs_refmask, FAMSA's layout and carry for flagged
    references) against lcs_refmask_plain, bit-exact: the flagged
    references of phase 5b's poly-Q family against all its sequences
    (int32 and uint16 out, a triangular n_queries), an unflagged short
    reference, references past 32 words (wpl 2 of the word wavefront),
    the wavefront's geometry edges (REFMASK_EDGE_W64: W64 = 1, 2, 3, 5,
    17, 32, 33 and 65, queries of mixed lengths padded with no-op
    symbols, uint16 at every second), and inside Prim rounds from round 0
    (after K1 wave: the row equals the plain version's for a flagged
    reference and K1 wave's for an unflagged one, which K9 leaves); a
    profiled chunk of the poly-Q family's rounds (exactly K1 wave, K9, K8
    a round) and K9's times (a flagged round also in a CUDA graph, with
    its bound).
    K8 (csrc/prim.cu, a Prim round after its
    LCS) against prim_round_plain, bit-exact on every state tensor (cur,
    dist, tieb, active, the next reference row) and edge, 64 consecutive
    rounds a case, each round's K1 wave row feeding both: the trees of
    phase 4's, 6's and 6b's families as the CLI builds them (1000 x 300,
    10,000 x 300, 10,000 x 600), from round 0 and from round n/2, the
    10,000 x 300 tree from round 0 on every cluster size forced (1, 2, 4,
    8, 16 CTAs), families of n on each side of the shape rule's threshold
    (2048 and 2049 sequences; the rule's cluster size read from the
    library too), and 257
    sequences, 100 sequences three times each (the tie keys decide) and
    two groups on disjoint alphabets (lcs == 0).  The main path's
    families hold no flagged sequence (so their rounds launch no K9).
    At each family's round
    shape: K8's ms from a launch loop and a launch's device ms in a CUDA
    graph (at its rule's cluster size and at each size forced), its bound
    and plain ms, and K1 wave's ms and bound; one chunk
    of 64 rounds of the 1000 and the 10,000 families under torch.profiler
    and set_sync_debug_mode("error"): exactly K1 wave then K8 a round,
    their device ms a round, and unprofiled the host's ms a round to
    enqueue the chunk against its ms a round to the device's end;
 3. K2 against its plain PyTorch versions on the card, bit-exact in
    direction bytes, finals, last, path and total, and path/total against
    the native host DP.  Staged variant (csrc/dp_wide.cu:
    dp_profile_batched_staged, one cluster of column folds a merge; held
    against dp_plain and its fold walk dp_staged_plain, which runs on host
    copies of the inputs on one CPU thread, as every fold walk of the
    smoke does, ~3x faster there than on the card): 8 mixed merges
    <= 512^2 (one seq-prof), one banded merge, one merge with cardinality
    > 2^16, 60x700, 60x1500, 16 merges of 1 to 8 folds (one at w2 4095),
    w2 on a fold edge and one column past it, 2^22-scaled scores, one
    2048x2048 prof-prof; on 9-16 folds a batch whose widest merge is
    5906.  Stripes variant (dp_profile_batched_stripes, held as staged): a
    batch with one merge past 4095 and one past 8191, a banded batch
    (60 x 9000 split), 2^22-scaled at w2 8500.  Spans variant
    (dp_profile_batched_spans, w2 32768-131071, up to 4 clusters of 16
    folds a merge; phase_k2_spans): against its fold walk and dp_plain
    at w1 6 x w2 32768, 65536 and 131071, plain and banded, and a mixed
    batch of three, with the host DP, K5, K4 and K6; against dp_plain at
    SPANS_LONE (500 x 40,000, 500 x 100,000, 300 x 131,071) and
    SPANS_BATCH (300 x 33,000 / 70,000 / 131,071), each plain and banded
    along the diagonal, with its ms and bound.  Prints the staged ms at
    2048^2, on the 16-merge batch and on the batches past 4095, how many
    clusters of F =
    1..16 staged folds and of 16 stripes folds fit on the card at once
    (cudaOccupancyMaxActiveClusters; fails if one fits nowhere) and the
    columns a stripes fold keeps in shared memory.  On every batch: K5
    (csrc/stage0.cu, stage 0, reading the sides through their
    descriptors) against its plain twin stage0_plain on the same
    descriptors and against the host prep (prepare_merge + pack_batch),
    in every int64; K4 (csrc/traceback.cu) on the kernel's direction
    bytes against its plain version (every output byte) and the native
    trace_path; and K6 (csrc/merged.cu, the merged counters) on K4's
    output as it lies against its plain twin, every int32;
 3b. K3 (csrc/dp_wide.cu) against its plain PyTorch version (the fold
    wavefront) and K2's, bit-exact in direction bytes, finals, last, path
    and total, and path/total against the native host DP.  Staged
    variant: 1, 2 and 8 folds, w2 on a fold edge and one column past it,
    seq-prof, a 400x4000 prof-prof, the widest 8-fold merge (w2 4095), a
    banded merge, cardinality > 2^16, 2^22-scaled scores; on 9-16 folds
    lone merges at w2 4096 (seq-prof) and 8191 and 2^22-scaled at 6000;
    stripes variant: lone merges at 8192 (seq-prof), 14,000 and 16,256, a
    banded 60 x 9000 split (against K2's plain version), 2^22-scaled and
    cardinality > 2^16 at 9000; the limits (w1 16384 x w2 16256, w2
    32767) against K2 and the host DP; a 3564x1334
    prof-prof and a lone 300x3850 (the 10,000-sequence family's wide
    merges) against K2; K5, K4 and K6 on every merge, as in phase 3;
 3c. K4 and K6 at their kernels' edges (phase_edges): at each of
    EDGE_WIDTHS, a batch of 41 merges whose direction bytes are made from
    chosen paths (k4_edge_paths, path_matrix): widths at the window's
    rows and columns and at the whole-matrix limit, H, V and D runs of
    31, 32 and 33 cells ending beside, on and past the first window's
    edges, an all-H top row and an all-V first column; and 11 merges at
    K6's tile edges (k6_edge_paths: lengths T - 1, T, T + 1, 2T + 1, runs
    straddling or starting on a tile boundary).  K4 bit-exact against its
    plain twin and the native trace_path, K6 against its plain twin with
    a tile of rows past the longest path;
 4. the main path: a seeded 1000-sequence family of mean length 300
    through the CLI entry point (refinement AUTO = on) with -backend torch
    at the default knobs, with every profile merge and guided
    re-alignment forced on K2, then on K3; every torch output must equal
    its -backend numpy child's byte for byte, and each run
    must launch the kernel variants it is meant to exercise (n - 1 Prim
    rounds for its n sequences, each one K1 wave and one K8 launch, every
    K2 launch whose widest w2 is <= 4095 on K2 staged, every K3 call at
    w2 <= 4095 on K3 staged).  The device DP
    route (ops/dp_resident.py) is held to ResidencyWatch in every torch
    run: one K5 and one K4 launch per K2 launch and K3 call, one K6
    launch per dispatch that asks for merged counters, at most
    sum(w1 + w2 + 17) bytes copied down, exactly the sides a device merge
    produced read resident, and no host read of a device tensor inside
    a dispatch (each dispatch runs under torch.cuda.set_sync_debug_mode
    ("error")); in the 1000-sequence runs every device merge's resident
    counters equal the host counters construct made.  Per run: the
    route's bytes up and down, its resident, leaf and uploaded sides and
    the peak device memory.  In the forced-K2 and forced-K3 runs, four
    dispatches each (after the first ten) run under torch.profiler: the
    device operations (kernels, copies, fills) a dispatch, with their
    names;
 5. the guide tree: -gt_export on a seeded 2000-sequence family, torch
    against numpy, with a Prim chunk small enough to cross chunk
    boundaries (n - 1 K1 wave and K8 launches), and under -dist
    indel_div_lcs (K1's rows variant);
 5b. the poly-Q family (POLYQ_FAMILY: 500 sequences of mean length 300,
    every 10th with a poly-Q tract of 64-200 residues) with -backend
    torch, refinement off: aligned (K1 wave, K9 and K8 once a Prim
    round), -gt_export and -dist_export (K1 for unflagged references, K9
    for flagged ones), each byte-identical to a -backend numpy child;
 5c. profile-profile mode on a 1500 x 40,000-column merge (PROFPROF,
    make_profiles), refinement off: one K2 launch on its spans variant
    (B = 1; K3 refuses the width), byte-identical to a -backend numpy
    child;
 5d. the row axis of multi-device sharding (famsa_tpu_torch/parallel/)
    on meshes of MESH_SIZES (4 and 3) shards on cuda:0, each on its own
    stream (phase_mesh): auto_mesh gives no mesh on one card; with a mesh
    set in its cache, the CLI's -gt_export of phase 5's 2000 sequences
    (a Prim chunk of 300) and of phase 5b's poly-Q family (K9 on every
    shard), each byte-identical to the numpy output its phase wrote, with
    S x (n - 1) K1 wave (and K9) launches and n - 1 K8; the poly-Q
    family's -dist_export (against 5b's numpy child) and -gt upgma
    -gt_export (against a numpy child) through ShardedDistanceBackend; the
    sharded trees' seconds beside one card's route's, and the host's ms
    a round to issue 256 rounds against their ms to the device's end (on
    one card: the route's overhead, not a multi-GPU speed);
 5e. the column axis of multi-device sharding (parallel/dp_sharded.py,
    K10 csrc/dp_wide.cu:dp_profile_shard, one persistent launch a shard)
    on meshes of shards on cuda:0, each on its own stream (phase_cols):
    auto_mesh gives no "cols" mesh on one card; K10 against the (shard,
    block) pipeline of its plain version dp_shard_plain on host shards
    and against dp_plain (every direction byte and final) at COLS_K10:
    300 x 26,001 on 3 uneven slices (the stripes body) and 200 x 3000 on
    4 (the staged body, 3 folds a slice; the plain version on the
    kernel's folds), unguided and banded, blocks that do not divide w1,
    one launch a shard; the stripes case banded with its launches issued
    in reverse pipeline order; the ticket rule on COLS_MANY (40 x
    124,799 on 32 slices of 3900 columns, more than the card holds
    clusters of at once) in pipeline and reverse order, both ending,
    equal to dp_plain; with a "cols" mesh set, phase 5c's merge through
    the CLI on 2 and 3 shards (S K10 launches, one K5, one K4, no other
    DP launch), byte-identical to 5c's numpy child; the merge in turns
    against K2 spans on one device (spans, 2, 3, 3, 2, spans: host ms of
    the merge, K2 spans' and K10's device ms, the same path), K10 held at
    the 2-shard merge's slice 0 against dp_shard_plain; and the poly-Q
    family with refinement on (its default) on 3 shards at a threshold
    that shards progressive merges and guided re-alignments,
    byte-identical to its numpy child, 3 K10 launches a sharded merge;
 5f. sequences past 65,536 residues (phase_long): K1 wave at W 2049 and
    8192 (a segment across warps; the masks staged and read from global
    memory) against lcs_wave_plain and K9 at W64 1025 and 4096 against
    lcs_refmask_wave_plain on host copies, bit-exact, K9 also in a Prim
    round; a 65,537-residue query across warps against it as a reference
    through one warp's segment; the LONG_FAMILY family with one
    65,537-residue sequence (make_long; cut from 200 sequences, see
    LONG_FAMILY) with -backend torch: aligned at its defaults
    (refinement on), -gt_export and -dist_export, each byte-identical to a
    -backend numpy child, every K1 launch on the wave variant, K9
    launched; K1 wave's and K9's ms at the long sequence as the
    reference against the family;
 6. the wide path: a seeded 10,000-sequence family of mean length 300
    (refinement AUTO = off) with -backend torch at the default knobs,
    against -backend numpy on the guide tree the torch -gt_export wrote;
    byte-identical, and K1 wave, K8, K2 staged, K3 staged, K4, K5 and K6
    launched as in phase 4, the route held to ResidencyWatch as there (the
    numpy run a child process started in phase 1).  Prints the stage
    seconds and the profile merges per route (host / K2 / K3);
 6b. the wide family past 4095 columns (WIDE_FAMILY: 10,000 sequences of
    mean length 600, seed 7, an alignment of 5906 columns) the same way,
    its numpy reference (-gt import of the torch tree) a child process
    started in phase 1; every DP launch on the variant its width selects, the
    staged body on 9-16 folds launched at least once and K2's spans
    variant never.  Prints the stage seconds, the merges per route, the
    device merges past 4095 columns on K3 and in K2 batches, and the DP
    launches per variant with their CUDA-event totals and means;
 7. the chain route (ops/dp_chain.py): K7 (csrc/chain.cu, the chain's
    carry, csrc/chain.cuh, as a launch of its own) against
    chain_carry_plain on every case of its state (a step that ran, an
    overflow, a poisoned chain, an invalid lane, a failed walk, the fold
    after the last step; both slots of the double-buffered state), every
    word; one chunk's CUDA-graph replay (per step K5, whose chain entry
    runs the carry, the DP, K4, K6; K7 once after the last step) against
    the plain chunk on host buffers of the same content at a staged
    capacity of 8 and of 9-16 folds (6 and 4 leaves, the other lanes of
    32 invalid), with an overflow forced mid-chunk, and at the buckets
    8191 (16 staged folds) and 16256 (the stripes body; 2 leaves) with DP
    folds past the chain's width left dead: both state slots, recorded
    widths, both carry buffers, every step's header and descriptors (the
    carry K5's chain entry ran) and every path of a step that ran, its
    launches counted (one K7 a replay), no host read; then a
    family of 1700 variants of one 800-residue protein (make_variants,
    seed 5: its guide tree is one caterpillar) through the
    CLI entry point with -backend torch at the default knobs (host merges
    below 1536 columns, then chunks), with FAMSA_TORCH_CHAIN_MIN_W2=0
    (every merge on chunks) and with FAMSA_TORCH_CHAIN=0 (one resident
    dispatch a merge, on the torch tree read back through -gt import),
    each byte-identical to -backend numpy on the torch tree; the chain
    counters (one run, prefix + chain merges = the
    run, one replay a chunk, one K7 launch a replay and a capture's
    warm-up; the all-chain run's saved chunk replayed against the plain
    chunk, headers and descriptors too), every chunk under set_sync_debug_mode
    ("error"), the device operations of one chunk (torch.profiler), the
    replays' CUDA-event times, one chunk's replay against its launch loop
    and by kernel, ms a merge by chain width on the chain and on the host
    route, and the alignment seconds of the all-chain and the per-merge
    run (one each, for the record);
 8. the guide-tree methods and the distance export (TREE_RUNS) through
    the CLI entry point, -backend torch against -backend numpy byte for
    byte (the numpy runs child processes started in phase 1, every one
    ended before the torch runs, whose seconds are then the host's alone):
    -gt slink, upgma and upgma_modified with -gt_export on phase 5's 2000
    sequences, -gt nj -gt_export on phase 4's 1000, -gt upgma aligned
    (refinement on) on the 1000, -dist_export, -dist_export -pid and
    -dist_export -square_matrix on the 2000, -medoidtree and -parttree
    with -gt_export on phase 6's 10,000 at the default medoid parameters
    (threshold 2000, subtree 100, sample 2000), and -medoidtree aligned on
    3000 sequences (seed 13).  Each torch run launches exactly the K1
    variants listed (every block of the prefix sweeps and of the square
    export, 256 references against 257 to 2000 queries, and the
    heuristics' first row of 256 x 10,000 and CLARANS sample blocks go to
    rows; the heuristics' small subgroup sets to wave), its
    largest launch of each variant is held bit-exact against lcs_plain
    and timed, and a tree run leaves no device memory allocated; the two
    alignments are held to ResidencyWatch and their K2/K3 calls to the
    staged variants as in phase 4.  Prints per run the tree and total
    seconds of torch and numpy, K1's launches, CUDA-event total and mean
    ms, its largest launch's ms and bound, and the peak device memory
    (with what the recorder held of it).
Then a JSON line with every kernel variant's numbers, the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}.

Every kernel launch of the 1000-sequence default run, the -dist tree
run, the 10,000-sequence runs (phases 6 and 6b) and phase 8's runs is timed with CUDA events
recorded around its C entry point on the launch stream; the JSON line
gives each variant's launches, total ms and mean ms per run ("runs").  "ms" is a
CUDA-event mean over repeated launches on the largest input the runs
gave the variant, after it is held bit-exact against its plain version
there (the DP variants against dp_plain, the row-serial plain version of
the same function; phases 3 and 3b hold them against their fold walks
too), and "plain_ms" that plain version's time; "launches" counts its launches in the run named by
"launches_run" (the 1000-sequence default run; K1 rows: the -dist run;
K9: phase 5b's alignment, whose Prim rounds launch it once each, most
returning at once, and it is held and timed on the largest call of
phase 5b's -dist_export run; the DP variants past 4095 columns: phase
6b's run; K2 spans: phase 5c's profile-profile run).  A variant that no
main-path run launched has launches 0 and is measured where "at" says:
K3's and K2's stripes bodies (no family
that fits the smoke reaches 8192 columns) on phase 3b's lone 100 x
14,000 merge and phase 3's batch with merges past 4095 and 8191; K2's
staged body on 9-16 folds, if phase 6b launched none, on phase 3's batch
of widest w2 5906.  The variants that share an entry point with another
(the staged bodies on 9-16 folds) carry "[9-16 folds]" in their name.
bound_ms is the larger of the bytes the call must move over 3.35 TB/s
and the int32 instructions its arithmetic needs over the SM's issue
rate of 128 lanes a clock (33.5e12/s: the data sheet's 67 TFLOP/s
float32 rate counts an FMA as two operations on 128 lanes per SM).  That
rate is reached only with both integer pipes busy, the ALU pipe (adds,
compares, selects, logic) and the FMA pipe (integer multiply-adds), 64
lanes each, so the bound is a floor.  K4's bound counts bytes alone
(a direction byte a step, finals and meta, the output): its walk is a
chain of dependent loads, bound by their latency, so its line also
gives ns a step.  K4's and K6's entries also give "graph_ms", the C
entry's device time a launch from 20 launches captured in one CUDA graph
(a launch loop from Python floors a short kernel at the host's launch
rate), and "slowest": the same numbers on the inputs of the launch that
took longest in the 10,000-sequence run ("launch_ms", its time there).
K9's bound counts a 64-bit word update (~12 int32 instructions) per
reference word and live query position, against the rows read once.
K5's and K6's bound is the larger of their bytes
(each side's counter rows or symbol bytes read once, the path bytes, the
outputs written once) and the int64 multiply-adds and adds their rows
need (K5: 32 lanes a row times its nonzero amino-acid counts plus one;
K6: a row of 32 adds a parent's advance).  K7's bound counts the ~260
bytes it reads and writes; its "ms" is a launch's device time from 100
launches captured in one CUDA graph, at the fold after a chunk's last
step, the one launch a replay makes (a launch loop from Python, its
"launch_loop_ms", measures the host's launch rate).  Its entry's
"graph" holds the chain's chunks: replays, their CUDA-event total and
mean in the all-chain run, one chunk's replay and launch-loop ms and
bound (the DP's work on its steps), and the checked chunks' replay
against plain ms.  K8's entry comes from phase 2: "ms" is a launch's
device time from 20 launches captured in one CUDA graph at round n/2
of the 10,000 x 600 family ("launch_loop_ms" from a Python loop, beside
K1 wave's ms and bound there, and the profiled chunks); its bound
counts bytes (an active vertex's lcs, length, dist and tieb, the pow
entry of one with lcs > 0, the writes of the vertices it updates, the
reference row read and written); its launches and totals are the
recorded runs'.  K10's entry comes from phase 5e: "ms" is the device
time of phase 5c's merge on 2 shards, from its first launch's start to
its last launch's end (the faster of two rounds; "spans_ms" K2 spans'
on the same merge in the same turns), held on 2 and 3 shards against
K2 spans, every byte, and at slice 0 against dp_shard_plain; its launches and totals are the 2-shard CLI run's
("cols"); its bound is the whole merge's (dp_bound_ms, the spans'
work) and its edges'.  K1 wave's and K9's entries carry "seg" from
phase 5f: their ms and bound at the long family's largest call (the
65,537-residue reference against the family, a segment across warps;
K1's bound counts each query's own words, lcs_bound_ms) and their plain
twins' ms at 5f's checks.  No kernel has a single
PyTorch call computing the same function, so library_ms is null.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
AA = "ARNDCQEGHILKMFPSTWYV"
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def log(msg):
    """One line of output, after the seconds since the smoke started."""
    print(f"[{time.perf_counter() - T0:.0f} s] {msg}", flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, n=20, reps=10):
    """Device milliseconds a call of fn() (one or more kernel launches on
    the current stream, no host read): n calls captured in one CUDA graph
    and replayed, so that the host's launch rate does not floor a short
    kernel's time as it does in cuda_ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(n):
            fn()
        graph.capture_end()
    cur.wait_stream(side)
    return cuda_ms(graph.replay, reps) / n


def on_host(fn, *args, **kw):
    """fn on host copies of its tensor arguments, on one CPU thread: the
    fold walks (the plain versions of K2's fold-walking variants, K3, K10
    and a chain chunk) are chains of small operations, ~3x faster there
    than as launches on the card, and threads slow them."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args), **kw)
    finally:
        torch.set_num_threads(threads)


def wall_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def make_family(n, mean_len, seed):
    """Seeded synthetic protein family (the generator of
    scripts/make_family.py): point mutations and indels along a random
    tree from one root.  Returns FASTA text."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 20, size=mean_len)]
    while len(seqs) < n:
        child = seqs[rng.integers(0, len(seqs))].copy()
        k = max(1, int(len(child) * rng.uniform(0.05, 0.15)))
        pos = rng.integers(0, len(child), size=k)
        child[pos] = rng.integers(0, 20, size=k)
        if rng.random() < 0.5 and len(child) > 30:
            p = rng.integers(0, len(child) - 10)
            ln = int(rng.integers(1, 10))
            if rng.random() < 0.5:
                child = np.delete(child, slice(p, p + ln))
            else:
                child = np.insert(child, p, rng.integers(0, 20, size=ln))
        seqs.append(child)
    lines = []
    for i, s in enumerate(seqs):
        txt = "".join(AA[c] for c in s)
        lines.append(f">synth_{i}")
        lines.extend(txt[p:p + 60] for p in range(0, len(txt), 60))
    return "\n".join(lines) + "\n"


def make_variants(n, root_len, seed, indel_rate):
    """FASTA text of n variants of one protein (a mutant library, or a
    virus's within-host samples): sequence 0 is a random root of root_len
    residues; each other one copies it, mutates max(1, floor(r L))
    positions at a rate r ~ U(0.01, 0.25), then applies Poisson
    (indel_rate) indels of 1-8 residues, half insertions, half
    deletions.  Each variant is nearest the root, so the MST is a star and
    the guide tree one caterpillar run."""
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


# ----------------------------------------------------------------------
# K1
def lcs_case(n_refs, n_queries, mean_len, seed, device):
    """(table, syms) for random sequences of lengths around mean_len."""
    import torch
    from famsa_tpu_torch.ops.lcs_torch import PAD_SYMBOL, build_query_mask_table
    rng = np.random.default_rng(seed)
    lens = rng.integers(mean_len - 20, mean_len + 21, size=n_queries)
    lmax = int(lens.max())
    padded = np.full((n_queries, lmax), PAD_SYMBOL, dtype=np.int8)
    for k, ln in enumerate(lens):
        # mostly amino acids, some codes >= 20 (no-ops)
        padded[k, :ln] = rng.choice(24, size=ln, p=[0.049] * 20 + [0.005] * 4)
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    syms = torch.from_numpy(padded[:n_refs].astype(np.int32))
    return table.to(device), syms.to(device)


def lcs_case_w(n_refs, n_queries, w, seed, device, ref_len=None):
    """(table, syms) with exactly w mask words: query lengths in
    (32 (w - 1), 32 w], the first one 32 w long, some codes >= 20; the
    references are the first n_refs queries, cut to ref_len positions."""
    import torch
    from famsa_tpu_torch.ops.lcs_torch import PAD_SYMBOL, build_query_mask_table
    rng = np.random.default_rng(seed)
    lens = rng.integers(32 * (w - 1) + 1, 32 * w + 1, size=n_queries)
    lens[0] = 32 * w
    padded = np.full((n_queries, 32 * w), PAD_SYMBOL, dtype=np.int8)
    for k, ln in enumerate(lens):
        padded[k, :ln] = rng.choice(24, size=ln, p=[0.049] * 20 + [0.005] * 4)
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    syms = torch.from_numpy(padded[:n_refs, :ref_len].astype(np.int32))
    return table.to(device), syms.contiguous().to(device)


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the larger of nbytes over the memory
    rate and ops int32 instructions over the issue rate."""
    t_b, t_o = nbytes / MEM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations"


def lcs_bound_ms(table, syms, n_queries):
    """K1's bound: a 32-bit word update (and, two adds, compare, subtract,
    or) per live reference position and word of a query, each query up to
    its last word that holds a residue (a shorter query's padded words add
    nothing to its LCS), against the reference's symbols' masks in those
    words, the references and the output (int32 at L >= 65536) read or
    written once."""
    import torch
    _, w, n = table.shape
    r, length = syms.shape
    s = syms.cpu()
    live = int((s < 20).sum())                    # no-op symbols are skipped
    held = (table[:, :, :n_queries] != 0).any(dim=0).cpu()
    words = int((held * torch.arange(1, w + 1)[:, None]).amax(dim=0).sum())
    planes = len(torch.unique(s[s < 20]))
    out = 4 if length >= 65536 else 2
    return bound(4 * planes * words + 4 * syms.numel()
                 + out * r * n_queries, 6 * live * words)


def refmask_bound_ms(refs, queries, n_queries):
    """K9's bound: a 64-bit word update (and, two adds, compare, subtract,
    or; ~12 int32 instructions) per reference word and live query
    position, against the rows read once and the output written once."""
    r, lr = refs.shape
    live = int(((queries[:n_queries] >= 0) & (queries[:n_queries] < 20))
               .sum())
    ops = 12 * live * r * -(-lr // 64)
    return bound(4 * refs.numel() + 4 * n_queries * queries.shape[1]
                 + 4 * r * n_queries, ops)


def lcs_check(table, syms, q, variant, what):
    """K1's `variant` against lcs_plain, bit for bit, on the first q
    queries; the launch must have gone to that variant."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.lcs_torch import lcs_plain, lcs_rows
    key = "lcs_wave" if variant == "wave" else "lcs"
    before = kernels.LAUNCHES[key]
    got = lcs_rows(table, syms, n_queries=q, variant=variant)
    want = lcs_plain(table, syms, q)
    if table.is_cuda:
        torch.cuda.synchronize()
        if kernels.LAUNCHES[key] != before + 1:
            raise AssertionError(f"K1 {what}: {variant} variant not "
                                 "launched")
    if not torch.equal(got[:, :q], want[:, :q]):
        bad = (got[:, :q] != want[:, :q]).nonzero()[:5].tolist()
        raise AssertionError(f"K1 {variant} {what}: mismatch at {bad}")


def lcs_runs_case(device):
    """(table, syms) whose queries hold runs of 33-130 equal residues from
    a word's start: the words where the exact carry and the test V2 < V
    differ (a word of V all ones, covered by the mask, a carry in)."""
    import torch
    from famsa_tpu_torch.ops.lcs_torch import PAD_SYMBOL, build_query_mask_table
    rng = np.random.default_rng(3)
    padded = np.full((40, 192), PAD_SYMBOL, dtype=np.int8)
    for k in range(40):
        ln = int(rng.integers(100, 193))
        padded[k, :ln] = rng.integers(0, 20, size=ln)
        run = int(rng.integers(33, min(131, ln + 1)))
        start = 32 * int(rng.integers(0, (ln - run) // 32 + 1))
        padded[k, start:start + run] = k % 3
    table = torch.from_numpy(build_query_mask_table(padded).view(np.int32))
    syms = torch.from_numpy(padded.astype(np.int32))
    return table.to(device), syms.to(device)


# the rows variant's P-by-W template edges (ops/lcs_torch.py:rows_geometry)
ROWS_EDGE_WS = (16, 17, 64, 65)


def phase_k1(device="cuda", big=(256, 4096, 300), wide=(16, 512, 1300),
             tri=(64, 1000, 120), local=(4, 256, 2600),
             huge=(256, 10000, 346)):
    import torch
    from famsa_tpu_torch.ops.lcs_torch import (lcs_plain, lcs_rows,
                                               rows_geometry, wave_geometry)
    out = {}
    # the rows variant (many references)
    for name, (r, n, ln), nq in (("main", big, None), ("wide", wide, None),
                                 ("tri", tri, tri[1] // 3),
                                 ("local", local, None),
                                 ("huge", huge, None)):
        table, syms = lcs_case(r, n, ln, 100 + ln, device)
        if name == "local":
            # W > 64 (the local-memory state); short refs keep the plain
            # version's position loop affordable
            syms = syms[:, :300].contiguous()
        q = n if nq is None else nq
        lcs_check(table, syms, q, "rows", name)
        out[name] = (table, syms, q)
    edges = []
    for w in ROWS_EDGE_WS:
        # 37 references: CTAs of 16 or 32 references, the last partial
        table, syms = lcs_case_w(37, 300, w, 60 + w, device, ref_len=150)
        lcs_check(table, syms, 300, "rows", f"W={w}")
        edges.append(f"W={w} {rows_geometry(w)}")
    table, syms = lcs_runs_case(device)
    for variant in ("rows", "wave"):
        lcs_check(table, syms, 40, variant, "runs of equal residues")
    msg = (f"phase 2 K1 rows: bit-exact vs plain on {big[0]}x{big[1]} "
           f"(W={out['main'][0].shape[1]}), {huge[0]}x{huge[1]} "
           f"(W={out['huge'][0].shape[1]}, L={out['huge'][1].shape[1]}), "
           f"{wide[0]}x{wide[1]} "
           f"(W={out['wide'][0].shape[1]}), triangular n_queries="
           f"{out['tri'][2]}, {local[0]}x{local[1]} "
           f"(W={out['local'][0].shape[1]}), the P template's edges "
           f"{', '.join(edges)} (cap, P, refs a CTA, staged; 37 refs x 300 "
           f"queries each), and (rows and wave) 40 queries with runs of "
           f"33-130 equal residues")
    # the wave variant (few references): the Prim round's shapes, every
    # lane layout, a partial last segment (257 queries), no-op symbols,
    # and a triangular n_queries ending inside a warp
    waves = []
    for r, n, ln in ((1, 1000, 300), (1, 10000, 300)):
        table, syms = lcs_case(r, n, ln, 7 + n, device)
        lcs_check(table, syms, n, "wave", f"{r}x{n}")
        waves.append(f"{r}x{n} (W={table.shape[1]})")
    for w in (1, 11, 16, 17, 32, 33, 64, 70):
        table, syms = lcs_case_w(2, 257, w, 40 + w, device,
                                 ref_len=None if w <= 32 else 120)
        lcs_check(table, syms, 257, "wave", f"W={w}")
        waves.append(f"W={w} {wave_geometry(w)}")
    table, syms = lcs_case_w(3, 1000, 11, 5, device)
    lcs_check(table, syms, 333, "wave", "triangular")
    msg += (f"; K1 wave: bit-exact vs plain on {', '.join(waves)} "
            f"(wseg, wpl, lanes), 2 refs x 257 queries each, triangular "
            f"n_queries=333 of 1000 at W=11")
    if device == "cuda":
        for name in ("main", "huge"):
            table, syms, q = out[name]
            ms = cuda_ms(lambda: lcs_rows(table, syms, n_queries=q,
                                          out_dtype=torch.uint16,
                                          variant="rows"), 10)
            pms = wall_ms(lambda: lcs_plain(table, syms, q))
            bms, _ = lcs_bound_ms(table, syms, q)
            pairs = syms.shape[0] * q
            msg += (f"; rows {syms.shape[0]}x{q} (L={syms.shape[1]}): "
                    f"kernel {ms:.3f} ms ({pairs / ms * 1e3:.4g} pairs/s), "
                    f"plain {pms:.1f} ms, bound {bms:.4f} ms")
    log(msg)


# ----------------------------------------------------------------------
# K8
K8_ROUNDS = 64              # consecutive rounds each check holds
STATE = ("cur", "dist", "tieb", "active", "ref")


def fasta_strings(text):
    """The residue strings of FASTA text."""
    return ["".join(block.splitlines()[1:]) for block in text.split(">")[1:]]


def cli_sequences(strings, dedup=True):
    """The sequences `strings` as the CLI builds its tree from them:
    sorted, padded, and (dedup) without duplicates."""
    from famsa_tpu_torch.core.sequence import Sequence
    from famsa_tpu_torch.pipeline import remove_duplicates, sort_and_extend
    seqs = sort_and_extend([Sequence(f">s{k}", s, k)
                            for k, s in enumerate(strings)])
    if dedup:
        seqs = remove_duplicates(seqs, list(range(len(seqs))))
    return seqs


def prim_case(strings, device, dedup=True):
    """The device Prim's inputs (ops/prim_torch.py:prim_inputs) for the
    sequences `strings` as the CLI builds its tree (cli_sequences)."""
    from famsa_tpu_torch.ops.lcs_torch import BV32, pad_sequences
    from famsa_tpu_torch.ops.prim_torch import prim_inputs
    seqs = cli_sequences(strings, dedup)
    lengths = np.array([s.length for s in seqs], dtype=np.int64)
    return prim_inputs(pad_sequences(seqs, align=BV32), lengths, device)


def k8_small_families(seed=31):
    """Kernel-level cases of K8 besides the main path's families: 257
    sequences (a partial last warp of the CTA's stride); 100 distinct
    sequences three times each, kept (every distance from a vertex ties
    with its copies', so the tie keys decide); and two groups on disjoint
    alphabets, whose rows have lcs == 0."""
    rng = np.random.default_rng(seed)

    def rand(n, lo, hi, letters=20, shift=0):
        return ["".join(AA[shift + c] for c in rng.integers(
            0, letters, size=int(rng.integers(lo, hi)))) for _ in range(n)]
    distinct = rand(100, 60, 200)
    return {"257": (fasta_strings(make_family(257, 150, seed)), True),
            "tie": ([s for s in distinct for _ in range(3)], False),
            "lcs0": ([s for pair in zip(rand(100, 40, 120, 10),
                                        rand(100, 40, 120, 10, 10))
                      for s in pair], True)}


def _bits(t):
    """A float64 tensor's bits (so that equal means bit for bit)."""
    import torch
    return t.view(torch.int64) if t.is_floating_point() else t


def clone_state(state):
    from famsa_tpu_torch.ops.prim_torch import PrimState
    out = object.__new__(PrimState)
    for name in STATE:
        setattr(out, name, getattr(state, name).clone())
    out.flags = state.flags
    return out


def k8_check(inputs, what, start=0, rounds=K8_ROUNDS, cluster=None):
    """K8 against prim_round_plain, bit for bit on every state tensor and
    output, for `rounds` consecutive rounds from the state after `start`
    rounds (reached on K1 wave and K8): both sides start from one state,
    and each round's K1 wave row (held in K1's part of this phase) feeds
    both; K8 on a cluster of `cluster` CTAs (default: its shape rule's).
    Returns (max abs error, the kernel side's state before its last
    round, that round's LCS row)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.lcs_torch import lcs_rows
    from famsa_tpu_torch.ops.prim_torch import (PrimState, prim_chunk,
                                                prim_round, prim_round_plain)
    table, queries, lengths, pow_tab = inputs
    ks = PrimState(queries)
    if start:
        prim_chunk(table, queries, lengths, pow_tab, ks, start)
    ps = clone_state(ks)
    ek = torch.zeros((3, rounds), dtype=torch.int64, device=queries.device)
    ep = ek.clone()
    err = 0.0
    for r in range(rounds):
        lcs = lcs_rows(table, ks.ref)
        before = clone_state(ks)
        launched = kernels.LAUNCHES["prim_round"]
        prim_round(lcs, lengths, pow_tab, queries, *(getattr(ks, a) for a
                                                     in STATE), ek, r,
                   cluster=cluster)
        if queries.is_cuda and kernels.LAUNCHES["prim_round"] != launched + 1:
            raise AssertionError(f"K8 {what}: the kernel was not launched")
        prim_round_plain(lcs, lengths, pow_tab, queries,
                         *(getattr(ps, a) for a in STATE), ep, r)
        err = max(err, float((ks.dist - ps.dist).abs().max()),
                  int_err(ks.tieb, ps.tieb), int_err(ek, ep))
        bad = [a for a in STATE if not torch.equal(
            _bits(getattr(ks, a)), _bits(getattr(ps, a)))]
        if bad or not torch.equal(ek, ep):
            raise AssertionError(f"K8 {what}: round {start + r} differs "
                                 f"from prim_round_plain in {bad} or the "
                                 f"edges {ek[:, r].tolist()} against "
                                 f"{ep[:, r].tolist()}")
    return err, before, lcs


def k8_bound_ms(state, after, lcs):
    """K8's bound by bytes on one round: every vertex's active flag; an
    active vertex's lcs, length, dist and tieb; the pow table entry of one
    with lcs > 0; dist and tieb written where they change; the reference
    row read and written, cur, the reference's length and the edge."""
    n_act = int(state.active.sum())
    n_pow = int((state.active & (lcs[0] > 0)).sum())
    n_upd = int(((after.dist != state.dist) | (after.tieb != state.tieb))
                .sum())
    length = state.ref.shape[1]
    nbytes = (state.active.numel() + 28 * n_act + 8 * n_pow + 16 * n_upd
              + 8 * length + 8 + 8 + 1 + 24)
    return bound(nbytes, 12 * n_act)


def k8_graph_ms(inputs, state, lcs, cluster=0):
    """K8's device ms a launch from 20 in one CUDA graph at `state` (on a
    clone), on a cluster of `cluster` CTAs (0: the shape rule's)."""
    import torch
    from famsa_tpu_torch import kernels
    table, queries, lengths, pow_tab = inputs
    edges = torch.zeros((3, 1), dtype=torch.int64, device=queries.device)
    st = clone_state(state)
    lib = kernels.get("prim")
    return graph_ms(lambda: kernels.check(lib.prim_round(
        lcs.data_ptr(), lengths.data_ptr(), pow_tab.data_ptr(),
        queries.data_ptr(), queries.shape[0], queries.shape[1],
        *(getattr(st, a).data_ptr() for a in STATE), edges.data_ptr(), 1,
        0, cluster, torch.cuda.current_stream().cuda_stream), "prim_round"))


def k8_times(inputs, state, lcs):
    """K8 on one round at `state`: (launch-loop ms, device ms a launch
    from 20 in one CUDA graph, plain ms, bound ms, bound by, {cluster
    size: device ms a launch in a graph}); each on a clone of the state
    (200 launches leave the tree a few vertices shorter)."""
    import torch
    from famsa_tpu_torch.ops.prim_torch import (CLUSTERS, prim_round,
                                                prim_round_plain)
    table, queries, lengths, pow_tab = inputs
    edges = torch.zeros((3, 1), dtype=torch.int64, device=queries.device)
    after = clone_state(state)
    plain_ms = wall_ms(lambda: prim_round_plain(
        lcs, lengths, pow_tab, queries, *(getattr(after, a) for a in STATE),
        edges, 0))
    bms, by = k8_bound_ms(state, after, lcs)
    st = clone_state(state)
    ms = cuda_ms(lambda: prim_round(lcs, lengths, pow_tab, queries,
                                    *(getattr(st, a) for a in STATE), edges,
                                    0), 50)
    gms = k8_graph_ms(inputs, state, lcs)
    by_c = {c: k8_graph_ms(inputs, state, lcs, c) for c in CLUSTERS}
    return ms, gms, plain_ms, bms, by, by_c


def k8_profile(inputs, state, k=K8_ROUNDS):
    """One chunk of k rounds (prim_chunk) from `state` under torch.profiler
    and set_sync_debug_mode("error"): its device operations (2 a round, K1
    wave then K8, or with state.flags 3, K1 wave, K9, K8, or the smoke
    fails) and their device ms a round; then the same chunk on another
    clone, unprofiled: the host's ms a round to enqueue it and its ms a
    round to the end of the device's work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from famsa_tpu_torch.ops.prim_torch import prim_chunk
    st = clone_state(state)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prim_chunk(*inputs, st, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.name]
    want = (["lcs_wave_kernel"]
            + (["lcs_refmask_kernel"] if state.flags is not None else [])
            + ["prim_round_kernel"]) * k
    if len(ops) != len(want) or any(w not in e.name
                                    for w, e in zip(want, ops)):
        raise AssertionError(f"K8: a chunk of {k} rounds ran {len(ops)} "
                             f"device operations, not {want[:len(want) // k]}"
                             f" a round: {[short_name(e.name) for e in ops]}")
    dev_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / k
    st = clone_state(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prim_chunk(*inputs, st, k)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"rounds": k, "device_ops_a_round": len(ops) / k,
            "device_ms_a_round": dev_ms,
            "host_ms_a_round": (t1 - t0) * 1e3 / k,
            "round_ms": (t2 - t0) * 1e3 / k}


def phase_k8(device="cuda", fams=None):
    """K8 (csrc/prim.cu) against prim_round_plain on the card, bit for
    bit, K8_ROUNDS consecutive rounds each: the trees of the main path's
    families (phase 4's 1000, phase 6's 10,000 and phase 6b's 10,000 of
    mean length 600; from round 0 and from round n/2) and
    k8_small_families.  Times K8 and K1 wave at the families' round
    shapes (K1 wave's bound at 6b's too), and profiles one chunk of the
    1000 and the 10,000 families.  Returns K8's entry of the kernel
    report (measured on 6b's family, at round n/2)."""
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.lcs_torch import lcs_rows
    from famsa_tpu_torch.ops.prim_torch import (CLUSTERS, CTA_VERTICES,
                                                cluster_size)
    fams = fams or {"1000": (1000, 300, 7), "10000": WIDE_300,
                    "wide600": WIDE_FAMILY}
    held, parts, err, entry, profiles = [], [], 0.0, None, {}
    for name, (strings, dedup) in k8_small_families().items():
        inputs = prim_case(strings, device, dedup)
        e, _, _ = k8_check(inputs, name)
        err = max(err, e)
        held.append(f"{name} (n={inputs[1].shape[0]})")
    # an n on each side of the shape rule's threshold
    rule = []
    for n in (CTA_VERTICES, CTA_VERTICES + 1):
        inputs = prim_case(fasta_strings(make_family(n, 60, n)), device,
                           dedup=False)
        if device == "cuda" and kernels.get("prim").prim_cluster_size(
                n) != cluster_size(n):
            raise AssertionError(f"K8: the shape rule at n={n} differs "
                                 "between csrc/prim.cu and prim_torch")
        e, _, _ = k8_check(inputs, f"n={n}")
        err = max(err, e)
        rule.append(f"{n}: {cluster_size(n)}")
    held.append(f"n on each side of the shape rule's threshold (n: CTAs) "
                f"{', '.join(rule)}")
    for name, fam in fams.items():
        inputs = prim_case(fasta_strings(make_family(*fam)), device)
        table, queries = inputs[:2]
        n = queries.shape[0]
        if cli_flags(queries) is not None:
            raise AssertionError(f"K8: the {name} family has a flagged "
                                 "sequence: its rounds would launch K9")
        e, _, _ = k8_check(inputs, name)
        e2, state, lcs = k8_check(inputs, f"{name} from round {n // 2}",
                                  start=n // 2)
        err = max(err, e, e2)
        held.append(f"{name} (n={n}, L={queries.shape[1]}) from rounds 0 "
                    f"and {n // 2}")
        if name == "10000":
            # every cluster size forced
            for c in CLUSTERS:
                e, _, _ = k8_check(inputs, f"{name} on {c} CTAs",
                                   cluster=c)
                err = max(err, e)
            held.append(f"{name} from round 0 on clusters of "
                        f"{', '.join(map(str, CLUSTERS))} CTAs forced")
        if device != "cuda":
            continue
        ms, gms, plain_ms, bms, by, by_c = k8_times(inputs, state, lcs)
        k1_ms = cuda_ms(lambda: lcs_rows(table, state.ref), 50)
        k1_bms, k1_by = lcs_bound_ms(table, state.ref, n)
        if name != "wide600":
            profiles[name] = k8_profile(inputs, state)
        parts.append(
            f"{name} (n={n}, L={queries.shape[1]}, W={table.shape[1]}): K8 "
            f"{ms:.5f} ms from a launch loop, {gms:.5f} ms a launch in a "
            f"CUDA graph on {cluster_size(n)} CTAs (forced: "
            + ", ".join(f"{c}: {v:.5f}" for c, v in by_c.items())
            + f"), bound {bms:.7f} ms ({by}), plain {plain_ms:.3f} "
            f"ms; K1 wave {k1_ms:.5f} ms, bound {k1_bms:.5f} ms ({k1_by}); "
            f"K8 / K1 wave {gms / k1_ms:.3f}")
        entry = {"name": "prim_round", "route": "cuda",
                 "source": "famsa_tpu_torch/csrc/prim.cu",
                 "replaces": "famsa_tpu/ops/prim_device.py:67",
                 "ms": gms, "plain_ms": plain_ms, "bound_ms": bms,
                 "bound_by": by, "library_ms": None, "launch_loop_ms": ms,
                 "at": f"phase 2: round {n // 2} of the {name} family "
                       f"(n={n}, L={queries.shape[1]})",
                 "k1_wave_ms": k1_ms, "k1_wave_bound_ms": k1_bms,
                 "cluster": cluster_size(n), "graph_ms_by_cluster": by_c,
                 "profile": profiles}
    msg = (f"phase 2 K8: bit-exact vs prim_round_plain ({K8_ROUNDS} rounds "
           f"each, every state tensor and edge) on {', '.join(held)}")
    if device == "cuda":
        msg += ("; " + "; ".join(parts) + "; a profiled chunk (device ms, "
                "host ms to enqueue, ms to the device's end, a round): "
                + "; ".join(f"{k} {v['device_ops_a_round']:g} device "
                            f"operations a round, {v['device_ms_a_round']:.5f}"
                            f", {v['host_ms_a_round']:.5f}, "
                            f"{v['round_ms']:.5f}"
                            for k, v in profiles.items()))
        entry["max_abs_err"] = err
    log(msg)
    return entry


# ----------------------------------------------------------------------
# K9
# phase 5b's family: sequences, mean length, seed (every 10th sequence
# with a poly-Q tract, make_polyq)
POLYQ_FAMILY = (500, 300, 13)


def make_polyq(n, mean_len, seed, every=10):
    """FASTA text of make_family(n, mean_len, seed) in which every
    `every`-th sequence carries a poly-Q tract of 64-200 residues at an
    offset of 0-63: FAMSA's LCS departs from the exact one where such a
    sequence is the reference (ops/lcs_torch.py:famsa_flags)."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for k, seq in enumerate(fasta_strings(make_family(n, mean_len, seed))):
        if k % every == 0:
            off = int(rng.integers(0, 64))
            seq = seq[:off] + "Q" * int(rng.integers(64, 201)) + seq[off:]
        out.append(f">polyq_{k}\n{seq}\n")
    return "".join(out)


def cli_flags(queries):
    """The flags a CLI run's device Prim takes for these query rows
    (ops/prim_torch.py:device_flags; None: no sequence flagged)."""
    from famsa_tpu_torch.ops.lcs_torch import famsa_flags
    from famsa_tpu_torch.ops.prim_torch import device_flags
    return device_flags(famsa_flags(queries.cpu().numpy().astype(np.int8)),
                        queries.device)


def refmask_check(refs, queries, q, what, out_dtype=None):
    """K9 against lcs_refmask_plain, bit for bit on the first q queries;
    the launch must have happened."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.lcs_torch import lcs_refmask, lcs_refmask_plain
    before = kernels.LAUNCHES["lcs_refmask"]
    got = lcs_refmask(refs, queries, n_queries=q,
                      out_dtype=out_dtype or torch.int32)
    want = lcs_refmask_plain(refs, queries, q)
    if refs.is_cuda:
        torch.cuda.synchronize()
        if kernels.LAUNCHES["lcs_refmask"] != before + 1:
            raise AssertionError(f"K9 {what}: not launched")
    if not torch.equal(got[:, :q].to(torch.int32), want[:, :q]):
        bad = (got[:, :q].to(torch.int32) != want[:, :q]).nonzero()[:5]
        raise AssertionError(f"K9 {what}: mismatch at {bad.tolist()}")


# K9's wavefront edges (K1 wave's geometry over 64-bit words,
# csrc/lcs.cu:wave_geometry): W64 = 1 (no carry), powers of two and not
# (a partial last lane), 32 (one lane a word), 33 and 65 (wpl 2 and 3:
# registers, a partial last lane)
REFMASK_EDGE_W64 = (1, 2, 3, 5, 17, 32, 33, 65)


def refmask_edge_case(w64, seed, device, n_refs=3, n_queries=101):
    """(refs, queries) int32 on `device`: references of exactly W64
    64-bit words, each (W64 >= 2) with a whole word k >= 1 of glutamine
    (flagged), some symbols >= 20 inside; queries of 1-100 residues, every
    third with a poly-Q tract of 64-100, padded with the no-op symbol past
    their ends and past the longest (tests/test_torch_refmask_wave.py's
    cases, shorter: the plain version walks every query position and
    reference word from Python)."""
    import torch
    from famsa_tpu_torch.ops.lcs_torch import PAD_SYMBOL
    rng = np.random.default_rng(seed)
    q_code = AA.index("Q")
    lr = 64 * w64 if w64 <= 2 else int(rng.integers(64 * (w64 - 1) + 1,
                                                    64 * w64 + 1))
    refs = []
    for _ in range(n_refs):
        ref = rng.choice(24, size=lr, p=[0.048] * 20 + [0.01] * 4)
        if w64 >= 2:
            word = int(rng.integers(1, lr // 64))
            ref[64 * word:64 * (word + 1)] = q_code
        refs.append(ref)
    rows = []
    for j in range(n_queries):
        row = rng.choice(24, size=int(rng.integers(1, 101)),
                         p=[0.048] * 20 + [0.01] * 4)
        if j % 3 == 0:
            off = int(rng.integers(0, min(64, len(row)) + 1))
            row = np.concatenate([row[:off], np.full(
                int(rng.integers(64, 101)), q_code), row[off:]])
        rows.append(row)
    lq = max(len(r) for r in rows) + 7
    queries = np.full((n_queries, lq), PAD_SYMBOL, dtype=np.int32)
    for j, r in enumerate(rows):
        queries[j, :len(r)] = r
    return (torch.from_numpy(np.stack(refs).astype(np.int32)).to(device),
            torch.from_numpy(queries).to(device))


def k9_prim_check(inputs, flags, min_rounds=K8_ROUNDS, max_rounds=512):
    """K9 inside Prim rounds from round 0, as prim_chunk runs it (K1 wave,
    K9, K8): each round's row after K9 against lcs_refmask_plain when the
    round's reference is flagged and against K1 wave's row when it is
    not, until both kinds were held (at least min_rounds rounds).
    Returns ({flagged: rounds held}, a flagged and an unflagged state)."""
    import torch
    from famsa_tpu_torch.ops.lcs_torch import (lcs_refmask, lcs_refmask_plain,
                                               lcs_rows)
    from famsa_tpu_torch.ops.prim_torch import PrimState, prim_round
    table, queries, lengths, pow_tab = inputs
    n = queries.shape[0]
    ks = PrimState(queries, flags)
    edges = torch.zeros((3, max_rounds), dtype=torch.int64,
                        device=queries.device)
    seen, states = {True: 0, False: 0}, {}
    for r in range(max_rounds):
        if r >= min_rounds and seen[True] and seen[False]:
            break
        cur = int(ks.cur[0])
        flagged = bool(flags[cur])
        states.setdefault(flagged, clone_state(ks))
        lcs = lcs_rows(table, ks.ref, variant="wave")
        k1 = lcs.clone()
        lcs_refmask(ks.ref, queries, out=lcs, cur=ks.cur, flags=flags)
        want = lcs_refmask_plain(ks.ref, queries, n) if flagged else k1
        if not torch.equal(lcs, want):
            raise AssertionError(f"K9 in Prim round {r} (reference {cur}, "
                                 f"flagged {flagged}): the row differs")
        seen[flagged] += 1
        prim_round(lcs, lengths, pow_tab, queries,
                   *(getattr(ks, a) for a in STATE), edges, r)
    if not (seen[True] and seen[False]):
        raise AssertionError(f"K9 in Prim rounds: references held {seen}")
    return seen, states


def phase_k9(device="cuda"):
    """K9 (csrc/lcs.cu:lcs_refmask, FAMSA's layout and carry) against
    lcs_refmask_plain on the card, bit for bit: on the rows path (the
    flagged references of the poly-Q family against all its sequences,
    uint16 and int32 out, a triangular n_queries, an unflagged short
    reference, and references of ~3000 residues: past 32 words, the
    local-memory state) and inside Prim rounds (a flagged and an
    unflagged reference).  Then a profiled chunk of the poly-Q family's
    rounds (3 device operations a round) and K9's times."""
    import torch
    from famsa_tpu_torch.ops.lcs_torch import (famsa_flags, lcs_refmask,
                                               lcs_refmask_plain)
    from famsa_tpu_torch.ops.prim_torch import PrimState
    n, mean_len, seed = POLYQ_FAMILY
    inputs = prim_case(fasta_strings(make_polyq(n, mean_len, seed)), device)
    queries = inputs[1]
    flags = cli_flags(queries)
    if flags is None:
        raise AssertionError("K9: the poly-Q family has no flagged sequence")
    fl = flags.cpu().numpy()
    ids = torch.from_numpy(np.nonzero(fl)[0][:8]).to(device)
    refs = queries.index_select(0, ids).contiguous()
    nq = queries.shape[0]
    refmask_check(refs, queries, nq, f"{len(ids)} flagged x {nq}")
    refmask_check(refs, queries, nq, "uint16 out", torch.uint16)
    refmask_check(refs[:3].contiguous(), queries, nq // 3, "triangular")
    short = queries[~flags][:1, :40].contiguous()
    refmask_check(short, queries, nq, "an unflagged 40-residue reference")
    # references past 32 words (the local-memory state) against short
    # queries (the plain version's loop runs over query positions)
    long_strings = [s[:2000] + "N" * 130 + s[2000:] for s in fasta_strings(
        make_family(4, 3000, 5))]
    long_r = prim_case(long_strings, device, dedup=False)[1]
    if not famsa_flags(long_r.cpu().numpy().astype(np.int8)).all():
        raise AssertionError("K9: the long references are not flagged")
    short_q = prim_case(fasta_strings(make_family(64, 150, 6)), device,
                        dedup=False)[1]
    refmask_check(long_r, short_q, short_q.shape[0],
                  f"4 refs of L={long_r.shape[1]} (W64="
                  f"{-(-long_r.shape[1] // 64)}) x 64 queries")
    # the wavefront's geometry edges, queries of mixed lengths with pads
    # and no-op symbols, a triangular n_queries, both output types
    for i, w64 in enumerate(REFMASK_EDGE_W64):
        e_refs, e_q = refmask_edge_case(w64, 60 + i, device)
        refmask_check(e_refs, e_q, e_q.shape[0] - 5, f"W64={w64}",
                      torch.uint16 if i % 2 else torch.int32)
    seen, states = k9_prim_check(inputs, flags)
    msg = (f"phase 2 K9: bit-exact vs lcs_refmask_plain on the poly-Q "
           f"family (n={nq}, L={queries.shape[1]}, {int(fl.sum())} flagged): "
           f"{len(ids)} flagged refs x {nq} (int32 and uint16), triangular "
           f"{nq // 3}, an unflagged 40-residue ref, 4 refs of "
           f"L={long_r.shape[1]} x 64, 3 refs x 96 of 101 queries of mixed "
           f"lengths at W64 {REFMASK_EDGE_W64} (uint16 at every second); "
           f"in Prim rounds from round 0 "
           f"{seen[True]} flagged and {seen[False]} unflagged references "
           f"(row after K9 = plain / = K1 wave's)")
    if device == "cuda":
        prof = k8_profile(inputs, PrimState(queries, flags))
        ms = cuda_ms(lambda: lcs_refmask(refs, queries), 20)
        pms = wall_ms(lambda: lcs_refmask_plain(refs, queries, nq))
        bms, by = refmask_bound_ms(refs, queries, nq)
        row = torch.empty((1, nq), dtype=torch.int32, device=device)
        st_f, st_u = states[True], states[False]
        f_ms = cuda_ms(lambda: lcs_refmask(st_f.ref, queries, out=row,
                                           cur=st_f.cur, flags=flags), 50)
        u_ms = graph_ms(lambda: lcs_refmask(st_u.ref, queries, out=row,
                                            cur=st_u.cur, flags=flags))
        fg_ms = graph_ms(lambda: lcs_refmask(st_f.ref, queries, out=row,
                                             cur=st_f.cur, flags=flags))
        fbms, fby = refmask_bound_ms(st_f.ref, queries, nq)
        msg += (f"; {len(ids)} x {nq}: K9 {ms:.4f} ms, plain {pms:.1f} ms, "
                f"bound {bms:.5f} ms ({by}); in a round, flagged reference "
                f"{f_ms:.5f} ms ({fg_ms:.5f} a launch in a CUDA graph; "
                f"bound {fbms:.6f} ms, {fby}), unflagged (returns at once) "
                f"{u_ms:.5f} ms a "
                f"launch in a CUDA graph; a profiled chunk of the poly-Q "
                f"rounds: {prof['device_ops_a_round']:g} device operations "
                f"a round (K1 wave, K9, K8), {prof['device_ms_a_round']:.5f} "
                f"device ms, {prof['host_ms_a_round']:.5f} host ms a round")
    log(msg)


# ----------------------------------------------------------------------
# K2
def random_profile(rng, params, n_seqs, width, gap_frac=0.2):
    """A Profile of n_seqs random gapped rows of one width (gap_frac 0:
    ungapped, e.g. a leaf)."""
    from famsa_tpu_torch.core.profile import Profile
    from famsa_tpu_torch.core.sequence import GappedSequence
    prof = Profile(params)
    gaps = rng.random((n_seqs, width)) < gap_frac
    gaps[:, 0] = False
    syms = rng.integers(0, 20, size=(n_seqs, width)).astype(np.int8)
    for k in range(n_seqs):
        keep = ~gaps[k]
        # n_gaps[p] = gaps before symbol p; last entry = trailing gaps
        pos = np.nonzero(keep)[0]
        n_gaps = np.diff(np.concatenate([[-1], pos, [width]])) - 1
        prof.data.append(GappedSequence(
            f">s{k}", syms[k, keep].copy(), n_gaps.astype(np.int64),
            np.ones(len(pos), dtype=bool), [], k, k))
    prof.width = width
    prof.calculate_counters_scores()
    return prof


def banded_case(rng, params, w1=300, w2=320, split=None):
    """A refinement-style guided merge: align profiles of 6 and 5
    sequences of widths w1 and w2, split, condense, re-align with the
    find_row_ranges band.  split: the first `split` sequences against the
    rest (default: alternate ones)."""
    from famsa_tpu_torch.core.aligner import align_into
    from famsa_tpu_torch.core.profile import Profile
    from famsa_tpu_torch.core.dp_native import row_ranges
    p1 = random_profile(rng, params, 6, w1)
    p2 = random_profile(rng, params, 5, w2)
    dest = Profile(params)
    align_into(dest, p1, p2, backend="numpy")
    a, b = Profile(params), Profile(params)
    for k, gs in enumerate(dest.data):
        first = k % 2 == 0 if split is None else k < split
        (a if first else b).append_raw_sequence(gs)
    _, cm1 = a.condense()
    _, cm2 = b.condense()
    a.optimize_gaps()
    b.optimize_gaps()
    a.calculate_counters_scores()
    b.calculate_counters_scores()
    return a, b, (cm1, cm2), row_ranges(params, cm1, cm2)


def dp_check(params, pairs, bands, device, what, mappings=None,
             variants=(None,), walk=True, trace=True):
    """K2 against its plain versions on one batch, once per variant in
    `variants` (None: the one k2_variant picks): dp_plain, and for the
    staged and stripes variants their fold walk dp_staged_plain too, on
    the host (on_host; for the spans variant with walk: its fold walk,
    dp_staged_plain with span MAX_FOLDS); full direction bytes (so D
    everywhere and H/V on [1:, 1:]), per-row finals, last, path and
    total; and path/total vs the native host DP (guided by `mappings`,
    the column mappings the bands came from).  Each launch must go to its
    variant.  K4 and K6 run on the first variant's output (k4_check,
    k6_check; trace "native": K4 against the native walk alone, no K6).
    Returns the packed inputs on the device and dp_plain's wall ms."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.dp_native import dp_profile, finish_path
    from famsa_tpu_torch.ops.dp_torch import (dp_dirs, dp_plain, k2_variant,
                                              pack_batch, prepare_merge)
    from famsa_tpu_torch.ops.dp_wide import MAX_FOLDS, dp_staged_plain
    merges = [prepare_merge(params, p1, p2, bd)
              for (p1, p2), bd in zip(pairs, bands)]
    colf, rowf, meta, total = pack_batch(merges)
    args = [torch.from_numpy(x).to(device) for x in (colf, rowf, meta)]
    variants = list(dict.fromkeys(v or k2_variant(int(meta[:, 1].max()))
                                  for v in variants))
    t0 = time.perf_counter()
    plains = {"dp_plain": [x.cpu().numpy() for x in dp_plain(*args, total)]}
    plain_ms = (time.perf_counter() - t0) * 1e3
    if {"staged", "stripes"} & set(variants):
        plains["dp_staged_plain"] = [x.numpy() for x in on_host(
            dp_staged_plain, *args, total)]
    if "spans" in variants and walk:
        plains["spans fold walk"] = [x.numpy() for x in on_host(
            dp_staged_plain, *args, total, span=MAX_FOLDS)]
    hosts = [dp_profile(params, p1, p2, *(mappings[k] if mappings else ()))
             for k, (p1, p2) in enumerate(pairs)]
    sides, hdr = stage0_check(params, pairs, bands, (colf, rowf, meta),
                              device, f"K2 {what}")
    for variant in variants:
        key = dp_key("K2", list(meta[:, 1]), variant)
        before = kernels.LAUNCHES[key]
        dirs_d, fin_d = dp_dirs(*args, total, variant=variant)
        if device == "cuda":
            torch.cuda.synchronize()
            if kernels.LAUNCHES[key] != before + 1:
                raise AssertionError(f"K2 {what}: the {variant} variant was "
                                     "not launched")
        dirs_k, fin_k = dirs_d.cpu().numpy(), fin_d.cpu().numpy()
        natives = []
        for k, (w1, w2, off, _) in enumerate(meta):
            n = (w1 + 1) * (w2 + 1)
            dk = dirs_k[off:off + n].reshape(w1 + 1, w2 + 1)
            rk = finish_path(dk, w1, w2, fin_k[k, w1 - 1])
            natives.append(rk)
            for name, (dirs_p, fin_p) in plains.items():
                dp_ = dirs_p[off:off + n].reshape(w1 + 1, w2 + 1)
                if not np.array_equal(dk, dp_):
                    i, j = np.argwhere(dk != dp_)[0]
                    raise AssertionError(
                        f"K2 {variant} {what} merge {k}: dirs differ from "
                        f"{name} at ({i}, {j}): {dk[i, j]} vs {dp_[i, j]}")
                if not np.array_equal(fin_k[k, :w1], fin_p[k, :w1]):
                    raise AssertionError(f"K2 {variant} {what} merge {k}: "
                                         f"finals differ from {name}")
                rp = finish_path(dp_, w1, w2, fin_p[k, w1 - 1])
                if rk.last != rp.last or rk.total != rp.total or \
                        not np.array_equal(rk.path, rp.path):
                    raise AssertionError(f"K2 {variant} {what} merge {k}: "
                                         f"path/total differ from {name}")
            rh = hosts[k]
            if rh.total != rk.total or not np.array_equal(rh.path, rk.path):
                raise AssertionError(f"K2 {variant} {what} merge {k}: "
                                     "differs from the native host DP")
        if variant == variants[0] and trace:
            paths = k4_check(dirs_d, fin_d, args[2], f"K2 {variant} {what}",
                             natives, plain=trace is True)
            if trace is True:
                k6_check(sides, hdr, paths, f"K2 {variant} {what}")
    return args, total, plain_ms


def k4_check(dirs, fin, meta, what, natives, plain=True):
    """K4 (csrc/traceback.cu) on a DP kernel's output where it lies,
    against its plain version (every byte of the output buffer: paths,
    totals, lengths; skipped when not plain) and the native trace_path of
    each merge (natives: finish_path results on the same bytes)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.traceback_torch import (read_paths,
                                                     trace_paths,
                                                     trace_paths_plain)
    meta_h = meta.cpu().numpy()
    before = kernels.LAUNCHES["traceback"]
    got = trace_paths(dirs, fin, meta, meta_host=meta_h)
    want = trace_paths_plain(dirs, fin, meta) if plain else got
    if dirs.is_cuda:
        torch.cuda.synchronize()
        if kernels.LAUNCHES["traceback"] != before + 1:
            raise AssertionError(f"K4 {what}: not launched")
    if not torch.equal(got, want):
        at = int((got != want).nonzero()[0, 0])
        raise AssertionError(f"K4 {what}: output byte {at} differs from "
                             f"trace_paths_plain: {int(got[at])} vs "
                             f"{int(want[at])}")
    for k, ((path, total), rn) in enumerate(zip(
            read_paths(got.cpu().numpy(), meta_h), natives)):
        if total != rn.total or not np.array_equal(path, rn.path):
            raise AssertionError(f"K4 {what} merge {k}: path/total differ "
                                 "from the native trace_path")
    return got


def first_diff(got, want):
    """(index, got, want) of the first element where two tensors of one
    shape differ."""
    at = tuple((got != want).nonzero()[0].tolist())
    return at, int(got[at]), int(want[at])


def launch_inputs(params, pairs, bands, meta, device):
    """(hdr, band, sides) of a batch on the device as the route uploads
    them (ops/dp_resident.py:upload_launch): no side resident, so every
    side is a leaf's symbol bytes or uploaded counters."""
    import torch
    from famsa_tpu_torch.ops.dp_resident import upload_launch
    hdr = np.zeros((len(pairs), 8), dtype=np.int64)
    hdr[:, :4] = meta
    hdr[:, 4] = [len(p1.data) for p1, _ in pairs]
    hdr[:, 5] = [len(p2.data) for _, p2 in pairs]
    band = None
    if any(bd is not None for bd in bands):
        band = np.zeros((len(pairs), max(p1.width for p1, _ in pairs) + 1,
                         2), dtype=np.int64)
        for k, ((p1, p2), bd) in enumerate(zip(pairs, bands)):
            band[k, :, 1] = p2.width
            if bd is not None:
                band[k, :p1.width + 1] = bd[:p1.width + 1]
    return upload_launch(pairs, [(None, None)] * len(pairs), hdr, band,
                         torch.device(device))


def stage0_check(params, pairs, bands, packed, device, what):
    """K5 (csrc/stage0.cu, ops/dp_stage0.py:stage0) on the card, reading
    the sides through their descriptors, against its plain twin
    stage0_plain on the sides the plain reader gives for the same
    descriptors, and against the host prep, prepare_merge + pack_batch
    (`packed`: colf, rowf, meta), in every int64.  Returns (sides, hdr)
    on the device, for the K6 check."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.dp_stage0 import (score_table, stage0,
                                               stage0_plain)
    from famsa_tpu_torch.ops.sides import read_sides_plain
    hdr, band, sides = launch_inputs(params, pairs, bands, packed[2], device)
    table = torch.from_numpy(score_table(params)).to(device)
    before = kernels.LAUNCHES["stage0"]
    got = stage0(params, sides, hdr, table, band)
    want = stage0_plain(params, *read_sides_plain(sides), hdr, table, band)
    if device == "cuda":
        torch.cuda.synchronize()
        if kernels.LAUNCHES["stage0"] != before + 1:
            raise AssertionError(f"K5 {what}: not launched")
    for name, g, p, w in zip(("colf", "rowf", "meta"), got, want, packed):
        if g.shape != p.shape or not torch.equal(g, p):
            raise AssertionError(f"K5 {what}: {name} differs from "
                                 f"stage0_plain: {first_diff(g, p)}")
        if tuple(g.shape) != w.shape or not np.array_equal(g.cpu().numpy(),
                                                           w):
            raise AssertionError(f"K5 {what}: {name} differs from the host "
                                 "prep")
    return sides, hdr


def k6_check(sides, hdr, paths, what, smax=None):
    """K6 (csrc/merged.cu, ops/merged_torch.py:merged_from_paths) on K4's
    output as it lies on the card, against its plain twin on the same
    inputs, every int32 (smax: the rows a merge, default its longest
    path)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.merged_torch import (merged_from_paths,
                                                  merged_from_paths_plain)
    w1, w2 = sides.widths()
    smax = smax or int((w1 + w2).max())
    before = kernels.LAUNCHES["merged"]
    got = merged_from_paths(sides, paths, hdr, smax)
    want = merged_from_paths_plain(sides, paths, hdr, smax)
    if paths.is_cuda:
        torch.cuda.synchronize()
        if kernels.LAUNCHES["merged"] != before + 1:
            raise AssertionError(f"K6 {what}: not launched")
    if not torch.equal(got, want):
        raise AssertionError(f"K6 {what}: differs from "
                             f"merged_from_paths_plain: "
                             f"{first_diff(got, want)}")


def dp_bound_ms(colf, rowf, meta, total):
    """Least time of one K2 call: the int64 work the recurrence needs per
    cell (i, j), in int32 instructions (a 64-bit low multiply as 3, an
    add, compare or select as 2): 17 multiplies and 23 adds (the
    rank <= 4 gap terms, tmH / tmV, bc, H), 17 compares and 11 selects
    (direction picks, maxima, the band), and nnz_i multiply-adds of the
    match term; against its bytes (inputs once, outputs once)."""
    ops = 0
    meta_h = meta.cpu().numpy()
    rowf_h = rowf.cpu().numpy()
    for k, (w1, w2, _, _) in enumerate(meta_h):
        nnz = int(rowf_h[k, 1:w1 + 1, 0].sum())
        ops += w2 * (w1 * (17 * 3 + 23 * 2 + 17 * 2 + 11 * 2) + 5 * nnz)
    nbytes = 8 * (colf.numel() + rowf.numel() + meta.numel()) + total \
        + 8 * 3 * meta.shape[0] * (rowf.shape[1] - 1)
    return bound(nbytes, ops)


def k4_bound_ms(out_bytes, steps, merges):
    """Least time of one K4 call: the bytes it must move, one direction
    byte read a step, each merge's finals (24 bytes) and meta (32), and
    its output written once, over the memory rate.  The walk is a chain
    of dependent loads, so it is bound by their latency, not by this."""
    nbytes = steps + 56 * merges + out_bytes
    return nbytes / MEM_BYTES_PER_S * 1e3, "bytes"


def side_bytes(sides):
    """Bytes of a launch's sides, each read once: 128 (w + 1) for counter
    rows, w for a leaf's symbol bytes."""
    from famsa_tpu_torch.ops.sides import D_KIND, D_WIDTH, SIDE_LEAF
    d = sides.desc_h
    w = d[:, D_WIDTH]
    return int(np.where(d[:, D_KIND] == SIDE_LEAF, w, 128 * (w + 1)).sum())


def k5_bound_ms(sides, hdr, band, out):
    """Least time of one K5 call: its bytes (the sides, descriptors, hdr,
    the score table and the band read once; colf, rowf and meta written
    once) against the int64 multiply-adds of its scores, 32 lanes a
    counter row times the row's nonzero amino-acid counts plus one, at 5
    int32 instructions each."""
    from famsa_tpu_torch.ops.sides import D_WIDTH, read_sides_plain
    nnz = sum(int((c[..., :24] != 0).sum()) for c in read_sides_plain(sides))
    rows = int((sides.desc_h[:, D_WIDTH] + 1).sum())
    nbytes = side_bytes(sides) + sides.desc_h.nbytes + 8 * hdr.numel() \
        + 25 * 32 * 8 + (0 if band is None else 8 * band.numel()) \
        + 8 * sum(x.numel() for x in out)
    return bound(nbytes, 5 * 32 * (nnz + rows))


def k6_bound_ms(sides, hdr, paths, out):
    """Least time of one K6 call: its bytes (the sides, descriptors, hdr
    and K4's buffer read once, the merged counters written once) against
    a row of 32 int64 adds (2 int32 instructions each) for every step a
    parent advances, w1 + w2 a merge."""
    w1, w2 = sides.widths()
    nbytes = side_bytes(sides) + sides.desc_h.nbytes + 8 * hdr.numel() \
        + paths.numel() + 4 * out.numel()
    return bound(nbytes, 2 * 32 * int((w1 + w2).sum()))


def staged_cluster_fit(shapes, stripe=1):
    """{(folds, threads): clusters of the batched staged body (stripe 1)
    or stripes body (2, 4) that are resident on the card at once} for each
    (folds, threads) of shapes, at the launch's BLK
    (cudaOccupancyMaxActiveClusters)."""
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.dp_wide import BLK
    lib = kernels.get("dp_wide")
    fit = {}
    for folds, threads in shapes:
        n = lib.dp_wide_max_clusters(folds, threads, stripe, BLK)
        if n < 0:
            kernels.check(-n, "dp_wide_max_clusters")
        fit[folds, threads] = n
    return fit


# the DP variants' kernels.LAUNCHES keys: K2 staged on up to 8 folds and
# on 9-16, stripes and spans; K3 staged on up to 8 folds and on 9-16,
# and stripes
K2_KEYS = ("dp_staged", "dp_staged16", "dp_stripes", "dp_spans")
K3_KEYS = ("dp_wide", "dp_wide16", "dp_wide_stripes")
DP_KEYS = K2_KEYS + K3_KEYS


def dp_key(kernel, w2s, variant=None):
    """The kernels.LAUNCHES key of a K2 launch on a batch of widths w2s
    (kernel "K2") or of a K3 call on one (kernel "K3") of `variant`
    (default: the one its wrapper picks)."""
    from famsa_tpu_torch.ops import dp_torch, dp_wide
    widest = int(max(w2s))
    pick = dp_torch.k2_variant if kernel == "K2" else dp_wide.k3_variant
    variant = variant or pick(widest)
    if variant == "spans":
        return "dp_spans"
    return dp_wide.launch_key(kernel, variant,
                              dp_wide.fold_geometry(widest)[0])


def phase_k2(device="cuda", big=2048, card_big=70000):
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops.dp_torch import dp_dirs
    from famsa_tpu_torch.ops.dp_wide import staged_geometry
    widest8 = 4095                  # the widest merge on 8 folds
    rng = np.random.default_rng(17)
    params = Params(device=device)
    params.adjust(1000)
    mixed = []
    for k in range(8):
        n1 = 1 if k == 0 else 2 + k
        w1 = 120 + 50 * k
        mixed.append((random_profile(rng, params, n1, w1,
                                     0.0 if n1 == 1 else 0.2),
                      random_profile(rng, params, 3 + k, 500 - 40 * k)))
    dp_check(params, mixed, [None] * 8, device, "mixed")
    a, b, cms, band = banded_case(rng, params)
    dp_check(params, [(a, b)], [band], device, "banded", [cms])
    card = [(random_profile(rng, params, card_big, 24, 0.1),
             random_profile(rng, params, 4, 30))]
    dp_check(params, card, [None], device, "card>2^16")
    # staged at 3 and 6 folds of 256 columns, and on 10 of 512
    for w2 in (700, 1500, 5000):
        dp_check(params, [(random_profile(rng, params, 5, 60),
                           random_profile(rng, params, 4, w2))], [None],
                 device, f"60x{w2}")
    # 16 merges crossing 1 to 8 folds of 512 columns, two of each count
    w2s = [200, 511, 600, 1023, 1100, 1535, 1600, 2047, 2100, 2559, 2600,
           3071, 3100, 3583, 3700, widest8]
    geo = staged_geometry(w2s)
    if geo != (8, 512, [1 + k // 2 for k in range(16)]):
        raise AssertionError(f"K2 staged 16-merge batch geometry {geo}")
    sixteen = [(random_profile(rng, params, 2 + k % 4, 30 + 5 * k),
                random_profile(rng, params, 4, w2)) for k, w2 in enumerate(w2s)]
    args16, total16, _ = dp_check(params, sixteen, [None] * 16, device,
                                  "16 merges of 1-8 folds")
    on_edge, past_edge = fold_edge_widths()
    dp_check(params, [(random_profile(rng, params, 4, 90),
                       random_profile(rng, params, 3, w2))
                      for w2 in (on_edge, past_edge)], [None] * 2, device,
             f"w2={on_edge} on a fold edge and {past_edge} one past it")
    big_params = scaled_params(device)
    dp_check(big_params, [(random_profile(rng, big_params, 3, w1),
                           random_profile(rng, big_params, 2, w2))
                          for w1, w2 in ((100, 3000), (80, 700), (50, 1500))],
             [None] * 3, device, "2^22-scaled")
    bigp = [(random_profile(rng, params, 12, big),
             random_profile(rng, params, 9, big))]
    args, total, pms = dp_check(params, bigp, [None], device, f"{big}^2")
    # past 4095 columns: the staged body on 9-16 folds (a batch whose
    # widest merge is 5906 wide), the stripes body (one merge past 4095
    # and one past 8191), banded and 2^22-scaled
    wide_batches = {}
    for what, shapes in (("staged16", [(4, 60, 3, 5906), (2, 40, 3, 300),
                                       (1, 50, 5, 4100)]),
                         ("stripes", [(3, 50, 4, 5000), (2, 40, 3, 300),
                                      (1, 60, 2, 9000)])):
        pairs = [(random_profile(rng, params, n1, w1,
                                 0.0 if n1 == 1 else 0.2),
                  random_profile(rng, params, n2, w2))
                 for n1, w1, n2, w2 in shapes]
        wide_batches[what] = dp_check(params, pairs, [None] * len(pairs),
                                      device, f"{what} batch {shapes}")
    a, b, cms, band = banded_case(rng, params, 60, 9000, split=6)
    dp_check(params, [(a, b), (random_profile(rng, params, 3, 40),
                               random_profile(rng, params, 2, 200))],
             [band, None], device, f"banded {a.width}x{b.width}", [cms, ()])
    dp_check(big_params, [(random_profile(rng, big_params, 3, 60),
                           random_profile(rng, big_params, 2, w2))
                          for w2 in (8500, 300)], [None] * 2, device,
             "2^22-scaled stripes")
    msg = (f"phase 3 K2: staged bit-exact vs dp_plain and dp_staged_plain "
           f"(dirs, finals, last, path, total) and path/total = native host "
           f"DP on 8 mixed merges <= 512^2 (1 seq-prof), 1 banded, 1 of card "
           f"{card_big}, 60x700, 60x1500, 16 merges of folds 1-8 (w2 up to "
           f"{widest8}), w2={on_edge}/{past_edge} (fold edge), "
           f"2^22-scaled, 1 of {big}x{big}, 60x5000; past 4095 columns (staged "
           f"on 9-16 folds, stripes) on a batch widest 5906, one with merges "
           f"past 4095 and 8191, a banded batch of {a.width}x{b.width}, "
           f"2^22-scaled w2 8500")
    if device == "cuda":
        st = cuda_ms(lambda: dp_dirs(*args, total, variant="staged"), 5)
        bms, _ = dp_bound_ms(*args, total)
        st16 = cuda_ms(lambda: dp_dirs(*args16, total16, variant="staged"),
                       5)
        bms16, _ = dp_bound_ms(*args16, total16)
        fit = staged_cluster_fit([(f, t) for t in (512, 256)
                                  for f in range(1, 17)])
        sfit = {s: staged_cluster_fit([(16, 512)], s)[16, 512]
                for s in (2, 4)}
        msg += (f"; {big}x{big}: staged {st:.3f} ms "
                f"({big * big / st * 1e3:.4g} cells/s), "
                f"plain {pms:.1f} ms, bound {bms:.4f} ms; 16 merges of 1-8 "
                f"folds: staged {st16:.3f} ms, bound "
                f"{bms16:.4f} ms; staged clusters resident at once by folds "
                f"1..16: 512 threads "
                f"{[fit[f, 512] for f in range(1, 17)]}, 256 threads "
                f"{[fit[f, 256] for f in range(1, 17)]}; stripes clusters of "
                f"16 folds of 512 threads: S=2 {sfit[2]}, S=4 {sfit[4]}")
        if min(fit[f, 512] for f in range(1, 17)) < 1 or min(sfit.values()) < 1:
            raise AssertionError("a cluster of the DP's folds fits nowhere on "
                                 "the card")
    for what, (wargs, wtotal, _) in wide_batches.items():
        if device == "cuda":
            k = cuda_ms(lambda: dp_dirs(*wargs, wtotal), 5)
            bms_w, _ = dp_bound_ms(*wargs, wtotal)
            msg += f"; {what} batch: {k:.3f} ms, bound {bms_w:.4f} ms"
    log(msg)
    return {"dp_staged16": ("phase 3's batch of widest w2 5906",
                            (*wide_batches["staged16"][0],
                             wide_batches["staged16"][1])),
            "dp_stripes": ("phase 3's batch with merges past 4095 and 8191",
                           (*wide_batches["stripes"][0],
                            wide_batches["stripes"][1]))}


# K2 past 32767 columns (the spans variant): (w1, w2) of the lone merges
# and of the batch of three, each plain and banded, held against
# dp_plain; and the widths at which its fold walk is held (w1 6)
SPANS_LONE = ((500, 40000), (500, 100000), (300, 131071))
SPANS_BATCH = ((300, 33000), (300, 70000), (300, 131071))
SPANS_WALK = (32768, 65536, 131071)


def guided_case(rng, params, w1, w2, n1=6, n2=5):
    """banded_case with each side one of the two profiles: random
    profiles of n1 and n2 sequences of widths w1 and w2 (profile2
    ungapped, so that b is exactly w2 wide) aligned on the host, split
    back by their members (told apart by residue count),
    condensed and re-aligned with the find_row_ranges band.  Returns
    (a, b, (cm1, cm2), band)."""
    from famsa_tpu_torch.core.aligner import align_into
    from famsa_tpu_torch.core.dp_native import row_ranges
    from famsa_tpu_torch.core.profile import Profile
    p1 = random_profile(rng, params, n1, w1)
    p2 = random_profile(rng, params, n2, w2, 0.0)
    dest = Profile(params)
    align_into(dest, p1, p2, backend="numpy")
    a, b = Profile(params), Profile(params)
    for gs in dest.data:
        (a if len(gs.symbols) < (w1 + w2) // 2 else b).append_raw_sequence(gs)
    _, cm1 = a.condense()
    _, cm2 = b.condense()
    for prof in (a, b):
        prof.optimize_gaps()
        prof.calculate_counters_scores()
    return a, b, (cm1, cm2), row_ranges(params, cm1, cm2)


def spans_pairs(rng, params, shapes, banded, n1=4, n2=3):
    """(pairs, bands, mappings) of merges of `shapes` [(w1, w2)]: random
    profiles (profile2 ungapped, so exactly w2 wide), or guided_case's
    banded merges."""
    pairs, bands, maps = [], [], []
    for w1, w2 in shapes:
        if banded:
            a, b, cms, band = guided_case(rng, params, w1, w2)
            pairs.append((a, b))
            bands.append(band)
            maps.append(cms)
        else:
            pairs.append((random_profile(rng, params, n1, w1),
                          random_profile(rng, params, n2, w2, 0.0)))
            bands.append(None)
            maps.append(())
    return pairs, bands, maps


def diagonal_band(params, w1, w2):
    """Band rows [w1 + 2, 2] (lo, hi) of a guided merge of w1 x w2 along
    its diagonal, guided_alignment_radius columns to each side."""
    rad = params.guided_alignment_radius
    mid = np.arange(w1 + 2, dtype=np.int64) * w2 // max(w1, 1)
    return np.stack([np.clip(mid - rad, 0, w2),
                     np.clip(mid + rad, 0, w2)], axis=1)


def spans_full_check(params, rng, shapes, banded, device):
    """K2's spans variant on merges of `shapes` [(w1, w2)] (random
    profiles of 4 and 3 sequences; banded: along diagonal_band) against
    dp_plain on the card, every direction byte and per-row final, and the
    launch counted; returns (what, kernel ms, bound ms, bound by,
    dp_plain ms)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.dp_torch import (dp_dirs, dp_plain, pack_batch,
                                              prepare_merge)
    pairs, _, _ = spans_pairs(rng, params, shapes, False)
    bands = [diagonal_band(params, w1, w2) if banded else None
             for w1, w2 in shapes]
    colf, rowf, meta, total = pack_batch(
        [prepare_merge(params, a, b, bd) for (a, b), bd in zip(pairs, bands)])
    args = [torch.from_numpy(x).to(device) for x in (colf, rowf, meta)]
    what = ("banded " if banded else "") + " + ".join(
        f"{w1}x{w2}" for w1, w2 in shapes)
    before = kernels.LAUNCHES["dp_spans"]
    got = dp_dirs(*args, total, variant="spans")
    res, pms = {}, None
    if device == "cuda":
        pms = wall_ms(lambda: res.setdefault("plain",
                                             dp_plain(*args, total)))
    else:
        res["plain"] = dp_plain(*args, total)
    if device == "cuda" and kernels.LAUNCHES["dp_spans"] != before + 1:
        raise AssertionError(f"K2 spans {what}: not launched")
    if dp_max_err(got, res["plain"], meta):
        raise AssertionError(f"K2 spans {what}: differs from dp_plain")
    if device != "cuda":
        return what, None, None, None, pms
    ms = cuda_ms(lambda: dp_dirs(*args, total), 3)
    bms, by = dp_bound_ms(*args, total)
    return what, ms, bms, by, pms


def phase_k2_spans(device="cuda"):
    """K2's spans variant (csrc/dp_wide.cu:dp_profile_batched_spans, w2
    32768-131071: a merge over up to 4 clusters of 16 folds of 2048
    columns) on the card: against its fold walk (dp_staged_plain with
    span 16), dp_plain, the native host DP and K5, K4 and K6 (dp_check)
    at w2 32768, 65536 and 131071 (w1 6, plain and guided) and on a
    mixed batch of three; against dp_plain at SPANS_LONE and SPANS_BATCH,
    each plain and banded along the diagonal (spans_full_check); and its
    CUDA-event ms there beside the bound."""
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops.dp_torch import dp_dirs
    from famsa_tpu_torch.ops.dp_wide import spans_geometry
    rng = np.random.default_rng(23)
    params = Params(device=device)
    params.adjust(1000)
    walked = []
    for banded in (False, True):
        pairs, bands, maps = spans_pairs(rng, params,
                                         [(6, w2) for w2 in SPANS_WALK],
                                         banded)
        for pair, band, cms in zip(pairs, bands, maps):
            what = (f"{'banded ' if banded else ''}"
                    f"{pair[0].width}x{pair[1].width}")
            dp_check(params, [pair], [band], device, what, [cms],
                     variants=("spans",),
                     trace=True if pair[1].width <= 32768 else "native")
            walked.append(what)
    pairs, bands, maps = spans_pairs(rng, params, [(4, 33000), (6, 70000),
                                                   (8, 131071)], False)
    dp_check(params, pairs, bands, device, "mixed batch", maps,
             variants=("spans",), trace="native")
    walked.append("a batch of 4x33000, 6x70000, 8x131071")
    timed = []
    for banded in (False, True):
        for shapes in [[sh] for sh in SPANS_LONE] + [list(SPANS_BATCH)]:
            what, ms, bms, by, pms = spans_full_check(params, rng, shapes,
                                                      banded, device)
            if ms is None:
                timed.append(what)
                continue
            _, merge_spans = spans_geometry([w2 for _, w2 in shapes])
            timed.append(f"{what}: {ms:.3f} ms, bound {bms:.4f} ms ({by}), "
                         f"dp_plain {pms:.0f} ms, clusters a merge "
                         f"{merge_spans} ({[16 * c for c in merge_spans]} "
                         f"CTAs)")
    log(f"phase 3 K2 spans: bit-exact vs its fold walk and dp_plain (dirs, "
        f"finals, last, path, total) and path/total = native host DP on "
        f"{', '.join(walked)} (K5 on each, K4 and K6 vs their plain twins at "
        f"32768, K4 vs the native walk past it); vs dp_plain (every "
        f"byte and final) on " + "; ".join(timed))


# ----------------------------------------------------------------------
# K3
def wide_check(params, p1, p2, band, device, what, mapping=None,
               refs=("plain", "dp_plain"), variant=None):
    """K3 (its `variant`, default the one k3_variant picks) on one merge
    against each of refs on the same inputs ("plain": its plain version,
    the fold wavefront; "dp_plain": K2's plain version; "K2": kernel K2,
    held against its plain version in phase 3): every direction byte, the
    per-row finals, last, path and total; and path/total against the
    native host DP (guided by `mapping`).  Returns the packed inputs on
    the device and K3's and each ref's wall ms."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.dp_native import dp_profile, finish_path
    from famsa_tpu_torch.ops.dp_torch import (dp_dirs, dp_plain, pack_batch,
                                              prepare_merge)
    from famsa_tpu_torch.ops.dp_wide import (dp_dirs_wide, dp_wide_plain,
                                             k3_variant)
    variant = variant or k3_variant(p2.width)
    key = dp_key("K3", [p2.width], variant)
    fns = {"plain": lambda *a: on_host(dp_wide_plain, *a),
           "dp_plain": dp_plain, "K2": dp_dirs,
           "K3": lambda *a: dp_dirs_wide(*a, variant=variant)}
    colf, rowf, meta, total = pack_batch([prepare_merge(params, p1, p2, band)])
    args = [torch.from_numpy(x).to(device) for x in (colf, rowf, meta)]
    w1, w2 = p1.width, p2.width
    times = {}

    sides, hdr = stage0_check(params, [(p1, p2)], [band],
                              (colf, rowf, meta), device, f"K3 {what}")
    raw = {}

    def run(name):
        t0 = time.perf_counter()
        d, f = raw[name] = fns[name](*args, total)
        d, f = d.cpu().numpy(), f.cpu().numpy()
        times[name] = (time.perf_counter() - t0) * 1e3
        d = d.reshape(w1 + 1, w2 + 1)
        return d, f[0, :w1], finish_path(d, w1, w2, f[0, w1 - 1])

    before = kernels.LAUNCHES[key]
    dk, fk, rk = run("K3")
    if device == "cuda" and kernels.LAUNCHES[key] != before + 1:
        raise AssertionError(f"K3 {what}: the {variant} variant was not "
                             "launched")
    paths = k4_check(*raw.pop("K3"), args[2], f"K3 {variant} {what}", [rk])
    k6_check(sides, hdr, paths, f"K3 {variant} {what}")
    for name in refs:
        d, f, r = run(name)
        if not np.array_equal(dk, d):
            i, j = np.argwhere(dk != d)[0]
            raise AssertionError(f"K3 {variant} {what}: dirs differ from "
                                 f"{name} at ({i}, {j}): {dk[i, j]} vs "
                                 f"{d[i, j]}")
        if not np.array_equal(fk, f):
            raise AssertionError(f"K3 {variant} {what}: finals differ from "
                                 f"{name}")
        if rk.last != r.last or rk.total != r.total or \
                not np.array_equal(rk.path, r.path):
            raise AssertionError(f"K3 {variant} {what}: path/total differ "
                                 f"from {name}")
    rh = dp_profile(params, p1, p2, *(mapping or ()))
    if rh.total != rk.total or not np.array_equal(rh.path, rk.path):
        raise AssertionError(f"K3 {variant} {what}: differs from the native "
                             "host DP")
    return args, total, times


def fold_edge_widths():
    """(w2 ending on the last column of a fold, w2 one column past it,
    where fold_geometry starts a fold of one column)."""
    from famsa_tpu_torch.ops.dp_wide import fold_geometry
    for w2 in range(256, 4096):
        folds, threads, stripe = fold_geometry(w2)
        if w2 == (folds - 1) * threads * stripe and \
                fold_geometry(w2 - 1)[0] == folds - 1:
            return w2 - 1, w2
    raise AssertionError("no fold-edge width below 4096")


def scaled_params(device, shift=22):
    """Params whose scores and gap costs are scaled by 2^shift: every
    cost term and fold edge exceeds 32 bits."""
    from famsa_tpu_torch.core.params import Params
    big = Params(device=device)
    big.adjust(1000)
    big.score_matrix = big.score_matrix.astype(np.int64) << shift
    for k in ("gap_open", "gap_ext", "gap_term_open", "gap_term_ext"):
        setattr(big, k, getattr(big, k) << shift)
    return big


def phase_k3(device="cuda", lone=(400, 4000), limit=(16384, 16256),
             card_big=70000):
    """K3's variants against their plain versions and the host DP;
    returns the stand-in inputs of the stripes body for the kernel report
    (phase 3b's lone 100 x 14,000 merge)."""
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops.dp_torch import dp_dirs
    from famsa_tpu_torch.ops.dp_wide import (MAX_W2, STAGED_MAX_W2,
                                             dp_dirs_wide, fold_geometry)
    rng = np.random.default_rng(29)
    params = Params(device=device)
    params.adjust(1000)
    on_edge, past_edge = fold_edge_widths()
    cases = [("seq-prof 1 fold", (1, 150, 6, 200)),
             ("2 folds", (5, 180, 4, 400)),
             (f"w2={on_edge} on a fold edge", (4, 90, 3, on_edge)),
             (f"w2={past_edge} one past it", (4, 90, 3, past_edge)),
             (f"{lone[0]}x{lone[1]} prof-prof", (40, lone[0], 300, lone[1])),
             (f"widest 8-fold staged 300x4095", (20, 300, 10, 4095))]
    folds = []
    for what, (n1, w1, n2, w2) in cases:
        p1 = random_profile(rng, params, n1, w1, 0.0 if n1 == 1 else 0.2)
        p2 = random_profile(rng, params, n2, w2)
        folds.append(fold_geometry(w2)[0])
        args, total, _ = wide_check(params, p1, p2, None, device, what)
        if what.endswith("prof-prof"):
            lone_args = (args, total)
    # the largest K3 merge of the main path's shape (its plain versions
    # run on the runs' own largest call, in the kernel report), and a lone
    # merge of the 10,000-sequence family's shape (K4 and K6 held there)
    wide_check(params, random_profile(rng, params, 30, 3564),
               random_profile(rng, params, 40, 1334), None, device,
               "3564x1334", refs=("K2",))
    wide_check(params, random_profile(rng, params, 30, 300),
               random_profile(rng, params, 200, 3850), None, device,
               "lone 300x3850", refs=("K2",))
    a, b, cms, band = banded_case(rng, params)
    wide_check(params, a, b, band, device, "banded", cms)
    wide_check(params, random_profile(rng, params, card_big, 24, 0.1),
               random_profile(rng, params, 4, 700), None, device,
               f"card {card_big}")
    big = scaled_params(device)
    wide_check(big, random_profile(rng, big, 3, 100),
               random_profile(rng, big, 2, 3000), None, device,
               "2^22-scaled 100x3000")
    if folds[0] != 1 or folds[1] != 2 or max(folds) != 8:
        raise AssertionError(f"K3 cases cover folds {folds}, not 1, 2, 8")
    msg = (f"phase 3b K3: staged bit-exact vs its plain version and K2's "
           f"(dirs, finals, last, path, total) and path/total = native host "
           f"DP on {', '.join(w for w, _ in cases)} (folds {folds}), "
           f"3564x1334 and lone 300x3850 (= K2 and host DP), banded, "
           f"card {card_big}, 2^22-scaled 100x3000")
    # past 4095 columns: lone merges on 9-16 staged folds and on the
    # stripes body against the fold walk, K2's plain version and the host
    # DP; banded, 2^22-scaled and cardinality > 2^16 there; the limits
    # against K2 (its batched stripes entry) and the host DP
    wide = []
    for n1, w1, n2, w2 in ((1, 120, 30, 4096), (20, 80, 10, STAGED_MAX_W2),
                           (1, 100, 10, STAGED_MAX_W2 + 1),
                           (1, 100, 10, 14000), (20, 64, 10, 16256)):
        p1 = random_profile(rng, params, n1, w1, 0.0 if n1 == 1 else 0.2)
        p2 = random_profile(rng, params, n2, w2)
        args, total, t = wide_check(params, p1, p2, None, device,
                                    f"{w1}x{w2}")
        wide.append((w1, w2, fold_geometry(w2), args, total, t))
    a, b, cms, band = banded_case(rng, params, 60, 9000, split=6)
    wide_check(params, a, b, band, device, f"banded {a.width}x{b.width}",
               cms, refs=("dp_plain",))
    banded_w = (a.width, b.width)
    for w2 in (6000, 9000):
        wide_check(big, random_profile(rng, big, 3, 100),
                   random_profile(rng, big, 2, w2), None, device,
                   f"2^22-scaled 100x{w2}")
    wide_check(params, random_profile(rng, params, card_big, 24, 0.1),
               random_profile(rng, params, 4, 9000), None, device,
               f"card {card_big} x 9000")
    msg += ("; past 4095 columns bit-exact vs the plain version, K2's and "
            "the host DP: " + ", ".join(
                f"{w1}x{w2} {geo}" for w1, w2, geo, _, _, _ in wide)
            + f", banded {banded_w[0]}x{banded_w[1]} (vs K2's plain version"
            f"), 2^22-scaled 100x6000 and 100x9000, card {card_big} x 9000")
    for w1, w2 in [limit, (64, MAX_W2)]:
        _, _, t = wide_check(params, random_profile(rng, params, 4, w1),
                             random_profile(rng, params, 3, w2), None, device,
                             f"{w1}x{w2}", refs=("K2",))
        msg += (f"; {w1}x{w2} (geometry {fold_geometry(w2)}) = K2 and "
                f"host DP, call ms K3 {t['K3']:.1f} K2 {t['K2']:.1f}")
    if device == "cuda":
        args, total = lone_args
        k3 = cuda_ms(lambda: dp_dirs_wide(*args, total), 5)
        k2 = cuda_ms(lambda: dp_dirs(*args, total), 5)
        cells = lone[0] * lone[1]
        msg += (f"; lone {lone[0]}x{lone[1]}: K3 staged {k3:.3f} ms "
                f"({cells / k3 * 1e3:.4g} cells/s), K2 {k2:.3f} ms")
        for w1, w2, geo, args, total, t in wide:
            k3 = cuda_ms(lambda: dp_dirs_wide(*args, total), 5)
            bms, _ = dp_bound_ms(*args, total)
            msg += (f"; {w1}x{w2}: {k3:.3f} ms, bound {bms:.5f} ms, plain "
                    f"{t['plain']:.0f} ms")
    log(msg)
    stand = next(x for x in wide if x[1] == 14000)
    return {"dp_wide_stripes": (f"phase 3b's lone {stand[0]}x{stand[1]}",
                                (*stand[3], stand[4]))}


# ----------------------------------------------------------------------
# K4 and K6 at the edges of their windows and tiles
# the smoke's widths whose K4 windows place the edge cases: the 10,000-
# sequence family's lone wide merge, the widest merge of its largest K2
# batch, and a chain step of the variant family
EDGE_WIDTHS = ((300, 3850), (450, 891), (800, 1040))
_STEP = {0: (1, 1), 1: (0, 1), 2: (1, 0)}       # D, H, V: (di, dj)


def path_widths(path):
    """(w1, w2) of a forward path (codes 0 D, 1 H, 2 V)."""
    path = np.asarray(path)
    return int((path != 1).sum()), int((path != 2).sum())


def path_matrix(path, rng):
    """(packed direction bytes [w1+1, w2+1] uint8, last-row finals (D, H,
    V)) whose walk from (w1, w2) is the forward path `path`: row 0
    ROW0_PACK and column 0 COL0_PACK as the DP kernels write them, every
    other cell random channels in 0..2 but the channel the walk reads
    there, which names the step before."""
    from famsa_tpu_torch.ops.dp_pack import COL0_PACK, ROW0_PACK
    w1, w2 = path_widths(path)
    ch = rng.integers(0, 3, size=(3, w1 + 1, w2 + 1), dtype=np.uint8)
    i, j = w1, w2
    for k in range(len(path) - 1, -1, -1):
        d = int(path[k])
        if k >= 1 and i > 0 and j > 0:
            ch[d, i, j] = path[k - 1]
        di, dj = _STEP[d]
        i, j = i - di, j - dj
    if (i, j) != (0, 0):
        raise ValueError("the path does not end at (w1, w2)")
    m = ch[0] | (ch[1] << 2) | (ch[2] << 4)
    m[0, :] = ROW0_PACK
    m[1:, 0] = COL0_PACK
    last = [0, 0, 0]
    last[int(path[-1])] = 5
    return m, tuple(last)


def _spread(cols, rows, run):
    """Backward steps that move `cols` cells along runs of `run` (1 H, 2
    V), each run closed by a D, using at most `rows` D steps."""
    blocks = max(1, min(rows, cols // 2)) if cols else 0
    out = []
    for b in range(blocks):
        n = cols // blocks + (b < cols % blocks)
        out += [run] * (n - 1) + [0]
    return out


def _finish(back, w1, w2, rng, p_d=0.6):
    """Forward path of the backward steps `back` from (w1, w2), closed by
    a random mix of D, H and V steps down to (0, 0)."""
    i = w1 - sum(_STEP[s][0] for s in back)
    j = w2 - sum(_STEP[s][1] for s in back)
    if i < 0 or j < 0:
        raise ValueError("edge case does not fit its merge")
    nd = int(min(i, j) * p_d)
    rest = [0] * nd + [1] * (j - nd) + [2] * (i - nd)
    rng.shuffle(rest)
    return np.array(rest + back[::-1], dtype=np.uint8)


def random_path(rng, w1, w2, p_d=0.6):
    """A random forward path of a w1 x w2 merge."""
    return _finish([], w1, w2, rng, p_d)


def k4_edge_paths(w1, w2, rng):
    """[(name, forward path)]: K4's edge cases at the smoke width (w1, w2)
    (its window (R, C), anchored first at (w1, w2), spans rows
    [r0, w1] and columns [c0, w2]): random paths of w2 + 1 = C - 1, C,
    C + 1 (w1 kept) and of w1 + 1 = R - 1, R, R + 1 (w2 kept); random
    paths one below, at and one past the widest and the deepest matrix
    staged whole; on (w1, w2) itself, H runs of 31, 32 and 33 cells whose
    last cell is one column left of, on and one right of the window's
    left edge c0, V runs the same at its top edge r0 and D runs at the
    nearer edge; an all-H top row (the path's first C + 40 steps H) and an
    all-V first column."""
    from famsa_tpu_torch.ops.traceback_torch import (TB_WINDOW_BYTES,
                                                     row_stride,
                                                     window_shape)
    r, c = window_shape(w1, w2)
    out = []
    for cols in (c - 1, c, c + 1):
        out.append((f"{w1}x{cols - 1} (C{cols - c:+d})",
                    random_path(rng, w1, cols - 1)))
    for rows in (r - 1, r, r + 1):
        out.append((f"{rows - 1}x{w2} (R{rows - r:+d})",
                    random_path(rng, rows - 1, w2)))
    fit_c = max(k for k in range(1, w2 + 2)
                if (w1 + 1) * row_stride(k) <= TB_WINDOW_BYTES)
    fit_r = TB_WINDOW_BYTES // row_stride(w2 + 1)
    for cols in (fit_c - 1, fit_c, fit_c + 1):
        out.append((f"{w1}x{cols - 1} (whole fits to {fit_c})",
                    random_path(rng, w1, cols - 1)))
    for rows in (fit_r - 1, fit_r, fit_r + 1):
        if rows >= 2:
            out.append((f"{rows - 1}x{w2} (whole fits to {fit_r})",
                        random_path(rng, rows - 1, w2)))
    r0, c0 = max(0, w1 - r + 1), max(0, w2 - c + 1)
    # the steps before a run stay inside the first window
    for run, edge, name in ((1, c0, "H"), (2, r0, "V")):
        for length in (31, 32, 33):
            for delta in (-1, 0, 1):
                last = edge + delta         # the run's last cell
                first = last + length - 1
                if run == 1:                # reach column first, by a D
                    back = _spread(w2 - first - 1, min(w1 // 2, r - 3), 1)
                else:
                    back = _spread(w1 - first - 1, min(w2 // 2, c - 3), 2)
                back += [0] + [run] * length + [0]
                out.append((f"{name} run of {length} ending at "
                            f"{'c0' if run == 1 else 'r0'}{delta:+d}",
                            _finish(back, w1, w2, rng)))
    cols_first = w2 - c0 < w1 - r0
    edge = c0 if cols_first else r0
    for length in (31, 32, 33):
        for delta in (-1, 0, 1):
            last = edge + delta
            first = last + length - 1
            # reach the run's first cell by an H (a V), then a D run of
            # `length` cells closed by a V (an H)
            if cols_first:
                back = _spread(w2 - first - 1, r - length - 5, 1) + [1]
            else:
                back = _spread(w1 - first - 1, c - length - 5, 2) + [2]
            back += [0] * length + [2 if cols_first else 1]
            out.append((f"D run of {length} ending at "
                        f"{'c0' if cols_first else 'r0'}{delta:+d}",
                        _finish(back, w1, w2, rng)))
    top = min(w2 - 1, c + 40)
    out.append(("all-H top row",
                np.array([1] * top + list(random_path(rng, w1, w2 - top)),
                         dtype=np.uint8)))
    left = min(w1 - 1, r + 40)
    out.append(("all-V first column",
                np.array([2] * left + list(random_path(rng, w1 - left, w2)),
                         dtype=np.uint8)))
    return out


def k6_edge_paths(rng):
    """[(name, forward path)]: K6's edge cases at its tile of T =
    MERGED_TILE steps: path lengths T - 1, T, T + 1 and 2T + 1; an H run
    and a V run that straddle a tile boundary; runs that start on a
    tile's first step (after a D, and right after the other side's run);
    a path of one long H run across three tiles."""
    from famsa_tpu_torch.ops.merged_torch import MERGED_TILE as T
    out = []
    for n in (T - 1, T, T + 1, 2 * T + 1):
        p = np.zeros(n, dtype=np.uint8)
        p[rng.random(n) < 0.3] = 1
        p[rng.random(n) < 0.2] = 2
        p[0] = 0
        out.append((f"length {n}", p))
    for code, name in ((1, "H"), (2, "V")):
        p = rng.choice(3, size=2 * T + 40, p=[0.6, 0.2, 0.2]).astype(np.uint8)
        p[T - 20:T + 20] = code
        p[T - 21] = p[T + 20] = 0
        out.append((f"{name} run straddling step {T}", p))
        p = rng.choice(3, size=2 * T + 40, p=[0.6, 0.2, 0.2]).astype(np.uint8)
        p[T - 1], p[T:T + 7] = 0, code
        out.append((f"{name} run starting on step {T} after a D", p))
        p = p.copy()
        p[T - 3:T] = 3 - code
        out.append((f"{name} run starting on step {T} after the other "
                    "side's run", p))
    p = np.concatenate([[0, 2, 0], np.full(3 * T, 1), [2, 0]]).astype(np.uint8)
    out.append((f"H run of {3 * T} steps", p))
    return out


def edge_batch(paths, rng, device):
    """(dirs, fin, meta) on the device of a batch of merges whose walks
    are the forward paths, and the native trace_path of each."""
    import torch
    from famsa_tpu_torch.core.dp_native import finish_path
    mats, fins, meta, natives, off = [], [], [], [], 0
    for p in paths:
        m, last = path_matrix(p, rng)
        w1, w2 = path_widths(p)
        mats.append(m.reshape(-1))
        fins.append(last)
        meta.append((w1, w2, off, 0))
        natives.append(finish_path(m, w1, w2, last))
        off += m.size
    meta = np.array(meta, dtype=np.int64)
    fin = np.zeros((len(paths), int(meta[:, 0].max()), 3), dtype=np.int64)
    for k, last in enumerate(fins):
        fin[k, meta[k, 0] - 1] = last
    return ([torch.from_numpy(x).to(device)
             for x in (np.concatenate(mats), fin, meta)], natives)


def phase_edges(device="cuda"):
    """K4 and K6 on their edge cases (k4_edge_paths at each of
    EDGE_WIDTHS, k6_edge_paths): a batch of merges a set, their direction
    bytes made from the paths (path_matrix), K4 against its plain twin
    and the native trace_path, then K6 on K4's buffer against its plain
    twin with smax a tile past the longest path, the sides random
    profiles of the merges' widths (side 1 of the first merge a leaf)."""
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops.merged_torch import MERGED_TILE
    from famsa_tpu_torch.ops.traceback_torch import window_shape
    rng = np.random.default_rng(41)
    params = Params(device=device)
    params.adjust(1000)
    sets = [(f"{w1}x{w2} (window {window_shape(w1, w2)})",
             k4_edge_paths(w1, w2, rng)) for w1, w2 in EDGE_WIDTHS]
    sets.append((f"K6 tile {MERGED_TILE}", k6_edge_paths(rng)))
    counts = []
    for what, cases in sets:
        (dirs, fin, meta), natives = edge_batch([p for _, p in cases], rng,
                                                device)
        paths = k4_check(dirs, fin, meta, f"edges {what}", natives)
        meta_h = meta.cpu().numpy()
        pairs = [(random_profile(rng, params, 1 if k == 0 else 3, w1,
                                 0.0 if k == 0 else 0.2),
                  random_profile(rng, params, 2, w2))
                 for k, (w1, w2, _, _) in enumerate(meta_h)]
        hdr, _, sides = launch_inputs(params, pairs, [None] * len(pairs),
                                      meta_h, device)
        k6_check(sides, hdr, paths, f"edges {what}",
                 smax=int((meta_h[:, 0] + meta_h[:, 1]).max()) + MERGED_TILE)
        counts.append(f"{what}: {len(cases)}")
    log("phase 3c K4/K6 edges: K4 bit-exact vs trace_paths_plain and the "
        "native trace_path, K6 vs merged_from_paths_plain, on "
        + "; ".join(counts) + " merges")


# ----------------------------------------------------------------------
# main path
def read_stats(path):
    st = {}
    with open(path) as f:
        for line in f:
            if "=" in line:
                k, v = line.strip().split("=", 1)
                st[k] = v
    return st


def run_cli(args, env):
    """famsa_tpu_torch's CLI entry point in this process, with env knobs
    set for the call; returns (rc, seconds)."""
    from famsa_tpu_torch.cli import main
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        rc = main(list(args))
        return rc, time.perf_counter() - t0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def stage_report(name, secs, stats, counts):
    st = read_stats(stats)
    return (f"{name}: {secs:.2f} s (tree {float(st['time.tree_build']):.2f}, "
            f"alignment {float(st['time.alignment']):.2f}, refinement "
            f"{float(st['time.refinement']):.2f}), launches K1 rows "
            f"{counts['lcs']} wave {counts['lcs_wave']} K2 staged "
            f"{counts['dp_staged']} staged16 {counts['dp_staged16']} stripes "
            f"{counts['dp_stripes']} spans {counts['dp_spans']} K3 staged "
            f"{counts['dp_wide']} staged16 {counts['dp_wide16']} stripes "
            f"{counts['dp_wide_stripes']} K4 {counts['traceback']} K5 "
            f"{counts['stage0']} K6 {counts['merged']} K8 "
            f"{counts['prim_round']} K9 {counts['lcs_refmask']}")


def numpy_report(stats, waited):
    """A numpy reference run's stage seconds from its -stats file."""
    st = read_stats(stats)
    return (f"numpy (a child process): {float(st['time.total']):.2f} s (tree "
            f"{float(st['time.tree_build']):.2f}, alignment "
            f"{float(st['time.alignment']):.2f}, refinement "
            f"{float(st['time.refinement']):.2f}; waited {waited:.1f} s for "
            f"it)")


def check_launches(what, counts, needed, rec):
    """Each run must launch the kernels it is meant to exercise.  A run
    that builds the default guide tree ("prim_round" in needed) runs n-1
    Prim rounds for the n sequences of its one device Prim (rec.prim_n),
    each one launch of K1's wave variant and one of K8, and nothing else
    of K1; every K2 launch and K3 call must have gone to the variant
    its widest w2 selects (dp_key: staged on up to 8 folds to 4095,
    on 9-16 folds to 8191, stripes to 32767, K2 spans past it; rec holds
    the widths of the run's K2 and K3 calls).  A Prim tree of a family
    with a flagged sequence (rec.prim_flagged) launches K9 once a round
    too, one of none launches no K9 in its rounds."""
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} were never "
                             f"launched: {counts}")
    if "prim_round" in needed:
        rounds = [n - 1 for n in rec.prim_n]
        k9 = rounds[0] if rec.prim_flagged == [True] else 0
        if len(rounds) != 1 or counts["lcs"] or not (
                counts["lcs_wave"] == counts["prim_round"] == rounds[0]) \
                or counts["lcs_refmask"] != k9:
            raise AssertionError(f"{what}: device Prim rounds {rounds}, "
                                 f"launches of K1 rows {counts['lcs']}, K1 "
                                 f"wave {counts['lcs_wave']}, K8 "
                                 f"{counts['prim_round']}, K9 "
                                 f"{counts['lcs_refmask']} (flagged "
                                 f"{rec.prim_flagged})")
    for name, calls, keys in (("K2", rec.k2_calls, K2_KEYS),
                              ("K3", rec.wide_calls, K3_KEYS)):
        want = dict.fromkeys(keys, 0)
        for w2 in calls:
            want[dp_key(name, [w2])] += 1
        if want != {k: counts[k] for k in keys}:
            raise AssertionError(f"{what}: {name} calls by variant "
                                 f"{want}, launches {counts}")


class ResidencyWatch:
    """Watches the device DP route of the main path, apart from the
    route's own counters (kernels.TRAFFIC): it records every profile the
    pipeline's construct built from a device result with merged counters
    and, at each dispatch of the route, counts the sides that are such a
    profile with its host counters unchanged (the sides that must be read
    resident), the path bytes the route may copy down (16 + w1 + w2 a
    merge), the direction bytes the host-prep route copied down
    ((w1+1)(w2+1)) and the dispatches that ask for merged counters.
    Every dispatch runs under torch.cuda.set_sync_debug_mode("error"), so
    a host read of a device tensor inside it fails the run.  While
    `check` is set it holds every device merge's resident counters
    against the host counters construct made; while `profile` is set
    (skip, count) it runs `count` dispatches after the first `skip` under
    torch.profiler and keeps their device operations (ops)."""

    def __init__(self):
        import torch
        import famsa_tpu_torch.pipeline as pipeline
        from famsa_tpu_torch.ops import dp_torch, dp_wide
        self.check = False
        self.profile = None
        self.ops = []
        self.reset()
        orig_construct = pipeline.construct_profile
        orig_k2 = dp_torch.dp_profile_torch_paths_async
        orig_k3 = dp_wide.dp_profile_torch_wide_paths_async

        def construct(dest, p1, p2, res):
            out = orig_construct(dest, p1, p2, res)
            md = getattr(res, "merged_dev", None)
            if md is not None:
                self.produced[id(dest)] = (dest, dest.counters)
                if self.check:
                    got = md.tensor().cpu().numpy()
                    if not np.array_equal(got, dest.counters):
                        raise AssertionError(
                            f"resident counters of a {dest.width}-column "
                            "merge differ from the host construct's")
                    self.checked += 1
            return out

        def resident(p):
            seen = self.produced.get(id(p))
            return seen is not None and seen[0] is p \
                and seen[1] is p.counters

        def note(pairs, kw):
            for p1, p2 in pairs:
                self.expected += resident(p1) + resident(p2)
                self.bound += p1.width + p2.width + 17
                self.dense += (p1.width + 1) * (p2.width + 1)
                self.merges += 1
            self.merged += bool(kw.get("want_merged"))
            self.dispatches += 1

        def strict(fn, *a, **kw):
            """fn inside a window where a host read of a device tensor
            raises."""
            if not torch.cuda.is_available():
                return fn(*a, **kw)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        def dispatch(fn, *a, **kw):
            skip, count = self.profile or (0, 0)
            if not skip < self.dispatches <= skip + count:
                return strict(fn, *a, **kw)
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # a session after the first in a process may drop its
                # first one or two device records: two spin kernels, not
                # counted, open the window on an idle device
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                out = strict(fn, *a, **kw)
                torch.cuda.synchronize()
            self.ops.append([e.name for e in prof.events()
                             if e.device_type == DeviceType.CUDA
                             and "spin_kernel" not in e.name])
            return out

        def k2(params, pairs, *a, **kw):
            note(pairs, kw)
            return dispatch(orig_k2, params, pairs, *a, **kw)

        def k3(params, p1, p2, *a, **kw):
            note([(p1, p2)], kw)
            return dispatch(orig_k3, params, p1, p2, *a, **kw)

        pipeline.construct_profile = construct
        dp_torch.dp_profile_torch_paths_async = k2
        dp_wide.dp_profile_torch_wide_paths_async = k3

    def reset(self):
        self.produced = {}
        self.expected = self.bound = self.dense = 0
        self.merges = self.checked = self.merged = self.dispatches = 0

    def verify(self, what, counts, traffic):
        """Every device merge's planes came from K5 and its path from K4,
        every merged-counter dispatch's counters from K6, only paths came
        down, and exactly the sides a device merge produced were
        resident."""
        dp = sum(counts[k] for k in DP_KEYS)
        if dp != self.dispatches:
            raise AssertionError(f"{what}: {dp} K2 launches and K3 calls "
                                 f"for {self.dispatches} dispatches")
        for key, name in (("traceback", "K4"), ("stage0", "K5")):
            if counts[key] != dp:
                raise AssertionError(f"{what}: {counts[key]} {name} launches"
                                     f" for {dp} K2 launches and K3 calls")
        if counts["merged"] != self.merged:
            raise AssertionError(f"{what}: {counts['merged']} K6 launches "
                                 f"for {self.merged} dispatches that want "
                                 "merged counters")
        if not 0 < traffic["bytes_down"] <= self.bound:
            raise AssertionError(f"{what}: {traffic['bytes_down']} bytes "
                                 f"down, bound {self.bound}")
        if traffic["sides_resident"] != self.expected:
            raise AssertionError(f"{what}: {traffic['sides_resident']} "
                                 f"resident sides, {self.expected} produced "
                                 "on the device")

    def report(self, traffic, peak):
        t = traffic
        return (f"DP route: {self.merges} device merges in "
                f"{self.dispatches} dispatches ({self.merged} with merged "
                f"counters, every one free of host reads), bytes down "
                f"{t['bytes_down']} (bound sum(w1+w2+17) {self.bound}; dense "
                f"direction bytes {self.dense}), bytes up {t['bytes_up']}, "
                f"sides resident {t['sides_resident']} (produced on the "
                f"device {self.expected}) leaf {t['sides_leaf']} uploaded "
                f"{t['sides_uploaded']}, resident = host counters on "
                f"{self.checked} merges, peak device memory "
                f"{peak / 2 ** 20:.1f} MiB")


# the kernels the default 1000-sequence run must launch: K1's wave variant
# (the guide tree's Prim rounds), K2's staged variant (merges ready
# together) and K3's staged variant (lone merges and refinement's guided
# re-alignments, at the default FAMSA_TORCH_WIDE_MIN_CELLS)
DEFAULT_KERNELS = ("lcs_wave", "prim_round", "dp_staged", "dp_wide")


def run_torch(name, flags, env, recorder, watch, run, check, device):
    """One CLI run of the port on the main path, its kernel counts reset
    just before and read just after; returns (rc, seconds, counts, route
    line).  The torch runs' device DP route is held to ResidencyWatch."""
    import torch
    from famsa_tpu_torch import kernels
    watch.reset()
    watch.check = check
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    recorder.start(run)
    kernels.reset_launches()
    rc, secs = run_cli(flags, env)
    counts, traffic = dict(kernels.LAUNCHES), dict(kernels.TRAFFIC)
    recorder.stop(counts)
    watch.check = False
    if rc != 0 or "-backend" not in flags or "torch" not in flags:
        return rc, secs, counts, ""
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        watch.verify(f"{name}", counts, traffic)
    return rc, secs, counts, "; " + watch.report(traffic, peak)


def short_name(name):
    """A device operation's name without namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip() or name


def ops_report(ops):
    """The device operations of the profiled dispatches: their count a
    dispatch and the names of the first one's."""
    if not ops:
        return ""
    counts = [len(o) for o in ops]
    return (f"; device operations a dispatch (torch.profiler, "
            f"{len(ops)} dispatches): {counts}, the first: "
            f"{[short_name(n) for n in ops[0]]}")


def phase_main(work, recorder, watch, refs, device="cuda"):
    """The main path as a user runs it, against its numpy reference run
    ("main" of refs); the recorder times every kernel launch of the
    default torch run ("1000"); every device merge's resident counters are
    held against the host's."""
    n, mean_len, _ = MAIN_FAMILY
    fa = os.path.join(work, "fam.fa")
    torch_flags = ["-backend", "torch", "-device", device]
    runs = [("torch", torch_flags, {}, DEFAULT_KERNELS),
            ("torch_k2", torch_flags, {"FAMSA_TORCH_DP_MIN_CELLS": "0",
                                       "FAMSA_TORCH_WIDE_MIN_CELLS": "1e30"},
             ("lcs_wave", "prim_round", "dp_staged")),
            ("torch_k3", torch_flags, {"FAMSA_TORCH_DP_MIN_CELLS": "0",
                                       "FAMSA_TORCH_WIDE_MIN_CELLS": "0",
                                       "FAMSA_TORCH_MAX_BATCH": "1"},
             ("lcs_wave", "prim_round", "dp_wide"))]
    outs, report = {}, []
    for name, flags, env, needed in runs:
        out = os.path.join(work, f"out_{name}.fa")
        stats = os.path.join(work, f"stats_{name}.txt")
        # the forced runs profile four dispatches each, after the first ten
        watch.profile = (10, 4) if device == "cuda" and name in (
            "torch_k2", "torch_k3") else None
        watch.ops = []
        rc, secs, counts, route = run_torch(
            f"main path {name}", flags + ["-stats", stats, fa, out], env,
            recorder, watch, "1000" if name == "torch" else None, True,
            device)
        watch.profile = None
        if rc != 0:
            raise AssertionError(f"main path {name}: rc={rc}")
        with open(out, "rb") as f:
            outs[name] = f.read()
        report.append(stage_report(name, secs, stats, counts) + route
                      + ops_report(watch.ops))
        if device == "cuda":
            check_launches(f"main path {name}", counts, needed, recorder)
    waited = refs.wait("main")
    with open(os.path.join(work, "out_numpy.fa"), "rb") as f:
        outs["numpy"] = f.read()
    report.append(numpy_report(os.path.join(work, "stats_numpy.txt"),
                               waited))
    for name in ("torch", "torch_k2", "torch_k3"):
        if outs[name] != outs["numpy"]:
            raise AssertionError(f"main path: {name} output differs from "
                                 "numpy")
    log(f"phase 4 main path ({n} seqs, mean len {mean_len}, refinement "
        f"on): torch, torch_k2 and torch_k3 byte-identical to numpy; "
        + "; ".join(report))


# phase 5's -gt_export runs: name, flags
TREE_CASES = (("tree", []), ("dist", ["-dist", "indel_div_lcs"]))


def phase_tree(work, recorder, refs, device="cuda", chunk=300):
    """-gt_export of TREE_FAMILY, torch against its numpy reference runs
    (TREE_CASES, in refs): with a Prim chunk small enough to cross chunk
    boundaries, and under -dist indel_div_lcs, whose host Prim reads
    distance rows from TorchDistanceBackend (at n >= 2000 a first block of
    256 references on K1's rows variant, then single rows on its wave
    variant); the recorder times that run's launches ("dist")."""
    from famsa_tpu_torch import kernels
    n = TREE_FAMILY[0]
    fa = os.path.join(work, "fam_tree.fa")
    env = {"tree": {"FAMSA_TORCH_PRIM_CHUNK": str(chunk)}, "dist": {}}
    msg, extra_msg = [], ""
    for what, extra in TREE_CASES:
        outs, secs = {}, {}
        out = os.path.join(work, f"{what}_torch.dnd")
        recorder.start("dist" if what == "dist" else None)
        kernels.reset_launches()
        rc, secs["torch"] = run_cli(["-backend", "torch", "-device", device]
                                    + extra + ["-gt_export", fa, out],
                                    env[what])
        counts = dict(kernels.LAUNCHES)
        recorder.stop(counts)
        if rc != 0:
            raise AssertionError(f"gt_export {what} torch: rc={rc}")
        if device == "cuda":
            if what == "dist":
                check_launches("gt_export -dist indel_div_lcs", counts,
                               ("lcs",), recorder)
            else:
                check_launches(f"gt_export Prim chunk {chunk}", counts,
                               ("lcs_wave", "prim_round"), recorder)
                extra_msg = (f" (launches: K1 wave {counts['lcs_wave']}"
                             f", K8 {counts['prim_round']})")
        refs.wait(what)
        secs["numpy"] = float(read_stats(os.path.join(
            work, f"{what}_numpy.st"))["time.total"])
        for name in ("torch", "numpy"):
            with open(os.path.join(work, f"{what}_{name}.dnd"), "rb") as f:
                outs[name] = f.read()
        if outs["torch"] != outs["numpy"]:
            raise AssertionError(f"gt_export {what}: torch tree differs "
                                 "from numpy")
        msg.append(f"{n} seqs {' '.join(extra) or f'Prim chunk {chunk}'}:"
                   f" torch {secs['torch']:.2f} s, numpy {secs['numpy']:.2f} s"
                   + ("" if extra else extra_msg))
    log("phase 5 guide tree (-gt_export), torch byte-identical to numpy "
        "(child processes): " + "; ".join(msg) + f"; K1 launches of the -dist run: rows "
        f"{recorder.counts['dist']['lcs']} wave "
        f"{recorder.counts['dist']['lcs_wave']}")


# phase 5b's runs of the poly-Q family: name, flags, output's extension
POLYQ_RUNS = (("polyq", ["-refine_mode", "off"], ".fa"),
              ("polyq_tree", ["-gt_export"], ".dnd"),
              ("polyq_dist", ["-dist_export"], ".csv"))


def phase_polyq(work, recorder, watch, refs, device="cuda"):
    """Phase 5b: the poly-Q family (POLYQ_FAMILY, make_polyq: every 10th
    sequence with a poly-Q tract of 64-200 residues) through the CLI
    entry point with -backend torch, refinement off: aligned (its
    launches recorded as "polyq": K1 wave, K9 and K8 once a Prim round;
    the device DP route held to ResidencyWatch), -gt_export and
    -dist_export (recorded as "polyq_dist": K1 for unflagged references,
    K9 for flagged ones); each byte-identical to its -backend numpy
    child's output (POLYQ_RUNS, in refs)."""
    import torch
    from famsa_tpu_torch import kernels
    n, mean_len, _ = POLYQ_FAMILY
    fa = os.path.join(work, "polyq.fa")
    torch_flags = ["-backend", "torch", "-device", device]
    report = []
    for name, flags, ext in POLYQ_RUNS:
        args = torch_flags + flags + [fa, os.path.join(
            work, f"{name}_torch{ext}")]
        if name == "polyq":
            rc, secs, counts, _ = run_torch(
                "5b poly-Q alignment", args, {}, recorder, watch, name,
                False, device)
        else:
            recorder.start(name if name == "polyq_dist" else None)
            kernels.reset_launches()
            rc, secs = run_cli(args, {})
            counts = dict(kernels.LAUNCHES)
            recorder.stop(counts)
        if rc != 0:
            raise AssertionError(f"5b {name}: rc={rc}")
        if device == "cuda":
            if name == "polyq_dist":
                if not counts["lcs_refmask"] or not (
                        counts["lcs"] + counts["lcs_wave"]):
                    raise AssertionError(f"5b {name}: launches {counts}")
            else:
                check_launches(f"5b {name}", counts,
                               ("lcs_wave", "prim_round", "lcs_refmask"),
                               recorder)
        report.append(f"{name} {secs:.2f} s (K1 rows {counts['lcs']}, "
                      f"wave {counts['lcs_wave']}, K9 "
                      f"{counts['lcs_refmask']}, K8 "
                      f"{counts['prim_round']})")
    refs.wait(*(name for name, _, _ in POLYQ_RUNS))
    for name, flags, ext in POLYQ_RUNS:
        with open(os.path.join(work, f"{name}_torch{ext}"), "rb") as f:
            got = f.read()
        with open(os.path.join(work, f"{name}_numpy{ext}"), "rb") as f:
            if got != f.read():
                raise AssertionError(f"5b {name}: torch output differs from "
                                     "the numpy child's")
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"phase 5b poly-Q family ({n} seqs, mean len {mean_len}, every 10th "
        f"with a poly-Q tract of 64-200), torch byte-identical to a numpy "
        f"child: " + "; ".join(report))


# phase 5f: a family with one sequence past 65,536 residues (sequences,
# mean length, seed of make_family; the long sequence's residues).  The
# family is cut from 200 sequences to LONG_FAMILY[0]: its -backend numpy
# references pad every sequence to the longest and walk 1025 words a
# position, ~11 s a distance row, so a tree of 200 would take a child ~36
# min of CPU (~55 s at 30); the children of phases 4-8 share 4 cores and
# phase 7 waits for the last of them
LONG_FAMILY = (16, 300, 19)
LONG_RESIDUES = 65537
# its runs: name, flags, output's extension (the alignment at its
# defaults, refinement on)
LONG_RUNS = (("long", [], ".fa"),
             ("long_tree", ["-gt_export"], ".dnd"),
             ("long_dist", ["-dist_export"], ".csv"))
# K1 wave's query words and K9's reference words past one warp's segment
# held bit-exact: the first word past it (masks staged) and a width whose
# masks stay in global memory
LONG_K1_WORDS = (2049, 8192)
LONG_K9_WORDS = (1025, 4096)


def make_long(n, mean_len, seed, length=LONG_RESIDUES):
    """FASTA text: make_family(n, mean_len, seed) and one sequence of
    `length` residues, random from seed + 1 with a tract of 200
    glutamines from position 1000 (whole 64-position words of one
    residue: a flagged reference, K9).  At 65,537 residues its 64-bit
    word 1024 holds one residue, and every query table of the family is
    2049 32-bit words wide."""
    rng = np.random.default_rng(seed + 1)
    seq = np.array(list(AA))[rng.integers(0, 20, size=length)]
    seq[1000:1200] = "Q"
    return make_family(n, mean_len, seed) + f">long_{length}\n{''.join(seq)}\n"


# phase 5c's profile-profile run: profile1 of PROFPROF_1 sequences of
# the first width, profile2 of PROFPROF_2 of the second
PROFPROF = (1500, 40000)
PROFPROF_1, PROFPROF_2 = 4, 12


def make_profiles(seed=41):
    """FASTA texts of two aligned profiles of PROFPROF's widths:
    profile1 four close variants of one sequence (few symbols a column),
    profile2 twelve unrelated sequences with 5 % gaps (many symbols a
    column), so that align_into keeps profile2 as the DP's columns."""
    rng = np.random.default_rng(seed)
    aa = np.array(list(AA))
    w1, w2 = PROFPROF
    base = rng.integers(0, 20, size=w1)
    out1 = []
    for k in range(PROFPROF_1):
        seq = base.copy()
        mut = rng.random(w1) < 0.05
        seq[mut] = rng.integers(0, 20, size=int(mut.sum()))
        out1.append(f">pa{k}\n{''.join(aa[seq])}\n")
    out2 = []
    for k in range(PROFPROF_2):
        row = aa[rng.integers(0, 20, size=w2)]
        row[rng.random(w2) < 0.05] = "-"
        out2.append(f">pb{k}\n{''.join(row)}\n")
    return "".join(out1), "".join(out2)


def profprof_argv(work, side):
    """Phase 5c's CLI arguments, writing profprof_{side}.fa."""
    return ["-refine_mode", "off", os.path.join(work, "prof1.fa"),
            os.path.join(work, "prof2.fa"),
            os.path.join(work, f"profprof_{side}.fa")]


def phase_profprof(work, recorder, watch, refs, device="cuda"):
    """Phase 5c: profile-profile mode (pipeline.align_profiles) on a
    PROFPROF[0] x PROFPROF[1] merge through the CLI entry point, refinement
    off: -backend torch (recorded as "profprof": one K2 launch on its
    spans variant, B = 1, K3 refusing the width) byte-identical to its
    -backend numpy child ("profprof" in refs)."""
    rc, secs, counts, route = run_torch(
        "5c profile-profile", ["-backend", "torch", "-device", device]
        + profprof_argv(work, "torch"), {}, recorder, watch, "profprof",
        False, device)
    if rc != 0:
        raise AssertionError(f"5c profile-profile: rc={rc}")
    np_wait = refs.wait("profprof")
    if device == "cuda" and not (counts["dp_spans"] == counts["stage0"] ==
                                 counts["traceback"] == 1):
        raise AssertionError(f"5c profile-profile: launches {counts}")
    with open(os.path.join(work, "profprof_torch.fa"), "rb") as f:
        got = f.read()
    with open(os.path.join(work, "profprof_numpy.fa"), "rb") as f:
        if got != f.read():
            raise AssertionError("5c profile-profile: torch output differs "
                                 "from the numpy child's")
    log(f"phase 5c profile-profile {PROFPROF[0]}x{PROFPROF[1]} columns "
        f"({PROFPROF_1} and {PROFPROF_2} sequences, refinement off): torch "
        f"{secs:.2f} s, byte-identical to a numpy child (waited "
        f"{np_wait:.2f} s more for it); K2 spans {counts['dp_spans']}, K5 "
        f"{counts['stage0']}, K4 {counts['traceback']}{route}")


# phase 5d's meshes: shards on one card, each on a stream of its own
MESH_SIZES = (4, 3)
MESH_ROUNDS = 256        # the rounds timed for the host's ms a round


def sharded_launch_check(what, counts, n, size, flagged):
    """A sharded Prim tree of n sequences on `size` shards launches, a
    round, K1 wave once a shard, K9 once a shard when the family has a
    flagged sequence (none otherwise), K8 once, and no K1 rows."""
    want = {"lcs": 0, "lcs_wave": size * (n - 1),
            "lcs_refmask": size * (n - 1) if flagged else 0,
            "prim_round": n - 1}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def round_split(issue, k):
    """(host ms a round to issue k rounds, ms a round to the device's
    end) of issue(), which issues k Prim rounds on an idle device."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    issue()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / k, (t2 - t0) * 1e3 / k


def phase_mesh(work, recorder, refs, device="cuda"):
    """Phase 5d: the row axis of multi-device sharding (parallel/) on
    meshes of MESH_SIZES shards on one card, each shard on its own
    stream, so every launch, copy and cross-stream wait of the route runs
    (copies between distinct cards do not).  auto_mesh gives no mesh on
    one card; then a mesh is set in its cache and the CLI entry point
    runs, with -backend torch: phase 5's -gt_export of its 2000
    sequences with a Prim chunk that crosses boundaries, byte-identical to
    the numpy tree phase 5 wrote (S x (n - 1) K1 wave, n - 1 K8 launches);
    phase 5b's poly-Q family's -gt_export (K9 on every shard, S x (n - 1)
    launches) and -dist_export (ShardedDistanceBackend, K1 and K9),
    byte-identical to 5b's numpy child's outputs, and its -gt upgma
    -gt_export, byte-identical to its -backend numpy child ("mesh_upgma"
    in refs).  The
    sharded trees' seconds (the CLI's time.tree_build) beside the
    2000-sequence tree built on one card's route, and the host's ms a
    round to issue MESH_ROUNDS rounds against their ms to the device's
    end: on one card these measure the route's overhead, not a
    multi-GPU speed."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.lcs_torch import BV32, famsa_flags, pad_sequences
    from famsa_tpu_torch.ops.prim_torch import (PrimState, mst_prim_tree_torch,
                                                prim_chunk, prim_inputs)
    from famsa_tpu_torch.parallel import dist_sharded, mesh
    mesh._AUTO_MESH.clear()
    if mesh.auto_mesh("rows", device) is not None:
        raise AssertionError("5d: auto_mesh gave a mesh on one card")
    fam = os.path.join(work, "fam_tree.fa")
    polyq = os.path.join(work, "polyq.fa")
    upgma_ref = os.path.join(work, "mesh_upgma_numpy.dnd")
    refs.wait("mesh_upgma")
    np_secs = float(read_stats(upgma_ref + ".st")["time.total"])
    # (name, input, flags, env, reference, a Prim tree of a flagged family)
    runs = (("tree", fam, ["-gt_export"], {"FAMSA_TORCH_PRIM_CHUNK": "300"},
             os.path.join(work, "tree_numpy.dnd"), False),
            ("polyq_tree", polyq, ["-gt_export"], {},
             os.path.join(work, "polyq_tree_numpy.dnd"), True),
            ("polyq_dist", polyq, ["-dist_export"], {},
             os.path.join(work, "polyq_dist_numpy.csv"), None),
            ("polyq_upgma", polyq, ["-gt", "upgma", "-gt_export"], {},
             upgma_ref, None))
    trees, blocks = [], [0]
    orig_tree = dist_sharded.mst_prim_tree_sharded
    backend = dist_sharded.TorchDistanceBackend
    orig_block = backend._lcs_block

    def tree(sequences, *a, **kw):
        trees.append(len(sequences))
        return orig_tree(sequences, *a, **kw)

    def block(self, *a, **kw):
        blocks[0] += isinstance(self, dist_sharded.ShardedDistanceBackend)
        return orig_block(self, *a, **kw)

    report, tree_secs = [], []
    dist_sharded.mst_prim_tree_sharded = tree
    backend._lcs_block = block
    try:
        for size in MESH_SIZES:
            mesh._AUTO_MESH["rows"] = mesh.make_mesh([f"{device}:0"] * size)
            for name, fa, flags, env, ref, flagged in runs:
                out = os.path.join(work, f"mesh{size}_{name}")
                stats = out + ".stats"
                trees.clear()
                blocks[0] = 0
                recorder.start(None)
                kernels.reset_launches()
                rc, secs = run_cli(["-backend", "torch", "-device", device,
                                    "-stats", stats] + flags + [fa, out],
                                   env)
                counts = dict(kernels.LAUNCHES)
                recorder.stop(counts)
                what = f"5d {name} on {size} shards"
                if rc != 0:
                    raise AssertionError(f"{what}: rc={rc}")
                with open(out, "rb") as f, open(ref, "rb") as g:
                    if f.read() != g.read():
                        raise AssertionError(f"{what}: output differs from "
                                             "numpy's")
                if flagged is None:
                    if trees or not blocks[0] or counts["prim_round"] or \
                            not counts["lcs_refmask"]:
                        raise AssertionError(f"{what}: sharded trees {trees},"
                                             f" row blocks {blocks[0]}, "
                                             f"launches {counts}")
                else:
                    if len(trees) != 1:
                        raise AssertionError(f"{what}: sharded trees {trees}")
                    sharded_launch_check(what, counts, trees[0], size,
                                         flagged)
                if name == "tree":
                    build = float(read_stats(stats)["time.tree_build"])
                    tree_secs.append(f"{size} shards {build:.3f} s")
                report.append(
                    f"{name} S={size} {secs:.2f} s (K1 rows {counts['lcs']} "
                    f"wave {counts['lcs_wave']}, K9 {counts['lcs_refmask']}, "
                    f"K8 {counts['prim_round']})")
    finally:
        dist_sharded.mst_prim_tree_sharded = orig_tree
        backend._lcs_block = orig_block
        mesh._AUTO_MESH.clear()

    with open(fam) as f:
        seqs = cli_sequences(fasta_strings(f.read()))
    padded = pad_sequences(seqs, align=BV32)
    lengths = np.array([s.length for s in seqs], dtype=np.int64)
    if famsa_flags(padded).any():
        raise AssertionError("5d: the 2000-sequence family has a flagged "
                             "sequence")
    t0 = time.perf_counter()
    mst_prim_tree_torch(seqs, [], device=device, chunk=300)
    tree_secs.insert(0, f"one card's route {time.perf_counter() - t0:.3f} s")
    table, queries, lens, pow_tab = prim_inputs(padded, lengths, device)
    state = PrimState(queries)
    host, dev = round_split(lambda: prim_chunk(
        table, queries, lens, pow_tab, state, MESH_ROUNDS), MESH_ROUNDS)
    split = [f"one card's route {host:.4f} / {dev:.4f}"]
    for size in MESH_SIZES:
        m = mesh.make_mesh([f"{device}:0"] * size)
        prim = mesh.PrimShards(m, padded, lengths)
        edges = torch.empty((3, MESH_ROUNDS), dtype=torch.int64,
                            device=device)

        def issue():
            for slot in range(MESH_ROUNDS):
                mesh.prim_round_sharded(prim, edges, slot)

        with m.lead.use():
            host, dev = round_split(issue, MESH_ROUNDS)
        split.append(f"{size} shards {host:.4f} / {dev:.4f}")
    log(f"phase 5d mesh (shards on {device}:0, each on its own stream): "
        f"auto_mesh None on one card; byte-identical to numpy (upgma "
        f"numpy child {np_secs:.2f} s): " + "; ".join(report)
        + f"; the {len(seqs)}-sequence tree (tree_build): "
        + ", ".join(tree_secs) + f"; host ms a round to issue {MESH_ROUNDS} "
        "rounds / ms a round to the device's end: " + ", ".join(split)
        + " (one card: these measure the route's overhead, not a multi-GPU "
        "speed)")


# phase 5e: the column axis of multi-device sharding, on meshes of shards
# on one card.  K10 against its plain version: (w1, w2, shards, rows a
# block of the plain pipeline, the plain version's folds: "geometry" the
# kernel's, else one a slice), each unguided and banded along the
# diagonal: the stripes body on 3 uneven slices, the staged body on 4
# slices of 3 folds, blocks that do not divide w1
COLS_K10 = ((300, 26001, 3, 128, None), (200, 3000, 4, 48, "geometry"))
# (the plain version on the kernel's fold geometry only unguided: on the
# banded check it takes one fold a slice, ~4 s less)
COLS_MESHES = (2, 3)    # phase 5c's merge on meshes of these sizes
COLS_PROFPROF_CELLS = "1e7"   # ... with the shard threshold below its cells
COLS_POLYQ = (3, "1e5")   # the poly-Q run's shards and shard threshold
# the ticket rule's mesh: more slices than the card holds clusters of at
# once (w1, slices, columns a slice: 512 threads a fold, one CTA an SM)
COLS_MANY = (40, 32, 3900)


def k10_bound_ms(colf, rowf, meta, total, shards):
    """Least time of a sharded merge's K10 launches: the whole merge's
    (dp_bound_ms on its packed inputs, the work K2 spans does for it) and
    the edges between its shards (D, V and the running max of every row,
    written and read once)."""
    ms, by = dp_bound_ms(colf, rowf, meta, total)
    w1 = int(meta[0, 0])
    edges = 2 * 24 * w1 * (shards - 1)
    return max(ms, edges / MEM_BYTES_PER_S * 1e3), by


class K10Span:
    """The device time of a sharded merge's K10 launches while active:
    CUDA events right around each launch on its shard's stream, and the
    span from the first start to the last end (the launches overlap: one
    wavefront across their clusters)."""

    def __init__(self):
        from famsa_tpu_torch.parallel import dp_sharded
        self.events = []
        self.orig = dp_sharded.dp_shard

        def timed(table):
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.orig(table)
            end.record()
            self.events.append((start, end, table))

        dp_sharded.dp_shard = timed

    def close(self):
        from famsa_tpu_torch.parallel import dp_sharded
        dp_sharded.dp_shard = self.orig

    def take(self):
        """(span ms, [launch ms], [tables]) of the launches since the last
        take."""
        import torch
        torch.cuda.synchronize()
        ev, self.events = self.events, []
        first = min(ev, key=lambda e: ev[0][0].elapsed_time(e[0]))[0]
        span = max(first.elapsed_time(e) for _, e, _ in ev)
        return span, [s.elapsed_time(e) for s, e, _ in ev], [
            t for _, _, t in ev]


def cols_check(params, rng, case, banded, device, order=None):
    """K10 on a mesh of shards on one card (parallel/dp_sharded.py, one
    launch a shard) against the (shard, block) pipeline of its plain
    version dp_shard_plain on a mesh of as many host shards (on_host),
    and against the one-device dp_plain: every direction byte and per-row
    final; its launches counted (one a shard).  Returns a line."""
    import functools
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.dp_torch import (dp_plain, pack_batch,
                                              prepare_merge)
    from famsa_tpu_torch.ops.dp_wide import dp_shard_plain
    from famsa_tpu_torch.parallel import dp_sharded, mesh
    w1, w2, size, block, walk = case
    walk = walk and not banded
    a = random_profile(rng, params, 4, w1)
    b = random_profile(rng, params, 3, w2, 0.0)
    band = diagonal_band(params, w1, w2) if banded else None
    m = mesh.make_mesh([f"{device}:0"] * size)
    what = (f"{'banded ' if banded else ''}{w1}x{w2} on {size} shards"
            + (f" issued in order {order}" if order else ""))
    before = kernels.LAUNCHES["dp_shard"]
    t0 = time.perf_counter()
    dirs, fin = dp_sharded.dp_profile_sharded(params, a, b, m, band=band,
                                              order=order)
    ms = (time.perf_counter() - t0) * 1e3
    launched = kernels.LAUNCHES["dp_shard"] - before
    if device == "cuda" and launched != size:
        raise AssertionError(f"5e K10 {what}: {launched} launches")
    slices = [c1 - c0 for c0, c1 in m.bounds(w2 + 1)]
    step = dp_shard_plain if walk else functools.partial(
        dp_shard_plain, fold_cols=max(slices))
    t0 = time.perf_counter()
    want = on_host(dp_sharded.dp_profile_sharded, params, a, b,
                   mesh.make_mesh(["cpu"] * size), band=band, block=block,
                   step=step)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(dirs, want[0]) and np.array_equal(fin, want[1])):
        raise AssertionError(f"5e K10 {what}: differs from dp_shard_plain")
    colf, rowf, meta, total = pack_batch([prepare_merge(params, a, b, band)])
    d, f = dp_plain(*(torch.from_numpy(x).to(device)
                      for x in (colf, rowf, meta)), total)
    if not (np.array_equal(dirs.reshape(-1), d.cpu().numpy())
            and np.array_equal(fin, f[0, :w1].cpu().numpy())):
        raise AssertionError(f"5e K10 {what}: differs from dp_plain")
    return (f"{what} (slices {slices}): {launched} launches, the merge "
            f"{ms:.2f} ms on the mesh (host clock, with its copies to the "
            f"host), the plain pipeline (blocks of {block}, "
            f"{'the kernel' if walk else 'one'}"
            f"{' fold geometry' if walk else ' fold a slice'}) "
            f"{plain_ms:.0f} ms")


def many_check(params, rng, device):
    """The ticket rule: a merge of COLS_MANY's slices, more than the card
    holds clusters of at once (dp_wide_max_clusters of their geometry),
    launched in pipeline order and in reverse order, each on its shard's
    stream; both end, their bytes equal each other's and dp_plain's.
    Returns a line."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.dp_torch import (dp_plain, pack_batch,
                                              prepare_merge)
    from famsa_tpu_torch.ops.dp_wide import BLK, fold_geometry
    from famsa_tpu_torch.parallel import dp_sharded, mesh
    w1, size, cols = COLS_MANY
    w2 = size * cols - 1
    fit = kernels.get("dp_wide").dp_wide_max_clusters(
        *fold_geometry(cols - 1), BLK)
    if not 0 < fit < size:
        raise AssertionError(f"5e: {size} slices of {cols} columns fit the "
                             f"card at once ({fit} clusters)")
    a = random_profile(rng, params, 4, w1)
    b = random_profile(rng, params, 3, w2, 0.0)
    m = mesh.make_mesh([f"{device}:0"] * size)
    outs, ms = [], []
    for order in (None, list(range(size))[::-1]):
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs.append(dp_sharded.dp_profile_sharded(params, a, b, m,
                                                  order=order))
        ms.append((time.perf_counter() - t0) * 1e3)
        if kernels.LAUNCHES["dp_shard"] != size:
            raise AssertionError(f"5e ticket mesh: launches "
                                 f"{kernels.LAUNCHES['dp_shard']}")
    colf, rowf, meta, total = pack_batch([prepare_merge(params, a, b)])
    d, f = dp_plain(*(torch.from_numpy(x).to(device)
                      for x in (colf, rowf, meta)), total)
    for dirs, fin in outs:
        if not (np.array_equal(dirs.reshape(-1), d.cpu().numpy())
                and np.array_equal(fin, f[0, :w1].cpu().numpy())):
            raise AssertionError("5e ticket mesh: differs from dp_plain")
    return (f"{w1}x{w2} on {size} slices of {cols} columns (the card holds "
            f"{fit} clusters of their geometry at once), pipeline order "
            f"{ms[0]:.2f} ms and reverse order {ms[1]:.2f} ms (host clock): "
            f"both ended, equal to dp_plain")


def read_profiles(work, params):
    """Phase 5c's two profiles (prof1.fa, prof2.fa) as the CLI's
    profile-profile mode builds them, in align_into's operand order."""
    from famsa_tpu_torch.core.aligner import order_operands
    from famsa_tpu_torch.core.profile import Profile
    from famsa_tpu_torch.core.sequence import encode_gapped
    profs, k = [], 0
    for name in ("prof1.fa", "prof2.fa"):
        prof = Profile(params)
        with open(os.path.join(work, name)) as f:
            for row in fasta_strings(f.read()):
                prof.append_raw_sequence(encode_gapped(f">p{k}", row, k))
                k += 1
        prof.calculate_counters_scores()
        profs.append(prof)
    return order_operands(*profs)


def profprof_rounds(params, a, b, device, spans_args):
    """Phase 5c's merge, spans against K10 in turns (spans, 2, 3, 3, 2,
    spans shards): the one-device merge (K5, K2 spans, K4:
    dp_profile_torch_paths_async) and the sharded one
    (dp_profile_sharded_paths), host ms with a synchronize each; K2
    spans' CUDA-event ms on the merge's packed inputs (spans_args) and
    K10's span (first launch's start to last launch's end) on each mesh;
    the same path from every run.  Then the merge's DP on each of
    COLS_MESHES (dp_profile_sharded) against K2 spans on spans_args:
    every direction byte and final, both slices of each mesh.  Returns
    ({what: [ms]}, (the 2-shard merge's tables, its K10 launch ms), the
    max abs error of that check)."""
    import torch
    from famsa_tpu_torch.ops.dp_torch import (dp_dirs,
                                              dp_profile_torch_paths_async)
    from famsa_tpu_torch.parallel import dp_sharded, mesh
    times, paths, keep = {}, [], None
    span = K10Span()
    try:
        for what in ("spans", 2, 3, 3, 2, "spans"):
            if what == "spans":
                t = wall_ms(lambda: paths.append(dp_profile_torch_paths_async(
                    params, [(a, b)]).resolve()[0]))
                k = cuda_ms(lambda: dp_dirs(*spans_args, variant="spans"), 3)
            else:
                m = mesh.make_mesh([f"{device}:0"] * what)
                t = wall_ms(lambda: paths.append(
                    dp_sharded.dp_profile_sharded_paths(params, a, b, m)))
                k, launch_ms, tables = span.take()
                if what == 2:
                    keep = (tables, launch_ms)
            times.setdefault(f"{what} merge", []).append(t)
            times.setdefault(f"{what} kernel", []).append(k)
    finally:
        span.close()
    if any(p.total != paths[0].total or list(p.path) != list(paths[0].path)
           for p in paths):
        raise AssertionError("5e: the 1500 x 40,000 merge's paths differ "
                             "between K2 spans and K10")
    d, f = dp_dirs(*spans_args, variant="spans")
    d, f = d.cpu(), f[0, :a.width].cpu()
    err = 0
    for size in COLS_MESHES:
        m = mesh.make_mesh([f"{device}:0"] * size)
        dirs, fin = dp_sharded.dp_profile_sharded(params, a, b, m)
        err = max(err, int_err(torch.from_numpy(dirs.reshape(-1)),
                               d[:dirs.size]),
                  int_err(torch.from_numpy(fin), f))
    return times, keep, err


def k10_measure(tables, rows=256):
    """K10 at phase 5c's merge on 2 shards: slice 0 of the merge's table
    (its inputs as the launch read them) through dp_shard_plain (one
    fold) on host copies for its first `rows` rows, against what its
    cluster wrote there: the direction bytes, the finals and the edges
    into slice 1.  Returns (max abs error, plain ms, shape)."""
    import torch
    from famsa_tpu_torch.ops.dp_wide import dp_shard_plain
    table = tables[0]
    sl = table.slices[0]
    w1, n = table.w1, sl.c1 - sl.cs
    r1 = min(w1, rows) + 1
    got = [sl.dirs[:r1], sl.fin[:r1 - 1], sl.eout[:r1 - 1]]
    plain = [torch.zeros(x.shape, dtype=x.dtype)
             for x in (sl.dirs, sl.fin, sl.eout)]
    t0 = time.perf_counter()
    on_host(dp_shard_plain, sl.colf, sl.rowf, w1, sl.cs, sl.c1, 1, r1,
            plain[0], plain[1], torch.zeros((3, n + 1), dtype=torch.int64),
            eout=plain[2], fold_cols=n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int_err(g.cpu().long(), p[:g.shape[0]].long())
              for g, p in zip(got, plain))
    shape = (f"rows 1-{r1 - 1} of the {w1}x"
             f"{sum(s.c1 - s.cs for s in table.slices) - 1} merge on 2 "
             f"shards (slice 0: columns {sl.cs}-{sl.c1 - 1})")
    return err, plain_ms, shape


def phase_cols(work, recorder, refs, device="cuda"):
    """Phase 5e: the column axis of multi-device sharding
    (parallel/dp_sharded.py, K10) on meshes of shards on one card, each
    shard on its own stream (auto_mesh's cache set for "cols").  (a) K10
    against its plain version's (shard, block) pipeline and dp_plain on
    COLS_K10, unguided and banded (cols_check; the stripes case also
    with its launches issued in reverse pipeline order), and the ticket
    rule on COLS_MANY (many_check).  (b) Phase 5c's profile-profile merge
    through the CLI entry point on meshes of COLS_MESHES shards, its
    shard threshold below its cells: byte-identical to 5c's numpy child's
    output, with S K10 launches, one K5 and one K4, no other DP launch
    (the 2-shard run recorded as "cols"); the merge timed against K2
    spans in turns and held against K2 spans on it, every direction
    byte and final of both meshes (profprof_rounds); K10 held at slice 0
    of that merge against dp_shard_plain (k10_measure).  (c) The poly-Q
    family,
    refinement on (its default), on a mesh of COLS_POLYQ[0] shards with
    the threshold at COLS_POLYQ[1] cells, so that progressive merges and
    guided re-alignments go sharded: byte-identical to its -backend numpy
    child ("polyq_refine" in refs), S K10 launches a sharded merge.
    Returns K10's kernel-report entry."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.parallel import dp_sharded, mesh
    polyq = os.path.join(work, "polyq.fa")
    report = []
    mesh._AUTO_MESH.clear()
    if mesh.auto_mesh("cols", device) is not None:
        raise AssertionError("5e: auto_mesh gave a mesh on one card")
    # (a)
    rng = np.random.default_rng(29)
    params = Params(device=device)
    params.adjust(1000)
    checks = [cols_check(params, rng, case, banded, device)
              for case in COLS_K10 for banded in (False, True)]
    checks.append(cols_check(params, rng, COLS_K10[0], True, device,
                             order=list(range(COLS_K10[0][2]))[::-1]))
    checks.append(many_check(params, rng, device))
    # (b)
    merges = []
    orig = dp_sharded.dp_profile_sharded_paths

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(*a, **kw)
        merges.append((time.perf_counter() - t0) * 1e3)
        return res

    p1, p2 = (os.path.join(work, f"prof{k}.fa") for k in (1, 2))
    with open(os.path.join(work, "profprof_numpy.fa"), "rb") as f:
        want = f.read()
    env = {"FAMSA_TORCH_SHARD_DP_CELLS": COLS_PROFPROF_CELLS}
    dp_sharded.dp_profile_sharded_paths = timed
    try:
        for size in COLS_MESHES:
            mesh._AUTO_MESH["cols"] = mesh.make_mesh([f"{device}:0"]
                                                     * size)
            out = os.path.join(work, f"cols{size}_profprof.fa")
            merges.clear()
            recorder.start("cols" if size == COLS_MESHES[0] else None)
            kernels.reset_launches()
            rc, secs = run_cli(["-backend", "torch", "-device", device,
                                "-refine_mode", "off", p1, p2, out], env)
            counts = dict(kernels.LAUNCHES)
            recorder.stop(counts)
            what = f"5e profile-profile on {size} shards"
            if rc != 0:
                raise AssertionError(f"{what}: rc={rc}")
            with open(out, "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"{what}: output differs from "
                                         "5c's numpy child's")
            dp_keys = ("dp_staged", "dp_staged16", "dp_stripes",
                       "dp_spans", "dp_wide", "dp_wide16",
                       "dp_wide_stripes")
            if len(merges) != 1 or device == "cuda" and (
                    counts["dp_shard"] != size
                    or counts["stage0"] != 1 or counts["traceback"] != 1
                    or any(counts[k] for k in dp_keys)):
                raise AssertionError(f"{what}: launches {counts}, "
                                     f"sharded merges {len(merges)}")
            report.append(f"{size} shards: {secs:.2f} s, the merge "
                          f"{merges[0]:.2f} ms (K10 {counts['dp_shard']},"
                          f" K5 {counts['stage0']}, K4 "
                          f"{counts['traceback']}, K2 spans 0)")
    finally:
        dp_sharded.dp_profile_sharded_paths = orig
        mesh._AUTO_MESH.clear()
    n, tot, mean = recorder.totals("cols", "dp_shard")
    ns, tots, _ = recorder.totals("profprof", "dp_spans")
    report.append(f"K10 in the 2-shard run: {n} launches, {tot:.3f} ms "
                  f"of events in all, {mean:.4f} ms mean (the shards' "
                  f"launches overlap); 5c's K2 spans: {ns} launch, "
                  f"{tots:.3f} ms")
    params = Params(device=device)
    params.adjust(PROFPROF_1 + PROFPROF_2)
    a, b = read_profiles(work, params)
    spans_args = recorder.inputs["dp_spans"][1]
    times, (tables, launch_ms), spans_err = profprof_rounds(
        params, a, b, device, spans_args)
    if spans_err:
        raise AssertionError(f"5e K10: phase 5c's merge on {COLS_MESHES} "
                             f"shards differs from K2 spans (max abs error "
                             f"{spans_err})")
    report.append("the merge in turns, host ms with a synchronize (K2 "
                  "spans: K5, K2, K4 on one device; S shards: K5, copies, "
                  "K10, gather, K4) and device ms (K2 spans' events; K10 "
                  "from the first launch's start to the last one's end): "
                  + ", ".join(f"{k} {' / '.join(f'{x:.3f}' for x in v)}"
                              for k, v in times.items())
                  + f"; the 2-shard merge's K10 launches "
                  + " / ".join(f"{x:.3f}" for x in launch_ms) + " ms")
    err, plain_ms, shape = k10_measure(tables)
    if err:
        raise AssertionError(f"5e K10 at {shape}: max abs error {err} "
                             "against dp_shard_plain")
    ms = min(times["2 kernel"])
    bms, by = k10_bound_ms(*spans_args, 2)
    held = (f"phase 5c's merge on {' and '.join(map(str, COLS_MESHES))} "
            f"shards, every direction byte and final against K2 spans on "
            f"its packed inputs; {shape}, dirs, finals and edges, against "
            f"dp_shard_plain")
    report.append(f"K10 bit-exact: {held} (one fold, {plain_ms:.0f} ms); "
                  f"the merge's K10 {ms:.4f} ms (the faster span of the two "
                  f"rounds), bound {bms:.5f} ms ({by})")
    # (c)
    size, cells = COLS_POLYQ
    calls = {"guided": 0, "unguided": 0}
    orig = dp_sharded.dp_profile_sharded_paths

    def counted(*a, band=None, **kw):
        calls["unguided" if band is None else "guided"] += 1
        return orig(*a, band=band, **kw)

    out = os.path.join(work, "polyq_refine_torch.fa")
    dp_sharded.dp_profile_sharded_paths = counted
    mesh._AUTO_MESH["cols"] = mesh.make_mesh([f"{device}:0"] * size)
    try:
        kernels.reset_launches()
        rc, secs = run_cli(["-backend", "torch", "-device", device,
                            polyq, out],
                           {"FAMSA_TORCH_SHARD_DP_CELLS": cells})
        counts = dict(kernels.LAUNCHES)
    finally:
        dp_sharded.dp_profile_sharded_paths = orig
        mesh._AUTO_MESH.clear()
    if rc != 0:
        raise AssertionError(f"5e poly-Q refinement on: rc={rc}")
    merged = calls["guided"] + calls["unguided"]
    if not (calls["guided"] and calls["unguided"]) or (
            device == "cuda" and counts["dp_shard"] != size * merged):
        raise AssertionError(f"5e poly-Q: sharded merges {calls}, K10 "
                             f"launches {counts['dp_shard']}")
    np_wait = refs.wait("polyq_refine")
    with open(out, "rb") as f, \
            open(os.path.join(work, "polyq_refine_numpy.fa"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("5e poly-Q refinement on: torch output "
                                 "differs from the numpy child's")
    report.append(f"poly-Q, refinement on, {size} shards, threshold "
                  f"{cells} cells: {secs:.2f} s, sharded merges "
                  f"{calls['unguided']} progressive and {calls['guided']} "
                  f"guided (K10 {counts['dp_shard']}, {size} a merge, K5 "
                  f"{counts['stage0']}, K4 {counts['traceback']}), "
                  f"byte-identical to a numpy child (waited {np_wait:.2f} s "
                  "more for it)")
    log(f"phase 5e cols mesh (shards on {device}:0, each on its own stream): "
        f"auto_mesh None on one card; K10 bit-exact vs dp_shard_plain and "
        f"dp_plain (dirs, finals) on " + "; ".join(checks) + "; "
        + "; ".join(report))
    return {"name": "dp_profile_shard", "route": "cuda",
            "source": "famsa_tpu_torch/csrc/dp_wide.cu",
            "replaces": "famsa_tpu/parallel/dp_sharded.py:40",
            "launches": recorder.counts["cols"]["dp_shard"],
            "max_abs_err": max(err, spans_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "launches_run": "cols", "at": held,
            "spans_ms": min(times["spans kernel"]),
            "runs": run_totals(recorder, "dp_shard")}


def long_queries(rng, n, length):
    """[n, length] int8 queries: random residues (codes >= 20 among them)
    with a run of 64-200 equal residues in every second one (K1's exact
    carry across words and lanes), lengths from length // 2, the first
    exactly length, padded with the no-op symbol."""
    from famsa_tpu_torch.ops.lcs_torch import PAD_SYMBOL
    padded = np.full((n, length), PAD_SYMBOL, dtype=np.int8)
    for i in range(n):
        ln = int(rng.integers(length // 2, length + 1)) if i else length
        row = rng.choice(24, size=ln, p=[0.048] * 20 + [0.01] * 4)
        if i % 2 == 0:
            run = int(rng.integers(64, 201))
            off = int(rng.integers(0, max(1, ln - run)))
            row[off:off + run] = rng.integers(0, 20)
        padded[i, :ln] = row
    return padded


def long_checks(device):
    """Phase 5f (a): K1 wave and K9 past one warp's segment, bit for bit
    against their plain twins on host copies; returns the log's parts and
    the plain twins' wall ms by case."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import lcs_torch as lt
    rng = np.random.default_rng(23)
    parts, plain = [], {}
    for i, w in enumerate(LONG_K1_WORDS):
        padded = long_queries(rng, 6, 32 * w)
        refs = np.concatenate([padded[[1, 3]][:, :300],
                               long_queries(rng, 1, 300)])
        table = torch.from_numpy(lt.build_query_mask_table(padded).view(
            np.int32))
        syms = torch.from_numpy(refs.astype(np.int32))
        t0 = time.perf_counter()
        want = on_host(lt.lcs_wave_plain, table, syms, 5)
        plain[f"K1 W={w}"] = (time.perf_counter() - t0) * 1e3
        dt = torch.uint16 if i % 2 else torch.int32
        before = kernels.LAUNCHES["lcs_wave"]
        got = lt.lcs_rows(table.to(device), syms.to(device), n_queries=5,
                          out_dtype=dt)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["lcs_wave"] != before + 1:
            raise AssertionError(f"5f K1 W={w}: the wave variant was not "
                                 "launched")
        if not torch.equal(got[:, :5].cpu().to(torch.int32), want[:, :5]):
            raise AssertionError(f"5f K1 wave W={w}: differs from "
                                 "lcs_wave_plain")
        parts.append(f"K1 wave W={w} {lt.seg_geometry(w)[:4]} "
                     f"({str(dt)[6:]} out)")
    # a 65,537-residue reference through the one-warp wave variant and
    # the same pairs through a segment across warps: the LCS is symmetric
    long = long_queries(rng, 4, LONG_RESIDUES)
    short = long_queries(rng, 5, 300)
    t_long, t_short = (torch.from_numpy(lt.build_query_mask_table(x).view(
        np.int32)).to(device) for x in (long, short))
    across = lt.lcs_rows(t_long, torch.from_numpy(short.astype(
        np.int32)).to(device))
    one = lt.lcs_rows(t_short, torch.from_numpy(long.astype(np.int32)).to(
        device), variant="wave")
    if not torch.equal(across, one.T):
        raise AssertionError("5f K1 wave: a 65,537-residue query across "
                             "warps differs from it as a reference")
    parts.append(f"4 queries of {LONG_RESIDUES} (W={t_long.shape[1]}) x 5 "
                 "refs of 300 = the transpose through one warp's segment")
    for w64 in LONG_K9_WORDS:
        refs = rng.choice(24, size=(2, 64 * w64 - 5),
                          p=[0.048] * 20 + [0.01] * 4).astype(np.int8)
        for ref in refs:
            word = int(rng.integers(1, w64 - 1))
            ref[64 * word:64 * (word + 1)] = AA.index("Q")
        queries = long_queries(rng, 7, 150)
        queries[1] = AA.index("Q")
        r, q = (torch.from_numpy(x.astype(np.int32)) for x in (refs, queries))
        t0 = time.perf_counter()
        want = on_host(lt.lcs_refmask_wave_plain, r, q, 6)
        plain[f"K9 W64={w64}"] = (time.perf_counter() - t0) * 1e3
        before = kernels.LAUNCHES["lcs_refmask"]
        got = lt.lcs_refmask(r.to(device), q.to(device), n_queries=6)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["lcs_refmask"] != before + 1:
            raise AssertionError(f"5f K9 W64={w64}: not launched")
        if not torch.equal(got[:, :6].cpu(), want[:, :6]):
            raise AssertionError(f"5f K9 W64={w64}: differs from "
                                 "lcs_refmask_wave_plain")
        # a Prim round: the row overwritten only for a flagged cur
        flags = torch.zeros(7, dtype=torch.bool, device=device)
        flags[0] = True
        rows = []
        for cur in (0, 1):
            row = torch.full((1, 7), -1, dtype=torch.int32, device=device)
            lt.lcs_refmask(r[:1].to(device), q.to(device), out=row,
                           cur=torch.tensor([cur], device=device),
                           flags=flags)
            rows.append(row.cpu())
        if not (torch.equal(rows[0], on_host(lt.lcs_refmask_wave_plain,
                                             r[:1], q, 7))
                and bool((rows[1] == -1).all())):
            raise AssertionError(f"5f K9 W64={w64}: the Prim round's row")
        parts.append(f"K9 W64={w64} "
                     f"{lt.seg_geometry(w64, 'refmask')[:4]} (and in a "
                     "Prim round, flagged and not)")
    return parts, plain


def phase_long(work, recorder, watch, refs, device="cuda"):
    """Phase 5f: sequences past 65,536 residues.  (a) long_checks: K1
    wave past 2048 words (csrc/lcs.cu:lcs_wave_seg_kernel, a segment
    across warps) at W LONG_K1_WORDS against lcs_wave_plain, a
    65,537-residue query across warps against it as a reference through
    one warp's segment, and K9 past 1024 64-bit words
    (lcs_refmask_seg_kernel) at W64 LONG_K9_WORDS against
    lcs_refmask_wave_plain and in a Prim round.  (b) The LONG_FAMILY
    family with one LONG_RESIDUES-residue sequence (make_long, long.fa)
    through the CLI with -backend torch: the alignment (its defaults,
    refinement on; its DP route, the long sequence's merges and guided
    re-alignments on K3 with 65,537 rows, held to ResidencyWatch),
    -gt_export and -dist_export,
    each byte-identical to its -backend numpy child (LONG_RUNS, in
    refs); every K1 launch on the wave variant (its queries 2049 words),
    K9 launched (a Prim round's when the long sequence is the reference,
    a distance row's), the tree runs' K1 wave, K9 and K8 n - 1 each.
    (c) K1 wave and K9 timed at those runs' largest call, the long
    sequence as the reference against the family.  Returns K1 wave's and
    K9's entries for the kernel report (their "seg" fields)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import lcs_torch as lt
    t0 = time.perf_counter()
    parts, plain = long_checks(device)
    check_secs = time.perf_counter() - t0
    fa = os.path.join(work, "long.fa")
    report = []
    for name, flags, ext in LONG_RUNS:
        args = (["-backend", "torch", "-device", device] + flags
                + [fa, os.path.join(work, f"{name}_torch{ext}")])
        if name == "long":
            rc, secs, counts, route = run_torch(
                "5f long alignment", args, {}, recorder, watch, None, False,
                device)
        else:
            recorder.start(None)
            kernels.reset_launches()
            rc, secs = run_cli(args, {})
            counts, route = dict(kernels.LAUNCHES), ""
            recorder.stop(counts)
        if rc != 0:
            raise AssertionError(f"5f {name}: rc={rc}")
        if counts["lcs"] or not (counts["lcs_wave"]
                                 and counts["lcs_refmask"]):
            raise AssertionError(f"5f {name}: launches {counts}")
        if name != "long_dist":
            check_launches(f"5f {name}", counts,
                           ("lcs_wave", "prim_round", "lcs_refmask"),
                           recorder)
        report.append(f"{name} {secs:.2f} s (K1 wave {counts['lcs_wave']}"
                      f", K9 {counts['lcs_refmask']}, K8 "
                      f"{counts['prim_round']}, K1 rows {counts['lcs']}, "
                      f"K2 spans {counts['dp_spans']}){route}")
    np_wait = refs.wait(*(name for name, _, _ in LONG_RUNS))
    for name, _, ext in LONG_RUNS:
        with open(os.path.join(work, f"{name}_torch{ext}"), "rb") as f, \
                open(os.path.join(work, f"{name}_numpy{ext}"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"5f {name}: torch output differs from "
                                     "the numpy child's")
    # (c) the long sequence as the reference against the family
    with open(fa) as f:
        strings = fasta_strings(f.read())
    table, queries, _, _ = prim_case(strings, device)
    lengths = (queries < 20).sum(dim=1)
    ref = queries[int(lengths.argmax())][None].contiguous()
    n = queries.shape[0]
    out = {}
    for key, fn, bfn, args in (
            ("lcs_wave", lambda: lt.lcs_rows(table, ref, variant="wave"),
             lcs_bound_ms, (table, ref, n)),
            ("lcs_refmask", lambda: lt.lcs_refmask(ref, queries),
             refmask_bound_ms, (ref, queries, n))):
        ms = cuda_ms(fn, 3)
        bms, by = bfn(*args)
        tag = "K1" if key == "lcs_wave" else "K9"
        out[key] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                    "at": f"1 reference of {ref.shape[1]} positions x {n} "
                          f"queries of W={table.shape[1]} (phase 5f)",
                    "plain_ms": {k: v for k, v in plain.items()
                                 if k.startswith(tag)},
                    "plain_at": "phase 5f's checks"}
    log(f"phase 5f sequences past 65,536 residues: bit-exact vs their plain "
        f"twins on host copies: " + "; ".join(parts) + f" ({check_secs:.1f}"
        f" s, plain ms {', '.join(f'{k} {v:.0f}' for k, v in plain.items())}"
        f"); the family of {LONG_FAMILY[0]} x {LONG_FAMILY[1]} (seed "
        f"{LONG_FAMILY[2]}) and one of {LONG_RESIDUES}, torch byte-identical"
        f" to numpy children (waited {np_wait:.2f} s more for them): "
        + "; ".join(report) + "; at the long reference x the family: "
        + "; ".join(f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.5f} ms, "
                    f"{v['bound_by']})" for k, v in out.items()))
    return out


class RouteCounter:
    """Counts the alignment stage's profile merges per route while
    active: host (the native DP), K2 (batched) and K3 (wide)."""

    def __init__(self):
        import famsa_tpu_torch.pipeline as pipeline
        self.active = False
        self.counts = {"host": 0, "K2": 0, "K3": 0}
        orig_split, orig_align = pipeline.split_wide, pipeline.align_into

        def split_wide(device, max_batch):
            wide, batched = orig_split(device, max_batch)
            if self.active:
                self.counts["K3"] += len(wide)
                self.counts["K2"] += len(batched)
            return wide, batched

        def align_into(*args, **kw):
            if self.active:
                self.counts["host"] += 1
            return orig_align(*args, **kw)

        pipeline.split_wide, pipeline.align_into = split_wide, align_into


# the wide families: phase 6's (sequences, mean length, seed), and phase
# 6b's past 4095 columns (scripts/make_family.py 10000 600 f.fa 7: its
# alignment is 5906 columns)
WIDE_300 = (10000, 300, 7)
WIDE_FAMILY = (10000, 600, 7)


def phase_wide(work, recorder, watch, refs, tree_secs, device="cuda",
               family=WIDE_300, run="10000", label="6 wide path"):
    """Phases 6 and 6b: the wide path of a family, refinement off: the
    torch run at the default knobs (its launches recorded as `run`)
    against its -backend numpy reference (`run` in refs: -gt import of
    the torch tree that start_references wrote, in tree_secs[run]
    seconds), byte for byte.  The run past 4095 columns ("wide600") must
    launch the staged body on 9-16 folds and never K2's spans variant."""
    n, mean_len, seed = family
    fa = os.path.join(work, f"fam_{run}.fa")
    torch_flags = ["-backend", "torch", "-device", device]
    routes = RouteCounter()
    out = os.path.join(work, f"{run}_torch.fa")
    stats = os.path.join(work, f"{run}_stats_torch.txt")
    routes.active = True
    rc, secs, counts, route = run_torch(
        f"{label} torch", torch_flags + ["-stats", stats, fa, out], {},
        recorder, watch, run, False, device)
    routes.active = False
    if rc != 0:
        raise AssertionError(f"{label} torch: rc={rc}")
    k3_past = sum(w2 > 4095 for w2 in recorder.wide_calls)
    k2_past = sum(w2 > 4095 for w2 in recorder.k2_merges)
    widest = max(recorder.wide_calls + recorder.k2_merges, default=0)
    if device == "cuda":
        check_launches(f"{label} torch", counts, DEFAULT_KERNELS, recorder)
        if run == "wide600" and (
                counts["dp_wide16"] + counts["dp_staged16"] == 0
                or counts["dp_spans"]):
            raise AssertionError(f"{label} torch: the 9-16-fold staged "
                                 f"body launched {counts['dp_wide16']} + "
                                 f"{counts['dp_staged16']} times, K2 spans "
                                 f"{counts['dp_spans']}")
    report = stage_report("torch", secs, stats, counts) + route
    variants = ", ".join(
        f"{k} {v[0]} launches, {v[1]:.3f} ms in all, "
        f"{v[2] or 0:.5f} ms mean" for k, v in
        ((k, recorder.totals(run, k)) for k in DP_KEYS)
        if v[0]) if device == "cuda" else ""
    c = routes.counts
    waited = refs.wait(run)
    with open(out, "rb") as f, \
            open(os.path.join(work, f"{run}_numpy.fa"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{label}: torch output differs from numpy")
    st = read_stats(os.path.join(work, f"{run}_stats_numpy.txt"))
    with open(out) as f:
        width = len("".join(f.read().split(">", 2)[1].splitlines()[1:]))
    log(f"phase {label} ({n} seqs, mean len {mean_len}, seed "
        f"{seed}, alignment {width} columns, refinement off): torch "
        f"byte-identical to numpy on the torch tree (-gt_export "
        f"{tree_secs[run]:.2f} s); profile merges per route: host "
        f"{c['host']}, K2 {c['K2']}, K3 {c['K3']}; device merges past 4095 "
        f"columns: K3 {k3_past} of {len(recorder.wide_calls)}, K2 {k2_past} "
        f"of {len(recorder.k2_merges)} (widest w2 {widest}); {report}; DP "
        f"launches by variant (CUDA events) {variants}; numpy (a child "
        f"process): alignment {float(st['time.alignment']):.2f} s (waited "
        f"{waited:.1f} s for it)")


# ----------------------------------------------------------------------
# the chain route
# the variant family of phase 7: variants, root length, seed, indel rate
CHAIN_FAMILY = (1700, 800, 5, 0.6)
CHAIN_WIDTHS = 256          # width bucket of the per-merge times


def addr_offsets(bufs, s):
    """Step s's two descriptors with their addresses made offsets into
    the buffers they point into (two buffer sets compare equal)."""
    d = bufs.desc[s].cpu().clone()
    d[0, 1] -= bufs.leaf.data_ptr()
    d[1, 1] -= bufs.carry.data_ptr()
    return d


def k7_check(device, k=32, w1p=1024, cap=4095):
    """K7 (csrc/chain.cu, the chain's carry as a launch of its own: the
    device function K5's chain entry runs before each step) against
    chain_carry_plain on two buffer sets of one content: a step that ran,
    an overflow, a poisoned chain (an odd step: state slot 1), an invalid
    lane, a failed walk and the fold after the last step (slot 0 in
    place); the state (both slots), the recorded widths, the header and
    the descriptors, every word.  Returns (the buffers after the last
    case, the fold after the last step, as a chunk launches K7; that
    step, the capacity, the max abs error, the plain ms of that case)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_chain
    dev = torch.device(device)
    a = dp_chain.ChainBuffers(dev, k, w1p, cap)
    b = dp_chain.ChainBuffers(dev, k, w1p, cap)
    ps = dp_chain.path_stride(w1p, cap)
    # (what, step, state, w1 of the step before, its path length, lw)
    cases = [("ran", 1, (1500, 40, 0), 800, 1620, 790),
             ("overflow", 1, (4000, 40, 0), 800, cap + 5, 790),
             ("poisoned", 5, (cap + 5, 41, 1), 0, 1700, 790),
             ("invalid lane", 7, (1700, 44, 0), 780, 1710, 0),
             ("failed walk", 2, (1500, 40, 0), 800, -1, 790),
             ("last step", k, (1500, 40, 0), 800, 1550, 0)]
    err, plain_ms = 0, None
    for what, s, st, w1_prev, n, lw in cases:
        src, _ = dp_chain.state_slots(s, k)
        for bufs in (a, b):
            bufs.st.fill_(-9)
            bufs.st[4 * src:4 * src + 3] = torch.tensor(st)
            bufs.lw.zero_()
            if s < k:
                bufs.lw[s] = lw
            bufs.hdr.zero_()
            bufs.desc.zero_()
            bufs.out.zero_()
            bufs.hdr[s - 1, 0] = w1_prev
            at = (s - 1) * ps + 8
            bufs.out[at:at + 4].view(torch.int32)[0] = n
        before = kernels.LAUNCHES["chain"]
        dp_chain.chain_carry(a, s, cap)
        t0 = time.perf_counter()
        dp_chain.chain_carry_plain(b, s, cap)
        plain_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if kernels.LAUNCHES["chain"] != before + 1:
            raise AssertionError(f"K7 {what}: not launched")
        got = [a.st, a.hdr, a.widths(cap)]
        want = [b.st, b.hdr, b.widths(cap)]
        if s < k:
            got.append(addr_offsets(a, s))
            want.append(addr_offsets(b, s))
        for g, w in zip(got, want):
            e = int_err(g.cpu(), w.cpu())
            if e:
                raise AssertionError(f"K7 {what}: differs from "
                                     f"chain_carry_plain: "
                                     f"{first_diff(g.cpu(), w.cpu())}")
            err = max(err, e)
    return a, k, cap, err, plain_ms


def chain_case(params, seed, width, n_leaves=6):
    """(start profile, leaves): a 12-member profile of `width` columns and
    n_leaves ungapped leaves of 120-200 residues, made from `seed`."""
    rng = np.random.default_rng(seed)
    start = random_profile(rng, params, 12, width)
    leaves = [random_profile(rng, params, 1, int(rng.integers(120, 201)),
                             0.0) for _ in range(n_leaves)]
    return start, leaves


def chunk_check(params, device, seed, width, cap=None, k=32, w1p=1024,
                n_leaves=6):
    """One chunk's graph replay against the plain chunk on the card: a
    chain of `width` columns and n_leaves leaves in a chunk of k lanes
    (k - n_leaves trailing invalid lanes).  With no `cap`, at a capacity
    equal to the
    host route's width after the last step that the next one widens, so
    that one overflows it and poisons the steps after it; with a `cap`
    (a CHAIN_CAPS bucket well past the chain's width), all steps run
    and the DP's folds past the width are dead.  The state, the recorded
    widths, both carry buffers, every step's header and descriptors (the
    carry K5's chain entry ran before it) and every path of a step that
    ran must be equal, with one K7 launch in the replay; the resolved
    results stop at the overflow.  Then the chunk is
    timed again from the same state, one replay against the plain
    chunk's wall time.  Returns (cap, variant, overflow step or None,
    replay ms, plain ms, live DP folds a step of the folds launched)."""
    import copy

    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.aligner import align_into
    from famsa_tpu_torch.core.profile import Profile
    from famsa_tpu_torch.ops import dp_chain
    from famsa_tpu_torch.ops.dp_wide import fold_geometry, launch_key
    from famsa_tpu_torch.ops.traceback_torch import PATH_TRAILER
    start, leaves = chain_case(params, seed, width, n_leaves)
    prof, widths = copy.deepcopy(start), []
    for leaf in copy.deepcopy(leaves):
        prof = align_into(Profile(params), leaf, prof, backend="numpy")
        widths.append(prof.width)
    if cap is None:
        j = max(j for j in range(len(widths) - 1)
                if widths[j + 1] > widths[j])
        cap, ran, over = widths[j], j + 2, j + 1
    else:
        ran, over = len(widths), None
        if widths[-1] > cap:
            raise AssertionError(f"chain chunk at {cap}: the chain reaches "
                                 f"{widths[-1]} columns")
    # the DP's folds holding a column of each step's merge (its F)
    folds, threads, stripe = fold_geometry(cap)
    fw = threads * stripe
    live = [min(folds, (w2 + fw) // fw)
            for w2 in [start.width] + widths[:ran - 1]]
    # the plain chunk runs on host buffers of the same content (on_host)
    bufs = [dp_chain.ChainBuffers(torch.device(d), k, w1p, cap)
            for d in (device, "cpu")]
    states = [dp_chain.ChainState(b, start) for b in bufs]
    for st in states:
        st.seed(params, start)
    counts = dict(kernels.LAUNCHES)
    replays = kernels.CHAIN["replays"]
    a0 = [x.clone() for x in (bufs[0].st, bufs[0].carry)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = dp_chain.dispatch_chain_chunk(params, states[0], leaves, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    dp_chain.upload_leaves(bufs[1], leaves)
    t0 = time.perf_counter()
    on_host(dp_chain.chunk_plain, params, bufs[1], cap)
    plain_ms = (time.perf_counter() - t0) * 1e3
    res = pend.resolve()
    torch.cuda.synchronize()
    variant = dp_chain.dp_variant(cap)
    dp = launch_key("K2", variant, folds)
    # the warm-up launch sequence and the replay
    for key, times in (("stage0", 2 * k), (dp, 2 * k), ("traceback", 2 * k),
                       ("merged", 2 * k), ("chain", 2)):
        if kernels.LAUNCHES[key] - counts[key] != times:
            raise AssertionError(f"chain chunk {variant}: {key} launched "
                                 f"{kernels.LAUNCHES[key] - counts[key]} "
                                 f"times, not {times}")
    if kernels.CHAIN["replays"] != replays + 1:
        raise AssertionError(f"chain chunk {variant}: not one replay")
    a, b = bufs
    fold_check(a, b, f"chain chunk {variant}")
    wa, wb = a.widths(cap).cpu(), b.widths(cap).cpu()
    want = widths[:ran] + [dp_chain.NOT_RUN] * (k - ran)
    if not torch.equal(wa, wb) or wa.tolist() != want:
        raise AssertionError(f"chain chunk {variant}: widths {wa.tolist()}, "
                             f"plain {wb.tolist()}, host {want}")
    ps = dp_chain.path_stride(w1p, cap)
    for t in range(ran):
        n = PATH_TRAILER + int(wa[t])
        g, w = a.out[t * ps:t * ps + n].cpu(), b.out[t * ps:t * ps + n].cpu()
        if not torch.equal(g, w):
            raise AssertionError(f"chain chunk {variant} step {t}: path "
                                 f"differs from the plain chunk")
    if len(res) != ran or (over is not None) != (len(res[-1].path) > cap):
        raise AssertionError(f"chain chunk {variant}: {len(res)} results, "
                             f"the overflow at step {over}")

    def restore():
        a.st.copy_(a0[0])
        a.carry.copy_(a0[1])
    graph = a.graph(cap).graph
    replay_ms = cuda_ms(lambda: (restore(), graph.replay()), 5) \
        - cuda_ms(restore, 5)
    return cap, variant, over, replay_ms, plain_ms, (live, folds)


class ChainWatch:
    """Watches the chain route of the phase 7 runs while `active`: every
    chunk's dispatch (and every seed) runs under torch.cuda.
    set_sync_debug_mode("error"); per chunk the chain width and merges
    at its dispatch and the host clock there (per-merge wall by width);
    CUDA events around every graph replay; the chain's state
    before a replay past the tenth (`saved`, to time that chunk again);
    and per host merge (align_into) its wall and width.  Whether active or
    not, the dispatch numbered `profile_at` of a run runs under
    torch.profiler and its device operations are kept (`ops`)."""

    def __init__(self):
        import torch
        import famsa_tpu_torch.pipeline as pipeline
        from famsa_tpu_torch.ops import dp_chain
        self.active = False
        self.profile_at = None
        self.ops = {}
        self.reset()
        orig_dispatch = dp_chain.dispatch_chain_chunk
        orig_seed = dp_chain.ChainState.seed
        orig_replay = dp_chain.ChainGraph.replay
        orig_align = pipeline.align_into

        def strict(fn, *a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        def dispatch(params, state, leaves, cap):
            self.dispatches += 1
            if self.active:
                self.chunks.append((time.perf_counter(), state.w_host,
                                    len(leaves)))
            if self.dispatches != self.profile_at:
                return strict(orig_dispatch, params, state, leaves, cap)
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                out = strict(orig_dispatch, params, state, leaves, cap)
                torch.cuda.synchronize()
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and \
                        "spin_kernel" not in e.name:
                    name = short_name(e.name)
                    self.ops[name] = self.ops.get(name, 0) + 1
            return out

        def seed(state, *a, **kw):
            return strict(orig_seed, state, *a, **kw)

        def replay(graph):
            if not self.active:
                return orig_replay(graph)
            if self.saved is None and len(self.events) >= 10:
                b = graph.bufs
                self.saved = (graph, b.st.clone(), b.carry.clone(),
                              b.inp.clone())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig_replay(graph)
            end.record()
            self.events.append((start, end))
            return out

        def align_into(dest, *a, **kw):
            if not self.active:
                return orig_align(dest, *a, **kw)
            t0 = time.perf_counter()
            out = orig_align(dest, *a, **kw)
            self.host.append((out.width, time.perf_counter() - t0))
            return out

        dp_chain.dispatch_chain_chunk = dispatch
        dp_chain.ChainState.seed = seed
        dp_chain.ChainGraph.replay = replay
        pipeline.align_into = align_into

    def reset(self):
        self.chunks, self.events, self.host = [], [], []
        self.saved, self.dispatches = None, 0

    def replay_ms(self):
        import torch
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]

    def chain_by_width(self):
        """{width bucket: (merges, ms a merge)}: the wall from a chunk's
        dispatch to the next one's over its merges, by the chain's width
        at its dispatch (the last chunk, whose cycle the run's end cuts,
        is left out)."""
        out = {}
        for (t, w, n), (t1, _, _) in zip(self.chunks, self.chunks[1:]):
            key = w // CHAIN_WIDTHS * CHAIN_WIDTHS
            m, ms = out.get(key, (0, 0.0))
            out[key] = (m + n, ms + (t1 - t) * 1e3)
        return {k: (m, ms / m) for k, (m, ms) in sorted(out.items())}

    def host_by_width(self):
        out = {}
        for w, sec in self.host:
            key = w // CHAIN_WIDTHS * CHAIN_WIDTHS
            m, ms = out.get(key, (0, 0.0))
            out[key] = (m + 1, ms + sec * 1e3)
        return {k: (m, ms / m) for k, (m, ms) in sorted(out.items())}


def time_saved_chunk(watch):
    """The saved chunk of the all-chain run timed again: one replay of
    its graph against its launch sequence as separate launches, each run
    from the saved state (the restore's own time taken off).  Returns
    (capacity, replay ms, launch loop ms, bound ms, bound by, the
    chunk's (w1, w2) a step)."""
    import torch
    graph, st, carry, inp = watch.saved
    b = graph.bufs

    def restore():
        b.st.copy_(st)
        b.carry.copy_(carry)
        b.inp.copy_(inp)
    base = cuda_ms(restore, 10)
    rep = cuda_ms(lambda: (restore(), graph.graph.replay()), 10) - base
    loop = cuda_ms(lambda: (restore(), graph.launch()), 10) - base
    split = chunk_split(graph, restore)
    # the DP's work, as dp_bound_ms counts it (a leaf row holds one
    # symbol), and its bytes, over the steps that ran
    w1s = [w for w in b.lw.tolist() if w > 0]
    w2s = [int(st[0])] + b.widths(graph.cap).tolist()[:len(w1s) - 1]
    ops = sum(w2 * w1 * (17 * 3 + 23 * 2 + 17 * 2 + 11 * 2 + 5)
              for w1, w2 in zip(w1s, w2s))
    nbytes = sum(8 * 44 * (w2 + 1) + 8 * 77 * (w1 + 1) + (w1 + 1) * (w2 + 1)
                 + 24 * w1 for w1, w2 in zip(w1s, w2s))
    bms, by = bound(nbytes, ops)
    return graph.cap, rep, loop, bms, by, list(zip(w1s, w2s)), split


def saved_chunk_check(params, watch, steps=3):
    """The saved chunk of the all-chain run held against the plain chunk
    on the same state at the main path's shapes: its first `steps` leaves
    (the other lanes made invalid) through one replay of its graph, and
    through chunk_plain on a second ChainBuffers given the same state,
    carry, leaves and score table.  The state, the recorded widths, both
    carry buffers, every step's header and descriptors (K5's chain entry's
    fold) and the paths must be equal, with one K7 launch in the replay.
    Returns the steps' (w1, w2) and the plain chunk's wall ms."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops import dp_chain
    from famsa_tpu_torch.ops.traceback_torch import PATH_TRAILER
    graph, st, carry, inp = watch.saved
    a, cap = graph.bufs, graph.cap
    b = dp_chain.ChainBuffers(torch.device("cpu"), a.k, a.w1p, a.max_cap)
    for x in (a, b):
        x.st.copy_(st)
        x.carry.copy_(carry)
        x.inp.copy_(inp)
        x.lw[steps:] = 0
    b.table.copy_(a.table)
    before = kernels.LAUNCHES["chain"]
    graph.replay()
    if kernels.LAUNCHES["chain"] != before + 1:
        raise AssertionError("saved chain chunk: not one K7 launch in the "
                             "replay")
    t0 = time.perf_counter()
    on_host(dp_chain.chunk_plain, params, b, cap)
    plain_ms = (time.perf_counter() - t0) * 1e3
    fold_check(a, b, "saved chain chunk")
    wa, wb = a.widths(cap).cpu(), b.widths(cap).cpu()
    ran = [w for w in wa.tolist() if w != dp_chain.NOT_RUN]
    if not torch.equal(wa, wb) or len(ran) != steps:
        raise AssertionError(f"saved chain chunk: widths {wa.tolist()}, "
                             f"plain {wb.tolist()}")
    ps = dp_chain.path_stride(a.w1p, cap)
    for t, w in enumerate(ran):
        n = PATH_TRAILER + w
        if not torch.equal(a.out[t * ps:t * ps + n].cpu(),
                           b.out[t * ps:t * ps + n].cpu()):
            raise AssertionError(f"saved chain chunk step {t}: path differs "
                                 f"from the plain chunk")
    w1s = a.lw[:steps].tolist()
    return list(zip(w1s, [int(st[0])] + ran[:-1])), plain_ms


def fold_check(a, b, what):
    """The chain's carry on the card (K5's chain entry before each step, K7
    after the last) against chain_carry_plain's in the plain chunk, on two
    ChainBuffers after one chunk each: both state slots, both carry
    buffers, every step's header and descriptors (addresses as offsets
    into their buffers), word for word."""
    import torch
    got = {"st": a.st.cpu(), "carry": a.carry.cpu(), "hdr": a.hdr.cpu(),
           "desc": torch.stack([addr_offsets(a, s) for s in range(a.k)])}
    want = {"st": b.st.cpu(), "carry": b.carry.cpu(), "hdr": b.hdr.cpu(),
            "desc": torch.stack([addr_offsets(b, s) for s in range(b.k)])}
    for name, g in got.items():
        if not torch.equal(g, want[name]):
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 f"chunk: {first_diff(g, want[name])}")


def chunk_split(graph, restore):
    """{kernel: ms} of one run of a chunk's launch sequence from the
    restored state: CUDA events around each entry point (the launches are
    device-bound, so each span is its kernel's)."""
    import torch
    from famsa_tpu_torch import kernels
    entries = {"K5": ("stage0", "stage0_chain"),
               "DP": ("dp_wide", f"dp_profile_batched_{graph.variant}"),
               "K4": ("traceback", "trace_paths"),
               "K6": ("merged", "merged_counters"),
               "K7": ("chain", "chain_carry")}
    spans = {k: [] for k in entries}
    origs = {}
    for key, (lib, entry) in entries.items():
        fn = getattr(kernels.get(lib), entry)
        origs[key] = (kernels.get(lib), entry, fn)

        def timed(*a, _fn=fn, _key=key):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = _fn(*a)
            end.record()
            spans[_key].append((start, end))
            return err
        setattr(kernels.get(lib), entry, timed)
    try:
        restore()
        graph.launch()
        torch.cuda.synchronize()
    finally:
        for lib, entry, fn in origs.values():
            setattr(lib, entry, fn)
    return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}


def k7_device_ms(bufs, step, cap, n=100):
    """K7's device time a launch: n launches captured in one CUDA graph
    and replayed (a loop of launches from Python measures the host's
    launch rate, not the kernel)."""
    import torch
    from famsa_tpu_torch.ops import dp_chain
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(n):
            dp_chain.chain_carry(bufs, step, cap)
        graph.capture_end()
    cur.wait_stream(side)
    return cuda_ms(graph.replay, 10) / n


def phase_chain(work, recorder, device="cuda", family=CHAIN_FAMILY):
    """The chain route (ops/dp_chain.py): K7 against its plain twin, one
    chunk's graph against the plain chunk at staged capacities of 8, 12
    and 16 folds and at a stripes one,
    and the variant family through the CLI entry point with -backend
    torch at the default knobs, with FAMSA_TORCH_CHAIN_MIN_W2=0 (all
    chain) and with FAMSA_TORCH_CHAIN=0 (one resident dispatch a merge,
    on the torch run's guide tree through -gt import), each
    byte-identical to -backend numpy on that tree.  The recorder counts
    the all-chain run's launches ("chain").  Returns the K7 entry of the kernel report."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.core.params import Params
    from famsa_tpu_torch.ops import dp_chain
    params = Params(device=device)
    params.adjust(family[0])
    k7_bufs, k7_step, k7_cap, k7_err, k7_plain = k7_check(device)
    # an overflow at a staged capacity of 8 and of 12 folds, then the
    # buckets past 4095 columns that chains reach with folds left dead
    # (16 staged folds of 512 columns, 16 stripes folds of 1024)
    checks = [chunk_check(params, device, 41, 3400),
              chunk_check(params, device, 43, 5600, n_leaves=4),
              chunk_check(params, device, 47, 3600, cap=8191, n_leaves=2),
              chunk_check(params, device, 53, 5000, cap=16256, n_leaves=2)]
    folds = [c[5][1] for c in checks]
    if [c[1] for c in checks] != ["staged", "staged", "staged", "stripes"] \
            or folds[0] > 8 or not 8 < folds[1] <= 16 \
            or folds[2:] != [16, 16]:
        raise AssertionError(f"chain chunk checks at {checks}")
    if any(c[2] is None for c in checks[:2]) or any(
            max(c[5][0]) >= c[5][1] for c in checks[2:]):
        raise AssertionError(f"chain chunk checks: overflows "
                             f"{[c[2] for c in checks]}, live folds "
                             f"{[c[5] for c in checks]}")
    fasta = make_variants(*family)
    n_unique = len(set(fasta.split("\n")[1::2]))
    fa = os.path.join(work, "variants.fa")
    with open(fa, "w") as f:
        f.write(fasta)
    tree = os.path.join(work, "variants.dnd")
    torch_flags = ["-backend", "torch", "-device", device]
    rc, t_tree = run_cli(torch_flags + ["-gt_export", fa, tree], {})
    if rc != 0:
        raise AssertionError(f"variants gt_export: rc={rc}")
    imported = ["-gt", "import", tree]
    all_chain = {"FAMSA_TORCH_CHAIN_MIN_W2": "0"}
    per_merge = {"FAMSA_TORCH_CHAIN": "0"}
    runs = [("numpy", ["-backend", "numpy"] + imported, {}),
            ("default", torch_flags, {}),
            ("chain", torch_flags, all_chain),
            ("per_merge", torch_flags + imported, per_merge)]
    watch = ChainWatch()
    outs, secs, chains, report = {}, {}, {}, []
    host_ms, chain_ms, replay_ms = {}, {}, []
    for name, flags, env in runs:
        out = os.path.join(work, f"variants_{name}.fa")
        stats = os.path.join(work, f"variants_stats_{name}.txt")
        watch.reset()
        watch.active = name in ("numpy", "chain")
        # one profiled dispatch, in a run whose seconds are not compared
        watch.profile_at = 20 if name == "default" else None
        recorder.start("chain" if name == "chain" else None)
        kernels.reset_launches()
        rc, wall = run_cli(flags + ["-stats", stats, fa, out], env)
        counts, ch = dict(kernels.LAUNCHES), dict(kernels.CHAIN)
        recorder.stop(counts)
        watch.active = False
        if rc != 0:
            raise AssertionError(f"variants {name}: rc={rc}")
        with open(out, "rb") as f:
            outs[name] = f.read()
        secs[name] = float(read_stats(stats)["time.alignment"])
        chains[name] = ch
        if name == "numpy":
            host_ms = watch.host_by_width()
        elif name == "chain":
            chain_ms = watch.chain_by_width()
            replay_ms = watch.replay_ms()
            saved = time_saved_chunk(watch)
            saved_steps, saved_plain_ms = saved_chunk_check(params, watch,
                                                            steps=2)
        if name in ("default", "chain"):
            # the default run's tail passes the width floor in the full
            # family; a reduced one may stay below it
            ok = (ch["runs"] == 1 and ch["aborts"] == 0
                  and ch["prefix"] + ch["merges"] == n_unique - 2
                  and ch["chunks"] == ch["replays"]
                  and (ch["prefix"] > 0) == (name == "default")
                  and (ch["merges"] > 0 or (name == "default"
                                            and family != CHAIN_FAMILY)))
            if not ok:
                raise AssertionError(f"variants {name}: chain counters {ch}"
                                     f" for one run of {n_unique - 2} merges")
            need = ("chain", "stage0", "traceback", "merged")
            if ch["merges"] and (
                    any(counts[k] == 0 for k in need)
                    or sum(counts[k] for k in K2_KEYS) == 0):
                raise AssertionError(f"variants {name}: the chain's kernels "
                                     f"were not all launched: {counts}")
            # one K7 launch a replay, and one a capture's warm-up loop
            if counts["chain"] != ch["replays"] + ch["captures"]:
                raise AssertionError(f"variants {name}: K7 launched "
                                     f"{counts['chain']} times in "
                                     f"{ch['replays']} replays and "
                                     f"{ch['captures']} captures")
        elif name != "numpy" and ch["runs"]:
            raise AssertionError(f"variants {name}: chain runs {ch}")
        report.append(f"{name} {wall:.2f} s (alignment {secs[name]:.2f})")
    for name in outs:
        if outs[name] != outs["numpy"]:
            raise AssertionError(f"variants: {name} output differs from "
                                 "numpy")
    # the profiled chunk on the card: K7 at most once (the profiler may
    # drop some of a graph's kernel records, never add one)
    if watch.ops.get("chain_kernel", 0) > 1:
        raise AssertionError(f"a profiled chunk's device operations "
                             f"{watch.ops}: more than one K7 launch")
    ch = chains["chain"]
    rounds = [secs[n] for n in ("chain", "per_merge")]
    log(f"phase 7 chain route: K7 bit-exact vs chain_carry_plain (ran, "
        f"overflow, poisoned, invalid lane, failed walk, last step); chunk "
        f"graph = plain chunk (state, widths, carry, the headers and "
        f"descriptors of K5's chain entry's fold, paths; one K7 launch a "
        f"replay) at capacities "
        f"{[c[:2] for c in checks]} with the overflow at steps "
        f"{[c[2] for c in checks]} (live DP folds a step of those launched "
        f"{[c[5] for c in checks]}) and {[32 - n for n in (6, 4, 2, 2)]} "
        f"invalid lanes, no host read, "
        f"replay ms {[round(c[3], 4) for c in checks]} against plain chunk "
        f"ms {[round(c[4], 1) for c in checks]}; the all-chain run's saved "
        f"chunk = plain chunk over its first steps (w1, w2) {saved_steps} "
        f"(plain {saved_plain_ms:.1f} ms); "
        f"{family[0]} variants of {family[1]} (seed {family[2]}, indel rate "
        f"{family[3]}, {n_unique} unique; -gt_export {t_tree:.2f} s): "
        f"default, all-chain and per-merge runs byte-identical to numpy; "
        + "; ".join(report)
        + f"; chain counters default {chains['default']}, all-chain {ch}; "
        f"alignment s chain / per-merge {rounds}; "
        f"replays {len(replay_ms)}: {sum(replay_ms):.3f} ms in all, "
        f"{sum(replay_ms) / max(1, len(replay_ms)):.4f} ms mean; chunk at "
        f"capacity {saved[0]}: replay {saved[1]:.4f} ms, launch loop "
        f"{saved[2]:.4f} ms, bound {saved[3]:.5f} ms ({saved[4]}), steps "
        f"(w1, w2) {saved[5]}, launch loop by kernel (ms) {saved[6]}; "
        f"device operations of the default run's twentieth chunk "
        f"(torch.profiler) {watch.ops}")
    log("phase 7 ms a merge by chain width (bucket: merges, ms): host "
        f"(numpy run) {host_ms}; chain (all-chain run, dispatch to "
        f"dispatch) {chain_ms}")
    loop_ms = cuda_ms(lambda: dp_chain.chain_carry(k7_bufs, k7_step, k7_cap),
                      200)
    ms = k7_device_ms(k7_bufs, k7_step, k7_cap)
    # state, w1 before, path length, lw read; state, width, header and
    # descriptors written
    bms, by = bound(24 + 8 + 4 + 8 + 24 + 4 + 64 + 128, 0)
    return {"name": "chain_carry", "route": "cuda",
            "source": "famsa_tpu_torch/csrc/chain.cu",
            "replaces": "famsa_tpu/ops/dp_chain.py:74",
            "launches": recorder.counts["chain"]["chain"],
            "max_abs_err": k7_err, "ms": ms, "plain_ms": k7_plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "launches_run": "chain", "at": "K7 check's fold after the last "
            "step (a step that ran), 100 launches in one CUDA graph",
            "launch_loop_ms": loop_ms,
            "runs": {},
            "graph": {"replays": ch["replays"], "chunks": ch["chunks"],
                      "captures": ch["captures"],
                      "replay_total_ms": sum(replay_ms),
                      "replay_mean_ms": sum(replay_ms) / max(1,
                                                             len(replay_ms)),
                      "chunk_cap": saved[0], "chunk_replay_ms": saved[1],
                      "chunk_launch_loop_ms": saved[2],
                      "chunk_bound_ms": saved[3], "chunk_bound_by": saved[4],
                      "chunk_split_ms": saved[6],
                      "chunk_device_ops": watch.ops,
                      "checks": [dict(zip(("cap", "variant", "overflow_step",
                                           "replay_ms", "plain_ms",
                                           "live_folds"), c))
                                 for c in checks],
                      "saved_chunk_plain": {"steps": saved_steps,
                                            "plain_ms": saved_plain_ms}}}


# ----------------------------------------------------------------------
# the guide-tree methods and the distance export
# phase 8's runs (names apart from the other phases' recorded runs):
# name, family, flags, the K1 variants the run launches
# (exactly those: lcs_variant's rule on its blocks; every block of a
# prefix sweep or a square export, 256 rows against at least 257 queries,
# reaches WAVE_MAX_GRID, and only the heuristics' small subgroup sets
# stay below it) and the DP kernels an alignment must launch
TREE_RUNS = (
    ("slink", "2000", ["-gt", "slink", "-gt_export"], ("lcs",), ()),
    ("upgma", "2000", ["-gt", "upgma", "-gt_export"], ("lcs",), ()),
    ("upgma_modified", "2000", ["-gt", "upgma_modified", "-gt_export"],
     ("lcs",), ()),
    ("nj", "1000", ["-gt", "nj", "-gt_export"], ("lcs",), ()),
    ("dist_export", "2000", ["-dist_export"], ("lcs",), ()),
    ("dist_export_pid", "2000", ["-dist_export", "-pid"], ("lcs",),
     ()),
    ("dist_export_square", "2000", ["-dist_export", "-square_matrix"],
     ("lcs",), ()),
    ("medoid", "10000", ["-medoidtree", "-gt_export"], ("lcs", "lcs_wave"),
     ()),
    ("parttree", "10000", ["-parttree", "-gt_export"], ("lcs", "lcs_wave"),
     ()),
    ("upgma_align", "1000", ["-gt", "upgma"], ("lcs",),
     ("dp_staged", "dp_wide")),
    ("medoid_align", "3000", ["-medoidtree"], ("lcs", "lcs_wave"),
     ("dp_staged",)),
)
# the families of TREE_RUNS, by the name it gives them: their files
TREE_FAMS = {"1000": "fam.fa", "2000": "fam_tree.fa", "10000": "fam_10000.fa",
             "3000": "fam_3000.fa"}


def tree_argv(work, name, fam, flags, side):
    """The CLI arguments of a TREE_RUNS run on `side` (torch, numpy)."""
    return flags + ["-stats", os.path.join(work, f"t8_{name}_{side}.st"),
                    os.path.join(work, TREE_FAMS[fam]),
                    os.path.join(work, f"t8_{name}_{side}")]


class NumpyRefs:
    """The -backend numpy reference runs as child processes of the port's
    CLI, at most `width` at a time, in the order given, while this process
    goes on; they share the host's cores at the lowest CPU priority, so
    that this process's timed runs keep the cores they use.  Every child
    is killed if the smoke fails (close)."""

    def __init__(self, work, jobs, width=3):
        self.work = work
        self.todo = list(jobs)          # (name, argv)
        self.running = {}               # name -> (Popen, stderr file)
        self.width = width
        self.poll()

    def poll(self):
        """Reap finished children and start queued ones."""
        for name, (proc, err) in list(self.running.items()):
            if proc.poll() is None:
                continue
            err.close()
            del self.running[name]
            if proc.returncode != 0:
                with open(err.name) as f:
                    raise AssertionError(f"numpy reference run {name}: rc "
                                         f"{proc.returncode}: "
                                         f"{f.read()[-2000:]}")
        while self.todo and len(self.running) < self.width:
            name, argv = self.todo.pop(0)
            err = open(os.path.join(self.work, f"np_{name}.err"), "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "famsa_tpu_torch", "-backend",
                 "numpy"] + argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                stderr=err)
            # before its interpreter starts threads, which inherit it
            os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
            self.running[name] = (proc, err)

    def wait(self, *names):
        """Wait until the runs `names` have ended (all runs: none given);
        returns the seconds waited."""
        t0 = time.perf_counter()
        while True:
            pending = set(self.running) | {name for name, _ in self.todo}
            if not (pending & set(names) if names else pending):
                return time.perf_counter() - t0
            self.poll()
            time.sleep(0.1)

    def close(self):
        for proc, err in self.running.values():
            proc.kill()
            proc.wait()
            err.close()
        self.running = {}
        self.todo = []


def k1_largest(rec, run):
    """Each K1 variant's largest launch of `run` (by its work), held bit-
    exact against lcs_plain and timed (CUDA events); the held inputs are
    dropped.  Returns {variant: {shape, ms, bound_ms, bound_by}}."""
    from famsa_tpu_torch.ops.lcs_torch import lcs_rows
    out = {}
    for key, (_, (table, syms, q, dt)) in sorted(
            rec.lcs_largest.pop(run, {}).items()):
        variant = "wave" if key == "lcs_wave" else "rows"
        lcs_check(table, syms, q, variant, f"{run}'s largest launch")
        ms = cuda_ms(lambda: lcs_rows(table, syms, n_queries=q,
                                      out_dtype=dt, variant=variant),
                     10) if table.is_cuda else float("nan")
        bms, by = lcs_bound_ms(table, syms, q)
        out[key] = {"refs": syms.shape[0], "queries": q,
                    "L": syms.shape[1], "W": table.shape[1], "ms": ms,
                    "bound_ms": bms, "bound_by": by}
    return out


def k1_text(rec, run, largest):
    """K1's launches, CUDA-event total and mean ms of `run` by variant,
    and its largest launch of each."""
    parts = []
    for key, label in (("lcs", "rows"), ("lcs_wave", "wave")):
        n, tot, mean = rec.totals(run, key)
        if not n:
            parts.append(f"K1 {label} 0")
            continue
        g = largest[key]
        parts.append(f"K1 {label} {n} launches, {tot:.3f} ms in all, "
                     f"{mean:.5f} mean, largest {g['refs']} x {g['queries']}"
                     f" (L={g['L']}, W={g['W']}) {g['ms']:.4f} ms, bound "
                     f"{g['bound_ms']:.5f} ({g['bound_by']})")
    return ", ".join(parts)


def phase_trees(work, recorder, watch, refs, device="cuda"):
    """Every guide-tree method, the PartTree/MedoidTree heuristic and the
    distance export through the CLI entry point (TREE_RUNS), -backend
    torch against its -backend numpy child ("t8_" + the run's name in
    refs) byte for byte; every child has ended before the torch runs, so
    their seconds are taken alone on the host.  Each torch run launches
    exactly the K1 variants listed, its largest launch of each is held
    bit-exact against lcs_plain, and no device memory is left allocated
    after a tree run (hundreds of subgroup backends in the heuristics);
    the alignments are held to ResidencyWatch as in phase 4.  The
    recorder times every K1 launch of each run (run names: TREE_RUNS'
    names)."""
    import gc
    import torch
    from famsa_tpu_torch import kernels
    cuda = device == "cuda"
    clash = {r[0] for r in TREE_RUNS} & set(recorder.events)
    if clash:
        raise AssertionError(f"phase 8 runs {clash} would overwrite the "
                             "recorder's earlier runs")
    waited = refs.wait()
    torch_flags = ["-backend", "torch", "-device", device]
    lines = []
    for name, fam, flags, k1, dp in TREE_RUNS:
        align = bool(dp)
        gc.collect()
        before = torch.cuda.memory_allocated() if cuda else 0
        args = torch_flags + tree_argv(work, name, fam, flags, "torch")
        if align:
            watch.profile, watch.ops = None, []
            rc, _, counts, route = run_torch(
                f"phase 8 {name}", args, {}, recorder, watch, name,
                False, device)
            watch.reset()           # it holds the run's profiles
        else:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            recorder.start(name)
            kernels.reset_launches()
            rc, _ = run_cli(args, {})
            counts, route = dict(kernels.LAUNCHES), ""
            recorder.stop(counts)
        if rc != 0:
            raise AssertionError(f"phase 8 {name}: rc={rc}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        launched = tuple(k for k in ("lcs", "lcs_wave") if counts[k])
        if cuda and launched != k1:
            raise AssertionError(f"phase 8 {name}: K1 variants "
                                 f"{launched} launched, {k1} expected: "
                                 f"{counts}")
        if cuda and align:
            check_launches(f"phase 8 {name}", counts, dp, recorder)
        elif any(counts[k] for k in VARIANTS if k not in ("lcs",
                                                           "lcs_wave")):
            raise AssertionError(f"phase 8 {name}: a tree run launched "
                                 f"DP kernels or K8: {counts}")
        # the recorder's hold on the largest launches' inputs (in the
        # peak: it keeps their mask tables alive past their backends)
        kept = {id(t): t.numel() * t.element_size()
                for _, (table, syms, _, _) in recorder.lcs_largest.get(
                    name, {}).values()
                for t in (table, syms) if t.is_cuda}
        largest = k1_largest(recorder, name)
        gc.collect()
        # the recorder holds no new input: phases 4 and 5 gave it both
        # K1 variants' first calls, and k1_largest dropped this run's
        held = (torch.cuda.memory_allocated() if cuda else 0) - before
        if not align and held >= 2 ** 20:
            raise AssertionError(f"phase 8 {name}: {held} bytes of "
                                 "device memory left allocated")
        st = read_stats(os.path.join(work, f"t8_{name}_torch.st"))
        lines.append((name, st, k1_text(recorder, name, largest)
                      + (route if align else
                         ", peak device memory above the run's start "
                         f"{(peak - before) / 2 ** 20:.1f} MiB (the "
                         "recorder's held inputs "
                         f"{sum(kept.values()) / 2 ** 20:.1f})")
                      + f", left allocated {held} bytes"))
    report = []
    for name, st, text in lines:
        outs = []
        for side in ("torch", "numpy"):
            with open(os.path.join(work, f"t8_{name}_{side}"), "rb") as f:
                outs.append(f.read())
        if outs[0] != outs[1]:
            raise AssertionError(f"phase 8 {name}: torch output differs "
                                 "from numpy")
        nst = read_stats(os.path.join(work, f"t8_{name}_numpy.st"))
        secs = "; ".join(
            f"{k[5:]} torch {float(st[k]):.2f} numpy {float(nst[k]):.2f} s"
            for k in ("time.tree_build", "time.total") if k in st)
        report.append(f"{name}: {secs}; {text}")
    log("phase 8 tree methods and distance export, torch byte-identical "
        f"to numpy (numpy in child processes, every one ended before the "
        f"torch runs; waited {waited:.1f} s for them): " + "; ".join(report))


# kernel variant -> (library, C entry point, source, the TPU kernel it
# replaces)
VARIANTS = {
    "lcs": ("lcs", "lcs_bitpar", "famsa_tpu_torch/csrc/lcs.cu",
            "famsa_tpu/ops/lcs_pallas.py:102"),
    "lcs_wave": ("lcs", "lcs_wave", "famsa_tpu_torch/csrc/lcs.cu",
                 "famsa_tpu/ops/lcs_pallas.py:102"),
    "lcs_refmask": ("lcs", "lcs_refmask", "famsa_tpu_torch/csrc/lcs.cu",
                    "famsa_tpu/ops/lcs_pallas.py:102"),
    "dp_staged": ("dp_wide", "dp_profile_batched_staged",
                  "famsa_tpu_torch/csrc/dp_wide.cu",
                  "famsa_tpu/ops/dp_pallas.py:186"),
    "dp_staged16": ("dp_wide", "dp_profile_batched_staged",
                    "famsa_tpu_torch/csrc/dp_wide.cu",
                    "famsa_tpu/ops/dp_pallas.py:186"),
    "dp_stripes": ("dp_wide", "dp_profile_batched_stripes",
                   "famsa_tpu_torch/csrc/dp_wide.cu",
                   "famsa_tpu/ops/dp_pallas.py:186"),
    "dp_spans": ("dp_wide", "dp_profile_batched_spans",
                 "famsa_tpu_torch/csrc/dp_wide.cu",
                 "famsa_tpu/ops/dp_pallas.py:186"),
    "dp_wide": ("dp_wide", "dp_profile_wide", "famsa_tpu_torch/csrc/dp_wide.cu",
                "famsa_tpu/ops/dp_giant.py:90"),
    "dp_wide16": ("dp_wide", "dp_profile_wide",
                  "famsa_tpu_torch/csrc/dp_wide.cu",
                  "famsa_tpu/ops/dp_giant.py:90"),
    "dp_wide_stripes": ("dp_wide", "dp_profile_wide_stripes",
                        "famsa_tpu_torch/csrc/dp_wide.cu",
                        "famsa_tpu/ops/dp_giant.py:90"),
    "traceback": ("traceback", "trace_paths",
                  "famsa_tpu_torch/csrc/traceback.cu",
                  "famsa_tpu/ops/dp_pallas.py:948"),
    "stage0": ("stage0", "stage0", "famsa_tpu_torch/csrc/stage0.cu",
               "famsa_tpu/ops/dp_pallas.py:844"),
    "merged": ("merged", "merged_counters", "famsa_tpu_torch/csrc/merged.cu",
               "famsa_tpu/ops/dp_pallas.py:1919"),
    "chain": ("chain", "chain_carry", "famsa_tpu_torch/csrc/chain.cu",
              "famsa_tpu/ops/dp_chain.py:74"),
    "prim_round": ("prim", "prim_round", "famsa_tpu_torch/csrc/prim.cu",
                   "famsa_tpu/ops/prim_device.py:67"),
    "dp_shard": ("dp_wide", "dp_profile_shard",
                 "famsa_tpu_torch/csrc/dp_wide.cu",
                 "famsa_tpu/parallel/dp_sharded.py:40"),
}
# the entry points that two variants share, told apart by the launch's
# fold count (its argument at this index): up to PORTABLE_FOLDS folds the
# first key, more the second
SPLIT_BY_FOLDS = {"dp_profile_batched_staged": (5, "dp_staged",
                                                "dp_staged16"),
                  "dp_profile_wide": (4, "dp_wide", "dp_wide16")}
# the name of a variant in the kernel report where it shares its entry
REPORT_NAME = {"dp_staged16": "dp_profile_batched_staged[9-16 folds]",
               "dp_wide16": "dp_profile_wide[9-16 folds]"}
# the run whose launch count a variant's entry reports: the main path's
# default run, for K1's rows variant the -dist tree run, for K9 the
# poly-Q family's alignment (phase 5b), for the DP past 4095 columns the
# wide family's run (phase 6b), for K2 past 32767 the profile-profile run
# (phase 5c), for K7 the variant family's all-chain run, for K8
# (measured in phase 2) the main path's default run, and for K10 phase
# 5e's profile-profile run on 2 shards
LAUNCH_RUN = {"lcs": "dist", "lcs_wave": "1000", "lcs_refmask": "polyq",
              "dp_spans": "profprof",
              "dp_staged": "1000", "dp_staged16": "wide600",
              "dp_stripes": "wide600", "dp_wide": "1000",
              "dp_wide16": "wide600", "dp_wide_stripes": "wide600",
              "traceback": "1000", "stage0": "1000", "merged": "1000",
              "chain": "chain", "prim_round": "1000", "dp_shard": "cols"}
# the recorded runs whose per-variant totals the report gives
RECORDED_RUNS = ("1000", "10000", "wide600", "dist", "polyq",
                 "polyq_dist", "profprof", "cols")


class LaunchRecorder:
    """Times every kernel launch of the run it is started for with CUDA
    events recorded on the launch stream right around the C entry point,
    counts the launches per variant, and keeps the inputs of the largest
    call of each variant (the main path's shapes, timed after the runs)
    and of K4's and K6's slowest launch in the 10,000-sequence run (each
    launch's inputs held until its events have completed, read without a
    wait).
    Launches outside a started run (the checks, the timing) and launches
    captured into a chain chunk's CUDA graph are not recorded (a replay
    runs no entry point)."""

    def __init__(self):
        import torch
        from famsa_tpu_torch import kernels
        import famsa_tpu_torch.ops.dp_resident as dpr
        import famsa_tpu_torch.ops.dp_torch as dpt
        import famsa_tpu_torch.ops.dp_wide as dpw
        import famsa_tpu_torch.ops.lcs_torch as lct
        import famsa_tpu_torch.ops.prim_torch as pt
        self.run = None
        self.events = {}            # run -> variant -> [(start, end)]
        self.counts = {}            # run -> LAUNCHES after the run
        self.inputs = {}            # variant -> (size, args)
        self.lcs_largest = {}       # run -> K1 variant -> (work, args)
        self.batch_sizes = []
        self.staged_shapes = {}     # run -> [staged_geometry of a launch]
        self.k2_calls = []          # widest w2 of each K2 call of the run
        self.k2_merges = []         # w2 of each merge of the run's K2 calls
        self.wide_calls = []        # w2 of each K3 call of the run
        self.slowest = {}           # variant -> (launch ms, args)
        self.pending = []           # (variant, (start, end), args)
        self.prim_n = []            # sequences of each device Prim tree
        self.prim_flagged = []      # ... and whether it had a flagged one

        from famsa_tpu_torch.ops.dp_wide import PORTABLE_FOLDS
        entries = {}
        for key, (lib_name, entry, _, _) in VARIANTS.items():
            entries.setdefault((lib_name, entry), key)
        for (lib_name, entry), key in entries.items():
            lib = kernels.get(lib_name)
            orig = getattr(lib, entry)
            split = SPLIT_BY_FOLDS.get(entry)

            def timed(*a, _key=key, _orig=orig, _split=split):
                if self.run is None or \
                        torch.cuda.is_current_stream_capturing():
                    return _orig(*a)
                if _split is not None:
                    at, few, many = _split
                    _key = few if a[at] <= PORTABLE_FOLDS else many
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = _orig(*a)
                end.record()
                self.events[self.run].setdefault(_key, []).append((start,
                                                                   end))
                return err
            setattr(lib, entry, timed)

        def keep(key, size, args):
            # the wide family's run keeps only its own variants' inputs
            # (the others' largest calls stay those of the earlier runs)
            if self.run == "wide600" and LAUNCH_RUN[key] != "wide600":
                return
            if self.run is not None and (key not in self.inputs
                                         or size > self.inputs[key][0]):
                self.inputs[key] = (size, args)

        orig_dp, orig_wide = dpt.dp_dirs, dpw.dp_dirs_wide
        orig_lcs = lct.lcs_rows

        def dp_dirs(colf, rowf, meta, total, variant=None, meta_host=None):
            w2s = list((meta.cpu().numpy() if meta_host is None
                        else meta_host)[:, 1])
            variant = variant or dpt.k2_variant(max(w2s))
            self.k2_calls.append(max(w2s))
            self.k2_merges.extend(int(w) for w in w2s)
            if self.run is not None:
                self.batch_sizes.append(len(w2s))
                if variant == "staged":
                    self.staged_shapes[self.run].append(
                        dpw.staged_geometry(w2s))
            keep(dp_key("K2", w2s, variant), total, (colf, rowf, meta, total))
            return orig_dp(colf, rowf, meta, total, variant=variant,
                           meta_host=meta_host)

        def dp_dirs_wide(colf, rowf, meta, total, variant=None,
                         meta_host=None):
            w2 = int((meta.cpu().numpy() if meta_host is None
                      else meta_host)[0, 1])
            variant = variant or dpw.k3_variant(w2)
            self.wide_calls.append(w2)
            keep(dp_key("K3", [w2], variant), total, (colf, rowf, meta, total))
            return orig_wide(colf, rowf, meta, total, variant=variant,
                             meta_host=meta_host)

        def lcs_rows(table, syms, n_queries=None, out_dtype=torch.int32,
                     variant=None):
            nq = table.shape[2] if n_queries is None else n_queries
            variant = variant or lct.lcs_variant(syms.shape[0], nq)
            key = "lcs_wave" if variant == "wave" else "lcs"
            if self.run is not None and key not in self.inputs:
                keep(key, 0, (table, syms.clone(), nq))
            if self.run is not None:
                # the run's largest launch of each variant, by its work
                size = syms.shape[0] * syms.shape[1] * min(nq,
                                                           table.shape[2])
                big = self.lcs_largest.setdefault(self.run, {})
                if size > big.get(key, (-1,))[0]:
                    big[key] = (size, (table, syms.clone(), nq, out_dtype))
            return orig_lcs(table, syms, n_queries=n_queries,
                            out_dtype=out_dtype, variant=variant)

        orig_tb, orig_s0, orig_mg = (dpr.trace_paths, dpr.stage0,
                                     dpr.merged_from_paths)

        def stage0(params, sides, hdr, table, band=None):
            keep("stage0", int(sides.desc_h[:, 3].sum()),
                 (params, sides, hdr, table, band))
            return orig_s0(params, sides, hdr, table, band)

        def merged_from_paths(sides, paths, hdr, smax):
            args = (sides, paths, hdr, smax)
            keep("merged", int(sides.desc_h[:, 3].sum()), args)
            out = orig_mg(sides, paths, hdr, smax)
            self.track("merged", args)
            return out

        def trace_paths(dirs, fin, meta, meta_host=None):
            args = (dirs, fin, meta, meta_host)
            if meta_host is not None:
                keep("traceback", int((meta_host[:, 0]
                                       + meta_host[:, 1]).sum()), args)
            out = orig_tb(dirs, fin, meta, meta_host=meta_host)
            if meta_host is not None:
                self.track("traceback", args)
            return out

        orig_prim = pt.prim_rounds
        orig_refmask = lct.lcs_refmask

        def prim_rounds(table, queries, *a, **kw):
            self.prim_n.append(queries.shape[0])
            self.prim_flagged.append(kw.get("flags") is not None)
            return orig_prim(table, queries, *a, **kw)

        def lcs_refmask(refs, queries, n_queries=None, out_dtype=torch.int32,
                        out=None, cur=None, flags=None):
            # the largest call outside the Prim rounds (those return at
            # once unless their reference is flagged), by its work
            nq = queries.shape[0] if n_queries is None else n_queries
            if cur is None:
                keep("lcs_refmask", refs.shape[0] * refs.shape[1] * nq,
                     (refs.clone(), queries, nq))
            return orig_refmask(refs, queries, n_queries=n_queries,
                                out_dtype=out_dtype, out=out, cur=cur,
                                flags=flags)

        dpt.dp_dirs, dpw.dp_dirs_wide = dp_dirs, dp_dirs_wide
        lct.lcs_rows = pt.lcs_rows = lcs_rows
        lct.lcs_refmask = pt.lcs_refmask = lcs_refmask
        pt.prim_rounds = prim_rounds
        dpr.trace_paths = trace_paths
        dpr.stage0, dpr.merged_from_paths = stage0, merged_from_paths

    def start(self, run):
        """Record the launches of `run` (None: record nothing but the
        widths of the K2 and K3 calls)."""
        self.run = run
        self.k2_calls, self.k2_merges, self.wide_calls = [], [], []
        self.prim_n, self.prim_flagged = [], []
        if run is not None:
            self.events[run] = {}
            self.staged_shapes[run] = []

    def track(self, key, args):
        """Hold the inputs of the launch of `key` just made in the
        10,000-sequence run until its events complete; keep the slowest."""
        if self.run != "10000":
            return
        self.pending.append((key, self.events[self.run][key][-1], args))
        self.settle()

    def settle(self):
        """Read the pending launches whose events have completed (query
        does not wait) and keep the slowest of each variant."""
        left = []
        for key, (start, end), args in self.pending:
            if not end.query():
                left.append((key, (start, end), args))
                continue
            ms = start.elapsed_time(end)
            if ms > self.slowest.get(key, (-1.0,))[0]:
                self.slowest[key] = (ms, args)
        self.pending = left

    def stop(self, counts):
        """End the run."""
        import torch
        if self.run is not None:
            self.counts[self.run] = counts
        if self.pending:
            torch.cuda.synchronize()
            self.settle()
        self.run = None

    def totals(self, run, key):
        """(launches, total ms, mean ms) of one variant in one run."""
        import torch
        torch.cuda.synchronize()
        ev = self.events.get(run, {}).get(key, [])
        tot = sum(s.elapsed_time(e) for s, e in ev)
        return len(ev), tot, tot / len(ev) if ev else None


def int_err(got, want):
    """Max abs difference of two integer tensors of one shape, in exact
    integers (an int64 difference could wrap)."""
    if got.shape != want.shape:
        raise AssertionError(f"shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)} differ")
    bad = (got != want).nonzero()
    return max((abs(int(got[tuple(at)]) - int(want[tuple(at)]))
                for at in bad[:1000].tolist()), default=0)


def dp_max_err(got, want, meta):
    """Max abs difference of two (dirs, fin) results over the direction
    bytes and each merge's per-row finals (rows past w1 are unused)."""
    err = int((got[0].long() - want[0].long()).abs().max())
    for k, w1 in enumerate(meta[:, 0].tolist()):
        err = max(err, int((got[1][k, :w1] - want[1][k, :w1]).abs().max()))
    return err


def staged_coresidency(rec):
    """One line on K2 staged launches of the main-path runs: launches by
    fold count, the share of their CTAs that hold no column of their
    merge, and the launches that need more clusters than fit on the card
    at once."""
    parts = []
    for run in ("1000", "10000", "wide600"):
        shapes = rec.staged_shapes.get(run, [])
        if not shapes:
            continue
        fit = staged_cluster_fit({(f, t) for f, t, _ in shapes})
        by_folds = {}
        over, idle, ctas = 0, 0, 0
        for folds, threads, merge_folds in shapes:
            by_folds[folds] = by_folds.get(folds, 0) + 1
            idle += sum(folds - f for f in merge_folds)
            ctas += folds * len(merge_folds)
            over += len(merge_folds) > fit[folds, threads]
        parts.append(f"run {run}: {len(shapes)} launches, by folds "
                     f"{dict(sorted(by_folds.items()))}, idle CTAs "
                     f"{idle}/{ctas}, launches needing more clusters than "
                     f"fit {over}")
    return "K2 staged co-residency: " + "; ".join(parts)


def k4_measure(args):
    """K4 on a recorded launch's inputs: (max abs error against its plain
    twin, CUDA-event ms of the wrapper, device ms of the C entry in a CUDA
    graph, plain ms, bound ms, bound by, shape)."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.traceback_torch import (read_paths,
                                                     trace_paths,
                                                     trace_paths_plain)
    dirs, fin, meta, meta_h = args
    res = {}
    plain_ms = wall_ms(lambda: res.setdefault(
        "plain", trace_paths_plain(dirs, fin, meta)))
    got = trace_paths(dirs, fin, meta, meta_host=meta_h)
    err = int((got.long() - res["plain"].long()).abs().max())
    ms = cuda_ms(lambda: trace_paths(dirs, fin, meta, meta_host=meta_h), 20)
    lib, out = kernels.get("traceback"), torch.zeros_like(got)
    gms = graph_ms(lambda: kernels.check(lib.trace_paths(
        dirs.data_ptr(), fin.data_ptr(), meta.data_ptr(), meta.shape[0],
        fin.shape[1], out.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "trace_paths"))
    steps = sum(len(p) for p, _ in read_paths(got.cpu().numpy(), meta_h))
    bms, by = k4_bound_ms(got.numel(), steps, meta.shape[0])
    return err, ms, gms, plain_ms, bms, by, (
        f"{meta.shape[0]} merge(s) {meta_h[:, :2].tolist()}, {steps} steps: "
        f"{ms:.5f} ms, in a graph {gms:.5f} ms, "
        f"{gms * 1e6 / steps:.1f} ns a step")


def k6_measure(args):
    """K6 on a recorded launch's inputs, as k4_measure."""
    import torch
    from famsa_tpu_torch import kernels
    from famsa_tpu_torch.ops.merged_torch import (merged_from_paths,
                                                  merged_from_paths_plain)
    sides, paths, hdr, smax = args
    res = {}
    plain_ms = wall_ms(lambda: res.setdefault(
        "plain", merged_from_paths_plain(sides, paths, hdr, smax)))
    got = merged_from_paths(sides, paths, hdr, smax)
    err = int_err(got, res["plain"])
    ms = cuda_ms(lambda: merged_from_paths(sides, paths, hdr, smax), 20)
    lib, out = kernels.get("merged"), torch.empty_like(got)
    gms = graph_ms(lambda: kernels.check(lib.merged_counters(
        sides.desc.data_ptr(), hdr.data_ptr(), paths.data_ptr(), sides.b,
        smax, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "merged_counters"))
    bms, by = k6_bound_ms(sides, hdr, paths, got)
    w1, w2 = sides.widths()
    return err, ms, gms, plain_ms, bms, by, (
        f"{sides.b} merge(s) of w1 + w2 up to {int((w1 + w2).max())}, "
        f"smax {smax}: {ms:.5f} ms, in a graph {gms:.5f} ms")


def run_totals(rec, key):
    """{run: launches, CUDA-event total and mean ms} of one variant over
    the recorded runs that launched it."""
    runs = {}
    for r in RECORDED_RUNS + tuple(t[0] for t in TREE_RUNS):
        n, tot, mean = rec.totals(r, key)
        if n:
            runs[r] = {"launches": n, "total_ms": tot, "mean_ms": mean}
    return runs


def kernel_report(rec, stand_ins, k7, k8, k10, seg):
    """One entry per kernel variant: held against its plain version at
    the largest input the main-path runs gave it (bit-exact, or the smoke
    fails), its CUDA-event time there, the bound, and the per-run totals
    of every launch the recorder timed.  A variant those runs never
    launched is measured on other inputs (its entry's "at"): on stand_ins
    ({variant: (at, (colf, rowf, meta, total))}: phase 3's and 3b's
    inputs).  K9's launches are the poly-Q alignment's Prim rounds' (most
    return at once, their reference unflagged); it is held and timed on
    the largest call of the recorded runs outside the rounds (a block of
    flagged references of the poly-Q -dist_export run).
    K7's entry (k7) comes from phase 7, which holds and times it; its
    launches in the all-chain run are graph replays' in the main, so its
    totals are the replays' ("graph").  K8's entry (k8) comes from phase
    2, which holds it on the main path's families and times it there; its
    launches and totals are the recorded runs'.  K10's entry (k10) comes
    from phase 5e, which holds and times it; K1 wave's and K9's "seg"
    (seg) from phase 5f, past one warp's segment."""
    from famsa_tpu_torch.ops.dp_stage0 import stage0, stage0_plain
    from famsa_tpu_torch.ops.dp_torch import dp_dirs, dp_plain
    from famsa_tpu_torch.ops.dp_wide import dp_dirs_wide
    from famsa_tpu_torch.ops.lcs_torch import (lcs_plain, lcs_refmask,
                                               lcs_refmask_plain, lcs_rows)
    from famsa_tpu_torch.ops.sides import read_sides_plain
    # every DP variant against dp_plain, the row-serial plain version of
    # the same function (phases 3 and 3b hold each against its fold walk
    # too, which takes minutes a call at these shapes)
    dp_fns = {"dp_spans": lambda *a: dp_dirs(*a, variant="spans"),
              "dp_staged": lambda *a: dp_dirs(*a, variant="staged"),
              "dp_staged16": lambda *a: dp_dirs(*a, variant="staged"),
              "dp_stripes": lambda *a: dp_dirs(*a, variant="stripes"),
              "dp_wide": lambda *a: dp_dirs_wide(*a, variant="staged"),
              "dp_wide16": lambda *a: dp_dirs_wide(*a, variant="staged"),
              "dp_wide_stripes": lambda *a: dp_dirs_wide(*a,
                                                         variant="stripes")}
    stand_in = {}
    for key, (at, args) in stand_ins.items():
        stand_in[key] = (at, lambda a=args: a)
    out, shapes, extra = [], [], {}
    for key, (_, entry, source, replaces) in VARIANTS.items():
        if key == "chain":
            out.append(k7)
            continue
        if key == "dp_shard":
            out.append(k10)
            continue
        if key == "prim_round":
            out.append({**k8, "launches": rec.counts["1000"][key],
                        "launches_run": "1000", "runs": run_totals(rec, key)})
            continue
        # its count in its own run, else in the first run that launched it
        run = next((r for r in (LAUNCH_RUN[key],) + RECORDED_RUNS
                    if rec.counts[r][key]), None)
        if run is not None:
            launches, at = rec.counts[run][key], "largest main-path call"
            args = rec.inputs[key][1]
        elif key in stand_in:
            launches, (at, get) = 0, stand_in[key]
            args = get()
        else:
            raise AssertionError(f"{entry}: not launched by the main-path "
                                 "runs")
        if key == "lcs_refmask":
            args = rec.inputs[key][1]
            refs, queries, q = args
            got = lcs_refmask(refs, queries, n_queries=q)
            want = lcs_refmask_plain(refs, queries, q)
            err = int((got[:, :q].long() - want[:, :q].long()).abs().max())
            ms = cuda_ms(lambda: lcs_refmask(refs, queries, n_queries=q), 20)
            plain_ms = wall_ms(lambda: lcs_refmask_plain(refs, queries, q))
            bms, by = refmask_bound_ms(refs, queries, q)
            at = "largest call outside the Prim rounds (polyq_dist)"
            shapes.append(f"{entry} {refs.shape[0]} flagged ref(s) x {q} "
                          f"queries (Lr={refs.shape[1]}, "
                          f"Lq={queries.shape[1]})")
        elif key in ("lcs", "lcs_wave"):
            table, syms, q = args
            variant = "wave" if key == "lcs_wave" else "rows"
            got = lcs_rows(table, syms, n_queries=q, variant=variant)
            want = lcs_plain(table, syms, q)
            err = int((got[:, :q].long() - want[:, :q].long()).abs().max())
            ms = cuda_ms(lambda: lcs_rows(table, syms, n_queries=q,
                                          variant=variant), 50)
            plain_ms = wall_ms(lambda: lcs_plain(table, syms, q))
            bms, by = lcs_bound_ms(table, syms, q)
            shapes.append(f"{entry} {syms.shape[0]} ref x {q} queries "
                          f"(L={syms.shape[1]}, W={table.shape[1]})")
        elif key == "stage0":
            params, sides, hdr, table, band = args
            res = {}
            plain_ms = wall_ms(lambda: res.setdefault(
                "plain", stage0_plain(params, *read_sides_plain(sides), hdr,
                                      table, band)))
            got = stage0(params, sides, hdr, table, band)
            err = max(int_err(g, w) for g, w in zip(got, res["plain"]))
            ms = cuda_ms(lambda: stage0(params, sides, hdr, table, band), 20)
            bms, by = k5_bound_ms(sides, hdr, band, got)
            w1, w2 = sides.widths()
            shapes.append(f"{entry} {len(w1)} merge(s), w1 up to "
                          f"{int(w1.max())}, w2 up to {int(w2.max())}")
        elif key in ("merged", "traceback"):
            measure = k6_measure if key == "merged" else k4_measure
            err, ms, gms, plain_ms, bms, by, shape = measure(args)
            shapes.append(f"{entry} {shape}")
            extra[key] = {"graph_ms": gms}
            if key in rec.slowest:
                launch_ms, sargs = rec.slowest[key]
                serr, sms, sgms, _, sbms, _, sshape = measure(sargs)
                err = max(err, serr)
                extra[key]["slowest"] = {
                    "run": "10000", "launch_ms": launch_ms, "ms": sms,
                    "graph_ms": sgms, "bound_ms": sbms, "shape": sshape}
                shapes.append(f"{entry} slowest launch of run 10000 "
                              f"({launch_ms:.5f} ms in the run): {sshape}")
        else:
            colf, rowf, meta, total = args
            fn = dp_fns[key]
            res = {}
            plain_ms = wall_ms(lambda: res.setdefault(
                "plain", dp_plain(colf, rowf, meta, total)))
            err = dp_max_err(fn(colf, rowf, meta, total), res["plain"], meta)
            ms = cuda_ms(lambda: fn(colf, rowf, meta, total), 5)
            bms, by = dp_bound_ms(colf, rowf, meta, total)
            shapes.append(f"{REPORT_NAME.get(key, entry)} ({at}) "
                          f"{meta.shape[0]} merge(s), {meta[:, :2].tolist()}")
        if err:
            raise AssertionError(f"{entry} at the main path's shape: max abs "
                                 f"error {err} against the plain version")
        runs = run_totals(rec, key)
        out.append({"name": REPORT_NAME.get(key, entry), "route": "cuda",
                    "source": source,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "launches_run": run, "at": at, "runs": runs,
                    **extra.get(key, {}),
                    **({"seg": seg[key]} if key in seg else {})})
    hist = np.bincount(rec.batch_sizes) if rec.batch_sizes else []
    log("kernels at main-path shapes (largest call of each variant): "
        + "; ".join(shapes) + f"; K2 batch sizes (count by size 0..): "
        f"{list(map(int, hist))}")
    log(staged_coresidency(rec))
    for e in out:
        log(f"  {e['name']}: " + ", ".join(
            f"run {r}: {v['launches']} launches, {v['total_ms']:.3f} ms in "
            f"all, {v['mean_ms']:.5f} ms mean" for r, v in e["runs"].items()))
    return out


# ----------------------------------------------------------------------
# the inputs of phases 4-8 and their -backend numpy references
MAIN_FAMILY = (1000, 300, 7)        # phase 4: sequences, mean length, seed
TREE_FAMILY = (2000, 300, 11)       # phase 5 (and phase 8's trees)
MEDOID_FAMILY = (3000, 300, 13)     # phase 8's aligned MedoidTree run
# numpy runs at a time: the host has 8 cores, and phases 2-3c, which run
# beside them, keep one busy
REF_WIDTH = 4


def write_families(work):
    """Phases 4-8's input files in `work`, under the names they read."""
    texts = {"fam.fa": make_family(*MAIN_FAMILY),
             "fam_tree.fa": make_family(*TREE_FAMILY),
             "fam_3000.fa": make_family(*MEDOID_FAMILY),
             "fam_10000.fa": make_family(*WIDE_300),
             "fam_wide600.fa": make_family(*WIDE_FAMILY),
             "polyq.fa": make_polyq(*POLYQ_FAMILY),
             "long.fa": make_long(*LONG_FAMILY)}
    texts["prof1.fa"], texts["prof2.fa"] = make_profiles()
    for name, text in texts.items():
        with open(os.path.join(work, name), "w") as f:
            f.write(text)


def start_references(work, device="cuda"):
    """Write phases 4-8's inputs, the torch guide trees of phases 6 and 6b
    (-gt_export; their numpy references import them), and start every
    -backend numpy reference run of phases 4-8 as a child process,
    REF_WIDTH at a time, phase 4's and then the longest first, so that
    they run beside phases 2-3c (phase 7's numpy run stays in this
    process, which times its host merges).  Returns (the NumpyRefs, {run: seconds of its torch
    -gt_export}); the phases wait for their runs by name."""
    write_families(work)

    def w(name):
        return os.path.join(work, name)
    tree_secs = {}
    for run in ("wide600", "10000"):
        rc, tree_secs[run] = run_cli(["-backend", "torch", "-device", device,
                                      "-gt_export", w(f"fam_{run}.fa"),
                                      w(f"{run}.dnd")], {})
        if rc != 0:
            raise AssertionError(f"{run} gt_export: rc={rc}")
    trees = {name: (fam, flags) for name, fam, flags, _, _ in TREE_RUNS}

    def tree_job(name):
        return "t8_" + name, tree_argv(work, name, *trees[name], "numpy")
    polyq = w("polyq.fa")
    # phase 4's first (the first needed), then the longest
    jobs = [("main", ["-stats", w("stats_numpy.txt"), w("fam.fa"),
                      w("out_numpy.fa")])]
    jobs += [(run, ["-gt", "import", w(f"{run}.dnd"), "-stats",
                    w(f"{run}_stats_numpy.txt"), w(f"fam_{run}.fa"),
                    w(f"{run}_numpy.fa")]) for run in ("wide600", "10000")]
    jobs += [tree_job("upgma_align"), tree_job("medoid_align"),
             tree_job("medoid"), tree_job("parttree")]
    jobs += [(what, extra + ["-stats", w(f"{what}_numpy.st"), "-gt_export",
                             w("fam_tree.fa"), w(f"{what}_numpy.dnd")])
             for what, extra in TREE_CASES]
    jobs += [(name, flags + [polyq, w(f"{name}_numpy{ext}")])
             for name, flags, ext in POLYQ_RUNS]
    jobs += [(name, flags + [w("long.fa"), w(f"{name}_numpy{ext}")])
             for name, flags, ext in LONG_RUNS]
    jobs += [("profprof", profprof_argv(work, "numpy")),
             ("mesh_upgma", ["-gt", "upgma", "-gt_export", "-stats",
                             w("mesh_upgma_numpy.dnd.st"), polyq,
                             w("mesh_upgma_numpy.dnd")]),
             ("polyq_refine", [polyq, w("polyq_refine_numpy.fa")])]
    jobs += [tree_job(name) for name in trees
             if "t8_" + name not in dict(jobs)]
    return NumpyRefs(work, jobs, width=REF_WIDTH), tree_secs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from famsa_tpu_torch import kernels

    t0 = time.perf_counter()
    smi = nvidia_smi()
    secs = kernels.build_all()
    log(f"phase 1 build: {secs:.1f} s for {len(kernels.KERNELS)} kernel "
        f"sources; {smi}")
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
        refs, tree_secs = start_references(work)
        log(f"phase 1 references: {len(refs.todo) + len(refs.running)} "
            f"numpy runs of phases 4-8 started as child processes, "
            f"{REF_WIDTH} at a time; the torch trees of phases 6b and 6 "
            f"(-gt_export) {tree_secs['wide600']:.2f} s and "
            f"{tree_secs['10000']:.2f} s")
        try:
            phase_k1()
            phase_k9()
            k8 = phase_k8()
            stand_ins = phase_k2()
            phase_k2_spans()
            stand_ins.update(phase_k3())
            phase_edges()
            rec = LaunchRecorder()
            watch = ResidencyWatch()
            phase_main(work, rec, watch, refs)
            phase_tree(work, rec, refs)
            phase_polyq(work, rec, watch, refs)
            phase_profprof(work, rec, watch, refs)
            phase_mesh(work, rec, refs)
            k10 = phase_cols(work, rec, refs)
            seg = phase_long(work, rec, watch, refs)
            phase_wide(work, rec, watch, refs, tree_secs)
            phase_wide(work, rec, watch, refs, tree_secs,
                       family=WIDE_FAMILY, run="wide600",
                       label="6b wide family")
            np_wait = refs.wait()   # phase 7's timed runs alone on the host
            log(f"numpy children: {np_wait:.1f} s waited for the last")
            k7 = phase_chain(work, rec)
            phase_trees(work, rec, watch, refs)
        finally:
            refs.close()
    kern = kernel_report(rec, stand_ins, k7, k8, k10, seg)
    log(f"smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
